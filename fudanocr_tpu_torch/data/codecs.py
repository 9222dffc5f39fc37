"""Label codecs for decomposed targets (the port's copy of the parts of
fudanocr_tpu/data/codecs.py it needs; numpy only).

text-gestalt's english_decomposition.txt maps a character to a string of
stroke digits (stroke_focus_loss.py:32-38), SLD's table to stroke classes
1-5, and the image-ids-CTR / CCR-CLIP tables to radical token lists
(`load_radical_table`, `radical_codec`); `SequenceCodec` turns
decomposed labels into fixed-shape shift-right decoder inputs, dense
targets and lengths for the device (the pattern every CTR project
shares, e.g. sld/util.py:90-116).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_decomposition_table(path: str, fmt: str = "space") -> Dict[str, str]:
    """Load a char -> decomposition-string table.

    fmt='space':  "a 123"            (text-gestalt english_decomposition)
    fmt='sld':    "word | id | 1 2 3" (decompose-stroke-3755.txt)
    fmt='colon':  "char:r1 r2 r3"     (image-ids-CTR decompose.txt)
    """
    table: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if fmt == "space":
                ch, seq = line.split()
                table[ch] = seq
            elif fmt == "sld":
                parts = [p.strip() for p in line.split("|")]
                table[parts[0]] = "".join(parts[2].split())
            elif fmt == "colon":
                ch, _, seq = line.partition(":")
                table[ch] = seq.strip()
            else:
                raise ValueError(fmt)
    return table


class SequenceCodec:
    """Fixed-shape codec: decomposed token strings -> shift-right decoder
    inputs + dense targets + lengths."""

    def __init__(self, alphabet: Sequence[str],
                 decomposition: Optional[Dict[str, str]] = None,
                 terminator: Optional[str] = None):
        self.alphabet = list(alphabet)
        self.tok_to_idx = {t: i for i, t in enumerate(self.alphabet)}
        self.decomposition = decomposition
        self.terminator = terminator

    @property
    def num_classes(self) -> int:
        return len(self.alphabet)

    def decompose(self, label: str) -> List[str]:
        if self.decomposition is None:
            toks = list(label)
        else:
            toks = []
            for ch in label:
                if ch in self.decomposition:
                    dec = self.decomposition[ch]
                    # per-char strings (strokes) or token lists (radicals)
                    toks.extend(list(dec) if isinstance(dec, str) else dec)
        if self.terminator is not None:
            toks.append(self.terminator)
        return toks

    def encode(self, labels: Sequence[str], max_len: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (text_input [B, L] shift-right, text_gt [B, L], lengths [B]),
        int32."""
        b = len(labels)
        text_input = np.zeros((b, max_len), dtype=np.int32)
        text_gt = np.zeros((b, max_len), dtype=np.int32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, label in enumerate(labels):
            ids = [self.tok_to_idx[t] for t in self.decompose(label)
                   if t in self.tok_to_idx][:max_len]
            lengths[i] = len(ids)
            text_gt[i, :len(ids)] = ids
            text_input[i, 1:len(ids)] = ids[:-1]
        return text_input, text_gt, lengths


def load_radical_table(path: str) -> Dict[str, List[str]]:
    """image-ids-CTR decompose table: `char:r1 r2 r3` with multi-char
    radical tokens (CCR-CLIP/utils.py:20-30); a line ':' alone is the
    colon's own entry."""
    table: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            char, _, seq = line.partition(":")
            if char == "" and seq == "":
                char, seq = ":", ":"
            table[char] = seq.split(" ")
    return table


def radical_codec(alphabet_path: Optional[str] = None,
                  decompose_path: Optional[str] = None) -> SequenceCodec:
    """CCR-CLIP radical codec: alphabet = ['PAD'] + file lines + ['$']
    (CCR-CLIP/utils.py:10-17), terminator '$'. Without files, the JAX
    package's synthetic radical system (tests and demos): radicals r0-r11,
    and each of A-Z, 0-9 decomposed into 2-4 of them, drawn from
    `random.Random(0)` in JAX's order."""
    if alphabet_path and decompose_path:
        with open(alphabet_path, encoding="utf-8") as f:
            radicals = [ln.strip("\n") for ln in f if ln.strip("\n")]
        table = load_radical_table(decompose_path)
    else:
        import random
        import string
        radicals = [f"r{i}" for i in range(12)]
        rng = random.Random(0)
        table = {ch: [rng.choice(radicals) for _ in range(rng.randint(2, 4))]
                 for ch in string.ascii_uppercase + string.digits}
    return SequenceCodec(["PAD"] + radicals + ["$"], table, terminator="$")


def english_stroke_codec(decomposition_path: Optional[str] = None
                         ) -> SequenceCodec:
    """text-gestalt's stroke codec: 10 stroke classes '0'..'9', terminator
    '0' (stroke_focus_loss.py:28-38, 55-62). Without a table file, the JAX
    package's built-in fallback (every letter and digit decomposes to a
    two-stroke code from its alphabet position; for tests and demos)."""
    if decomposition_path:
        table = load_decomposition_table(decomposition_path, "space")
    else:
        import string
        chars = string.digits + string.ascii_lowercase + string.ascii_uppercase
        table = {ch: str(i % 9 + 1) + str((i * 7) % 9 + 1)
                 for i, ch in enumerate(chars)}
    return SequenceCodec("0123456789", table, terminator="0")
