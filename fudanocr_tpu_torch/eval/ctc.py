"""CTC label codec and greedy decoding (port of fudanocr_tpu/eval/ctc.py;
reference scene-text-telescope/utils/utils_crnn.py:10-78).

Blank is index 0 and alphabet indices start at 1; decoding collapses
repeats, then drops blanks. The argmax runs on the device, the string
assembly on the host. `CTCLabelConverter` is a copy of the JAX module's
pure-Python class (that module imports jax).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class CTCLabelConverter:
    def __init__(self, alphabet: str, ignore_case: bool = True):
        self.ignore_case = ignore_case
        if ignore_case:
            alphabet = alphabet.lower()
        self.alphabet = alphabet
        # index 0 is the CTC blank ('-' in the reference display alphabet)
        self.char_to_idx = {ch: i + 1 for i, ch in enumerate(alphabet)}

    @property
    def num_classes(self) -> int:
        return len(self.alphabet) + 1

    def encode(self, texts: Sequence[str], max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels [B, max_len] int32 zero-padded, lengths [B] int32)."""
        b = len(texts)
        labels = np.zeros((b, max_len), dtype=np.int32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, t in enumerate(texts):
            if self.ignore_case:
                t = t.lower()
            ids = [self.char_to_idx[ch] for ch in t if ch in self.char_to_idx]
            ids = ids[:max_len]
            labels[i, :len(ids)] = ids
            lengths[i] = len(ids)
        return labels, lengths

    def decode_ids(self, ids: np.ndarray) -> List[str]:
        """Collapse-repeats-then-drop-blanks over [B, T] argmax ids."""
        out = []
        for row in np.asarray(ids):
            chars = []
            prev = 0
            for k in row:
                if k != 0 and k != prev:
                    chars.append(self.alphabet[k - 1])
                prev = k
            out.append("".join(chars))
        return out


def ctc_greedy_decode(logits: torch.Tensor) -> torch.Tensor:
    """Device-side argmax over [B, T, C] logits -> [B, T] int64 ids."""
    return logits.argmax(-1)
