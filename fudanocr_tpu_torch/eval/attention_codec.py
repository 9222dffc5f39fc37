"""Attention-decoder label codec, MORAN/ASTER style (port of
fudanocr_tpu/eval/attention_codec.py; numpy only).

Rebuild of scene-text-telescope/utils/utils_moran.py
`strLabelConverterForAttention`: a separator-joined alphabet ending in the
'$' EOS; encode appends EOS and pads; decode trims at the first EOS. Used
by the ASTER head (models/rec/aster_head.py) and by any ported
MORAN-style recognizer (the MORAN network itself is not vendored in the
reference snapshot — only this converter and the loader, base.py:274-291).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class AttentionLabelConverter:
    def __init__(self, alphabet: str = None, sep: str = ":"):
        if alphabet is None:
            import string
            alphabet = sep.join(string.digits + string.ascii_lowercase + "$")
        self.alphabet = alphabet.split(sep)
        self.dict = {ch: i for i, ch in enumerate(self.alphabet)}
        self.eos = self.dict["$"]

    @property
    def num_classes(self) -> int:
        return len(self.alphabet)

    def encode(self, texts: Sequence[str], max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        b = len(texts)
        out = np.full((b, max_len), self.eos, dtype=np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, t in enumerate(texts):
            ids = [self.dict[ch] for ch in t.lower() if ch in self.dict]
            ids = ids[:max_len - 1] + [self.eos]
            out[i, :len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths

    def decode_ids(self, ids: np.ndarray) -> List[str]:
        out = []
        for row in np.asarray(ids):
            chars = []
            for t in row:
                if int(t) == self.eos:
                    break
                chars.append(self.alphabet[int(t)])
            out.append("".join(chars))
        return out
