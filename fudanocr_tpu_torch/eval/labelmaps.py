"""Vocabulary maps (port of fudanocr_tpu/eval/labelmaps.py;
scene-text-telescope/utils/labelmaps.py:6 equivalent)."""

from __future__ import annotations

import string
from typing import List


def get_vocabulary(voc_type: str = "ALLCASES_SYMBOLS", eos: str = "EOS",
                   padding: str = "PADDING", unknown: str = "UNKNOWN"
                   ) -> List[str]:
    if voc_type == "LOWERCASE":
        voc = list(string.digits + string.ascii_lowercase)
    elif voc_type == "ALLCASES":
        voc = list(string.digits + string.ascii_letters)
    elif voc_type == "ALLCASES_SYMBOLS":
        voc = list(string.printable[:-6])
    else:
        raise KeyError(f"unknown voc_type {voc_type!r}")
    return voc + [eos, padding, unknown]


def char2id(voc: List[str]) -> dict:
    return {ch: i for i, ch in enumerate(voc)}


def id2char(voc: List[str]) -> dict:
    return {i: ch for i, ch in enumerate(voc)}
