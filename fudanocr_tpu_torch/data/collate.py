"""Device-side half of the uint8 collate (port of
fudanocr_tpu/data/collate.py::normalize_uint8; the host-side collates of
that module wait for the LMDB serving port)."""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> float32 [0, 1] on x's device, bit-equal to the
    float32 host collate (the same `/ 255.0` on the same bytes)."""
    return x.float() / 255.0
