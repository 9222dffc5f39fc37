"""Component registries (port of fudanocr_tpu/core/registry.py; the
reference builds its segmentation stack through mmcv registries).

A `Registry` maps a config's `type` string to a factory;
`models/seg/__init__.py` registers the seg backbones, heads and
segmentors under the JAX package's names, and `apps/seg/inference.
build_model` builds a config's model through them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable] = {}

    def register(self, name: Optional[str] = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._items:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._items[key] = fn
            return fn

        return deco

    def get(self, key: str) -> Callable:
        if key not in self._items:
            raise KeyError(f"{key!r} not found in registry {self.name}; "
                           f"available: {sorted(self._items)}")
        return self._items[key]


BACKBONES = Registry("backbones")
HEADS = Registry("heads")
SEGMENTORS = Registry("segmentors")
