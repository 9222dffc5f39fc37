"""The port's LMDB store (fudanocr_tpu_torch/data/lmdb_store.py) against
the JAX package's: each reads what the other writes, item for item, for
small values, overflow values (one and several pages) and a B-tree of
three levels."""

import os

import numpy as np
import pytest

from fudanocr_tpu.data import lmdb_store as jax_store
from fudanocr_tpu_torch.data import lmdb_store as port_store


def _items(case: str) -> dict:
    rng = np.random.default_rng(["small", "overflow", "deep"].index(case))
    if case == "small":
        return {b"key-%06d" % i: bytes(rng.integers(
            0, 256, rng.integers(1, 100), dtype=np.uint8)) for i in range(500)}
    if case == "overflow":
        sizes = (port_store.PAGE_SIZE * 3 + 17, port_store.PAGE_SIZE - 10,
                 2100, 5000)
        out = {b"big-%d" % i: bytes(rng.integers(0, 256, n, dtype=np.uint8))
               for i, n in enumerate(sizes)}
        out.update({b"s-%03d" % i: b"x" * i for i in range(40)})
        return out
    # 200-byte keys: ~19 nodes a page, so 1000 keys need three levels
    return {b"%0200d" % i: b"v%d" % i for i in range(1000)}


WRITERS = {"jax": jax_store.LMDBWriter, "port": port_store.LMDBWriter}
READERS = {"jax": jax_store.LMDBReader, "port": port_store.LMDBReader}


@pytest.mark.parametrize("case", ["small", "overflow", "deep"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_reads_what_the_other_package_writes(tmp_path, case, writer,
                                                   reader):
    data = _items(case)
    w = WRITERS[writer](os.path.join(tmp_path, "db"))
    w.update(data)
    w.write()
    with READERS[reader](os.path.join(tmp_path, "db")) as r:
        assert len(r) == len(data)
        if case == "deep":
            assert r.main["depth"] >= 3
        assert list(r.items()) == sorted(data.items())
        keys = sorted(data)[::7] + [b"missing"]
        assert r.get_many(keys) == [data.get(k) for k in keys]
        assert all(r.get(k) == v for k, v in data.items())


def test_port_writer_is_byte_equal_to_jax_writer(tmp_path):
    data = {**_items("small"), **_items("overflow")}
    paths = []
    for name, cls in WRITERS.items():
        w = cls(os.path.join(tmp_path, name))
        w.update(data)
        paths.append(w.write())
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
