"""LMDB-compatible key-value store: mmap reader + single-shot writer.

Every reference data loader speaks LMDB (scene-text-telescope/dataset/
dataset.py:50-204, */data/lmdbReader.py), and its dataset-creation tools
write LMDB (create_lmdb.py:184-534). This environment has no py-lmdb, so
this module implements the LMDB 0.9.x on-disk format (little-endian 64-bit,
4096-byte pages) directly:

* `LMDBReader` — zero-copy mmap B+tree lookups / ordered scans over a real
  LMDB file (data.mdb) written by liblmdb or by `LMDBWriter`.
* `LMDBWriter` — builds a complete database in one pass (sorted keys ->
  leaf pages -> branch levels -> meta), producing files readable by
  liblmdb/py-lmdb. This covers the reference's create-dataset tools, which
  only ever bulk-write.

Port of fudanocr_tpu/data/lmdb_store.py without its optional ctypes path
to a native reader: lookups and scans are pure Python over the mmap, which
both hosts of the port can run.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
PAGEHDRSZ = 16
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01

_META_FMT = struct.Struct("<IIQQ" + "IHHQQQQQ" * 2 + "QQ")
_NODE_HDR = struct.Struct("<HHHH")


def _db_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LMDBReader:
    """Read-only LMDB environment: B+tree lookups and ordered scans over
    an mmap of data.mdb."""

    def __init__(self, path: str):
        self.path = _db_path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        self.meta = meta1 if meta1["txnid"] >= meta0["txnid"] else meta0
        self.main = self.meta["main"]

    def _read_meta(self, pgno: int) -> Dict:
        off = pgno * PAGE_SIZE + PAGEHDRSZ
        vals = _META_FMT.unpack_from(self._mm, off)
        magic, version = vals[0], vals[1]
        if magic != MDB_MAGIC:
            raise ValueError(f"{self.path}: bad LMDB magic {magic:#x}")
        free_db = vals[4:12]
        main_db = vals[12:20]

        def db(v):
            return {"pad": v[0], "flags": v[1], "depth": v[2],
                    "branch_pages": v[3], "leaf_pages": v[4],
                    "overflow_pages": v[5], "entries": v[6], "root": v[7]}

        return {"magic": magic, "version": version, "mapsize": vals[3],
                "free": db(free_db), "main": db(main_db),
                "last_pg": vals[20], "txnid": vals[21]}

    # -- page access -------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """-> (offset, flags, lower, upper)"""
        off = pgno * PAGE_SIZE
        flags, = struct.unpack_from("<H", self._mm, off + 10)
        lower, upper = struct.unpack_from("<HH", self._mm, off + 12)
        return off, flags, lower, upper

    def _node(self, page_off: int, ptr: int):
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(self._mm,
                                                     page_off + ptr)
        key_off = page_off + ptr + 8
        return lo, hi, flags, ksize, key_off

    def _num_keys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) // 2

    def _ptrs(self, page_off: int, n: int) -> List[int]:
        return list(struct.unpack_from(f"<{n}H", self._mm,
                                       page_off + PAGEHDRSZ))

    def _leaf_value(self, lo, hi, flags, ksize, key_off) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ov_pgno, = struct.unpack_from("<Q", self._mm, key_off + ksize)
            data_off = ov_pgno * PAGE_SIZE + PAGEHDRSZ
            return bytes(self._mm[data_off:data_off + dsize])
        data_off = key_off + ksize
        return bytes(self._mm[data_off:data_off + dsize])

    # -- lookups -----------------------------------------------------------

    def get_many(self, keys: List[bytes]) -> List[Optional[bytes]]:
        """Values of `keys`, in order (None where a key is absent)."""
        return [self.get(k) for k in keys]

    def get(self, key: bytes) -> Optional[bytes]:
        root = self.main["root"]
        if root == P_INVALID:
            return None
        pgno = root
        for _ in range(64):  # depth bound
            off, flags, lower, upper = self._page(pgno)
            n = self._num_keys(lower)
            ptrs = self._ptrs(off, n)
            if flags & P_LEAF:
                # binary search leaf keys
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    nlo, nhi, nflags, ksize, koff = self._node(off, ptrs[mid])
                    k = bytes(self._mm[koff:koff + ksize])
                    if k == key:
                        return self._leaf_value(nlo, nhi, nflags, ksize, koff)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: find rightmost child whose key <= search key
            child = None
            lo_i, hi_i = 1, n - 1
            idx = 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                nlo, nhi, nflags, ksize, koff = self._node(off, ptrs[mid])
                k = bytes(self._mm[koff:koff + ksize])
                if k <= key:
                    idx = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            nlo, nhi, nflags, _, _ = self._node(off, ptrs[idx])
            pgno = nlo | (nhi << 16) | (nflags << 32)
        raise RuntimeError("B+tree deeper than 64 levels — corrupt file?")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered scan of all (key, value) pairs."""
        root = self.main["root"]
        if root == P_INVALID:
            return

        def walk(pgno):
            off, flags, lower, upper = self._page(pgno)
            n = self._num_keys(lower)
            ptrs = self._ptrs(off, n)
            if flags & P_LEAF:
                for p in ptrs:
                    lo, hi, nflags, ksize, koff = self._node(off, p)
                    key = bytes(self._mm[koff:koff + ksize])
                    yield key, self._leaf_value(lo, hi, nflags, ksize, koff)
            else:
                for p in ptrs:
                    lo, hi, nflags, _, _ = self._node(off, p)
                    yield from walk(lo | (hi << 16) | (nflags << 32))

        yield from walk(root)

    def __len__(self):
        return self.main["entries"]

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class LMDBWriter:
    """Bulk writer: put() pairs, then write() a complete valid LMDB file."""

    def __init__(self, path: str, subdir: bool = True):
        self.path = path
        self.subdir = subdir
        self._data: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes):
        self._data[bytes(key)] = bytes(value)

    def update(self, mapping: Dict[bytes, bytes]):
        for k, v in mapping.items():
            self.put(k, v)

    # -- layout ------------------------------------------------------------

    @staticmethod
    def _leaf_node(key: bytes, value: bytes, ov_pgno: Optional[int]) -> bytes:
        if ov_pgno is None:
            hdr = _NODE_HDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                                 0, len(key))
            node = hdr + key + value
        else:
            hdr = _NODE_HDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                                 F_BIGDATA, len(key))
            node = hdr + key + struct.pack("<Q", ov_pgno)
        if len(node) % 2:
            node += b"\x00"
        return node

    @staticmethod
    def _branch_node(pgno: int, key: bytes) -> bytes:
        hdr = _NODE_HDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                             (pgno >> 32) & 0xFFFF, len(key))
        node = hdr + key
        if len(node) % 2:
            node += b"\x00"
        return node

    @staticmethod
    def _pack_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
        n = len(nodes)
        lower = PAGEHDRSZ + 2 * n
        total = sum(len(x) for x in nodes)
        upper = PAGE_SIZE - total
        assert lower <= upper, "page overflow"
        ptrs, body = [], b""
        off = PAGE_SIZE
        for node in nodes:  # place from the top downward, in key order
            off -= len(node)
            ptrs.append(off)
        page = struct.pack("<QHHHH", pgno, 0, flags, lower, upper)
        page += struct.pack(f"<{n}H", *ptrs)
        page += b"\x00" * (upper - lower)
        for node, p in sorted(zip(nodes, ptrs), key=lambda t: t[1]):
            page += node
        assert len(page) == PAGE_SIZE
        return page

    def write(self):
        items = sorted(self._data.items())
        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0,1 are meta
        n_overflow = 0

        # threshold for inline values (as liblmdb: nodesize <= page/2-ish);
        # use a conservative bound so pages always fit two nodes
        def needs_overflow(k, v):
            return 8 + len(k) + len(v) > (PAGE_SIZE - PAGEHDRSZ) // 2

        # 1) leaf pages
        leaf_nodes: List[bytes] = []
        leaf_first_key: List[bytes] = []
        leaf_pages: List[List[bytes]] = []
        cur: List[bytes] = []
        cur_size = 0
        ov_chunks: List[Tuple[int, bytes]] = []

        def flush_leaf():
            nonlocal cur, cur_size
            if cur:
                leaf_pages.append(cur)
                cur, cur_size = [], 0

        for key, value in items:
            if needs_overflow(key, value):
                npages = -(-(len(value) + PAGEHDRSZ) // PAGE_SIZE)
                ov_pgno = next_pg
                next_pg += npages
                n_overflow += npages
                ov_chunks.append((ov_pgno, value))
                node = self._leaf_node(key, value, ov_pgno)
            else:
                node = self._leaf_node(key, value, None)
            if PAGEHDRSZ + 2 * (len(cur) + 1) + cur_size + len(node) \
                    > PAGE_SIZE:
                flush_leaf()
            if not cur:
                leaf_first_key.append(key)
            cur.append(node)
            cur_size += len(node)
        flush_leaf()

        leaf_pgnos = []
        for nodes in leaf_pages:
            leaf_pgnos.append(next_pg)
            next_pg += 1

        # 2) branch levels (bottom-up)
        level = list(zip(leaf_pgnos, leaf_first_key))
        branch_levels: List[List[Tuple[int, List[bytes]]]] = []
        n_branch = 0
        depth = 1
        while len(level) > 1:
            new_level = []
            i = 0
            while i < len(level):
                nodes: List[bytes] = []
                size = 0
                first_key = level[i][1]
                start = i
                while i < len(level):
                    child_pg, child_key = level[i]
                    key = b"" if i == start else child_key
                    node = self._branch_node(child_pg, key)
                    if PAGEHDRSZ + 2 * (len(nodes) + 1) + size + len(node) \
                            > PAGE_SIZE:
                        break
                    nodes.append(node)
                    size += len(node)
                    i += 1
                pg = next_pg
                next_pg += 1
                n_branch += 1
                branch_levels.append([(pg, nodes)])
                new_level.append((pg, first_key))
            level = new_level
            depth += 1

        root = level[0][0] if level else P_INVALID
        if not items:
            root, depth = P_INVALID, 0

        # 3) serialize
        out_path = self.path
        if self.subdir:
            os.makedirs(self.path, exist_ok=True)
            out_path = os.path.join(self.path, "data.mdb")

        last_pg = next_pg - 1
        mapsize = max((last_pg + 1) * PAGE_SIZE, 1 << 20)

        def meta_page(pgno, txnid):
            hdr = struct.pack("<QHHHH", pgno, 0, P_META, 0, 0)
            free_db = struct.pack("<IHHQQQQQ", 0, 0, 0, 0, 0, 0, 0, P_INVALID)
            main_db = struct.pack("<IHHQQQQQ", 0, 0, depth, n_branch,
                                  len(leaf_pages), n_overflow, len(items),
                                  root)
            meta = struct.pack("<IIQQ", MDB_MAGIC, MDB_DATA_VERSION, 0,
                               mapsize) + free_db + main_db \
                + struct.pack("<QQ", last_pg, txnid)
            return (hdr + meta).ljust(PAGE_SIZE, b"\x00")

        with open(out_path, "wb") as f:
            f.write(meta_page(0, 0))
            f.write(meta_page(1, 1))
            f.seek((last_pg + 1) * PAGE_SIZE - 1)
            f.write(b"\x00")
            # overflow chains
            for ov_pgno, value in ov_chunks:
                npages = -(-(len(value) + PAGEHDRSZ) // PAGE_SIZE)
                f.seek(ov_pgno * PAGE_SIZE)
                f.write(struct.pack("<QHHI", ov_pgno, 0, P_OVERFLOW, npages))
                f.write(value)
            # leaves
            for pgno, nodes in zip(leaf_pgnos, leaf_pages):
                f.seek(pgno * PAGE_SIZE)
                f.write(self._pack_page(pgno, P_LEAF, nodes))
            # branches
            for entries in branch_levels:
                for pgno, nodes in entries:
                    f.seek(pgno * PAGE_SIZE)
                    f.write(self._pack_page(pgno, P_BRANCH, nodes))
        return out_path
