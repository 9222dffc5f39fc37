"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `*.cu` under `fudanocr_tpu_torch/csrc/` is compiled into one shared
library with a plain C interface, one nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/libfudanocr_kernels-<hash>.so *.o

The library name carries a hash of the sources and flags, so an edit
rebuilds and a stale build is never loaded. It is built at first use (the
first launch of any kernel), from the checkout's sources only, into
`build/kernels/` at the repository root (listed in .gitignore). No nvcc, or
a failed compile, raises with nvcc's own message. Nothing here runs at
import time: the CPU tests import every module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at first "
                       "use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfudanocr_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the kernels if no library for these sources exists.

    Returns (path, seconds spent compiling; 0.0 when it was already built).
    The compile writes to a temporary name and renames, so a process
    building at the same time never loads a half-written library."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compile before reporting, so no nvcc outlives us
        outputs = [p.communicate() for _, p in procs]
        for (cmd, p), (stdout, stderr) in zip(procs, outputs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{stderr}{stdout}")
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with argtypes declared for every entry."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, u32 = ctypes.c_longlong, ctypes.c_uint
    lib.fe_qkv_proj.argtypes = [p, p, p, p, i, i, i, p]
    lib.fe_attn_epilogue.argtypes = [p] * 17 + [i, i, i, f, i, p]
    lib.srb_conv3x3.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.srb_conv3x3_mish_bf16.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.srb_conv3x3_qkv_bf16.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.ln_residual_fwd.argtypes = [p] * 5 + [i64, i, f, i, p]
    lib.attn_dropout_fwd.argtypes = [p] * 6 + [i] * 4 + [i64] * 3 \
        + [f, f, u32, u32, i, p]
    lib.attn_dropout_bwd.argtypes = [p] * 11 + [i] * 4 + [i64] * 6 \
        + [f, f, u32, u32, i, p]
    lib.attn_dropout_keep.argtypes = [p, p, i, i, i, u32, u32, p]
    lib.attn_unmasked_packed_fwd.argtypes = [p] * 4 + [i] * 5 + [i64] * 4 \
        + [f, i, p]
    lib.attn_unmasked_bhld_fwd.argtypes = [p] * 4 + [i] * 5 + [i64] * 12 \
        + [f, i, p]
    lib.attn_region_packed_fwd.argtypes = [p] * 6 + [i] * 5 + [i64] * 4 \
        + [f, i, p]
    lib.attn_packed_fwd_stats.argtypes = [p] * 9 + [i] * 5 + [i64] * 3 \
        + [f, i, p]
    lib.attn_packed_bwd.argtypes = [p] * 15 + [i] * 5 + [i64] * 3 \
        + [i, f, i, p]
    lib.gru_bidir_fwd.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.gru_bidir_x_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    for fn in (lib.fe_qkv_proj, lib.fe_attn_epilogue, lib.srb_conv3x3,
               lib.srb_conv3x3_mish_bf16, lib.srb_conv3x3_qkv_bf16,
               lib.ln_residual_fwd, lib.attn_dropout_fwd,
               lib.attn_dropout_bwd, lib.attn_dropout_keep,
               lib.attn_unmasked_packed_fwd,
               lib.attn_unmasked_bhld_fwd, lib.attn_region_packed_fwd,
               lib.attn_packed_fwd_stats, lib.attn_packed_bwd,
               lib.gru_bidir_fwd, lib.gru_bidir_x_fwd):
        fn.restype = i
    lib.fe_error_string.argtypes = [i]
    lib.fe_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = load_library().fe_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
