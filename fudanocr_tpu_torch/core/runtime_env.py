"""Host runtime-environment knobs (port of fudanocr_tpu/core/runtime_env.py;
mmseg/utils/set_env.py:11-56 `setup_multi_processes`).

The reference pins the multiprocessing start method and caps the OMP /
MKL thread pools so that data workers do not oversubscribe the host.
Config keys mirror the reference: `mp_start_method`, `omp_num_threads`,
`mkl_num_threads`, and `opencv_num_threads`, which is read and left
unused: the port has no cv2 (its image ops are numpy, `data/image.py`).
"""

from __future__ import annotations

import logging
import os
import platform

log = logging.getLogger("fudanocr_tpu_torch.runtime_env")


def setup_multi_processes(cfg) -> None:
    """Apply the host-threading knobs of a config mapping (`cfg.get`-able):
    the multiprocessing start method, and OMP_NUM_THREADS /
    MKL_NUM_THREADS where the environment does not set them already.
    `opencv_num_threads` is accepted and does nothing (no cv2 here)."""
    if platform.system() != "Windows":
        method = cfg.get("mp_start_method", None)
        if method in ("fork", "spawn", "forkserver"):
            import multiprocessing as mp

            log.info("setting multiprocessing start method to %r", method)
            mp.set_start_method(method, force=True)

    if isinstance(cfg.get("opencv_num_threads", None), int):
        log.info("opencv_num_threads ignored: the port uses no cv2")

    for key, env in (("omp_num_threads", "OMP_NUM_THREADS"),
                     ("mkl_num_threads", "MKL_NUM_THREADS")):
        val = cfg.get(key, None)
        if isinstance(val, int) and env not in os.environ:
            os.environ[env] = str(val)
            log.info("%s = %d", env, val)
