"""Environment report (port of fudanocr_tpu/utils/collect_env.py;
mmseg/utils/collect_env.py), runnable as
`python -m fudanocr_tpu_torch.utils.collect_env`.

Reports Python, torch and its CUDA build, and each card's name and power
limit (from `nvidia-smi`, which states the limit a card runs under), so a
training log names the hardware its numbers come from.
"""

from __future__ import annotations

import platform
import subprocess
import sys
from typing import Dict


def collect_env() -> Dict[str, str]:
    import numpy
    import torch

    info: Dict[str, str] = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "Machine": platform.machine(),
        "PyTorch": torch.__version__,
        "CUDA (torch build)": str(torch.version.cuda),
        "numpy": numpy.__version__,
    }
    info["CUDA available"] = str(torch.cuda.is_available())
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        info["GPUs"] = ", ".join(torch.cuda.get_device_name(i)
                                 for i in range(n))
        info["GPU count"] = str(n)
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10)
            if out.returncode == 0:
                info["nvidia-smi name, power limit"] = "; ".join(
                    out.stdout.strip().splitlines())
        except (OSError, subprocess.SubprocessError):
            pass
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5)
        if sha.returncode == 0:
            info["git commit"] = sha.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


if __name__ == "__main__":
    for name, val in collect_env().items():
        print(f"{name}: {val}")
