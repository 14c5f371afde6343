"""What a calibration records of the card it ran on."""
from __future__ import annotations

import os
import subprocess

import torch


def card() -> dict:
    """The CUDA card in use: its name, as torch and as nvidia-smi's
    name,power.limit give it, and the host's thread count.  Raises
    without a card: a calibration measures the card, never the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the calibration measures the card")
    idx = torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(idx)], capture_output=True,
        text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(idx), "platform": "cuda",
            "nvidia_smi": smi, "host_threads": os.cpu_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
