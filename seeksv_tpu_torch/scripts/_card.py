"""What a calibration or a scale program records of the card it ran on."""
from __future__ import annotations

import os
import subprocess
import time

import torch

from .. import _build
from ..pipeline.driver import native_stage


def smi_line(idx: int) -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(idx)], capture_output=True,
        text=True, check=True).stdout.strip()


def card() -> dict:
    """The CUDA card in use: its name, as torch and as nvidia-smi's
    name,power.limit give it, and the host's thread count.  Raises
    without a card: a calibration measures the card, never the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the calibration measures the card")
    idx = torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(idx), "platform": "cuda",
            "nvidia_smi": smi_line(idx), "host_threads": os.cpu_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def require(device) -> torch.device:
    """``torch.device(device)``; a CUDA device on a host without a card
    raises: a scale program never goes on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device}; "
                         "--device cpu runs on the host")
    return dev


def provenance(dev: torch.device) -> dict:
    """The row fields that say where a scale run ran: the device, the
    card's nvidia-smi name,power.limit line (None on the CPU), torch's
    and CUDA's versions."""
    line = None
    if dev.type == "cuda":
        line = smi_line(dev.index if dev.index is not None
                        else torch.cuda.current_device())
    return {"device": str(dev), "card": line, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def warm(dev: torch.device, setup: dict) -> None:
    """Pay before the first timed trial what it would otherwise pay: the
    native host library's build (``setup["native"]``) and, on a CUDA
    device, the CUDA context and the build and load of the port's
    kernels (``setup["kernels"]``), seconds rounded to the millisecond."""
    native_stage(dev, setup)
    if dev.type == "cuda":
        t = time.perf_counter()
        torch.zeros(1, device=dev)
        _build.lib()
        torch.cuda.synchronize(dev)
        setup["kernels"] = time.perf_counter() - t
    for k in ("native", "kernels"):
        if k in setup:
            setup[k] = round(setup[k], 3)
