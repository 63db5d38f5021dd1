"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent;
    nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def card_line(device) -> str:
    """What a measurement ran on: for a CUDA device the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the device's line), else the
    device's type."""
    import subprocess

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return lines[device.index or 0]
