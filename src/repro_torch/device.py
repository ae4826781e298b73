"""The one rule for where the port runs: on the card unless asked otherwise."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a concrete ``torch.device`` (a CUDA device gets its
    index, so tensor placement compares equal).  Raises where CUDA is asked
    for and there is none: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def describe(device: torch.device) -> str:
    """What a time taken on ``device`` was taken on.  For a card: its name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints
    them (a card set below its maximum runs slower under load), or its name
    alone where ``nvidia-smi`` cannot be read.  For the CPU, a label that
    says its times are host times."""
    if device.type != "cuda":
        return "cpu (host clock, not a device metric)"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
