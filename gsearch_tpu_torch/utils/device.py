"""The one place a device name from the command line becomes a torch.device."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """Parse a device name; asking for CUDA without a visible card raises
    (there is no silent CPU fallback: a run on the CPU is asked for by name)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
