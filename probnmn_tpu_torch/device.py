r"""
The device an entry point runs on: ``cuda`` unless the caller asks for the
CPU, and asking for ``cuda`` without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    r"""``torch.device(device)``; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
