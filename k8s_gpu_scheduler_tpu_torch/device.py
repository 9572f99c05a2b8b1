"""Explicit device resolution for the port's entry points.

There is deliberately no "cuda if present else cpu" helper: a serving
engine that quietly lands on the CPU is a thousandfold slowdown nobody
asked for. The caller names the device; the default is the card.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``. ``None`` means ``"cuda"``. A CUDA
    device without a visible card raises ``RuntimeError``; only an
    explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev
