"""The port's one device rule: every tensor lives on an explicit device,
and a CUDA device without a card is an error, never a quiet CPU run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"bendy_tpu_torch renders on cuda or cpu, not {dev}")
    return dev
