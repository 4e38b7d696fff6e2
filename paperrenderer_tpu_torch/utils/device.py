"""Device selection: the port runs on the card unless the caller asks for the
CPU, and never moves to the CPU on its own."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device and
    this PyTorch has no usable CUDA card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available here; "
            "pass device='cpu' to run on the CPU")
    return device


def check_use_pallas(use_pallas) -> None:
    """The JAX package's ``use_pallas`` keyword. None or True runs the port's
    kernels, its counterpart of the Pallas route; False asks for the XLA
    route, which the port does not have."""
    if use_pallas is not None and not use_pallas:
        raise NotImplementedError(
            "use_pallas=False (the XLA route) is not ported yet (ROADMAP "
            "Queue 1 item 8)")
