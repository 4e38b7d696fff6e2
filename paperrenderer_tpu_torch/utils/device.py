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


def use_kernels(use_pallas) -> bool:
    """The JAX package's ``use_pallas`` keyword as the port's route: None
    or True runs the port's kernels (their plain versions on CPU tensors),
    the counterpart of the Pallas route, on every device; False runs the
    XLA route, plain tensor ops that launch no kernel, on the pass's
    device."""
    return use_pallas is None or bool(use_pallas)
