"""Device moves for the port's dataclasses of tensors (the pytree analogue),
and small per-device constants."""

from __future__ import annotations

import dataclasses

import torch

_CONSTANTS: dict = {}


def tree_to(obj, device):
    """Copy of a frozen dataclass with every tensor field moved to ``device``
    (non-tensor fields are kept as they are)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
    return dataclasses.replace(obj, **changes)


def device_constant(values: tuple, device) -> torch.Tensor:
    """A small f32 constant on ``device``, uploaded once per (values, device).

    A host-to-device copy of pageable memory synchronizes the stream, so
    per-frame code takes its constants from here instead of building them
    with ``torch.tensor(..., device=...)`` every call."""
    key = (values, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=torch.float32,
                                           device=device)
    return t
