"""Animation: per-vertex displacement and device-side instance animation.

PyTorch counterpart of ``paperrenderer_tpu/ops/animation.py``, plain
tensor functions with its operation order:

  * ``animate_vertices`` is ``BasicAnimation.comp``'s math (the reference
    example's per-vertex sine displacement of an instance's unique copy of
    its model's vertices, followed by a BLAS rebuild, main.cpp:908-921);
    the RT frames refit or re-split the instance's BLAS from it
    (``ops.accel.refit_anim_blases``, ``resplit_anim_tables``);
  * ``animate_instances`` moves every live instance on the device, orbit
    jitter on the position and one spin about z on the rotation, with no
    host work per instance: the animated 100k-instance loop of bench
    config 5 (``scenes.run_dynamic``).
"""

from __future__ import annotations

import math

import torch

from ..core.scene import InstanceArrays


def f32_time(time) -> torch.Tensor:
    """``time`` as an f32 tensor: a tensor keeps its device, a number
    becomes a 0-dim CPU tensor, which an op on the card reads as a scalar
    argument (no host-to-device copy)."""
    if isinstance(time, torch.Tensor):
        return time.to(torch.float32)
    return torch.tensor(time, dtype=torch.float32)


def animate_vertices(positions: torch.Tensor, time, *,
                     amplitude: float = 0.1,
                     frequency: float = 4.0) -> torch.Tensor:
    """Sine displacement along z by the xy phase: z + amplitude *
    sin(frequency * (x + y) + time) for positions f32[..., 3]."""
    phase = positions[..., 0] + positions[..., 1]
    dz = amplitude * torch.sin(frequency * phase + f32_time(time))
    return torch.cat([positions[..., :2], (positions[..., 2] + dz)[..., None]],
                     dim=-1)


def animate_instances(instances: InstanceArrays, time, *,
                      orbit_radius: float = 0.5, spin_rate: float = 1.0,
                      bob_rate: float = 2.0) -> InstanceArrays:
    """Animate every live instance: a bob of ``orbit_radius`` along z at
    ``bob_rate``, phased by the slot's golden-ratio phase, and the rotation
    turned by the same spin quaternion dq = (cos h, 0, 0, sin h), h = 0.5 *
    ``spin_rate`` * time, as q' = dq * q. Dead slots keep their rows."""
    n = instances.capacity
    dev = instances.pos.device
    t = f32_time(time)
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    alive = instances.alive

    phase = idx * 0.618034 * 2.0 * math.pi   # golden-ratio decorrelation
    bob = torch.sin(bob_rate * t + phase) * orbit_radius
    pos = instances.pos.clone()
    pos[:, 2] = instances.pos[:, 2] + torch.where(alive, bob, 0.0)

    half = 0.5 * spin_rate * t + phase * 0.0
    dw, dz = torch.cos(half), torch.sin(half)
    q = instances.quat
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    quat = torch.stack([dw * w - dz * z, dw * x - dz * y,
                        dw * y + dz * x, dw * z + dz * w], dim=-1)
    quat = torch.where(alive[:, None], quat, q)
    return InstanceArrays(pos=pos, scale=instances.scale, quat=quat,
                          model_id=instances.model_id)
