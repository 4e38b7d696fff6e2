"""Transform math: quaternions, TRS composition, 3x4 model matrices.

PyTorch counterpart of ``paperrenderer_tpu/core/transforms.py`` (reference:
resources/shaders/Common.glsl:79-117 ``getModelMatrix``). Every function is
vectorized over leading batch dimensions, so one call builds the matrices of
the whole instance SoA.

Conventions (matching the reference):
  * Quaternions are (w, x, y, z), normalized.
  * A model matrix is a row-major ``f32[..., 3, 4]``:
    ``world = M[:, :3] @ v + M[:, 3]`` with ``M[:, :3] = R @ diag(scale)``.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) ``[..., 4]``."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w,x,y,z) ``[..., 4]`` -> row-major rotation ``[..., 3, 3]``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 2.0 * (w * w + x * x) - 1.0
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 2.0 * (w * w + y * y) - 1.0
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 2.0 * (w * w + z * z) - 1.0
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of (w,x,y,z) quaternions ``[..., 4]``."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion (w,x,y,z). ``axis [..., 3]`` need not be unit."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def trs_to_mat34(pos: torch.Tensor, scale: torch.Tensor,
                 quat: torch.Tensor) -> torch.Tensor:
    """Per-instance TRS -> 3x4 model matrices,
    ``[..., 3]/[..., 3]/[..., 4] -> [..., 3, 4]``."""
    rot = quat_to_mat3(quat)
    rs = rot * scale[..., None, :]                # R @ diag(scale)
    return torch.cat([rs, pos[..., :, None]], dim=-1)


def apply_mat34(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 3x4 matrices to points: ``m [..., 3, 4]``, ``pts [..., 3]``.

    Written as broadcast multiply-adds, not a batched GEMM: geometry math
    stays in exact f32 elementwise arithmetic on every device."""
    return (m[..., :, 0] * pts[..., None, 0] + m[..., :, 1] * pts[..., None, 1]
            + m[..., :, 2] * pts[..., None, 2] + m[..., :, 3])


def mat34_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of affine 3x4 matrices ``[..., 3, 4]`` (world -> object)."""
    a_inv = torch.linalg.inv(m[..., :, :3])
    t = m[..., :, 3]
    t_inv = -(a_inv[..., :, 0] * t[..., None, 0]
              + a_inv[..., :, 1] * t[..., None, 1]
              + a_inv[..., :, 2] * t[..., None, 2])
    return torch.cat([a_inv, t_inv[..., :, None]], dim=-1)


def mat34_to_mat44(m: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 4]`` -> homogeneous ``[..., 4, 4]`` (last row 0, 0, 0, 1)."""
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                        device=m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, last], dim=-2)


def transform_aabb(m: torch.Tensor, aabb_min: torch.Tensor,
                   aabb_max: torch.Tensor):
    """AABBs through 3x4 matrices: the AABB of the 8 transformed corners, in
    Arvo's centre/extent form (Common.glsl:123-152). ``m [..., 3, 4]``,
    aabbs ``[..., 3]``; returns (min, max)."""
    a = m[..., :, :3]
    center = (aabb_min + aabb_max) * 0.5
    extent = (aabb_max - aabb_min) * 0.5
    new_center = apply_mat34(m, center)
    new_extent = (a[..., :, 0].abs() * extent[..., None, 0]
                  + a[..., :, 1].abs() * extent[..., None, 1]
                  + a[..., :, 2].abs() * extent[..., None, 2])
    return new_center - new_extent, new_center + new_extent
