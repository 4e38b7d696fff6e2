"""The two BVH primitives the two-level ray tracer uses: 30-bit morton codes
(the per-frame TLAS sort key) and the Möller-Trumbore test on stored edges
(the BLAS leaf test).

PyTorch counterpart of ``morton_codes`` and ``moller_trumbore_edges`` in
``paperrenderer_tpu/ops/bvh.py``. The JAX package's single-level world BVH
(``build_bvh``/``bvh_trace``) is a validation path and is not ported.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v with two zero bits between each (the
    standard uint32 morton magic numbers; int64 here, products stay exact)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """30-bit morton codes (int64) of points normalized into [lo, hi]."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) / extent, 0.0, 1.0)
    g = torch.clamp((q * 1024.0).to(torch.int64), max=1023)
    return ((_expand_bits(g[..., 0]) << 2) | (_expand_bits(g[..., 1]) << 1)
            | _expand_bits(g[..., 2]))


def _cross(a, b):
    """Cross product of [..., 3] tensors as explicit products (the order the
    traversal kernel evaluates)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    """Dot product over the last axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore_edges(o, d, v0, e1, e2, t_min: float = 1e-3):
    """Möller-Trumbore on a stored (vertex, edge1, edge2) triangle. Returns
    (t, u, v, hit); broadcasting over leading dimensions."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, u, v, hit
