"""Implicit Morton BVH: build, refit and lockstep ray traversal, and the two
primitives the two-level tracer shares with it (30-bit morton codes, the
Möller-Trumbore test on stored edges).

PyTorch counterpart of ``paperrenderer_tpu/ops/bvh.py``. The tree is
implicit: leaves are the morton-sorted primitives, ``leaf_size`` a leaf,
padded to a power of two; node i's children are 2i+1 and 2i+2; every
level's boxes come from one reshape + min/max, and a refit is the same
reduction. It backs the single-level world BVH (``render.raytrace.
build_world_scene``, ``ops.trace.BatchTracer``): every live instance's
LOD-0 triangles in world space, rebuilt each frame, the reference the
two-level path and the sharded tiles are checked against. It is plain
PyTorch on the device of its inputs (the JAX package walks it with an XLA
``while_loop``; no TPU kernel lies on it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.tree import tree_to


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


# ---------------------------------------------------------------------------
# The world BVH: build and refit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BVH:
    """Complete binary tree of L leaves (a power of two), 2L-1 nodes: node 0
    the root, node i's children 2i+1 and 2i+2, leaf k node (L-1)+k.
    ``perm[k]`` holds leaf k's primitive ids (-1 = padding)."""

    node_min: torch.Tensor     # f32[2L-1, 3]
    node_max: torch.Tensor     # f32[2L-1, 3]
    perm: torch.Tensor         # i32[L, K] — K primitives a leaf (-1 = empty)
    # row i (internal node) = [min(2i+1), max(2i+1), min(2i+2), max(2i+2)]
    child_boxes: torch.Tensor  # f32[L-1 or 1, 12]

    @property
    def num_leaves(self) -> int:
        return self.perm.shape[0]

    @property
    def depth(self) -> int:
        return self.num_leaves.bit_length() - 1

    def to(self, device) -> "BVH":
        return tree_to(self, device)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1


def build_bvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor,
              valid: torch.Tensor, *, leaf_size: int = 32) -> BVH:
    """An implicit BVH over N primitives' boxes f32[N, 3] (``valid``
    bool[N]; an invalid primitive gets an empty box and sorts last),
    ``leaf_size`` primitives a leaf. The sort is stable on the codes, as
    ``jnp.argsort`` is, so ``perm`` and the boxes equal the JAX package's."""
    n = aabb_min.shape[0]
    k = leaf_size
    n_pad = ((n + k - 1) // k) * k
    l = _next_pow2(n_pad // k)
    dev = aabb_min.device
    inf = float("inf")
    big_min = torch.where(valid[:, None], aabb_min, inf)
    big_max = torch.where(valid[:, None], aabb_max, -inf)
    centroid = torch.where(valid[:, None], (aabb_min + aabb_max) * 0.5, 0.0)
    scene_lo = big_min.amin(dim=0) if n else big_min.new_zeros(3)
    scene_hi = big_max.amax(dim=0) if n else big_max.new_zeros(3)
    codes = morton_codes(centroid, scene_lo, scene_hi)
    codes = torch.where(valid, codes, 0xFFFFFFFF)   # dead ones sort last
    order = torch.argsort(codes, stable=True)
    perm_flat = torch.full((l * k,), -1, dtype=torch.int32, device=dev)
    perm_flat[:n] = torch.where(valid[order], order, -1).to(torch.int32)
    s_min = torch.full((l * k, 3), inf, dtype=torch.float32, device=dev)
    s_max = torch.full((l * k, 3), -inf, dtype=torch.float32, device=dev)
    s_min[:n] = big_min[order]
    s_max[:n] = big_max[order]
    return _fit_nodes(s_min.reshape(l, k, 3).amin(dim=1),
                      s_max.reshape(l, k, 3).amax(dim=1), perm_flat.reshape(l, k))


def _fit_nodes(leaf_min: torch.Tensor, leaf_max: torch.Tensor,
               perm: torch.Tensor) -> BVH:
    """Bottom-up box fit, one pairwise min/max a level (the refit too)."""
    levels_min, levels_max = [leaf_min], [leaf_max]
    while levels_min[0].shape[0] > 1:
        cur_min, cur_max = levels_min[0], levels_max[0]
        levels_min.insert(0, torch.minimum(cur_min[0::2], cur_min[1::2]))
        levels_max.insert(0, torch.maximum(cur_max[0::2], cur_max[1::2]))
    node_min = torch.cat(levels_min)
    node_max = torch.cat(levels_max)
    l = leaf_min.shape[0]
    if l > 1:
        c0 = torch.arange(1, 2 * l - 1, 2, device=leaf_min.device)
        child_boxes = torch.cat([node_min[c0], node_max[c0],
                                 node_min[c0 + 1], node_max[c0 + 1]], dim=-1)
    else:
        child_boxes = leaf_min.new_zeros((1, 12))
    return BVH(node_min=node_min, node_max=node_max, perm=perm,
               child_boxes=child_boxes)


def refit_bvh(bvh: BVH, prim_min: torch.Tensor,
              prim_max: torch.Tensor) -> BVH:
    """The same tree (``perm``) over new primitive boxes f32[N, 3], indexed
    by primitive id (the ``TLAS::updateTLAS`` refit analogue)."""
    ok = (bvh.perm >= 0)[..., None]
    pid = torch.clamp(bvh.perm, min=0).long()
    inf = float("inf")
    leaf_min = torch.where(ok, prim_min[pid], inf).amin(dim=1)
    leaf_max = torch.where(ok, prim_max[pid], -inf).amax(dim=1)
    return _fit_nodes(leaf_min, leaf_max, bvh.perm)


def pack_leaf_tris(bvh: BVH, tri_v0, tri_v1, tri_v2) -> torch.Tensor:
    """Triangle vertices in leaf order, f32[L, K*9] (one row a leaf)."""
    l, k = bvh.perm.shape
    pid = torch.clamp(bvh.perm, min=0).reshape(-1).long()
    tri9 = torch.cat([tri_v0, tri_v1, tri_v2], dim=-1)
    return tri9[pid].reshape(l, k * 9)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def ray_aabb(o, inv_d, t_max, box_min, box_max) -> torch.Tensor:
    """Slab test, broadcasting over leading dims -> hit mask. An empty box
    (min +inf, max -inf) never hits."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return ((tf >= torch.clamp(tn, min=0.0)) & (tn <= t_max)
            & (box_min[..., 0] <= box_max[..., 0]))


def moller_trumbore(o, d, v0, v1, v2, t_min: float = 1e-3):
    """Two-sided ray/triangle test -> (t, u, v, hit) (the reference builds
    its BLASes without face culling)."""
    return moller_trumbore_edges(o, d, v0, v1 - v0, v2 - v0, t_min=t_min)


@dataclasses.dataclass(frozen=True)
class HitRecord:
    t: torch.Tensor       # f32[R] — inf on a miss
    prim: torch.Tensor    # i32[R] — primitive id, -1 on a miss
    bary: torch.Tensor    # f32[R, 2] — (u, v)

    @property
    def hit(self) -> torch.Tensor:
        return self.prim >= 0

    def to(self, device) -> "HitRecord":
        return tree_to(self, device)


# The loop reads the host once a step: the read keeps only the rays still
# walking (so the leaf tests run on live rays only) and is the exit test.
# A finished ray changes nothing, so reading less often would move time,
# never bits; but a step over finished rays costs more than the read that
# drops them: config 3's 2.07 M primary rays at 1080p traced in 286 ms
# reading every step, 338 every 4th and 674 every 16th (an H100,
# chip_smoke.py's world_rt phase).

# ``bvh_trace``'s work: steps run and host reads made, summed over calls
STATS = {"steps": 0, "host_reads": 0}


def bvh_trace(bvh: BVH, tri_v0, tri_v1, tri_v2, ray_o, ray_d, t_max, *,
              t_min: float = 1e-3, any_hit: bool = False,
              active: Optional[torch.Tensor] = None,
              alpha_test=None) -> HitRecord:
    """Lockstep BVH traversal (vkCmdTraceRaysKHR + rayQueryEXT, reference
    raytrace.rchit:94-106, :189-204) of R rays against T triangles
    f32[T, 3] each. Every ray keeps a node stack and each step pops one
    node a ray: an internal node slab-tests both children and pushes the
    hits, the far one first (children ordered by entry distance, the first
    on a tie); a leaf runs Möller-Trumbore on its K triangles and keeps the
    first nearest one with ``t < best`` (``alpha_test(prims, u, v)`` may
    reject candidates: the any-hit cutout). ``any_hit`` ends a ray at its
    first accepted hit; ``active`` False rays are not traced. |d| is
    clamped at 1e-12 for the slab test, as in the JAX package.

    Each step is the JAX loop body on the rays still in the set; after it
    one host read keeps only the rays still walking and ends the loop when
    none is."""
    r = ray_o.shape[0]
    dev = ray_o.device
    l = bvh.num_leaves
    stack_size = 2 * bvh.depth + 2
    leaf_base = l - 1
    k = bvh.perm.shape[1]
    leaf_tris = pack_leaf_tris(bvh, tri_v0, tri_v1, tri_v2)
    perm = bvh.perm
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(r) if t_max.dim() == 0 else t_max
    inv_all = 1.0 / torch.where(ray_d.abs() < 1e-12, 1e-12, ray_d)

    out_t = t_max.clone()
    out_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    out_bary = torch.zeros((r, 2), dtype=torch.float32, device=dev)

    start = torch.ones(r, dtype=torch.bool, device=dev)
    if active is not None:
        start = start & active
    ids = torch.nonzero(start).squeeze(1)
    STATS["host_reads"] += 1
    n = ids.shape[0]
    o, d, inv_d = ray_o[ids], ray_d[ids], inv_all[ids]
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # the root preloaded
    stack = torch.zeros((n, stack_size), dtype=torch.int64, device=dev)
    best_t = t_max[ids]
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_bary = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    kk = torch.arange(k, device=dev)

    def push(sp, stack, nid, do):
        at = torch.clamp(sp, max=stack_size - 1)[:, None]
        keep = stack.gather(1, at)
        stack = stack.scatter(1, at, torch.where(
            (do & (sp < stack_size))[:, None], nid[:, None], keep))
        return torch.where(do, sp + 1, sp), stack

    while n:
        STATS["steps"] += 1
        live = sp > 0
        top = torch.clamp(sp - 1, min=0)
        node = torch.where(live, stack.gather(1, top[:, None])[:, 0], 0)
        sp = torch.where(live, sp - 1, sp)
        is_leaf = node >= leaf_base

        # internal node: test both children, push the hits (near last)
        c0, c1 = 2 * node + 1, 2 * node + 2
        boxes = bvh.child_boxes[torch.clamp(node, 0, max(leaf_base - 1, 0))]
        cmin = torch.stack([boxes[:, 0:3], boxes[:, 6:9]], dim=1)
        cmax = torch.stack([boxes[:, 3:6], boxes[:, 9:12]], dim=1)
        hit_c = ray_aabb(o[:, None, :], inv_d[:, None, :],
                         best_t[:, None], cmin, cmax)
        hit_c = hit_c & (~is_leaf & live)[:, None]
        tn = torch.minimum((cmin - o[:, None, :]) * inv_d[:, None, :],
                           (cmax - o[:, None, :]) * inv_d[:, None, :]
                           ).amax(dim=-1)
        first0 = tn[:, 0] <= tn[:, 1]
        far = torch.where(first0, c1, c0)
        near = torch.where(first0, c0, c1)
        far_hit = torch.where(first0, hit_c[:, 1], hit_c[:, 0])
        near_hit = torch.where(first0, hit_c[:, 0], hit_c[:, 1])
        sp, stack = push(sp, stack, far, far_hit)
        sp, stack = push(sp, stack, near, near_hit)

        # leaf: its K triangles
        leaf_idx = torch.clamp(node - leaf_base, 0, l - 1)
        prims = perm[leaf_idx]
        do_leaf = is_leaf & live
        tri = leaf_tris[leaf_idx].reshape(-1, k, 9)
        t, u, v, hit = moller_trumbore(
            o[:, None, :], d[:, None, :], tri[..., 0:3], tri[..., 3:6],
            tri[..., 6:9], t_min=t_min)
        cand = do_leaf[:, None] & hit & (prims >= 0) & (t < best_t[:, None])
        if alpha_test is not None:
            cand = cand & alpha_test(torch.clamp(prims, min=0), u, v)
        t_m = torch.where(cand, t, float("inf"))
        best_k = torch.argmin(t_m, dim=1)
        sel = (kk[None, :] == best_k[:, None])
        any_win = cand.any(dim=1)
        t_new = t_m.amin(dim=1)
        prim_new = torch.where(sel, prims, 0).sum(dim=1).to(torch.int32)
        u_new = torch.where(sel, u, 0.0).sum(dim=1)
        v_new = torch.where(sel, v, 0.0).sum(dim=1)
        best_t = torch.where(any_win, t_new, best_t)
        best_prim = torch.where(any_win, prim_new, best_prim)
        best_bary = torch.where(any_win[:, None],
                                torch.stack([u_new, v_new], dim=-1),
                                best_bary)
        if any_hit:
            sp = torch.where(any_win, 0, sp)
        out_t[ids] = best_t
        out_prim[ids] = best_prim
        out_bary[ids] = best_bary
        keep = torch.nonzero(sp > 0).squeeze(1)
        STATS["host_reads"] += 1
        n = keep.shape[0]
        if n < ids.shape[0]:
            ids, o, d, inv_d = ids[keep], o[keep], d[keep], inv_d[keep]
            sp, stack = sp[keep], stack[keep]
            best_t, best_prim, best_bary = (best_t[keep], best_prim[keep],
                                            best_bary[keep])
    miss = out_prim < 0
    return HitRecord(t=torch.where(miss, float("inf"), out_t), prim=out_prim,
                     bary=out_bary)
