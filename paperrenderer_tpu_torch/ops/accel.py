"""Two-level acceleration structure: per-model BLASes built once on the host,
a TLAS over the instances built every frame, and the traversal.

PyTorch counterpart of ``paperrenderer_tpu/ops/accel.py`` on its flat
(resident) layout. Both levels live in ONE node table ``f32[*, 12]`` (two
child boxes per row) with a parallel ``i32[*, 2]`` table of tagged child
codes:

    bit 30        object-space flag (the row's boxes are in BLAS space)
    bits 29..28   type: 0 = box row, 1 = BLAS leaf, 2 = instance
    bits 27..0    payload (row index / leaf row / instance row)

Popping an instance code reads that instance's inverse TRS (stored as a node
row), moves the ray into object space and pushes the BLAS root. The object-
space direction is not normalized, so ``t`` is shared by both spaces. A
BLAS leaf holds K = 8 triangles as (vertex a, edge b-a, edge c-a) plus uvs
in one 120-float row.

Row layout of a frame: [static BLAS rows | anim BLAS rows | instance rows |
TLAS 0 | TLAS 1 ...]; each TLAS has its own root code (``add_tlas``).

A unique-geometry instance (``ModelInstance(unique_geometry=True)``) gets a
BLAS of its own, an implicit complete tree (``_build_blas_host``) whose
rows a frame refits at the animated pose (``refit_anim_blases``, after an
optional re-split at that pose, ``resplit_anim_tables``); its "anim" rows
follow the static ones on both layouts.

Big scenes take the paged layout (``PagedScene``, ``assemble_scene_paged``;
``prefer_paged`` decides): the TLAS is cut into blocks of CHUNK = 256
instances, and a model over BL_THRESH leaf rows into BLAS chunks of at most
BL_LEAVES leaves (``_chunk_blas_host``). Paged codes carry a 27-bit payload
and bit 27, LOCAL_FLAG, which makes the payload a row of the current chunk
block; a TYPE_CHUNK code names a whole chunk. ``paged_to_flat`` turns a
PagedScene into the equivalent flat RTScene.

Not ported: ``assemble_scene_paged``'s ``order_override`` (its one caller
is a TPU profiling script, and the k-d order it fed was a measured loss).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.material import SHADE_LEAF
from ..core.scene import InstanceArrays
from ..core.transforms import quat_to_mat3, transform_aabb, trs_to_mat34
from .animation import f32_time
from .bvh import moller_trumbore_edges, morton_codes
from .shading import leaf_alpha
from .trace import SurfaceHits, occlusion_bits

K = 8                      # triangles per BLAS leaf
LEAF_ROW = K * 15          # 120: K*9 positions + K*6 uvs
_UV = K * 9                # 72: offset of the uvs in a leaf row

TYPE_BOX = 0
TYPE_LEAF = 1
TYPE_INST = 2
OBJ_FLAG = 1 << 30
_TYPE_SHIFT = 28
_PAYLOAD_MASK = (1 << 28) - 1

INST_ID_MASK = 0x007FFFFF    # self-id bits of the instance record word
INST_OPAQUE_BIT = 1 << 23    # force-opaque flag; bits 24-31: 8-bit mask

# paged layout
CHUNK = 256                  # instances per TLAS chunk
BROWS = 2 * CHUNK            # block rows: CH-1 box rows, CH instance rows, 1 pad
LOCAL_FLAG = 1 << 27         # code bit: the payload is a row of the current chunk
_PAYLOAD_MASK_P = (1 << 27) - 1   # paged payload (27 bits)
TYPE_CHUNK = 3

# BLAS chunking: a model over BL_THRESH leaf rows is cut into subtree chunks
# of at most BL_LEAVES leaves (paged layout only)
BL_LEAVES = 256              # leaf rows per BLAS chunk (2,048 triangles)
BL_THRESH = 512
BL_NROWS = 2 * BL_LEAVES     # node rows per BLAS chunk block
BCH_NODE = BL_NROWS * 12     # f32 per chunk node block
BCH_CODE = BL_NROWS * 2      # i32 per chunk code block
BCH_POS = BL_LEAVES * 72     # f32 per chunk leaf-position block
BCH_PRIM = BL_LEAVES * K     # i32 per chunk prim block
BCH_UV = BL_LEAVES * 48      # f32 per chunk uv block


def _code(typ: int, payload, obj: bool = False):
    return ((typ << _TYPE_SHIFT) | (OBJ_FLAG if obj else 0)) | payload


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1


# ---------------------------------------------------------------------------
# BLAS build (host numpy: models are immutable and registered rarely)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BLASBuild:
    """One BLAS's host-side build products (before the row-offset fixup)."""

    num_leaves: int
    leaf_rows: np.ndarray    # f32[L, 120] positions (a, e1, e2) + uvs
    leaf_prim: np.ndarray    # i32[L, K] tagged prim ids ((slot<<24)|tri, -1 pad)
    root_min: np.ndarray     # f32[3] the whole BLAS's box
    root_max: np.ndarray
    depth: int
    # explicit topology (the SAH builds)
    node_rows: np.ndarray = None    # f32[L-1, 12] child boxes
    child_kind: np.ndarray = None   # i8[L-1, 2] 0 = box child, 1 = leaf child
    child_idx: np.ndarray = None    # i32[L-1, 2] local child indices
    # implicit complete tree over L (a power of two) leaves, root first
    # (the unique-geometry builds, whose boxes are refit every frame)
    node_min: np.ndarray = None     # f32[2L-1, 3]
    node_max: np.ndarray = None


def _sah_leaf_arrays(leaves, vs, uvs, prim_tagged):
    """Pack per-leaf triangle id lists into the [L, K*...] leaf tables."""
    l = len(leaves)
    pos9 = np.zeros((l * K, 9), np.float32)
    uv6 = np.zeros((l * K, 6), np.float32)
    prim = np.full(l * K, -1, np.int32)
    for li, ids in enumerate(leaves):
        n = len(ids)
        s = li * K
        pos9[s:s + n] = vs[ids]
        uv6[s:s + n] = uvs[ids]
        prim[s:s + n] = prim_tagged[ids]
    rows = np.zeros((l, LEAF_ROW), np.float32)
    # leaf rows store (a, e1=b-a, e2=c-a): Möller-Trumbore takes the edges
    pos9[:, 3:6] -= pos9[:, 0:3]
    pos9[:, 6:9] -= pos9[:, 0:3]
    rows[:, :_UV] = pos9.reshape(l, K * 9)
    rows[:, _UV:] = uv6.reshape(l, K * 6)
    return rows, prim.reshape(l, K)


def _build_blas_host_sah(v0, v1, v2, uv0, uv1, uv2, prim_tagged, *,
                         bins: int = 16,
                         depth_cap: int = 48) -> _BLASBuild:
    """Top-down binned-SAH BLAS with explicit topology (the GPU driver's
    PREFER_FAST_TRACE quality, AccelerationStructure.cpp:218-271): at each
    node 16 centroid bins per axis, split minimizing SA(L)*N_L + SA(R)*N_R;
    a median-count split on degenerate extents and past ``depth_cap``.
    Leaves hold up to K triangles."""
    t = v0.shape[0]
    centroid = ((v0 + v1 + v2) / 3.0).astype(np.float32)
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    vs = np.concatenate([v0, v1, v2], axis=-1).astype(np.float32)
    uvs = np.concatenate([uv0, uv1, uv2], axis=-1).astype(np.float32)

    leaves: List[np.ndarray] = []
    nodes: List[list] = []       # [kind0, idx0, kind1, idx1] (preorder)
    node_box: List[tuple] = []   # (lo, hi) per node, same order
    max_depth = [1]

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def build(ids, depth):
        """-> (kind, idx); kind 1 = leaf, 0 = box node."""
        max_depth[0] = max(max_depth[0], depth)
        lo = tri_min[ids].min(axis=0)
        hi = tri_max[ids].max(axis=0)
        if len(ids) <= K:
            leaves.append(ids)
            return 1, len(leaves) - 1
        c = centroid[ids]
        split = None
        if depth < depth_cap:
            best_cost = np.inf
            for ax in range(3):
                cl, ch = c[:, ax].min(), c[:, ax].max()
                if ch <= cl:
                    continue
                b = np.minimum(
                    ((c[:, ax] - cl) * (bins / (ch - cl))).astype(np.int64),
                    bins - 1)
                cnt = np.bincount(b, minlength=bins)
                blo = np.full((bins, 3), np.inf, np.float32)
                bhi = np.full((bins, 3), -np.inf, np.float32)
                np.minimum.at(blo, b, tri_min[ids])
                np.maximum.at(bhi, b, tri_max[ids])
                plo = np.minimum.accumulate(blo, axis=0)
                phi = np.maximum.accumulate(bhi, axis=0)
                slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                pcnt = np.cumsum(cnt)
                for i in range(bins - 1):
                    nl = pcnt[i]
                    nr = len(ids) - nl
                    if nl == 0 or nr == 0:
                        continue
                    cost = (area(plo[i], phi[i]) * nl
                            + area(slo[i + 1], shi[i + 1]) * nr)
                    if cost < best_cost:
                        best_cost = cost
                        split = (ax, cl, ch, i)
        if split is not None:
            ax, cl, ch, i = split
            b = np.minimum(
                ((c[:, ax] - cl) * (bins / (ch - cl))).astype(np.int64),
                bins - 1)
            mask = b <= i
            left, right = ids[mask], ids[~mask]
        else:
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            half = len(ids) // 2
            part = np.argpartition(c[:, ax], half - 1)
            left, right = ids[part[:half]], ids[part[half:]]
        me = len(nodes)
        nodes.append(None)
        node_box.append((lo, hi))
        k0, i0 = build(left, depth + 1)
        k1, i1 = build(right, depth + 1)
        nodes[me] = [k0, i0, k1, i1]
        return 0, me

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, depth_cap * 4 + 10000))
    try:
        build(np.arange(t, dtype=np.int64), 1)
    finally:
        sys.setrecursionlimit(old_limit)

    rows, prim = _sah_leaf_arrays(leaves, vs, uvs, prim_tagged)
    l = len(leaves)
    nn = len(nodes)
    node_rows = np.zeros((nn, 12), np.float32)
    child_kind = np.zeros((nn, 2), np.int8)
    child_idx = np.zeros((nn, 2), np.int32)
    leaf_lo = np.zeros((l, 3), np.float32)
    leaf_hi = np.zeros((l, 3), np.float32)
    for li, ids in enumerate(leaves):
        leaf_lo[li] = tri_min[ids].min(axis=0)
        leaf_hi[li] = tri_max[ids].max(axis=0)
    for ni, (k0, i0, k1, i1) in enumerate(nodes):
        b0 = (leaf_lo[i0], leaf_hi[i0]) if k0 else node_box[i0]
        b1 = (leaf_lo[i1], leaf_hi[i1]) if k1 else node_box[i1]
        node_rows[ni] = np.concatenate([b0[0], b0[1], b1[0], b1[1]])
        child_kind[ni] = (k0, k1)
        child_idx[ni] = (i0, i1)
    root = node_box[0] if nn else (leaf_lo[0], leaf_hi[0])
    return _BLASBuild(
        num_leaves=l, leaf_rows=rows, leaf_prim=prim, root_min=root[0],
        root_max=root[1], depth=max_depth[0], node_rows=node_rows,
        child_kind=child_kind, child_idx=child_idx)


def _median_order(centroid: np.ndarray, slots: int) -> np.ndarray:
    """Leaf-slot permutation i64[slots] by recursive widest-axis median
    splits of the triangle centroids (-1 on dead slots). The implicit tree's
    topology is fixed, so its quality is set by the leaf order alone;
    partial populations left-pack, and a dead slot keeps an inf/-inf box."""
    t = centroid.shape[0]
    out = np.full(slots, -1, np.int64)
    stack = [(np.arange(t, dtype=np.int64), 0, slots)]
    while stack:
        ids, base, n = stack.pop()
        if len(ids) == 0:
            continue
        if n <= K:
            out[base:base + len(ids)] = ids
            continue
        half = n // 2
        k = min(half, len(ids))
        c = centroid[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        if k < len(ids):
            part = np.argpartition(c[:, ax], k - 1)
            left, right = ids[part[:k]], ids[part[k:]]
        else:
            left, right = ids, ids[:0]
        stack.append((right, base + half, n - half))
        stack.append((left, base, half))
    return out


def _build_blas_host(v0, v1, v2, uv0, uv1, uv2, prim_tagged) -> _BLASBuild:
    """Implicit BLAS: a complete binary tree over L = next_pow2(ceil(T/K))
    leaves in ``_median_order``'s slot order, the topology that a refit
    keeps (the unique-geometry builds). Dead slots hold zeros and prim -1."""
    t = v0.shape[0]
    centroid = (v0 + v1 + v2) / 3.0
    l = _next_pow2(-(-t // K))
    slots = l * K

    leaf_order = _median_order(centroid, slots)
    lo = np.full((slots, 3), np.inf, np.float32)
    hi = np.full((slots, 3), -np.inf, np.float32)
    rows = np.zeros((l, LEAF_ROW), np.float32)

    vs = np.concatenate([v0, v1, v2], axis=-1).astype(np.float32)     # [T, 9]
    uvs = np.concatenate([uv0, uv1, uv2], axis=-1).astype(np.float32)  # [T, 6]
    pos9 = np.zeros((slots, 9), np.float32)
    uv6 = np.zeros((slots, 6), np.float32)
    prim = np.full(slots, -1, np.int32)
    live = leaf_order >= 0        # dead slots interleave (left-packed runs)
    src = leaf_order[live]
    pos9[live] = vs[src]
    uv6[live] = uvs[src]
    prim[live] = prim_tagged[src]
    tri_min = np.minimum(np.minimum(pos9[:, 0:3], pos9[:, 3:6]), pos9[:, 6:9])
    tri_max = np.maximum(np.maximum(pos9[:, 0:3], pos9[:, 3:6]), pos9[:, 6:9])
    lo[live] = tri_min[live]
    hi[live] = tri_max[live]

    # leaf rows store (a, e1=b-a, e2=c-a); the boxes use the vertices
    pos9[:, 3:6] -= pos9[:, 0:3]
    pos9[:, 6:9] -= pos9[:, 0:3]
    rows[:, :_UV] = pos9.reshape(l, K * 9)
    rows[:, _UV:] = uv6.reshape(l, K * 6)

    levels_min = [lo.reshape(l, K, 3).min(axis=1)]
    levels_max = [hi.reshape(l, K, 3).max(axis=1)]
    while levels_min[0].shape[0] > 1:
        cur_min, cur_max = levels_min[0], levels_max[0]
        levels_min.insert(0, np.minimum(cur_min[0::2], cur_min[1::2]))
        levels_max.insert(0, np.maximum(cur_max[0::2], cur_max[1::2]))
    node_min = np.concatenate(levels_min, axis=0)
    node_max = np.concatenate(levels_max, axis=0)
    return _BLASBuild(
        num_leaves=l, leaf_rows=rows, leaf_prim=prim.reshape(l, K),
        root_min=node_min[0], root_max=node_max[0],
        depth=l.bit_length() - 1, node_min=node_min, node_max=node_max)


def _emit_blas_node_rows(b: _BLASBuild, node_off: int,
                         leaf_off: int) -> Tuple[np.ndarray, np.ndarray]:
    """Internal node rows (f32[L-1, 12] child boxes, i32[L-1, 2] child codes)
    with the codes at global row offsets. An implicit build's row i has
    children 2i+1 and 2i+2 (leaves from L-1 on) and keeps its inf/-inf
    boxes, as the refit writes them."""
    l = b.num_leaves
    if l <= 1:
        return np.zeros((0, 12), np.float32), np.zeros((0, 2), np.int32)
    if b.node_rows is not None:
        codes = np.where(
            b.child_kind == 1,
            _code(TYPE_LEAF, leaf_off + b.child_idx, obj=True),
            _code(TYPE_BOX, node_off + b.child_idx, obj=True),
        ).astype(np.int32)
        return b.node_rows, codes
    c0 = 2 * np.arange(l - 1) + 1
    c1 = c0 + 1
    rows = np.concatenate([b.node_min[c0], b.node_max[c0], b.node_min[c1],
                           b.node_max[c1]], axis=-1).astype(np.float32)

    def codes(c):
        return np.where(
            c < l - 1, _code(TYPE_BOX, node_off + c, obj=True),
            _code(TYPE_LEAF, leaf_off + np.maximum(c - (l - 1), 0), obj=True),
        ).astype(np.int32)

    return rows, np.stack([codes(c0), codes(c1)], axis=-1)


def _chunk_blas_host(b: _BLASBuild, first_chunk: int):
    """Cut one big BLAS into subtree chunks. Nodes over BL_LEAVES leaves stay
    static rows (the top tree); their children at or under BL_LEAVES leaves
    become chunks of local node rows (preorder, codes with LOCAL_FLAG) and
    leaf rows. Returns (top rows, top_codes(node_off), chunks): top codes
    are TYPE_BOX|obj at global offsets and TYPE_CHUNK|obj at cut children;
    ``first_chunk`` is the global index of this BLAS's first chunk."""
    nn = b.num_leaves - 1
    counts = np.zeros(nn, np.int64)
    order, stack = [], [(0, False)]
    while stack:                 # post-order: leaf counts bottom-up
        ni, seen = stack.pop()
        if seen:
            order.append(ni)
            continue
        stack.append((ni, True))
        for k in range(2):
            if b.child_kind[ni, k] == 0:
                stack.append((int(b.child_idx[ni, k]), False))
    for ni in order:
        counts[ni] = sum(1 if b.child_kind[ni, k] == 1
                         else counts[b.child_idx[ni, k]] for k in range(2))

    chunks = []

    def cut(kind, idx):
        """The subtree at (kind, idx) as one chunk -> its global index."""
        nodes, leaves = [], []

        def walk(kind, idx):
            if kind == 1:
                leaves.append(int(idx))
                return 1, len(leaves) - 1
            me = len(nodes)
            nodes.append(None)
            links = [walk(int(b.child_kind[idx, k]), int(b.child_idx[idx, k]))
                     for k in range(2)]
            nodes[me] = (int(idx), links)
            return 0, me

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(old + 4 * BL_LEAVES + 100)
        try:
            walk(kind, idx)
        finally:
            sys.setrecursionlimit(old)
        n_rows = np.zeros((BL_NROWS, 12), np.float32)
        n_codes = np.zeros((BL_NROWS, 2), np.int32)
        for li, (src, links) in enumerate(nodes):
            n_rows[li] = b.node_rows[src]
            for k, (ck, ci) in enumerate(links):
                n_codes[li, k] = _code(TYPE_LEAF if ck == 1 else TYPE_BOX, ci,
                                       obj=True) | LOCAL_FLAG
        lp = np.zeros((BL_LEAVES, LEAF_ROW), np.float32)
        pr = np.full((BL_LEAVES, K), -1, np.int32)
        lp[:len(leaves)] = b.leaf_rows[leaves]
        pr[:len(leaves)] = b.leaf_prim[leaves]
        if not nodes:
            # a single-leaf chunk: its local root must still be a box row;
            # child 0 takes every ray (the chunk's own box gated entry),
            # child 1 is dead (min > max)
            n_rows[0, 0:3], n_rows[0, 3:6] = -3.0e38, 3.0e38
            n_rows[0, 6:9], n_rows[0, 9:12] = 1.0, -1.0
            n_codes[0] = _code(TYPE_LEAF, 0, obj=True) | LOCAL_FLAG
        chunks.append(dict(nodes=n_rows, codes=n_codes, lpos=lp, lprim=pr))
        return first_chunk + len(chunks) - 1

    # the root stays in the top tree (root_code is its global box row)
    top_ids = [ni for ni in range(nn) if counts[ni] > BL_LEAVES] or [0]
    remap = {ni: i for i, ni in enumerate(sorted(top_ids))}
    t = len(remap)
    top_rows = np.zeros((t, 12), np.float32)
    top_kind = np.zeros((t, 2), np.int8)    # 0 = top box row, 2 = chunk
    top_link = np.zeros((t, 2), np.int32)
    for ni, i in remap.items():
        top_rows[i] = b.node_rows[ni]
        for k in range(2):
            ck, ci = int(b.child_kind[ni, k]), int(b.child_idx[ni, k])
            if ck == 0 and ci in remap:
                top_link[i, k] = remap[ci]
            else:
                top_kind[i, k] = 2
                top_link[i, k] = cut(ck, ci)

    def top_codes(node_off: int) -> np.ndarray:
        return np.where(top_kind == 0,
                        _code(TYPE_BOX, node_off + top_link, obj=True),
                        _code(TYPE_CHUNK, top_link, obj=True)).astype(np.int32)

    return top_rows, top_codes, chunks


@dataclasses.dataclass(frozen=True)
class BLASSet:
    """All models' BLASes packed on one device. Row offsets are baked into
    the child codes, so the tables concatenate directly into a frame's node
    table (BLAS rows first). A big model keeps only its top tree in
    ``nodes``; its chunks live in the flat ``bch_*`` blocks (paged layout
    only). The JAX package's ``leaf_nrm``/``bch_lnrm`` normal tables are
    left out: the port resolves normals from ``tri_attr``."""

    nodes: torch.Tensor      # f32[NB, 12] internal rows (child boxes)
    codes: torch.Tensor      # i32[NB, 2] child codes
    leaf_rows: torch.Tensor  # f32[LB, 120] positions + uvs
    leaf_prim: torch.Tensor  # i32[LB, K] tagged prim ids
    root_min: torch.Tensor   # f32[B, 3] object-space root AABBs
    root_max: torch.Tensor   # f32[B, 3]
    root_code: torch.Tensor  # i32[B]
    bch_nodes: torch.Tensor  # f32[NBC * BCH_NODE] BLAS-chunk node blocks
    bch_codes: torch.Tensor  # i32[NBC * BCH_CODE]
    bch_lpos: torch.Tensor   # f32[NBC * BCH_POS] leaf positions
    bch_lprim: torch.Tensor  # i32[NBC * BCH_PRIM]
    bch_luv: torch.Tensor    # f32[NBC * BCH_UV] leaf uvs


@dataclasses.dataclass
class AnimBLAS:
    """Rest-pose facts of one unique-geometry instance's BLAS, whose node and
    leaf rows are refit every frame (Model.cpp:398-404 and the example's
    BasicAnimation.comp with its BLAS rebuild, main.cpp:908-921)."""

    blas_id: int
    instance_index: int       # the instance's slot when the set was built
    node_off: int             # first row within the anim node rows
    node_count: int           # L-1
    leaf_off: int             # first row within the anim leaf rows
    num_leaves: int           # L, a power of two
    rest_rows: np.ndarray     # f32[L, 120] rest-pose leaf rows
    rest_prim: np.ndarray     # i32[L, K] tagged prim ids
    node_codes: np.ndarray    # i32[L-1, 2] child codes (global rows)
    phase: float = 0.0        # the instance's ``anim_phase``


@dataclasses.dataclass
class BLASSetMeta:
    """Host-side facts about a BLASSet (static across frames). The anim rows
    (the unique-geometry BLASes) follow the static rows in a frame's table:
    nodes [static | anim], leaves [static | anim]."""

    blas_of_model: np.ndarray   # i32[M] model id -> blas id
    max_depth: int              # over every build, the implicit ones too
    num_static_nodes: int
    num_static_leaves: int
    num_bchunks: int            # BLAS chunks (big models; paged layout only)
    anim: List[AnimBLAS]
    num_anim_nodes: int
    num_anim_leaves: int
    num_blas: int
    anim_node_codes: np.ndarray   # i32[NA, 2]
    anim_leaf_prim: np.ndarray    # i32[LA, K] (rest order)
    # the refit's index tables and the anim codes on each device
    device_tables: dict = dataclasses.field(default_factory=dict, repr=False,
                                            compare=False)

    @property
    def total_nodes(self) -> int:
        return self.num_static_nodes + self.num_anim_nodes


def build_blas_set(scene, device="cuda"):
    """One SAH BLAS per model over its LOD-0 triangles in object space
    (reference: queueBLAS at model creation, Model.cpp:59-74; geometry is
    always LOD 0, AccelerationStructure.cpp:335-377), and one implicit BLAS
    per unique-geometry instance (``_build_blas_host``), whose rows are
    refit every frame. A model over BL_THRESH leaf rows is cut into BLAS
    chunks (``_chunk_blas_host``). Returns (blasset, meta, anim_rest
    f32[LA, 120], anim_rest_nodes f32[NA, 12]): the anim rows at the rest
    pose, which a frame without animation uses as they are."""
    arena = scene.arena
    builds: List[_BLASBuild] = []
    blas_of_model = np.zeros(max(1, len(scene.models)), np.int32)

    def model_tris(model):
        parts = [[] for _ in range(7)]
        for mm in model.lods[0].meshes:
            h = mm.handle
            # tagged prim id = (slot << 24) | arena tri id in one i32
            if not (0 <= mm.material_slot < 128):
                raise ValueError(
                    f"material slot {mm.material_slot} out of the tagged-prim "
                    "range [0, 128)")
            if h.tri_offset + h.tri_count >= (1 << 24):
                raise ValueError("geometry arena exceeds 2^24 triangles — "
                                 "tagged prim ids cannot address it")
            idx = arena._idx[h.tri_offset:h.tri_offset + h.tri_count]
            tri_ids = np.arange(h.tri_offset, h.tri_offset + h.tri_count)
            for j in range(3):
                parts[j].append(arena._pos[idx[:, j]])
                parts[3 + j].append(arena._uv[idx[:, j]])
            parts[6].append((np.int32(mm.material_slot) << 24)
                            | tri_ids.astype(np.int32))
        return [np.concatenate(p, axis=0) for p in parts]

    for model in scene.models:
        blas_of_model[model.model_id] = len(builds)
        builds.append(_build_blas_host_sah(*model_tris(model)))
    num_models_blas = len(builds)
    # the unique-geometry instances keep the implicit tree the refit needs
    anim_instances = [i for i in scene.instances if i.unique_geometry]
    for inst in anim_instances:
        builds.append(_build_blas_host(*model_tris(inst.model)))

    chunked, bchunks = {}, []
    for bi in range(num_models_blas):
        if builds[bi].num_leaves > BL_THRESH:
            top_rows, top_codes, chunks = _chunk_blas_host(builds[bi],
                                                           len(bchunks))
            chunked[bi] = (top_rows, top_codes)
            bchunks.extend(chunks)

    node_rows = [np.zeros((0, 12), np.float32)]
    node_codes = [np.zeros((0, 2), np.int32)]
    leaf_rows = [np.zeros((0, LEAF_ROW), np.float32)]
    leaf_prims = [np.zeros((0, K), np.int32)]
    root_min = np.zeros((len(builds), 3), np.float32)
    root_max = np.zeros((len(builds), 3), np.float32)
    root_code = np.zeros(len(builds), np.int32)
    offs = []
    no = lo = static_no = static_lo = 0
    for bi, b in enumerate(builds):
        offs.append((no, lo))
        if bi in chunked:        # top rows only; the leaves are in chunks
            rows, codes = chunked[bi][0], chunked[bi][1](no)
        else:
            rows, codes = _emit_blas_node_rows(b, no, lo)
            leaf_rows.append(b.leaf_rows)
            leaf_prims.append(b.leaf_prim)
        node_rows.append(rows)
        node_codes.append(codes)
        root_min[bi] = np.where(np.isfinite(b.root_min), b.root_min, 0.0)
        root_max[bi] = np.where(np.isfinite(b.root_max), b.root_max, 0.0)
        root_code[bi] = (_code(TYPE_BOX, no, obj=True) if b.num_leaves > 1
                         else _code(TYPE_LEAF, lo, obj=True))
        no += rows.shape[0]
        lo += 0 if bi in chunked else b.num_leaves
        if bi < num_models_blas:
            static_no, static_lo = no, lo

    anim = []
    for ai, inst in enumerate(anim_instances):
        bi = num_models_blas + ai
        b = builds[bi]
        anim.append(AnimBLAS(
            blas_id=bi, instance_index=inst.index,
            node_off=offs[bi][0] - static_no,
            node_count=max(b.num_leaves - 1, 0),
            leaf_off=offs[bi][1] - static_lo, num_leaves=b.num_leaves,
            rest_rows=b.leaf_rows, rest_prim=b.leaf_prim,
            node_codes=node_codes[bi + 1],
            phase=float(getattr(inst, "anim_phase", 0.0))))

    def stack(key, shape, dtype):
        return (np.stack([c[key] for c in bchunks]) if bchunks
                else np.zeros((0,) + shape, dtype))

    all_nodes = np.concatenate(node_rows)
    all_codes = np.concatenate(node_codes)
    all_leaves = np.concatenate(leaf_rows)
    all_prims = np.concatenate(leaf_prims)
    bch_lp = stack("lpos", (BL_LEAVES, LEAF_ROW), np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    blasset = BLASSet(
        nodes=t(all_nodes[:static_no]), codes=t(all_codes[:static_no]),
        leaf_rows=t(all_leaves[:static_lo]),
        leaf_prim=t(all_prims[:static_lo]),
        root_min=t(root_min), root_max=t(root_max), root_code=t(root_code),
        bch_nodes=t(stack("nodes", (BL_NROWS, 12), np.float32).reshape(-1)),
        bch_codes=t(stack("codes", (BL_NROWS, 2), np.int32).reshape(-1)),
        bch_lpos=t(bch_lp[:, :, :_UV].reshape(-1)),
        bch_lprim=t(stack("lprim", (BL_LEAVES, K), np.int32).reshape(-1)),
        bch_luv=t(bch_lp[:, :, _UV:].reshape(-1)))
    meta = BLASSetMeta(
        blas_of_model=blas_of_model,
        max_depth=max((b.depth for b in builds), default=0),
        num_static_nodes=static_no, num_static_leaves=static_lo,
        num_bchunks=len(bchunks), anim=anim,
        num_anim_nodes=no - static_no, num_anim_leaves=lo - static_lo,
        num_blas=len(builds), anim_node_codes=all_codes[static_no:],
        anim_leaf_prim=all_prims[static_lo:])
    return (blasset, meta, t(all_leaves[static_lo:]),
            t(all_nodes[static_no:]))


def build_tri_attr(scene, device="cuda") -> torch.Tensor:
    """Arena-wide object-space attribute rows f32[Ta, 16]: [n0 n1 n2 (9) |
    uv0 uv1 uv2 (6) | material slot (1)], one row read per resolved hit
    (the hitcommon.glsl getHitInfo analogue)."""
    arena = scene.arena
    idx = arena._idx
    ta = idx.shape[0]
    out = np.zeros((ta, 16), np.float32)
    out[:, 0:9] = arena._nrm[idx].reshape(ta, 9)
    out[:, 9:15] = arena._uv[idx].reshape(ta, 6)
    for model in scene.models:
        for lod in model.lods:
            for mm in lod.meshes:
                h = mm.handle
                out[h.tri_offset:h.tri_offset + h.tri_count, 15] = mm.material_slot
    return torch.from_numpy(out).to(device)


def required_stack_size(meta: BLASSetMeta, capacity: int) -> int:
    """Traversal stack bound: one pending far child per level of each tree +
    one instance entry + slack (+ one for a BLAS chunk's local root),
    rounded up to a multiple of 8."""
    d1 = max(1, _next_pow2(capacity).bit_length() - 1)
    bch = 1 if meta.num_bchunks else 0
    return -(-(d1 + meta.max_depth + 8 + bch) // 8) * 8


# ---------------------------------------------------------------------------
# Per frame: the unique-geometry BLASes' refit and re-split (device tensors)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _AnimGroup:
    """Anim BLASes of one leaf count L, refit as one [A, L, ...] batch."""

    ids: torch.Tensor           # i64[A] indices into meta.anim
    num_leaves: int
    leaf_rows: torch.Tensor     # i64[A, L] rows of the anim leaf region
    node_rows: torch.Tensor     # i64[A, L-1] rows of the anim node region
    phase: torch.Tensor         # f32[A] the instances' anim_phase
    rest_ok: torch.Tensor       # bool[A, L, K, 1] live rest-pose slots


def _anim_groups(meta: BLASSetMeta, device, batched: bool = True):
    """The anim BLASes grouped by leaf count (``batched``) or one a group,
    their index tables uploaded once per meta and device (kept on the
    meta): a host-to-device copy synchronizes the stream, and the tables
    are the same every frame."""
    key = (str(device), batched)
    if key in meta.device_tables:
        return meta.device_tables[key]
    by_l = {}
    for i, a in enumerate(meta.anim):
        by_l.setdefault(a.num_leaves if batched else (i,), []).append(i)
    groups = []
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    for ids in by_l.values():
        anims = [meta.anim[i] for i in ids]
        nl = anims[0].num_leaves
        groups.append(_AnimGroup(
            ids=t(np.asarray(ids, np.int64)), num_leaves=nl,
            leaf_rows=t(np.stack([a.leaf_off + np.arange(nl, dtype=np.int64)
                                  for a in anims])),
            node_rows=t(np.stack([a.node_off
                                  + np.arange(nl - 1, dtype=np.int64)
                                  for a in anims])),
            phase=t(np.asarray([a.phase for a in anims], np.float32)),
            rest_ok=t(np.stack([a.rest_prim >= 0 for a in anims])[..., None])))
    meta.device_tables[key] = groups
    return groups


def _anim_codes_prim(meta: BLASSetMeta, device):
    """(anim child codes i32[NA, 2], rest-order anim prim ids i32[LA, K]) on
    ``device``, uploaded once per meta and device."""
    key = (str(device), "codes")
    if key not in meta.device_tables:
        meta.device_tables[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (meta.anim_node_codes, meta.anim_leaf_prim))
    return meta.device_tables[key]


def _anim_verts(rows: torch.Tensor) -> torch.Tensor:
    """Leaf positions (a, e1, e2) f32[..., 72] -> vertices f32[..., K, 9]."""
    p = rows[..., :_UV].reshape(rows.shape[:-1] + (K, 9))
    a0 = p[..., 0:3]
    return torch.cat([a0, a0 + p[..., 3:6], a0 + p[..., 6:9]], dim=-1)


def _animate_group(animate, verts: torch.Tensor, times: torch.Tensor):
    """``animate(v f32[M, 3], t f32[])`` over a group's vertices f32[A, ...,
    9] at its times f32[A], mapped over the A BLASes with ``torch.vmap``:
    one batched call with the JAX package's per-instance contract."""
    a = verts.shape[0]
    pos = torch.vmap(animate)(verts.reshape(a, -1, 3), times)
    return pos.reshape(verts.shape)


def refit_anim_blases(meta: BLASSetMeta, anim_rest: torch.Tensor, time,
                      animate, anim_prim: Optional[torch.Tensor] = None, *,
                      batched: bool = True):
    """Animate the unique-geometry vertices and refit their BLAS rows.

    Returns (anim node rows f32[NA, 12], anim leaf rows f32[LA, 120], root
    boxes f32[A, 3] twice, in ``meta.anim`` order). The leaf order (and so
    the implicit tree) stays the rest pose's, or ``anim_prim``'s when a
    re-split permuted it (``resplit_anim_tables``; its prim ids then give
    the live slots). ``animate(v f32[M, 3], t f32[])`` moves one BLAS's
    vertices at its instance's time + phase (in f32), as in the JAX
    package; it is mapped with ``torch.vmap``. ``batched`` refits the
    BLASes of one leaf count together: every op is elementwise or an exact
    min/max, so the bits equal one BLAS at a time (``batched=False``)."""
    dev = anim_rest.device
    na, la, a_n = meta.num_anim_nodes, meta.num_anim_leaves, len(meta.anim)
    nodes = torch.zeros((na, 12), device=dev)
    leaves = torch.zeros((la, LEAF_ROW), device=dev)
    r_lo = torch.zeros((a_n, 3), device=dev)
    r_hi = torch.zeros((a_n, 3), device=dev)
    t = f32_time(time)
    inf = float("inf")
    for g in _anim_groups(meta, dev, batched):
        a, nl = g.ids.shape[0], g.num_leaves
        rows = anim_rest[g.leaf_rows]                          # [A, L, 120]
        pos9 = _animate_group(animate, _anim_verts(rows), t + g.phase)
        edges9 = torch.cat([pos9[..., 0:3], pos9[..., 3:6] - pos9[..., 0:3],
                            pos9[..., 6:9] - pos9[..., 0:3]], dim=-1)
        leaves[g.leaf_rows.reshape(-1)] = torch.cat(
            [edges9.reshape(a, nl, _UV), rows[..., _UV:]],
            dim=-1).reshape(-1, LEAF_ROW)
        ok = (g.rest_ok if anim_prim is None
              else (anim_prim[g.leaf_rows] >= 0)[..., None])    # [A, L, K, 1]
        tri_min = torch.minimum(torch.minimum(pos9[..., 0:3], pos9[..., 3:6]),
                                pos9[..., 6:9])
        tri_max = torch.maximum(torch.maximum(pos9[..., 0:3], pos9[..., 3:6]),
                                pos9[..., 6:9])
        leaf_min = torch.where(ok, tri_min, inf).amin(dim=2)   # [A, L, 3]
        leaf_max = torch.where(ok, tri_max, -inf).amax(dim=2)
        node_min, node_max = _implicit_levels(leaf_min, leaf_max)
        r_lo[g.ids] = torch.where(torch.isfinite(node_min[:, 0]),
                                  node_min[:, 0], 0.0)
        r_hi[g.ids] = torch.where(torch.isfinite(node_max[:, 0]),
                                  node_max[:, 0], 0.0)
        if nl > 1:
            c0 = torch.arange(1, 2 * nl - 1, 2, device=dev)
            c1 = c0 + 1
            nodes[g.node_rows.reshape(-1)] = torch.cat(
                [node_min[:, c0], node_max[:, c0], node_min[:, c1],
                 node_max[:, c1]], dim=-1).reshape(-1, 12)
    return nodes, leaves, r_lo, r_hi


def _median_perm(cen: torch.Tensor, valid: torch.Tensor,
                 stop_seg: int = 1) -> torch.Tensor:
    """Slot permutation i64[..., L] by recursive widest-axis median splits
    of centroids f32[..., L, 3] (L a power of two; leading axes batch):
    level l sorts each of its 2^l nested segments along the segment's
    widest centroid axis, ``_median_order``'s recursion as segmented sorts.
    Invalid slots sink to their segment's right. The sort is stable, as
    ``jnp.argsort`` is: tied keys (pads, a grid's shared coordinates) keep
    their order. ``stop_seg`` ends the recursion early, as the JAX
    package's level count does."""
    n = cen.shape[-2]
    assert n & (n - 1) == 0, "slot count must be a power of two"
    lead = cen.shape[:-2]
    inf = float("inf")
    perm = torch.arange(n, device=cen.device).expand(lead + (n,))
    levels = max(n // max(stop_seg, 1) - 1, 1).bit_length() - 1
    for lvl in range(levels):
        seg = n >> lvl
        c = torch.take_along_dim(cen, perm[..., None], dim=-2).reshape(
            lead + (-1, seg, 3))
        v = torch.take_along_dim(valid, perm, dim=-1).reshape(
            lead + (-1, seg))
        lo = torch.where(v[..., None], c, inf).amin(dim=-2)
        hi = torch.where(v[..., None], c, -inf).amax(dim=-2)
        ext = hi - lo
        ext = torch.where(torch.isfinite(ext), ext, 0.0)
        ax = torch.argmax(ext, dim=-1)                        # [..., S]
        key = torch.take_along_dim(c, ax[..., None, None], dim=-1)[..., 0]
        key = torch.where(v, key, inf)                        # pads sink right
        order = torch.argsort(key, dim=-1, stable=True)       # [..., S, seg]
        perm = torch.take_along_dim(perm.reshape(lead + (-1, seg)), order,
                                    dim=-1).reshape(lead + (n,))
    return perm


def resplit_anim_tables(meta: BLASSetMeta, anim_rest: torch.Tensor, time,
                        animate, *, batched: bool = True):
    """Re-split the anim BLASes' leaves at the animated pose -> (anim_rest
    f32[LA, 120], anim_prim i32[LA, K]), both permuted, row-aligned.

    A refit keeps the rest pose's leaf order, so its boxes fatten under a
    large deformation; the reference rebuilds the BLAS every frame instead
    (main.cpp:908-921). This regroups each BLAS's triangles by recursive
    median splits of their animated centroids (``_median_perm``, down to
    leaves of K) and hands the permuted rest tables to
    ``refit_anim_blases(anim_prim=)``. The prim ids travel with their
    triangles, so a hit's ``tri_attr`` row (normals, uvs, slot) is the
    same. The JAX package's permuted normal table is left out: the port
    resolves normals from ``tri_attr``. ``batched`` as in the refit."""
    dev = anim_rest.device
    prim = _anim_codes_prim(meta, dev)[1]
    t = f32_time(time)
    rest = torch.empty_like(anim_rest)
    out_prim = torch.empty_like(prim)
    for g in _anim_groups(meta, dev, batched):
        a, nl = g.ids.shape[0], g.num_leaves
        rows = anim_rest[g.leaf_rows]                          # [A, L, 120]
        pos = rows[..., :_UV].reshape(a, nl * K, 9)            # rest (a, e1, e2)
        uv = rows[..., _UV:].reshape(a, nl * K, 6)
        pr = prim[g.leaf_rows].reshape(a, nl * K)
        pos9 = _animate_group(animate, _anim_verts(rows),
                              t + g.phase).reshape(a, nl * K, 9)
        cen = (pos9[..., 0:3] + pos9[..., 3:6] + pos9[..., 6:9]) / 3.0
        order = _median_perm(cen, pr >= 0, stop_seg=K)         # [A, L*K]
        rest[g.leaf_rows.reshape(-1)] = torch.cat(
            [torch.take_along_dim(pos, order[..., None], dim=1).reshape(
                a, nl, _UV),
             torch.take_along_dim(uv, order[..., None], dim=1).reshape(
                 a, nl, LEAF_ROW - _UV)], dim=-1).reshape(-1, LEAF_ROW)
        out_prim[g.leaf_rows.reshape(-1)] = torch.take_along_dim(
            pr, order, dim=1).reshape(-1, K)
    return rest, out_prim


# ---------------------------------------------------------------------------
# Per frame: TLAS build + node table assembly (device tensors)
# ---------------------------------------------------------------------------

def build_tlas_rows(
    instances: InstanceArrays,
    inst_blas: torch.Tensor,   # i32[N] blas id per instance slot
    root_min: torch.Tensor,    # f32[B, 3] per-blas object root AABBs
    root_max: torch.Tensor,
    mask: torch.Tensor,        # bool[N] membership in this TLAS
    *,
    node_offset: int,          # global row offset of this TLAS's rows
    inst_offset: int,          # global row offset of the instance rows
):
    """TLAS over instance world AABBs -> (node rows f32[Lt-1, 12], child
    codes i32[Lt-1, 2]). The TLASInstBuild.comp +
    TOP_LEVEL build analogue: O(N) matrix/AABB math and one morton sort.
    Leaves are single instances; a leaf pop goes straight to the instance
    switch."""
    n = instances.capacity
    l = _next_pow2(n)
    dev = instances.pos.device
    perm, leaf_min, leaf_max = _instance_leaves(
        instances, inst_blas, root_min, root_max, mask, l)
    node_min, node_max = _implicit_levels(leaf_min, leaf_max)
    c0 = torch.arange(1, 2 * l - 1, 2, device=dev)
    c1 = c0 + 1

    def codes_of(c):
        leaf_k = torch.clamp(c - (l - 1), min=0)
        inst = torch.clamp(perm[leaf_k], min=0) + inst_offset
        return torch.where(c < l - 1, _code(TYPE_BOX, 0) + node_offset + c,
                           _code(TYPE_INST, 0) + inst).to(torch.int32)

    rows = _child_rows(node_min[..., c0, :], node_max[..., c0, :],
                       node_min[..., c1, :], node_max[..., c1, :])
    return rows, torch.stack([codes_of(c0), codes_of(c1)], dim=-1)


def _instance_leaves(instances: InstanceArrays, inst_blas, root_min,
                     root_max, mask, l: int):
    """The TLAS leaves in morton order (stable; dead instances last):
    (perm i64[l] instance slot per leaf or -1, leaf_min/leaf_max f32[l, 3]
    world AABBs, inf/-inf on dead leaves)."""
    n = instances.capacity
    dev = instances.pos.device
    inf = float("inf")
    alive = instances.alive & mask
    mats = trs_to_mat34(instances.pos, instances.scale, instances.quat)
    bid = torch.clamp(inst_blas, 0, root_min.shape[0] - 1).long()
    wlo, whi = transform_aabb(mats, root_min[bid], root_max[bid])

    blo = torch.where(alive[:, None], wlo, inf)
    bhi = torch.where(alive[:, None], whi, -inf)
    centroid = torch.where(alive[:, None], (wlo + whi) * 0.5, 0.0)
    codes = morton_codes(centroid, blo.amin(dim=0), bhi.amax(dim=0))
    codes = torch.where(alive, codes, 0xFFFFFFFF)
    order = torch.argsort(codes, stable=True)

    perm = torch.full((l,), -1, dtype=torch.int64, device=dev)
    perm[:n] = torch.where(alive[order], order, -1)
    leaf_min = torch.full((l, 3), inf, device=dev)
    leaf_max = torch.full((l, 3), -inf, device=dev)
    leaf_min[:n] = blo[order]
    leaf_max[:n] = bhi[order]
    return perm, leaf_min, leaf_max


def _implicit_levels(leaf_min, leaf_max):
    """Boxes of the implicit complete binary tree over the leaves of axis
    -2 (a power of two), root first: f32[..., 2L-1, 3] twice."""
    levels_min, levels_max = [leaf_min], [leaf_max]
    while levels_min[0].shape[-2] > 1:
        cm, cx = levels_min[0], levels_max[0]
        levels_min.insert(0, torch.minimum(cm[..., 0::2, :], cm[..., 1::2, :]))
        levels_max.insert(0, torch.maximum(cx[..., 0::2, :], cx[..., 1::2, :]))
    return torch.cat(levels_min, dim=-2), torch.cat(levels_max, dim=-2)


def _child_rows(min0, max0, min1, max1):
    """Node rows [min0 max0 min1 max1] f32[..., 12]. An empty child (min >
    max) gets min 1e30 and max -1e30 on that axis, which the slab test
    rejects explicitly."""
    rows = torch.cat([torch.nan_to_num(min0, posinf=1e30),
                      torch.nan_to_num(max0, neginf=-1e30),
                      torch.nan_to_num(min1, posinf=1e30),
                      torch.nan_to_num(max1, neginf=-1e30)], dim=-1)
    for lo_col in (0, 6):
        box_lo = rows[..., lo_col:lo_col + 3]
        box_hi = rows[..., lo_col + 3:lo_col + 6]
        dead = box_hi < box_lo
        rows[..., lo_col:lo_col + 3] = torch.where(dead, 1e30, box_lo)
        rows[..., lo_col + 3:lo_col + 6] = torch.where(dead, -1e30, box_hi)
    return rows


def make_instance_rows(
    instances: InstanceArrays,
    inst_blas: torch.Tensor,     # i32[N]
    root_code: torch.Tensor,     # i32[B]
    inst_mask: Optional[torch.Tensor] = None,    # i32[N] 8-bit, default 0xFF
    inst_opaque: Optional[torch.Tensor] = None,  # bool[N] force-opaque
):
    """Instance rows: (inverse 3x4 f32[N, 12], codes i32[N, 2] = [BLAS root
    code, instance record word]). The record word packs [mask:8 |
    force_opaque:1 | self id:23], the reference's
    ``AccelerationStructureInstanceData`` (RayTrace.h:19-35): traversal skips
    an instance whose ``mask & cull_mask == 0``."""
    rot = quat_to_mat3(instances.quat)
    scale = instances.scale
    # M = T R S  ->  M^-1 = S^-1 R^T T^-1
    inv_s = 1.0 / torch.clamp(scale.abs(), min=1e-12) * torch.sign(
        torch.where(scale == 0.0, 1.0, scale))
    a_inv = rot.transpose(-1, -2) * inv_s[:, :, None]
    pos = instances.pos
    t_inv = -(a_inv[:, :, 0] * pos[:, None, 0] + a_inv[:, :, 1] * pos[:, None, 1]
              + a_inv[:, :, 2] * pos[:, None, 2])
    n = pos.shape[0]
    if n > INST_ID_MASK + 1:
        raise ValueError("instance capacity exceeds the 23-bit instance id")
    inv12 = torch.cat([a_inv, t_inv[:, :, None]], dim=-1).reshape(n, 12)
    dev = pos.device
    rec = torch.arange(n, dtype=torch.int64, device=dev)
    m8 = (torch.full((n,), 0xFF, dtype=torch.int64, device=dev)
          if inst_mask is None else inst_mask.to(torch.int64) & 0xFF)
    rec = rec | (m8 << 24)
    if inst_opaque is not None:
        rec = rec | torch.where(inst_opaque, INST_OPAQUE_BIT, 0)
    rec = torch.where(rec >= 1 << 31, rec - (1 << 32), rec).to(torch.int32)
    bid = torch.clamp(inst_blas, 0, root_code.shape[0] - 1).long()
    return inv12, torch.stack([root_code[bid], rec], dim=-1)


@dataclasses.dataclass(frozen=True)
class RTScene:
    """One frame's traversal scene (all tensors on one device)."""

    nodes: torch.Tensor      # f32[*, 12]: [blas | anim | instance | tlas...]
    codes: torch.Tensor      # i32[*, 2]: child codes / [root, record] per row
    leaf_rows: torch.Tensor  # f32[*, 120]: [static | anim] positions + uvs
    leaf_prim: torch.Tensor  # i32[*, K]: tagged prim ids per leaf
    inv_rows: torch.Tensor   # f32[N, 12] inverse matrices (world normal =
    #                          (M^-1)^T n_obj, hitcommon.glsl:128)
    tri_attr: torch.Tensor   # f32[Ta, 16] obj normals(9) + uv(6) + slot(1)


def _anim_frame_rows(blasset: BLASSet, meta: BLASSetMeta, anim_rest,
                     anim_rest_nodes, time, animate, resplit: bool):
    """This frame's anim rows -> (anim nodes f32[NA, 12], anim codes
    i32[NA, 2], anim leaves f32[LA, 120], anim prims i32[LA, K], root_min,
    root_max f32[B, 3]): refit (after a re-split with ``resplit``) when the
    scene has anim BLASes and ``animate`` and ``time`` are given, else the
    rest pose. The anim BLASes' roots take their refit boxes."""
    dev = anim_rest.device
    codes, prim = _anim_codes_prim(meta, dev)
    if not (meta.anim and animate is not None and time is not None):
        return (anim_rest_nodes, codes, anim_rest, prim, blasset.root_min,
                blasset.root_max)
    if resplit:
        anim_rest, prim = resplit_anim_tables(meta, anim_rest, time, animate)
    nodes, leaves, a_lo, a_hi = refit_anim_blases(
        meta, anim_rest, time, animate, anim_prim=prim if resplit else None)
    ns = meta.num_blas - len(meta.anim)
    return (nodes, codes, leaves, prim,
            torch.cat([blasset.root_min[:ns], a_lo]),
            torch.cat([blasset.root_max[:ns], a_hi]))


def assemble_scene(
    blasset: BLASSet,
    meta: BLASSetMeta,
    anim_rest: torch.Tensor,         # f32[LA, 120] rest-pose anim leaf rows
    anim_rest_nodes: torch.Tensor,   # f32[NA, 12] rest-pose anim node rows
    instances: InstanceArrays,
    inst_blas: torch.Tensor,
    tlas_masks: Sequence[torch.Tensor],
    tri_attr: torch.Tensor,
    *,
    time=None,
    animate=None,
    inst_mask: Optional[torch.Tensor] = None,
    inst_opaque: Optional[torch.Tensor] = None,
    resplit: bool = False,
) -> Tuple[RTScene, List[int]]:
    """This frame's node table: [static BLAS | anim BLAS | instance rows |
    TLAS 0 | TLAS 1 ...]. Returns (scene, [root code per TLAS]). With
    ``animate`` and ``time`` the anim BLASes are refit at the animated pose
    (``resplit``: re-split first, the reference's per-frame rebuild
    quality), and the TLAS is built over their refit roots."""
    if meta.num_bchunks:
        raise ValueError("the scene has chunked big-model BLASes, which only "
                         "the paged layout holds: use assemble_scene_paged "
                         "(prefer_paged routes such scenes there)")
    anim_nodes, anim_codes, anim_leaves, anim_prim, root_min, root_max = (
        _anim_frame_rows(blasset, meta, anim_rest, anim_rest_nodes, time,
                         animate, resplit))
    n = instances.capacity
    inst_off = meta.num_static_nodes + meta.num_anim_nodes
    tlas_off = inst_off + n
    tlas_rows, tlas_codes, root_codes = [], [], []
    for mask in tlas_masks:
        rows, codes = build_tlas_rows(
            instances, inst_blas, root_min, root_max, mask,
            node_offset=tlas_off, inst_offset=inst_off)
        tlas_rows.append(rows)
        tlas_codes.append(codes)
        root_codes.append(_code(TYPE_BOX, tlas_off))
        tlas_off += rows.shape[0]
    inst_rows, inst_codes = make_instance_rows(
        instances, inst_blas, blasset.root_code, inst_mask=inst_mask,
        inst_opaque=inst_opaque)
    scene = RTScene(
        nodes=torch.cat([blasset.nodes, anim_nodes, inst_rows] + tlas_rows),
        codes=torch.cat([blasset.codes, anim_codes, inst_codes] + tlas_codes),
        leaf_rows=torch.cat([blasset.leaf_rows, anim_leaves]),
        leaf_prim=torch.cat([blasset.leaf_prim, anim_prim]),
        inv_rows=inst_rows, tri_attr=tri_attr)
    return scene, root_codes


# ---------------------------------------------------------------------------
# Paged layout: the TLAS in chunk blocks of CHUNK instances
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedScene:
    """One frame's chunked-TLAS traversal scene (all tensors on one device).

    Static rows: the BLAS rows and the root BVH over the chunks' boxes.
    Each TLAS chunk is a block of BROWS rows, [CH-1 box rows | CH instance
    rows (inverse matrix; codes [BLAS root, instance record]) | 1 pad], with
    the chunk's slot -> material table in ``chunk_smat``. Big models' BLAS
    chunks come from the BLASSet. The JAX package's ``leaf_nrm``,
    ``bch_lnrm`` and ``fwd_rows`` are left out: the port resolves normals
    from ``tri_attr`` and the inverse rows."""

    static_nodes: torch.Tensor   # f32[Ns, 12]: [static BLAS | root BVH]
    static_codes: torch.Tensor   # i32[Ns, 2]
    chunk_boxes: torch.Tensor    # f32[NC * BROWS * 12] chunk blocks
    chunk_codes: torch.Tensor    # i32[NC * BROWS * 2]
    chunk_smat: torch.Tensor     # i32[NC * smat_block(S)]
    leaf_rows: torch.Tensor      # f32[L, 120] static BLAS leaves
    leaf_prim: torch.Tensor      # i32[L, K]
    inv_rows: torch.Tensor       # f32[N, 12] inverse matrices by slot
    tri_attr: torch.Tensor       # f32[Ta, 16]
    bch_nodes: torch.Tensor      # f32[NBC * BCH_NODE] BLAS-chunk blocks
    bch_codes: torch.Tensor      # i32[NBC * BCH_CODE]
    bch_lpos: torch.Tensor       # f32[NBC * BCH_POS]
    bch_lprim: torch.Tensor      # i32[NBC * BCH_PRIM]
    bch_luv: torch.Tensor        # f32[NBC * BCH_UV]


def smat_block(n_slots: int) -> int:
    """Per-chunk slot-material block length (a multiple of 1024)."""
    return -(-CHUNK * n_slots // 1024) * 1024


def _chunk_local_codes() -> np.ndarray:
    """The chunk-interior child codes i32[CH-1, 2]: an implicit binary tree
    over CH instance leaves, payloads rows of the chunk block (leaf k is
    block row CH-1+k)."""
    ch = CHUNK
    c0 = 2 * np.arange(ch - 1) + 1

    def code(c):
        return np.where(c < ch - 1, _code(TYPE_BOX, 0) | LOCAL_FLAG | c,
                        _code(TYPE_INST, 0) | LOCAL_FLAG | c).astype(np.int32)

    return np.stack([code(c0), code(c0 + 1)], axis=-1)


def _root_codes(nc_pad: int, root_off: int) -> np.ndarray:
    """Child codes i32[NCP-1, 2] of the implicit root BVH over ``nc_pad``
    chunks: box rows from ``root_off`` on, TYPE_CHUNK codes at the leaves."""
    c = np.arange(1, 2 * nc_pad - 1, 2)

    def code(c):
        return np.where(c < nc_pad - 1, _code(TYPE_BOX, 0) + root_off + c,
                        _code(TYPE_CHUNK, 0)
                        + np.maximum(c - (nc_pad - 1), 0)).astype(np.int32)

    return np.stack([code(c), code(c + 1)], axis=-1)


@functools.lru_cache(maxsize=32)
def _device_codes(name: str, device: str, *args) -> torch.Tensor:
    """A static code table on ``device``, uploaded once: a host-to-device
    copy of pageable memory synchronizes the stream, and these tables are
    the same every frame."""
    table = {"local": _chunk_local_codes, "root": _root_codes}[name](*args)
    return torch.from_numpy(table).to(device)


def assemble_scene_paged(
    blasset: BLASSet,
    meta: BLASSetMeta,
    anim_rest: torch.Tensor,        # f32[LA, 120] rest-pose anim leaf rows
    anim_rest_nodes: torch.Tensor,  # f32[NA, 12] rest-pose anim node rows
    instances: InstanceArrays,
    inst_blas: torch.Tensor,
    mask: torch.Tensor,             # bool[N] membership in the one TLAS
    slot_materials: torch.Tensor,   # i32[N, S]
    tri_attr: torch.Tensor,
    *,
    time=None,
    animate=None,
    inst_mask: Optional[torch.Tensor] = None,
    inst_opaque: Optional[torch.Tensor] = None,
    resplit: bool = False,
) -> Tuple[PagedScene, int]:
    """This frame's chunked-TLAS scene -> (scene, root code). The
    instances' morton order (``build_tlas_rows``') fills the chunks in
    turn; each chunk gets an implicit BVH over its CH leaves, and the root
    BVH over the chunks' boxes ends in TYPE_CHUNK codes. The anim BLASes
    are refit as in ``assemble_scene``; their rows are static rows
    ([static BLAS | anim BLAS | root BVH]) and their leaves follow the
    static leaves."""
    anim_nodes, anim_codes, anim_leaves, anim_prim, root_min, root_max = (
        _anim_frame_rows(blasset, meta, anim_rest, anim_rest_nodes, time,
                         animate, resplit))
    n = instances.capacity
    ch = CHUNK
    l = max(_next_pow2(n), ch)
    nc = l // ch
    nc_pad = _next_pow2(nc)
    dev = instances.pos.device
    inf = float("inf")
    root_off = meta.num_static_nodes + meta.num_anim_nodes

    perm, leaf_min, leaf_max = _instance_leaves(
        instances, inst_blas, root_min, root_max, mask, l)
    node_min, node_max = _implicit_levels(leaf_min.reshape(nc, ch, 3),
                                          leaf_max.reshape(nc, ch, 3))
    c0 = torch.arange(1, 2 * ch - 1, 2, device=dev)
    rows12 = _child_rows(node_min[:, c0], node_max[:, c0],
                         node_min[:, c0 + 1], node_max[:, c0 + 1])

    inv12, icodes = make_instance_rows(
        instances, inst_blas, blasset.root_code, inst_mask=inst_mask,
        inst_opaque=inst_opaque)
    live = (perm >= 0)[:, None]
    safe = torch.clamp(perm, min=0)
    inst_rows = torch.where(live, inv12[safe], 0.0).reshape(nc, ch, 12)
    inst_codes = torch.where(live, icodes[safe], 0).reshape(nc, ch, 2)
    blocks_f = torch.cat([rows12, inst_rows, rows12.new_zeros((nc, 1, 12))],
                         dim=1)
    local = _device_codes("local", str(dev))
    blocks_i = torch.cat([local.expand(nc, ch - 1, 2), inst_codes,
                          inst_codes.new_zeros((nc, 1, 2))], dim=1)

    s = slot_materials.shape[1]
    smat = torch.where(live, slot_materials.to(torch.int32)[safe],
                       0).reshape(nc, ch * s)
    smat = torch.nn.functional.pad(smat, (0, smat_block(s) - ch * s))

    # the root BVH over the chunks' boxes
    pad = nc_pad - nc
    r_min, r_max = _implicit_levels(
        torch.cat([node_min[:, 0], torch.full((pad, 3), inf, device=dev)]),
        torch.cat([node_max[:, 0], torch.full((pad, 3), -inf, device=dev)]))
    if nc_pad > 1:
        rc0 = torch.arange(1, 2 * nc_pad - 1, 2, device=dev)
        rrows = _child_rows(r_min[rc0], r_max[rc0], r_min[rc0 + 1],
                            r_max[rc0 + 1])
        rcodes = _device_codes("root", str(dev), nc_pad, root_off)
        root_code = _code(TYPE_BOX, root_off)
    else:
        rrows = torch.zeros((0, 12), device=dev)
        rcodes = torch.zeros((0, 2), dtype=torch.int32, device=dev)
        root_code = _code(TYPE_CHUNK, 0)
    static_nodes = torch.cat([blasset.nodes, anim_nodes, rrows])
    if static_nodes.shape[0] >= 1 << 27:
        raise ValueError("static rows exceed the paged 27-bit payload")
    scene = PagedScene(
        static_nodes=static_nodes,
        static_codes=torch.cat([blasset.codes, anim_codes, rcodes]),
        chunk_boxes=blocks_f.reshape(-1), chunk_codes=blocks_i.reshape(-1),
        chunk_smat=smat.reshape(-1),
        leaf_rows=torch.cat([blasset.leaf_rows, anim_leaves]),
        leaf_prim=torch.cat([blasset.leaf_prim, anim_prim]),
        inv_rows=inv12, tri_attr=tri_attr,
        bch_nodes=blasset.bch_nodes, bch_codes=blasset.bch_codes,
        bch_lpos=blasset.bch_lpos, bch_lprim=blasset.bch_lprim,
        bch_luv=blasset.bch_luv)
    return scene, root_code


def prefer_paged(meta: BLASSetMeta, capacity: int, n_slots: int = 1) -> bool:
    """The JAX package's layout choice, kept as it is so that both packages
    trace a scene on the same layout: paged when the scene has chunked
    big-model BLASes (only the paged layout holds them) or when the flat
    scene's resolve tables pass 640 KiB (the TPU kernels' SMEM budget)."""
    if meta.num_bchunks > 0:
        return True
    l = _next_pow2(capacity)
    nn = meta.total_nodes + capacity + max(l - 1, 0)
    nl = meta.num_static_leaves + meta.num_anim_leaves
    resolve_bytes = (nn * 14 * 4 + nl * (72 + K + 48 + 72) * 4
                     + capacity * n_slots * 4)
    return resolve_bytes > 640 * 1024


def paged_to_flat(scene: PagedScene):
    """The equivalent flat RTScene of a PagedScene -> (scene,
    remap_root(code)). The TLAS chunk blocks, then the BLAS chunk blocks,
    append after the static rows (their leaves after the static leaves);
    local payloads become absolute rows, and a TYPE_CHUNK code becomes a
    box code at its block's row 0. The instance record words (column 1 of
    rows CH-1..2CH-2) are not codes and stay as they are."""
    ns = scene.static_nodes.shape[0]
    nc = scene.chunk_boxes.shape[0] // (BROWS * 12)
    nbc = scene.bch_codes.shape[0] // BCH_CODE
    l0 = scene.leaf_rows.shape[0]
    bnode0 = ns + nc * BROWS        # first BLAS-chunk node row
    dev = scene.static_nodes.device
    blocks_i = scene.chunk_codes.reshape(nc, BROWS, 2)
    box0 = _code(TYPE_BOX, 0)
    strip = lambda c: c & ~(LOCAL_FLAG | _PAYLOAD_MASK_P)
    typ_of = lambda c: (c >> _TYPE_SHIFT) & 3

    base = ns + torch.arange(nc, dtype=torch.int32, device=dev)[:, None, None] \
        * BROWS
    c = blocks_i
    pay = c & _PAYLOAD_MASK_P
    is_chunk = typ_of(c) == TYPE_CHUNK
    flat_codes = torch.where((((c >> 27) & 1) == 1) & ~is_chunk,
                             strip(c) + base + pay, c)
    flat_codes = torch.where(is_chunk, box0 + ns + pay * BROWS, flat_codes)
    flat_codes[:, CHUNK - 1:2 * CHUNK - 1, 1] = \
        blocks_i[:, CHUNK - 1:2 * CHUNK - 1, 1]

    # static CHUNK codes: world space -> a TLAS block's row 0; object space
    # (big-model top trees) -> a BLAS chunk's row 0
    c = scene.static_codes
    pay = c & _PAYLOAD_MASK_P
    chunk = typ_of(c) == TYPE_CHUNK
    obj = ((c >> 30) & 1) == 1
    static_codes = torch.where(chunk & ~obj, box0 + ns + pay * BROWS, c)
    static_codes = torch.where(chunk & obj, _code(TYPE_BOX, 0, obj=True)
                               + bnode0 + pay * BL_NROWS, static_codes)

    bcodes = scene.bch_codes.reshape(nbc, BL_NROWS, 2)
    k = torch.arange(nbc, dtype=torch.int32, device=dev)[:, None, None]
    pay = bcodes & _PAYLOAD_MASK_P
    b_codes = torch.where(typ_of(bcodes) == TYPE_BOX,
                          strip(bcodes) + bnode0 + k * BL_NROWS + pay, bcodes)
    b_codes = torch.where(typ_of(bcodes) == TYPE_LEAF,
                          strip(bcodes) + l0 + k * BL_LEAVES + pay, b_codes)
    b_leaf_rows = torch.cat(
        [scene.bch_lpos.reshape(nbc * BL_LEAVES, _UV),
         scene.bch_luv.reshape(nbc * BL_LEAVES, LEAF_ROW - _UV)], dim=1)

    flat = RTScene(
        nodes=torch.cat([scene.static_nodes,
                         scene.chunk_boxes.reshape(-1, 12),
                         scene.bch_nodes.reshape(-1, 12)]),
        codes=torch.cat([static_codes, flat_codes.reshape(-1, 2),
                         b_codes.reshape(-1, 2)]),
        leaf_rows=torch.cat([scene.leaf_rows, b_leaf_rows]),
        leaf_prim=torch.cat([scene.leaf_prim,
                             scene.bch_lprim.reshape(-1, K)]),
        inv_rows=scene.inv_rows, tri_attr=scene.tri_attr)

    def remap_root(root_code: int) -> int:
        if (root_code >> _TYPE_SHIFT) & 3 == TYPE_CHUNK:
            return _code(TYPE_BOX, ns + (root_code & _PAYLOAD_MASK_P) * BROWS)
        return root_code

    return flat, remap_root


# ---------------------------------------------------------------------------
# Two-level traversal: the plain PyTorch version of the traversal kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HitRecord2:
    t: torch.Tensor      # f32[R], inf on a miss
    prim: torch.Tensor   # i32[R] arena triangle id, -1 on a miss
    inst: torch.Tensor   # i32[R] instance slot, -1 on a miss
    bary: torch.Tensor   # f32[R, 2]

    @property
    def hit(self) -> torch.Tensor:
        return self.prim >= 0


def _slab2(o, inv_d, t_max, bmin0, bmax0, bmin1, bmax1):
    """Slab-test two child boxes -> (hit0, hit1, tn0, tn1). Dead children
    are inverted boxes (min > max), rejected on axis 0."""
    def one(bmin, bmax):
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tf >= torch.clamp(tn, min=0.0)) & (tn <= t_max)
        return hit & (bmin[:, 0] <= bmax[:, 0]), tn

    h0, tn0 = one(bmin0, bmax0)
    h1, tn1 = one(bmin1, bmax1)
    return h0, h1, tn0, tn1


def leaf_cutout_keep(tri_attr, slot_materials, shading_model, prim_tag,
                     inst_word, u, v) -> torch.Tensor:
    """The any-hit leaf cutout (leaf.rahit) of one leaf's candidates ->
    bool[R, K], False where a candidate lies on a SHADE_LEAF material
    outside the procedural leaf (``shading.leaf_alpha(uv) < 0.5``).
    ``prim_tag`` i32[R, K] (the material slot in bits 24-30), ``inst_word``
    i32[R] the instance record word (a force-opaque instance keeps every
    candidate), ``u``/``v`` f32[R, K] the candidates' barycentrics; the
    material is ``slot_materials[instance, slot]`` and the uv is
    interpolated from ``tri_attr`` cols 9:15 with (1-u-v, u, v). The
    traversal kernels' alpha forms evaluate these expressions in this
    order (``csrc/trace.cu`` ``alpha_keep``)."""
    n, s = slot_materials.shape
    iid = torch.clamp(inst_word & INST_ID_MASK, 0, n - 1).long()
    slot = torch.clamp(prim_tag >> 24, 0, s - 1).long()
    mat = slot_materials[iid[:, None], slot]
    is_leaf = shading_model[
        torch.clamp(mat, 0, shading_model.shape[0] - 1).long()] == SHADE_LEAF
    attr = tri_attr[torch.where(prim_tag >= 0, prim_tag & 0x00FFFFFF,
                                0).long()]
    w0 = 1.0 - u - v
    uv = (w0[..., None] * attr[..., 9:11] + u[..., None] * attr[..., 11:13]
          + v[..., None] * attr[..., 13:15])
    opaque = (inst_word & INST_OPAQUE_BIT) != 0
    return opaque[:, None] | ~is_leaf | (leaf_alpha(uv) >= 0.5)


def trace_scene(
    scene: RTScene,
    ray_o: torch.Tensor,    # f32[R, 3] world
    ray_d: torch.Tensor,    # f32[R, 3] world
    t_max,                  # f32[R] or a number
    *,
    root_code: int,
    stack_size: int,
    t_min: float = 1e-3,
    any_hit: bool = False,
    active: Optional[torch.Tensor] = None,
    cull_mask: int = 0xFF,
    counts: Optional[dict] = None,
    max_steps: Optional[int] = None,
    slot_materials: Optional[torch.Tensor] = None,
    shading_model: Optional[torch.Tensor] = None,
    debug_steps: bool = False,
) -> HitRecord2:
    """Two-level traversal, the plain version of the traversal kernels
    (``csrc/trace.cu``) and the port of ``accel.trace_scene``.

    Each ray runs the same pop/push machine as the kernel's thread: pop a
    code; an instance code moves the ray to object space and pushes the BLAS
    root when its mask meets ``cull_mask``; a box row slab-tests both
    children and pushes the far hit child, then the near one (``tn0 <= tn1``
    picks child 0 as near); a leaf tests its K triangles, keeps the first of
    the closest candidates with ``t < best_t``, and with ``any_hit`` ends
    the walk. Rays are processed in lockstep steps; a step handles each code
    type only on the rays that popped it, and finished rays leave the
    working set. ``counts`` (optional) accumulates the box, leaf and
    instance pops; ``max_steps`` (optional) ends every walk after that many
    pops with the best hit so far. With ``shading_model`` (i32[M], and the
    frame's ``slot_materials`` i32[N, S]) a leaf's candidates first pass
    the any-hit leaf cutout (``leaf_cutout_keep``; ``counts["alpha_rejected"]``
    counts the candidates it drops). With ``debug_steps``, ``bary[:, 0]``
    carries each ray's walk-loop trip count as f32 (its pops, a paged
    walk's chunk rows included; 0 for a dead ray), the plain version of
    the kernels' step-count form; the other outputs are unchanged."""
    r = ray_o.shape[0]
    dev = ray_o.device
    nn = scene.nodes.shape[0]
    nl = scene.leaf_rows.shape[0]
    s = stack_size
    t_cap = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    best_t = t_cap.expand(r).clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_bary = torch.zeros((r, 2), dtype=torch.float32, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)

    w = (torch.arange(r, device=dev) if active is None
         else torch.nonzero(active).flatten())
    m = w.shape[0]
    o, d = ray_o[w], ray_d[w]
    bt, bp, bi, bb = best_t[w], best_prim[w], best_inst[w], best_bary[w]
    oo, do = o.clone(), d.clone()
    ci = torch.zeros((m,), dtype=torch.int32, device=dev)
    # column s is a trash slot: a push past the stack bound is dropped
    stack = torch.zeros((m, s + 1), dtype=torch.int32, device=dev)
    stack[:, 0] = root_code
    sp = torch.ones((m,), dtype=torch.int64, device=dev)

    def push(rows, val, do_push):
        rows, val = rows[do_push], val[do_push]
        top = sp[rows]
        stack[rows, torch.clamp(top, max=s)] = val
        sp[rows] = top + 1

    step = 0
    while m and (max_steps is None or step < max_steps):
        step += 1
        top = sp - 1
        code = torch.where(
            top < s, stack.gather(1, torch.clamp(top, max=s)[:, None])[:, 0], 0)
        sp = top
        typ = (code >> _TYPE_SHIFT) & 3
        payload = code & _PAYLOAD_MASK
        ii = torch.nonzero(typ == TYPE_INST).flatten()
        ib = torch.nonzero(typ == TYPE_BOX).flatten()
        il = torch.nonzero(typ == TYPE_LEAF).flatten()
        if counts is not None:
            for key, idx in (("box", ib), ("leaf", il), ("inst", ii)):
                counts[key] = counts.get(key, 0) + int(idx.shape[0])

        if ii.numel():   # instance switch: world ray -> object ray
            p = torch.clamp(payload[ii], 0, nn - 1).long()
            inv, cpair = scene.nodes[p], scene.codes[p]
            wo, wd = o[ii], d[ii]
            oo[ii] = torch.stack(
                [inv[:, 4 * k] * wo[:, 0] + inv[:, 4 * k + 1] * wo[:, 1]
                 + inv[:, 4 * k + 2] * wo[:, 2] + inv[:, 4 * k + 3]
                 for k in range(3)], dim=-1)
            do[ii] = torch.stack(
                [inv[:, 4 * k] * wd[:, 0] + inv[:, 4 * k + 1] * wd[:, 1]
                 + inv[:, 4 * k + 2] * wd[:, 2] for k in range(3)], dim=-1)
            ci[ii] = cpair[:, 1]
            push(ii, cpair[:, 0], ((cpair[:, 1] >> 24) & cull_mask) != 0)

        if ib.numel():   # box row: slab-test both children in its space
            p = torch.clamp(payload[ib], 0, nn - 1).long()
            row, cpair = scene.nodes[p], scene.codes[p]
            use_obj = (((code[ib] >> 30) & 1) == 1)[:, None]
            ot = torch.where(use_obj, oo[ib], o[ib])
            dt = torch.where(use_obj, do[ib], d[ib])
            inv_d = 1.0 / torch.where(dt.abs() < 1e-12, 1e-12, dt)
            h0, h1, tn0, tn1 = _slab2(ot, inv_d, bt[ib], row[:, 0:3],
                                      row[:, 3:6], row[:, 6:9], row[:, 9:12])
            first0 = tn0 <= tn1
            c0, c1 = cpair[:, 0], cpair[:, 1]
            push(ib, torch.where(first0, c1, c0), torch.where(first0, h1, h0))
            push(ib, torch.where(first0, c0, c1), torch.where(first0, h0, h1))

        if il.numel():   # leaf: K triangle tests
            p = torch.clamp(payload[il], 0, nl - 1).long()
            tri = scene.leaf_rows[p, :_UV].reshape(-1, K, 9)
            prim_tag = scene.leaf_prim[p]
            t, u, v, hit = moller_trumbore_edges(
                oo[il][:, None, :], do[il][:, None, :],
                tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], t_min=t_min)
            cand = hit & (prim_tag >= 0) & (t < bt[il][:, None])
            if shading_model is not None:
                keep = leaf_cutout_keep(scene.tri_attr, slot_materials,
                                        shading_model, prim_tag, ci[il], u, v)
                if counts is not None:
                    counts["alpha_rejected"] = counts.get(
                        "alpha_rejected", 0) + int((cand & ~keep).sum())
                cand = cand & keep
            t_m = torch.where(cand, t, float("inf"))
            k = torch.argmin(t_m, dim=1, keepdim=True)
            win = cand.any(dim=1)
            wl = il[win]
            bt[wl] = t_m.gather(1, k)[:, 0][win]
            bp[wl] = (prim_tag.gather(1, k)[:, 0] & 0x00FFFFFF)[win]
            bi[wl] = ci[wl] & INST_ID_MASK
            bb[wl] = torch.stack([u.gather(1, k)[:, 0], v.gather(1, k)[:, 0]],
                                 dim=-1)[win]
            if any_hit:
                sp[wl] = 0

        done = sp <= 0
        if max_steps is not None and step == max_steps:
            done = torch.ones_like(done)
        if bool(done.any()):
            wd_ = w[done]
            best_t[wd_], best_prim[wd_] = bt[done], bp[done]
            best_inst[wd_], best_bary[wd_] = bi[done], bb[done]
            steps[wd_] = step   # every ray of the working set started at 0
            keep = ~done
            w, o, d, oo, do, ci = w[keep], o[keep], d[keep], oo[keep], do[keep], ci[keep]
            bt, bp, bi, bb = bt[keep], bp[keep], bi[keep], bb[keep]
            stack, sp = stack[keep], sp[keep]
            m = w.shape[0]

    miss = best_prim < 0
    if debug_steps:
        best_bary[:, 0] = steps.to(torch.float32)
    return HitRecord2(t=torch.where(miss, float("inf"), best_t),
                      prim=best_prim,
                      inst=torch.where(miss, -1, best_inst),
                      bary=best_bary)


def resolve_attrs(scene: RTScene, slot_materials: torch.Tensor,
                  rec: HitRecord2):
    """Hit attributes from ONE object-space attribute row and the instance's
    inverse matrix: (uv f32[R, 2], world normal f32[R, 3] before
    normalization, material i32[R]). The plain version of the resolve step
    of the traversal kernel's resolve entry."""
    pid = torch.clamp(rec.prim, min=0).long()
    iid = torch.clamp(rec.inst, 0, scene.inv_rows.shape[0] - 1).long()
    u, v = rec.bary[:, 0], rec.bary[:, 1]
    w0 = 1.0 - u - v
    attr = scene.tri_attr[pid]
    inv = scene.inv_rows[iid]
    n_obj = (w0[:, None] * attr[:, 0:3] + u[:, None] * attr[:, 3:6]
             + v[:, None] * attr[:, 6:9])
    # world normal = (M^-1)^T n_obj (hitcommon.glsl:128)
    normal = torch.stack(
        [inv[:, k] * n_obj[:, 0] + inv[:, k + 4] * n_obj[:, 1]
         + inv[:, k + 8] * n_obj[:, 2] for k in range(3)], dim=-1)
    uv = (w0[:, None] * attr[:, 9:11] + u[:, None] * attr[:, 11:13]
          + v[:, None] * attr[:, 13:15])
    slot = torch.clamp(attr[:, 15].to(torch.int64), 0,
                       slot_materials.shape[1] - 1)
    mat = slot_materials[iid, slot]
    return uv, normal, torch.where(rec.hit, mat, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Tracer context: the (trace, resolve) protocol of the lighting passes
# ---------------------------------------------------------------------------

class SceneTracer:
    """Two-level tracer and attribute resolver bound to one frame's RTScene.
    Every method goes through a traversal kernel wrapper
    (``ops/trace_kernel.py``): the CUDA kernel on a CUDA scene, its plain
    version on a CPU scene. With ``leaf_cutout``, ``trace`` and
    ``trace_resolve`` called with ``use_alpha=True`` apply the any-hit leaf
    cutout (the kernels' alpha forms); the bundles stay opaque.
    ``textures`` (the atlas, or None) is read by the lighting passes to
    shade the hits.

    ``use_pallas=False`` is the JAX package's XLA route on the scene's
    device: every method runs the plain versions (``trace_scene``, one
    any-hit trace per occlusion sample and one closest-hit trace per AO
    sample instead of the bundle, a trace then ``resolve_attrs``), which
    launch no kernel."""

    def __init__(self, scene: RTScene, slot_materials: torch.Tensor,
                 materials, *, root_code: int, stack_size: int,
                 leaf_cutout: bool = False, textures=None,
                 use_pallas: bool = True, image_shape=None,
                 wide: bool = False, pack: int = 1):
        del image_shape, wide, pack     # TPU packet knobs: no result moves
        self.scene = scene
        self.slot_materials = slot_materials
        self.materials = materials
        self.textures = textures
        self.root_code = root_code
        self.stack_size = stack_size
        self.leaf_cutout = leaf_cutout
        self.use_pallas = use_pallas

    def _walk(self):
        return dict(root_code=self.root_code, stack_size=self.stack_size)

    def _shading_model(self, use_alpha: bool):
        """The material table's shading models when this trace applies the
        leaf cutout, else None."""
        return (self.materials.shading_model
                if use_alpha and self.leaf_cutout else None)

    def trace(self, o, d, t_max, *, any_hit=False, active=None,
              use_alpha=False, cull_mask: int = 0xFF) -> HitRecord2:
        from .trace_kernel import trace_scene_kernel

        walk = trace_scene_kernel if self.use_pallas else trace_scene
        return walk(
            self.scene, o, d, t_max, any_hit=any_hit, active=active,
            cull_mask=cull_mask, slot_materials=self.slot_materials,
            shading_model=self._shading_model(use_alpha), **self._walk())

    def resolve(self, rec: HitRecord2, ray_o, ray_d):
        """Interpolated hit attributes (hitcommon.glsl getHitInfo)."""
        return surface_hits(rec, resolve_attrs(self.scene, self.slot_materials,
                                               rec), ray_o, ray_d)

    def trace_resolve(self, o, d, t_max, *, active=None, use_alpha=False,
                      cull_mask: int = 0xFF):
        """Closest hit + attribute resolve in one kernel -> SurfaceHits."""
        from .trace_kernel import trace_resolve_kernel, trace_resolve_plain

        walk = trace_resolve_kernel if self.use_pallas else trace_resolve_plain
        rec, attrs = walk(
            self.scene, self.slot_materials, o, d, t_max, active=active,
            cull_mask=cull_mask, shading_model=self._shading_model(use_alpha),
            **self._walk())
        return surface_hits(rec, attrs, o, d)

    def _bundle(self):
        from .trace_kernel import trace_bundle_kernel, trace_bundle_plain

        return trace_bundle_kernel if self.use_pallas else trace_bundle_plain

    def trace_shadow_ao_bundle(self, o, dirs, t_caps, ao_dirs, ao_caps, *,
                               occ_actives=None, ao_actives=None,
                               cull_mask: int = 0xFF):
        """Origin-shared any-hit occlusion samples and closest-t AO samples
        in one kernel -> (bits i32[R], AO t per sample). Bit s is set where
        occlusion sample s is occluded or inactive; an AO t is its cap on a
        miss and -3e38 on an inactive ray."""
        bits, ao_ts, _ = self._bundle()(
            self.scene, o, dirs, t_caps, occ_actives, ao_dirs, ao_caps,
            ao_actives, cull_mask=cull_mask, **self._walk())
        return bits, ao_ts

    def trace_occlusion_bundle(self, o, dirs, t_caps, *, active=None,
                               cull_mask: int = 0xFF) -> torch.Tensor:
        """Origin-shared any-hit samples -> occlusion bits i32[R] (bit s
        set where sample s is occluded or inactive): one K9 launch with no
        AO sample, or on the XLA route one any-hit trace a sample; the same
        bits as ``PagedSceneTracer.trace_occlusion_bundle``."""
        if not self.use_pallas:
            return occlusion_bits(self, o, dirs, t_caps, active=active,
                                  cull_mask=cull_mask)
        bits, _ = self.trace_shadow_ao_bundle(
            o, dirs, t_caps, [], [], occ_actives=[active] * len(dirs),
            cull_mask=cull_mask)
        return bits

    def trace_shadow_ao_resolve_bundle(self, o, dirs, t_caps, ao_dirs,
                                       ao_caps, rs_d, rs_cap, *,
                                       occ_actives=None, ao_actives=None,
                                       rs_active=None, cull_mask: int = 0xFF):
        """The bundle plus one closest-hit + resolve sample (the 1-bounce
        reflection ray) -> (bits, AO t per sample, SurfaceHits)."""
        bits, ao_ts, (rec, attrs) = self._bundle()(
            self.scene, o, dirs, t_caps, occ_actives, ao_dirs, ao_caps,
            ao_actives, resolve=(self.slot_materials, rs_d, rs_cap, rs_active),
            cull_mask=cull_mask, **self._walk())
        return bits, ao_ts, surface_hits(rec, attrs, o, rs_d)


def surface_hits(rec: HitRecord2, attrs, ray_o, ray_d):
    """(hit record, resolved attributes) -> SurfaceHits: world position from
    the ray equation, the normal normalized and faced toward the ray."""
    uv, n, material = attrs
    hit = rec.hit
    t = torch.where(hit, rec.t, 0.0)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    facing = (n * ray_d).sum(dim=-1) < 0.0
    n = torch.where(facing[:, None], n, -n)
    return SurfaceHits(world_pos=ray_o + t[:, None] * ray_d, normal=n, uv=uv,
                       material=material, valid=hit, t=rec.t)


class PagedSceneTracer:
    """The tracer of a PagedScene (the JAX package's ``PagedSceneTracer``):
    ``trace`` runs K10, ``trace_occlusion_bundle`` one K10 any-hit launch
    per sample, ``trace_resolve`` K11 (``ops/trace_paged.py``). There is no
    fused shadow/AO bundle, so the lighting passes trace shadows and AO
    apart, as the JAX package does for this tracer. On a CPU scene every
    method runs the plain version: the flat view (``paged_to_flat``, built
    once per tracer) walked by ``trace_scene``. ``leaf_cutout`` and
    ``use_alpha`` work as on ``SceneTracer``, and so does ``textures``.
    ``use_pallas=False`` (the XLA route, as in the JAX package) traces the
    flat view with a ``SceneTracer(use_pallas=False)`` on every device."""

    def __init__(self, scene: PagedScene, slot_materials: torch.Tensor,
                 materials, *, root_code: int, stack_size: int,
                 leaf_cutout: bool = False, textures=None,
                 use_pallas: bool = True, image_shape=None,
                 wide: bool = False, pack: int = 1):
        del image_shape, wide, pack     # TPU packet knobs: no result moves
        self.scene = scene
        self.slot_materials = slot_materials
        self.materials = materials
        self.textures = textures
        self.root_code = root_code
        self.stack_size = stack_size
        self.leaf_cutout = leaf_cutout
        self.use_pallas = use_pallas
        self._flat = None
        self._flat_tracer = None

    _shading_model = SceneTracer._shading_model

    def flat_view(self):
        """(flat RTScene, its root code), built at first use."""
        if self._flat is None:
            flat, remap_root = paged_to_flat(self.scene)
            self._flat = (flat, remap_root(self.root_code))
        return self._flat

    def _step_bound(self) -> int:
        sc = self.scene
        nn = (sc.static_nodes.shape[0] + sc.chunk_codes.shape[0] // 2
              + sc.bch_codes.shape[0] // 2)
        nl = sc.leaf_rows.shape[0] + sc.bch_lprim.shape[0] // K
        n = self.slot_materials.shape[0]
        return min(2 ** 31 - 2, 2 * n * (nl + 2) + nn + 64)

    def _walk(self):
        flat = self.flat_view() if self.scene.static_nodes.is_cpu else None
        return dict(root_code=self.root_code, stack_size=self.stack_size,
                    max_steps=self._step_bound(), flat=flat)

    def xla_tracer(self) -> SceneTracer:
        """The XLA route's tracer: the flat view's plain SceneTracer."""
        if self._flat_tracer is None:
            flat, root = self.flat_view()
            self._flat_tracer = SceneTracer(
                flat, self.slot_materials, self.materials, root_code=root,
                stack_size=self.stack_size, leaf_cutout=self.leaf_cutout,
                textures=self.textures, use_pallas=False)
        return self._flat_tracer

    def trace(self, o, d, t_max, *, any_hit=False, active=None,
              use_alpha=False, cull_mask: int = 0xFF) -> HitRecord2:
        from .trace_paged import trace_scene_paged_kernel

        if not self.use_pallas:
            return self.xla_tracer().trace(
                o, d, t_max, any_hit=any_hit, active=active,
                use_alpha=use_alpha, cull_mask=cull_mask)

        return trace_scene_paged_kernel(
            self.scene, o, d, t_max, any_hit=any_hit, active=active,
            cull_mask=cull_mask, slot_materials=self.slot_materials,
            shading_model=self._shading_model(use_alpha), **self._walk())

    def trace_occlusion_bundle(self, o, dirs, t_caps, *, active=None,
                               cull_mask: int = 0xFF) -> torch.Tensor:
        """Origin-shared any-hit samples -> occlusion bits i32[R] (bit s
        set where sample s is occluded or inactive): one K10 any-hit launch
        per sample, as the JAX package's paged tracer does."""
        return occlusion_bits(self, o, dirs, t_caps, active=active,
                              cull_mask=cull_mask)

    def resolve(self, rec: HitRecord2, ray_o, ray_d):
        """Interpolated hit attributes; ``resolve_attrs`` reads only
        ``tri_attr`` and ``inv_rows``, which the flat view shares."""
        return surface_hits(rec, resolve_attrs(self.scene, self.slot_materials,
                                               rec), ray_o, ray_d)

    def trace_resolve(self, o, d, t_max, *, active=None, use_alpha=False,
                      cull_mask: int = 0xFF):
        """Closest hit + attribute resolve in one K11 launch -> SurfaceHits."""
        from .trace_paged import trace_resolve_paged_kernel

        if not self.use_pallas:
            return self.xla_tracer().trace_resolve(
                o, d, t_max, active=active, use_alpha=use_alpha,
                cull_mask=cull_mask)
        rec, attrs = trace_resolve_paged_kernel(
            self.scene, self.slot_materials, o, d, t_max, active=active,
            cull_mask=cull_mask, shading_model=self._shading_model(use_alpha),
            **self._walk())
        return surface_hits(rec, attrs, o, d)


def make_scene_tracer(blasset, meta, anim_rest, anim_rest_nodes, instances,
                      inst_blas, masks, tri_attr, slot_materials, materials,
                      *, tlas_index: int, stack_size: int,
                      paged: bool = False, inst_mask=None, inst_opaque=None,
                      leaf_cutout: bool = False, textures=None, time=None,
                      animate=None, resplit: bool = False,
                      use_pallas: bool = True, image_shape=None,
                      wide: bool = False, pack: int = 1):
    """Assemble this frame's scene and return its tracer: the paged layout
    over TLAS ``tlas_index`` alone (``PagedSceneTracer``) with ``paged``,
    else the flat layout over every TLAS (``SceneTracer``); ``time``,
    ``animate`` and ``resplit`` refit the anim BLASes, ``leaf_cutout``,
    ``textures`` and ``use_pallas`` (False: the XLA route) go to the
    tracer. ``image_shape``, ``wide`` and ``pack`` shape the TPU kernels'
    ray packets and BVH width, which change no result: accepted and
    ignored."""
    del image_shape, wide, pack
    anim = dict(time=time, animate=animate, resplit=resplit,
                inst_mask=inst_mask, inst_opaque=inst_opaque)
    if paged:
        scene, root = assemble_scene_paged(
            blasset, meta, anim_rest, anim_rest_nodes, instances, inst_blas,
            masks[tlas_index], slot_materials, tri_attr, **anim)
        return PagedSceneTracer(scene, slot_materials, materials,
                                root_code=root, stack_size=stack_size,
                                leaf_cutout=leaf_cutout, textures=textures,
                                use_pallas=use_pallas)
    rt_scene, roots = assemble_scene(
        blasset, meta, anim_rest, anim_rest_nodes, instances, inst_blas,
        list(masks), tri_attr, **anim)
    return SceneTracer(rt_scene, slot_materials, materials,
                       root_code=roots[tlas_index], stack_size=stack_size,
                       leaf_cutout=leaf_cutout, textures=textures,
                       use_pallas=use_pallas)
