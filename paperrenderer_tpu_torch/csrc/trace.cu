// Two-level (TLAS -> instance -> BLAS) ray traversal for Hopper (sm_90a).
//
// Replaces the TPU packet-traversal kernels of
// paperrenderer_tpu/ops/trace_kernel.py:
//   K7 trace_launch          <- _make_kernel (:228), via trace_scene_pallas
//                               (closest hit or any hit)
//   K8 trace_resolve_launch  <- _make_resolve_kernel (:506): closest hit +
//                               interpolated uv / normal / material
//   K9 trace_bundle_launch   <- _make_bundle_kernel (:1012): origin-shared
//                               any-hit occlusion samples -> bitmask,
//                               closest-t AO samples, optionally one
//                               closest-hit + resolve sample
// and the paged traversal kernels of paperrenderer_tpu/ops/trace_paged.py:
//   K10 trace_paged_launch         <- _make_kernel_paged (:214): K7's walk
//                                     over a PagedScene
//   K11 trace_resolve_paged_launch <- _make_resolve_kernel_paged (:575):
//                                     K8's over a PagedScene, the material
//                                     from the chunk's slot-material block
// K8 and K11 have an alpha form, the any-hit leaf cutout of leaf.rahit
// (_make_resolve_kernel(alpha_test=True), trace_kernel.py:506, gate :735;
// _make_resolve_kernel_paged(alpha_test=True), trace_paged.py:575, gate
// :906), and so do K7 and K10 (SceneTracer.trace(use_alpha=True), which the
// JAX package runs in XLA): the ALPHA template flag of the walk. A leaf
// candidate that would win (t < best_t and t < the leaf's best so far)
// reads its material (flat: slot_mats[inst, slot]; paged: the chunk's
// slot-material block at the instance's row) and its shading model; only
// on a SHADE_LEAF material does it read its 6 uv floats and keep the
// candidate inside the leaf's lens, |uv.y - 0.5| < (1 - (1 - 2 uv.x)^2) *
// 0.2, unless the instance is force-opaque (record bit 23). The TPU kernels
// re-derive the uv from their packet's ratio state; this walk has u and v.
// A null shading-model pointer selects the instantiation without the gate.
//
// K7 and K10 also have a step-count form, the TPU kernels' debug_steps
// (_make_kernel(debug_steps=True), trace_kernel.py:229, output :489-491;
// _make_kernel_paged(debug_steps=True), trace_paged.py:218, output :563):
// the STEPS template flag of trace_kernel. Its u output carries the trip
// count of the ray's walk loop as f32 (0 for a dead ray), every other output
// is the plain form's. The TPU kernels count a packet's steps, shared by its
// 1024 rays; a thread here walks one ray, so the count is that ray's. The
// paged TPU kernel also packs its leaf and instance pop counts into v; the
// port's v stays the hit's (the plain walk's `counts` gives the pops).
//
// Design: each ray walks its own stack in local memory with the pop/push
// machine of accel.trace_scene (the plain PyTorch version in
// paperrenderer_tpu_torch/ops/accel.py): pop a tagged code; an instance code
// moves the ray to object space (the direction is not normalized, so t is
// shared by both spaces) and pushes the BLAS root when the instance mask
// meets the cull mask; a box row slab-tests both children and pushes the far
// hit child, then the near one; a leaf tests its 8 triangles and keeps the
// first of the closest candidates with t < best_t. The TPU kernels share one
// scalar stack across a 1024-ray packet because the TPU has one scalar unit
// per core; a Hopper thread has its own control flow, so the packet, its
// union footprint and its (8,128) tiling are gone.
//
// K9 keeps the TPU kernel's union walk (_make_bundle_kernel: one traversal
// over the union footprint of a pixel's samples) for its occlusion samples,
// inside one thread: a ray's occlusion samples walk two at a time as one
// union walk (bundle_occlusion), each stack entry with the mask of the
// samples that reached it, each sample tested with its own 1/d and cap. An
// any-hit bit is "some triangle in (t_min, cap) under boxes whose slab
// tests pass at the cap", whatever the order of the visits, so each bit is
// the one the sample's own walk gives (the plain version walks each sample
// alone; ops/trace_kernel.py occlusion_union_plain is the union walk in
// PyTorch). A sample equal to the one before it (a point light's samples)
// shares that walk. The AO and resolve samples are closest-t walks, whose
// result the visit order can change: they walk one after another
// (traverse), as the plain version does. What the union shares is a pop's
// row load, its decode and stack work and the box planes less the origin;
// the slab tests stay one a sample, and they are most of a pop's
// instructions: on config 3 the union halves the occlusion pops and takes
// K9 5-7% down, on hybrid config 4 (four samples, two of them one ray)
// 12-16%. Chaining a ray's phases in one loop, and persistent warps that
// claim rays, were slower on all four of the frames' bundles (PERF.md,
// K9's design steps).
//
// What a step costs, and what the walk does about it. On the 10k grid at
// 1080p a primary ray pops 52.7 codes, 98% of them box rows, and a warp
// runs one pop of each lane's ray at a time, so the box pop is the walk:
//   - 1/d is computed once per ray for the world ray, and once per instance
//     pop for the object-space ray, with the plain version's expression (so
//     the bits are the same), and carried in registers: a box pop selects
//     one instead of paying three IEEE divides (-fmad=false, -prec-div);
//   - a node or instance row is read as three 16-byte vectors and its codes
//     as one 8-byte vector through the read-only path, and so are the rows
//     the resolve and the leaf cutout read (every table starts 16-byte
//     aligned: the wrappers check); leaf rows stay scalar (a 4-triangle
//     group in 16-byte vectors held ~100 registers and was slower);
//   - a leaf skips its padding slots (tag < 0), which are never candidates;
//   - the stack stays in local memory, served from L1: a stack in shared
//     memory ([entry][thread], conflict-free) and a top entry held in a
//     register were both slower on the card.
// Two kernels run the walk, split on the wave's active mask:
//   - trace_kernel (no mask: the camera's rays) walks ray i in thread i.
//     The rays come in 8x128 (1080p) or 32x32 screen tiles, so a warp's 32
//     rays are neighbours that walk mostly the same nodes, and their step
//     counts keep 85% of a warp's lane-steps busy (the 10k grid);
//   - trace_kernel_fetch (a mask: shadow, AO and reflection rays, dead
//     where the camera ray missed) is persistent: its warps claim rays from
//     work counters, write dead rays out as they are claimed and refill
//     lanes whose ray ended, so the live rays of a sparse wave fill whole
//     warps; a claimed batch of 32 live rays is walked whole, in lane
//     order. On the camera's dense waves refilling was slower: a refilled
//     lane's ray is no neighbour of its warp's others. The mask, not the
//     live count, picks the kernel (the count is not known before the
//     launch): on a wave that is 71% live (config 3's reflection rays) the
//     persistent kernel is 8% slower than trace_kernel on the same rays,
//     on the 5-20%-live waves 23-53% faster.
// Which thread runs a ray, and when, never changes the ray's result: each
// ray walks from its root with its own stack, best hit and step count, and
// the work counters only hand out ray indices. No result is combined across
// rays, so no atomic touches one.
//
// K10/K11 are the same walk templated on the layout (PAGED). A paged scene
// has three row tables: the static rows (BLAS top trees, root BVH over the
// TLAS chunks), the TLAS chunk blocks and the BLAS chunk blocks. A code
// with LOCAL_FLAG (bit 27) names a row of the current chunk block; the walk
// rebases such child codes to absolute rows of their block's table when it
// pushes them, so no current-chunk state is kept: the TLAS table for
// world-space codes, the BLAS-chunk tables for object-space ones. A
// TYPE_CHUNK code names a block and is walked as a box pop of the block's
// row 0, which is what the flat view (accel.paged_to_flat, the plain
// version's scene) holds in its place, so both take the same steps. The
// instance record word is read as data, never decoded as a code. The TPU
// kernels DMA the current chunk into SMEM; here every table is read from
// global memory (through L2) and nothing is staged.
//
// Bitwise parity with the plain version: the file is built with -fmad=false
// and every expression is evaluated in the plain version's operation order
// (left-to-right sums of products, IEEE division), so t, prim, inst, u, v,
// the occlusion bits, AO t and the resolved attributes are bit-identical.
//
// What bounds it: instruction issue and the latency of each pop's row load,
// not bytes. The scene tables are a few MB and stay in L2; a ray reads 28 B
// and writes 20 B (0.030 ms for 1080p's 2,073,600 rays at 3.35 TB/s), while
// a live wave costs about 9 ps of the card a pop (K7 on the 10k grid's
// 109.4 M pops in 0.97 ms; K10 11 ps), and rays in a random order cost 2.1x
// the screen-tiled ones. An all-dead wave takes 0.042 ms, the claims'
// atomics above the 0.030 ms of its bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 8;              // triangles per BLAS leaf
constexpr int LEAF_ROW = 120;     // floats per leaf row (72 positions + 48 uv)
constexpr int STACK_MAX = 64;     // per-thread stack; the wrapper checks
constexpr int TYPE_BOX = 0;
constexpr int TYPE_LEAF = 1;
constexpr int TYPE_INST = 2;
constexpr int TYPE_CHUNK = 3;
constexpr int PAYLOAD_MASK = (1 << 28) - 1;
constexpr int LOCAL_FLAG = 1 << 27;
constexpr int PAYLOAD_MASK_P = (1 << 27) - 1;   // paged payload
constexpr int CHUNK = 256;        // instances per TLAS chunk
constexpr int BROWS = 2 * CHUNK;  // rows per TLAS chunk block
constexpr int BL_LEAVES = 256;    // leaf rows per BLAS chunk
constexpr int BL_NROWS = 512;     // node rows per BLAS chunk block
constexpr int INST_ID_MASK = 0x007FFFFF;
constexpr int INST_OPAQUE_BIT = 1 << 23;
constexpr int SHADE_LEAF = 1;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int COUNTER_STRIDE = 32;   // ints between work counters (128 B)
// The persistent kernel's tuning constants, each the best of the values
// timed on an H100 (PERF.md, PR 8) on the 1080p leaf grid's AO and
// reflection waves (20% of the rays live) and on config 3's and hybrid
// config 4's reflection waves (71% live):
//   REFILL: refill a warp once 8 of its lanes are idle (4: 1% slower, 16:
//     2%, 32: 6-11%);
//   BATCH: claim 32 rays at once (64: 3% slower, 128: 10%, though both
//     take the all-dead wave 15% faster);
//   SEGMENTS: spread the claims over 8 counters (1: the all-dead wave 1.7x
//     slower; 4 and 16: within 1% live, slower dead);
//   FETCH_BLOCKS: cap registers at 7 blocks of 128 threads a SM (6: the
//     71%-live waves 3-4% slower; 8: 64 registers with spills, the sparse
//     waves up to 12% slower);
//   WHOLE: walk a batch whole once all 32 of its rays are live (24, 16
//     or 8: no faster on the 71%-live waves, up to 30% slower on the
//     sparse ones).
// REFILL, BATCH and SEGMENTS were timed before the whole-batch rule and
// the deferred writes, WHOLE before the deferred writes, at 6 blocks.
constexpr int REFILL = 8;
constexpr int BATCH = 32;
constexpr int SEGMENTS = 8;
constexpr int FETCH_BLOCKS = 7;
constexpr int WHOLE = 32;
static_assert(BATCH == 32, "a batch of live rays fills one warp");

struct SceneView {
  const float* __restrict__ nodes;      // f32[nn, 12] (paged: static rows)
  const int* __restrict__ codes;        // i32[nn, 2]
  const float* __restrict__ leaf;       // f32[nl, 120]
  const int* __restrict__ leaf_prim;    // i32[nl, 8]
  int nn, nl;
  int root, stack_size, cull_mask, max_steps;
  float t_min;
  // paged layout only
  const float* __restrict__ cboxes;     // f32[nct, 12] TLAS chunk blocks
  const int* __restrict__ ccodes;       // i32[nct, 2]
  const float* __restrict__ bnodes;     // f32[nbn, 12] BLAS chunk blocks
  const int* __restrict__ bcodes;       // i32[nbn, 2]
  const float* __restrict__ blpos;      // f32[nbl, 72] BLAS chunk leaves
  const int* __restrict__ blprim;       // i32[nbl, 8]
  int nct, nbn, nbl;
};

struct ResolveView {
  const float* __restrict__ tri_attr;   // f32[Ta, 16]
  const float* __restrict__ inv_rows;   // f32[N, 12]
  const int* __restrict__ slot_mats;    // i32[N, S] (paged: chunk_smat)
  int n_inst, n_slots;
  int smat_blk;                         // paged: per-chunk block length
  const int* __restrict__ shading_model;   // i32[n_mats]; alpha forms only
  int n_mats;
};

struct Hit {
  float t;
  int prim, inst;
  float u, v;
  int irow;   // paged: TLAS chunk row of the hit's instance
  int steps;  // trip count of the walk loop
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? 1e-12f : x);
}

// a 12-float row (a node's two child boxes, an instance's inverse matrix):
// three 16-byte loads through the read-only path
__device__ __forceinline__ void load_row12(const float* p, float* r) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 x = __ldg(q + k);
    r[4 * k] = x.x;
    r[4 * k + 1] = x.y;
    r[4 * k + 2] = x.z;
    r[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ int2 load_codes(const int* p) {
  return __ldg(reinterpret_cast<const int2*>(p));
}

// slab test of one child box (lo: b[0:3], hi: b[3:6]): (hit, tn) as
// _slab2's `one`
__device__ __forceinline__ bool slab(const float* b, const float* o,
                                     const float* inv_d, float t_max,
                                     float* tn_out) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (b[k] - o[k]) * inv_d[k];
    float t1 = (b[3 + k] - o[k]) * inv_d[k];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  *tn_out = tn;
  return (tf >= fmaxf(tn, 0.0f)) && (tn <= t_max) && (b[0] <= b[3]);
}

// slab's test of one child box from its planes less the ray origin (r[0:3]
// = lo - o, r[3:6] = hi - o), without the box's own lo <= hi check: the
// same t0, t1, tn and tf as slab
__device__ __forceinline__ bool slab_rel(const float* r, const float* inv_d,
                                         float t_max, float* tn_out) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = r[k] * inv_d[k];
    float t1 = r[3 + k] * inv_d[k];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  *tn_out = tn;
  return (tf >= fmaxf(tn, 0.0f)) && (tn <= t_max);
}

// a child code of a chunk block row, rebased to an absolute row of its
// block's table (box and instance rows: base_row; leaves: base_leaf)
__device__ __forceinline__ int rebase(int c, int base_row, int base_leaf) {
  if (((c >> 27) & 1) == 0) return c;
  return c + (((c >> 28) & 3) == TYPE_LEAF ? base_leaf : base_row);
}

// the material of slot `slot` of an instance: flat, slot_mats[inst, slot];
// paged, the hit chunk's slot-material block at the instance's place in
// its chunk (irow: the instance's TLAS chunk row)
template <bool PAGED>
__device__ __forceinline__ int slot_material(const ResolveView& rv, int inst,
                                             int irow, int slot) {
  if (PAGED) {
    const int chunk = irow / BROWS;
    const int k = irow - chunk * BROWS - (CHUNK - 1);
    return __ldg(rv.slot_mats + (size_t)chunk * rv.smat_blk +
                 (size_t)k * rv.n_slots + slot);
  }
  return __ldg(rv.slot_mats + (size_t)clampi(inst, 0, rv.n_inst - 1) *
               rv.n_slots + slot);
}

// the any-hit leaf cutout of one candidate (accel.leaf_cutout_keep, in its
// operation order): false where it lies on a SHADE_LEAF material outside
// the procedural leaf (shading.leaf_alpha(uv) < 0.5)
template <bool PAGED>
__device__ __forceinline__ bool alpha_keep(const ResolveView& rv, int tag,
                                           int inst_word, int irow, float u,
                                           float v) {
  if (inst_word & INST_OPAQUE_BIT) return true;
  const int slot = clampi(tag >> 24, 0, rv.n_slots - 1);
  const int mat = slot_material<PAGED>(rv, inst_word & INST_ID_MASK, irow,
                                       slot);
  if (__ldg(rv.shading_model + clampi(mat, 0, rv.n_mats - 1)) != SHADE_LEAF)
    return true;
  const float* a = rv.tri_attr + (size_t)(tag & 0x00FFFFFF) * 16;
  const float4 p = __ldg(reinterpret_cast<const float4*>(a) + 2);
  const float4 q = __ldg(reinterpret_cast<const float4*>(a) + 3);
  const float a9 = p.y, a10 = p.z, a11 = p.w, a12 = q.x, a13 = q.y,
              a14 = q.z;
  const float w0 = 1.0f - u - v;
  const float x = w0 * a9 + u * a11 + v * a13;
  const float y = w0 * a10 + u * a12 + v * a14;
  const float e = 1.0f - 2.0f * x;
  const float curve = (-(e * e) + 1.0f) * 0.2f;
  return fabsf(y - 0.5f) < curve;
}

// A thread's traversal stack (local memory; a walk writes an entry before
// it reads it)
struct Stack {
  int s[STACK_MAX];
  __device__ __forceinline__ int get(int e) const { return s[e]; }
  __device__ __forceinline__ void set(int e, int c) { s[e] = c; }
};

// One ray's walk: its world ray, its object-space ray (after an instance
// pop), 1/d of both, its best hit so far, its stack pointer and its trip
// count.
struct Walk {
  float o[3], d[3], oo[3], dd[3];
  float iw[3], io[3];
  float best_t, bu, bv;
  int best_prim, best_inst, cur_inst, cur_row, best_row;
  int sp, steps;
};

// a live ray's walk from the root
__device__ __forceinline__ void walk_begin(Walk& w, Stack& st,
                                           const SceneView& sc,
                                           const float* o, const float* d,
                                           float t_max) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w.o[k] = w.oo[k] = o[k];
    w.d[k] = w.dd[k] = d[k];
    w.iw[k] = w.io[k] = inv_dir(d[k]);
  }
  w.sp = 1;
  if (sc.stack_size > 0) st.set(0, sc.root);
  w.best_t = t_max;
  w.bu = w.bv = 0.0f;
  w.best_prim = w.best_inst = -1;
  w.cur_inst = w.cur_row = w.best_row = 0;
  w.steps = 0;
}

// the step bound is the paged tracer's (PagedSceneTracer._step_bound);
// the flat walk has none, as before
template <bool PAGED>
__device__ __forceinline__ bool walk_live(const Walk& w, const SceneView& sc) {
  return w.sp > 0 && (!PAGED || w.steps < sc.max_steps);
}

__device__ __forceinline__ void push(Walk& w, Stack& st, int s, int c) {
  if (w.sp < s) st.set(w.sp, c);
  ++w.sp;
}

// One trip of the walk loop: pop a code (0 for an entry dropped past the
// bound) and handle it.
template <bool PAGED, bool ANY_HIT, bool ALPHA>
__device__ __forceinline__ void walk_step(Walk& w, Stack& st,
                                          const SceneView& sc,
                                          const ResolveView& rv) {
  const int s = sc.stack_size;
  const int top = w.sp - 1;
  const int code = top < s ? st.get(top) : 0;
  w.sp = top;
  ++w.steps;
  const int typ = (code >> 28) & 3;
  const bool local = PAGED && (typ == TYPE_CHUNK || ((code >> 27) & 1));
  const bool obj = ((code >> 30) & 1) != 0;
  if (typ == TYPE_INST) {
    const float* mp;
    const int* cp;
    if (PAGED) {   // instance rows live in the TLAS chunk blocks only
      const int p = clampi(code & PAYLOAD_MASK_P, 0, sc.nct - 1);
      mp = sc.cboxes + (size_t)p * 12;
      cp = sc.ccodes + 2 * (size_t)p;
      w.cur_row = p;
    } else {
      const int p = clampi(code & PAYLOAD_MASK, 0, sc.nn - 1);
      mp = sc.nodes + (size_t)p * 12;
      cp = sc.codes + 2 * (size_t)p;
    }
    float m[12];
    load_row12(mp, m);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w.oo[k] = m[4 * k] * w.o[0] + m[4 * k + 1] * w.o[1] +
                m[4 * k + 2] * w.o[2] + m[4 * k + 3];
      w.dd[k] = m[4 * k] * w.d[0] + m[4 * k + 1] * w.d[1] +
                m[4 * k + 2] * w.d[2];
      w.io[k] = inv_dir(w.dd[k]);
    }
    const int2 c = load_codes(cp);
    w.cur_inst = c.y;   // the record word: data, not a code
    if (((w.cur_inst >> 24) & sc.cull_mask) != 0) push(w, st, s, c.x);
  } else if (typ == TYPE_BOX || (PAGED && typ == TYPE_CHUNK)) {
    const float* row;
    const int* cp;
    int base_row = 0, base_leaf = 0;
    if (!PAGED || !local) {
      const int p = clampi(code & (PAGED ? PAYLOAD_MASK_P : PAYLOAD_MASK),
                           0, sc.nn - 1);
      row = sc.nodes + (size_t)p * 12;
      cp = sc.codes + 2 * (size_t)p;
    } else {
      int pay = code & PAYLOAD_MASK_P;
      if (typ == TYPE_CHUNK) pay *= obj ? BL_NROWS : BROWS;   // row 0
      if (obj) {   // a BLAS chunk block
        const int p = clampi(pay, 0, sc.nbn - 1);
        row = sc.bnodes + (size_t)p * 12;
        cp = sc.bcodes + 2 * (size_t)p;
        base_row = p - p % BL_NROWS;
        base_leaf = p / BL_NROWS * BL_LEAVES;
      } else {     // a TLAS chunk block
        const int p = clampi(pay, 0, sc.nct - 1);
        row = sc.cboxes + (size_t)p * 12;
        cp = sc.ccodes + 2 * (size_t)p;
        base_row = p - p % BROWS;
      }
    }
    float b[12];
    load_row12(row, b);
    float ot[3], inv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ot[k] = obj ? w.oo[k] : w.o[k];
      inv[k] = obj ? w.io[k] : w.iw[k];
    }
    float tn0, tn1;
    const bool h0 = slab(b, ot, inv, w.best_t, &tn0);
    const bool h1 = slab(b + 6, ot, inv, w.best_t, &tn1);
    int2 c = load_codes(cp);
    if (local) {
      c.x = rebase(c.x, base_row, base_leaf);
      c.y = rebase(c.y, base_row, base_leaf);
    }
    const bool first0 = tn0 <= tn1;
    const int near_c = first0 ? c.x : c.y, far_c = first0 ? c.y : c.x;
    const bool near_h = first0 ? h0 : h1, far_h = first0 ? h1 : h0;
    if (far_h) push(w, st, s, far_c);
    if (near_h) push(w, st, s, near_c);
  } else if (typ == TYPE_LEAF) {
    const float* row;
    const int* prim;
    if (local) {   // a BLAS chunk leaf: positions only (72 floats)
      const int p = clampi(code & PAYLOAD_MASK_P, 0, sc.nbl - 1);
      row = sc.blpos + (size_t)p * 72;
      prim = sc.blprim + (size_t)p * K;
    } else {
      const int p = clampi(code & (PAGED ? PAYLOAD_MASK_P : PAYLOAD_MASK),
                           0, sc.nl - 1);
      row = sc.leaf + (size_t)p * LEAF_ROW;
      prim = sc.leaf_prim + (size_t)p * K;
    }
    float kt = CUDART_INF_F, ku = 0.0f, kv = 0.0f;
    int ktag = -1;
    bool win = false;
#pragma unroll 1
    for (int j = 0; j < K; ++j) {
      const int tag = __ldg(prim + j);
      if (tag < 0) continue;   // a padding slot is never a candidate
      const float* tri = row + 9 * j;
      const float a0 = __ldg(tri), a1 = __ldg(tri + 1), a2 = __ldg(tri + 2);
      const float e10 = __ldg(tri + 3), e11 = __ldg(tri + 4),
                  e12 = __ldg(tri + 5);
      const float e20 = __ldg(tri + 6), e21 = __ldg(tri + 7),
                  e22 = __ldg(tri + 8);
      // Moller-Trumbore on (a, e1, e2), bvh.moller_trumbore_edges' order
      const float p0 = w.dd[1] * e22 - w.dd[2] * e21;
      const float p1 = w.dd[2] * e20 - w.dd[0] * e22;
      const float p2 = w.dd[0] * e21 - w.dd[1] * e20;
      const float det = e10 * p0 + e11 * p1 + e12 * p2;
      const bool ok = fabsf(det) > 1e-12f;
      const float inv = 1.0f / (ok ? det : 1.0f);
      const float s0 = w.oo[0] - a0, s1 = w.oo[1] - a1, s2 = w.oo[2] - a2;
      const float u = (s0 * p0 + s1 * p1 + s2 * p2) * inv;
      const float q0 = s1 * e12 - s2 * e11;
      const float q1 = s2 * e10 - s0 * e12;
      const float q2 = s0 * e11 - s1 * e10;
      const float v = (w.dd[0] * q0 + w.dd[1] * q1 + w.dd[2] * q2) * inv;
      const float t = (e20 * q0 + e21 * q1 + e22 * q2) * inv;
      const bool hit = ok && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f &&
                       t > sc.t_min;
      // first of the closest candidates (argmin over t where cand) that
      // the leaf cutout keeps
      if (hit && t < w.best_t && t < kt &&
          (!ALPHA || alpha_keep<PAGED>(rv, tag, w.cur_inst, w.cur_row, u,
                                       v))) {
        kt = t;
        ku = u;
        kv = v;
        ktag = tag;
        win = true;
      }
    }
    if (win) {
      w.best_t = kt;
      w.best_prim = ktag & 0x00FFFFFF;
      w.best_inst = w.cur_inst & INST_ID_MASK;
      w.best_row = w.cur_row;
      w.bu = ku;
      w.bv = kv;
      if (ANY_HIT) w.sp = 0;
    }
  }
}

__device__ __forceinline__ Hit walk_hit(const Walk& w) {
  Hit h;
  h.prim = w.best_prim;
  h.t = w.best_prim < 0 ? CUDART_INF_F : w.best_t;
  h.inst = w.best_prim < 0 ? -1 : w.best_inst;
  h.u = w.bu;
  h.v = w.bv;
  h.irow = w.best_row;
  h.steps = w.steps;
  return h;
}

// the hit of a ray that never walks (active == 0), as its walk would give
__device__ __forceinline__ Hit dead_hit() {
  Hit h;
  h.prim = h.inst = -1;
  h.t = CUDART_INF_F;
  h.u = h.v = 0.0f;
  h.irow = 0;
  h.steps = 0;
  return h;
}

// one ray's whole walk, in the calling thread
template <bool PAGED, bool ANY_HIT, bool ALPHA>
__device__ Hit traverse(const SceneView& sc, const ResolveView& rv,
                        const float* o, const float* d, float t_max,
                        bool active) {
  if (!active) return dead_hit();
  Stack st;
  Walk w;
  walk_begin(w, st, sc, o, d, t_max);
  while (walk_live<PAGED>(w, sc))
    walk_step<PAGED, ANY_HIT, ALPHA>(w, st, sc, rv);
  return walk_hit(w);
}

// accel.resolve_attrs: uv, world normal (before normalization), material.
// The paged form reads the material from the hit chunk's slot-material
// block (chunk_smat) at the instance's place in its chunk.
template <bool PAGED>
__device__ void resolve(const ResolveView& rv, const Hit& h, float* uv,
                        float* n, int* material) {
  const int pid = h.prim < 0 ? 0 : h.prim;
  const int iid = clampi(h.inst, 0, rv.n_inst - 1);
  const float u = h.u, v = h.v;
  const float w0 = 1.0f - u - v;
  float a[16], inv[12];
  const float4* a4 =
      reinterpret_cast<const float4*>(rv.tri_attr) + (size_t)pid * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 x = __ldg(a4 + k);
    a[4 * k] = x.x;
    a[4 * k + 1] = x.y;
    a[4 * k + 2] = x.z;
    a[4 * k + 3] = x.w;
  }
  load_row12(rv.inv_rows + (size_t)iid * 12, inv);
  float no[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) no[k] = w0 * a[k] + u * a[3 + k] + v * a[6 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    n[k] = inv[k] * no[0] + inv[k + 4] * no[1] + inv[k + 8] * no[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    uv[k] = w0 * a[9 + k] + u * a[11 + k] + v * a[13 + k];
  const int slot = clampi((int)a[15], 0, rv.n_slots - 1);
  *material = h.prim >= 0 ? slot_material<PAGED>(rv, iid, h.irow, slot) : 0;
}

__device__ __forceinline__ void load3(const float* p, int i, float* v) {
  v[0] = __ldg(p + 3 * (size_t)i);
  v[1] = __ldg(p + 3 * (size_t)i + 1);
  v[2] = __ldg(p + 3 * (size_t)i + 2);
}

__device__ __forceinline__ void store_hit(const Hit& h, int i, float* t,
                                          int* prim, int* inst, float* bary) {
  t[i] = h.t;
  prim[i] = h.prim;
  inst[i] = h.inst;
  reinterpret_cast<float2*>(bary)[i] = make_float2(h.u, h.v);
}

template <bool PAGED>
__device__ __forceinline__ void store_resolved(const ResolveView& rv,
                                               const Hit& h, int i, float* uv,
                                               float* normal, int* material) {
  float a[2], n[3];
  int mat;
  resolve<PAGED>(rv, h, a, n, &mat);
  reinterpret_cast<float2*>(uv)[i] = make_float2(a[0], a[1]);
  normal[3 * (size_t)i] = n[0];
  normal[3 * (size_t)i + 1] = n[1];
  normal[3 * (size_t)i + 2] = n[2];
  material[i] = mat;
}

struct RayArgs {
  const float* __restrict__ o;          // f32[R, 3]
  const float* __restrict__ d;          // f32[R, 3]
  const float* __restrict__ t_max;      // f32[R]
  const unsigned char* __restrict__ active;   // u8[R] or null: all live
  int n;
};

struct Outputs {
  float* t;
  int* prim;
  int* inst;
  float* bary;
  float* uv;       // RESOLVE only
  float* normal;
  int* mat;
};

template <bool PAGED, bool RESOLVE, bool STEPS>
__device__ __forceinline__ void finish(const ResolveView& rv, Hit h, int i,
                                       const Outputs& out) {
  if (STEPS) h.u = (float)h.steps;
  store_hit(h, i, out.t, out.prim, out.inst, out.bary);
  if (RESOLVE) store_resolved<PAGED>(rv, h, i, out.uv, out.normal, out.mat);
}

// One thread per ray: thread i walks ray i (`work` is unused; both kernels
// take the same arguments).
template <bool PAGED, bool ANY_HIT, bool RESOLVE, bool ALPHA, bool STEPS>
__global__ void __launch_bounds__(THREADS)
trace_kernel(SceneView sc, ResolveView rv, RayArgs ra, Outputs out,
             int* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ra.n) return;
  float o[3], d[3];
  load3(ra.o, i, o);
  load3(ra.d, i, d);
  const bool act = ra.active == nullptr || ra.active[i] != 0;
  const Hit h = traverse<PAGED, ANY_HIT, ALPHA>(sc, rv, o, d,
                                                __ldg(ra.t_max + i), act);
  finish<PAGED, RESOLVE, STEPS>(rv, h, i, out);
}

// Persistent warps with dynamic ray fetch (Aila and Laine, "Understanding
// the Efficiency of Ray Traversal on GPUs", HPG 2009). The grid holds as
// many blocks as fit on the card at once. Each warp steps its lanes' rays
// one pop at a time; when at least REFILL of its lanes are idle, it
// hands them the next rays of its queue, in lane order: BATCH
// consecutive rays that it claims at once with one atomicAdd on a work
// counter. A ray that is dead (active == 0) is written out when it is
// handed out, and its lane stays idle for the next one, so the live rays
// of a sparse wave fill whole warps. A batch whose 32 rays are all live
// (WHOLE: a dense stretch of a mostly live wave, such as the reflection
// rays of surfaces that fill the screen) waits until every lane is idle
// and is walked in lane order, as trace_kernel walks its rays: refilling
// single lanes would break its warp's screen-space coherence. A lane whose
// walk ends keeps its hit until the warp next hands out rays, and the idle
// lanes write theirs together there (K8 and K11 resolve each hit as it is
// written: one lane at a time, that was 4% of a sparse wave's time). The
// rays are cut into SEGMENTS slices, each with its own counter (128 B
// apart, so the claims spread over L2); a warp starts on slice (warp id %
// SEGMENTS) and moves to the next when its slice runs dry. Each ray still
// walks from its root with its own stack,
// best hit and step count, so which lane runs a ray, and when, never
// changes its result: the counters order work, not results.
template <bool PAGED, bool ANY_HIT, bool RESOLVE, bool ALPHA, bool STEPS>
__global__ void __launch_bounds__(THREADS, FETCH_BLOCKS)
trace_kernel_fetch(SceneView sc, ResolveView rv, RayArgs ra, Outputs out,
                   int* __restrict__ work) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  Stack st;
  Walk w;
  int ray = -1;                 // this lane's ray, -1 when idle
  int done = -1;                // an ended ray whose hit is not written yet
  // warp-uniform: the slice being claimed, the slices not yet dry, and the
  // claimed rays [qnext, qend) not yet handed out
  int seg = warp % SEGMENTS, segs_left = SEGMENTS, qnext = 0, qend = 0;
  bool whole = false;   // warp-uniform: the queue is one batch of live rays
  unsigned idle = FULL;
  for (;;) {
    if (__popc(idle) >= (whole ? 32 : REFILL)) {
      // the idle lanes write their ended rays out together (K8/K11 resolve
      // them), not each in the step its walk ended
      if (done >= 0) finish<PAGED, RESOLVE, STEPS>(rv, walk_hit(w), done, out);
      done = -1;
      while (idle != 0) {
        if (qnext == qend) {   // claim the next batch of the slice
          if (segs_left == 0) break;
          const int lo = (int)((long long)ra.n * seg / SEGMENTS);
          const int hi = (int)((long long)ra.n * (seg + 1) / SEGMENTS);
          int base = 0;
          if (lane == 0) base = atomicAdd(work + seg * COUNTER_STRIDE,
                                          BATCH);
          base = lo + __shfl_sync(FULL, base, 0);
          qnext = base < hi ? base : hi;
          qend = base + BATCH < hi ? base + BATCH : hi;
          if (base + BATCH >= hi) {   // this slice is dry
            seg = seg + 1 == SEGMENTS ? 0 : seg + 1;
            --segs_left;
          }
          // a batch of at least WHOLE live rays (a dense stretch of the
          // wave) waits for every lane to be idle and is walked in lane
          // order, as trace_kernel walks it: refilled lanes would break its
          // coherence
          const bool live = qend - qnext == 32 && ra.active[qnext + lane];
          whole = __popc(__ballot_sync(FULL, live)) >= WHOLE;
          if (whole && idle != FULL) break;
          continue;
        }
        const int i = qnext + __popc(idle & below);
        if (((idle >> lane) & 1) && i < qend) {
          if (ra.active != nullptr && ra.active[i] == 0) {
            finish<PAGED, RESOLVE, STEPS>(rv, dead_hit(), i, out);
          } else {
            float o[3], d[3];
            load3(ra.o, i, o);
            load3(ra.d, i, d);
            walk_begin(w, st, sc, o, d, __ldg(ra.t_max + i));
            if (walk_live<PAGED>(w, sc))
              ray = i;
            else   // a paged walk bounded to no step
              finish<PAGED, RESOLVE, STEPS>(rv, walk_hit(w), i, out);
          }
        }
        qnext = qnext + __popc(idle) < qend ? qnext + __popc(idle) : qend;
        idle = __ballot_sync(FULL, ray < 0);
        if (whole) break;   // a whole batch's dead lanes stay idle
      }
      if (idle == FULL && qnext == qend && segs_left == 0) break;   // done
    }
    if (ray >= 0) {
      walk_step<PAGED, ANY_HIT, ALPHA>(w, st, sc, rv);
      if (!walk_live<PAGED>(w, sc)) {
        done = ray;
        ray = -1;
      }
    }
    idle = __ballot_sync(FULL, ray < 0);
  }
}

// ---------------------------------------------------------------------------
// K9: the origin-shared sample bundle
// ---------------------------------------------------------------------------

// K9's union walks take GROUP occlusion samples (4 held more registers and
// was slower on 2-sample bundles, PERF.md), and its kernel is held to
// 64 registers, BUNDLE_BLOCKS blocks of THREADS a SM: the walk waits on its
// loads, and uncapped (73-92 registers) it ran 3-8% slower.
constexpr int GROUP = 2;
constexpr int BUNDLE_BLOCKS = 8;
static_assert(GROUP >= 1 && GROUP <= 30, "a stack entry's mask");

struct BundleArgs {
  const float* origin;                // f32[R, 3]
  const float* occ_d;                 // f32[S, R, 3]
  const float* occ_cap;               // f32[S, R]
  const unsigned char* occ_act;       // u8[S, R]
  int n_occ;
  const float* ao_d;                  // f32[A, R, 3]
  const float* ao_cap;                // f32[A, R]
  const unsigned char* ao_act;        // u8[A, R]
  int n_ao;
  const float* rs_d;                  // f32[R, 3] or null: no resolve sample
  const float* rs_cap;                // f32[R]
  const unsigned char* rs_act;        // u8[R]
  int n_rays;
  int* bits;                          // i32[R]
  float* ao_t;                        // f32[A, R]
  Outputs rs;                         // the resolve sample's hit + attributes
};

// An any-hit walk of up to GROUP occlusion samples from one origin (a
// union walk). Every stack entry carries the mask of the samples that
// reached it; each sample is slab- and leaf-tested with its own 1/d,
// object-space direction and cap (bt), in the expressions of walk_step,
// and leaves at its first winning leaf (won). A sample equal to the one
// before it (direction and cap, bit for bit) does not walk (alias): its
// bit is that sample's. The world directions are read again at an
// instance pop. A box pop pushes at most its two children, as walk_step's,
// so the stack holds one pending entry a level and stack_size bounds it.
struct Union {
  float o[3], oo[3];
  float iw[GROUP][3], io[GROUP][3], dd[GROUP][3], bt[GROUP];
  const float* dir;   // sample 0's world direction; sample g at + g * dstride
  size_t dstride;
  unsigned alive, won, alias;
  int sp;
};

// a union walk's stack: (code, mask) entries, one 8-byte access each
struct UStack {
  int2 e[STACK_MAX];
};

__device__ __forceinline__ void upush(Union& u, UStack& st, int s, int c,
                                      unsigned m) {
  if (u.sp < s) st.e[u.sp] = make_int2(c, (int)m);
  ++u.sp;
}

__device__ __forceinline__ bool union_live(const Union& u) {
  return u.sp > 0 && u.alive != 0;
}

// One trip of the union walk: pop a code and its mask (an entry dropped
// past the bound is code 0 for every sample, as walk_step's), and handle it
// for the mask's live samples; an entry none of whose samples is live is
// dropped without a load.
__device__ __forceinline__ void union_step(Union& u, UStack& st,
                                           const SceneView& sc) {
  const int s = sc.stack_size;
  const int top = u.sp - 1;
  int code = 0;
  unsigned m = ~0u;
  if (top < s) {
    const int2 e = st.e[top];
    code = e.x;
    m = (unsigned)e.y;
  }
  u.sp = top;
  m &= u.alive;
  if (m == 0) return;
  const int typ = (code >> 28) & 3;
  const bool obj = ((code >> 30) & 1) != 0;
  if (typ == TYPE_INST) {
    const int p = clampi(code & PAYLOAD_MASK, 0, sc.nn - 1);
    float mm[12];
    load_row12(sc.nodes + (size_t)p * 12, mm);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      u.oo[k] = mm[4 * k] * u.o[0] + mm[4 * k + 1] * u.o[1] +
                mm[4 * k + 2] * u.o[2] + mm[4 * k + 3];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (!((m >> g) & 1)) continue;
      const float* dp = u.dir + g * u.dstride;
      const float d0 = __ldg(dp), d1 = __ldg(dp + 1), d2 = __ldg(dp + 2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        u.dd[g][k] = mm[4 * k] * d0 + mm[4 * k + 1] * d1 + mm[4 * k + 2] * d2;
        u.io[g][k] = inv_dir(u.dd[g][k]);
      }
    }
    const int2 c = load_codes(sc.codes + 2 * (size_t)p);
    if (((c.y >> 24) & sc.cull_mask) != 0) upush(u, st, s, c.x, m);
  } else if (typ == TYPE_BOX) {
    const int p = clampi(code & PAYLOAD_MASK, 0, sc.nn - 1);
    float rel[12];
    load_row12(sc.nodes + (size_t)p * 12, rel);
    const bool ok0 = rel[0] <= rel[3], ok1 = rel[6] <= rel[9];
    // the children's planes less the origin, which the samples share
    // (slab's b - o, done once)
#pragma unroll
    for (int k = 0; k < 12; ++k)
      rel[k] = rel[k] - (obj ? u.oo[k % 3] : u.o[k % 3]);
    unsigned m0 = 0, m1 = 0;
    bool first0 = true, led = false;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (!((m >> g) & 1)) continue;
      float inv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) inv[k] = obj ? u.io[g][k] : u.iw[g][k];
      float tn0, tn1;
      const bool h0 = slab_rel(rel, inv, u.bt[g], &tn0) && ok0;
      const bool h1 = slab_rel(rel + 6, inv, u.bt[g], &tn1) && ok1;
      m0 |= (unsigned)h0 << g;
      m1 |= (unsigned)h1 << g;
      // the near/far order of the lowest sample that hits a child (any
      // order gives the same bits)
      if (!led && (h0 || h1)) {
        led = true;
        first0 = tn0 <= tn1;
      }
    }
    const int2 c = load_codes(sc.codes + 2 * (size_t)p);
    const int near_c = first0 ? c.x : c.y, far_c = first0 ? c.y : c.x;
    const unsigned near_m = first0 ? m0 : m1, far_m = first0 ? m1 : m0;
    if (far_m) upush(u, st, s, far_c, far_m);
    if (near_m) upush(u, st, s, near_c, near_m);
  } else if (typ == TYPE_LEAF) {
    const int p = clampi(code & PAYLOAD_MASK, 0, sc.nl - 1);
    const float* row = sc.leaf + (size_t)p * LEAF_ROW;
    const int* prim = sc.leaf_prim + (size_t)p * K;
#pragma unroll 1
    for (int j = 0; j < K && m != 0; ++j) {
      const int tag = __ldg(prim + j);
      if (tag < 0) continue;   // a padding slot is never a candidate
      const float* tri = row + 9 * j;
      const float a0 = __ldg(tri), a1 = __ldg(tri + 1), a2 = __ldg(tri + 2);
      const float e10 = __ldg(tri + 3), e11 = __ldg(tri + 4),
                  e12 = __ldg(tri + 5);
      const float e20 = __ldg(tri + 6), e21 = __ldg(tri + 7),
                  e22 = __ldg(tri + 8);
      // Moller-Trumbore on (a, e1, e2), bvh.moller_trumbore_edges' order;
      // s, q and e2.q do not depend on the direction: one per triangle
      const float s0 = u.oo[0] - a0, s1 = u.oo[1] - a1, s2 = u.oo[2] - a2;
      const float q0 = s1 * e12 - s2 * e11;
      const float q1 = s2 * e10 - s0 * e12;
      const float q2 = s0 * e11 - s1 * e10;
      const float tq = e20 * q0 + e21 * q1 + e22 * q2;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (!((m >> g) & 1)) continue;
        const float dx = u.dd[g][0], dy = u.dd[g][1], dz = u.dd[g][2];
        const float p0 = dy * e22 - dz * e21;
        const float p1 = dz * e20 - dx * e22;
        const float p2 = dx * e21 - dy * e20;
        const float det = e10 * p0 + e11 * p1 + e12 * p2;
        const bool ok = fabsf(det) > 1e-12f;
        const float inv = 1.0f / (ok ? det : 1.0f);
        const float uu = (s0 * p0 + s1 * p1 + s2 * p2) * inv;
        const float vv = (dx * q0 + dy * q1 + dz * q2) * inv;
        const float t = tq * inv;
        // a candidate that walk_step's any-hit walk takes: its first win
        if (ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f &&
            t > sc.t_min && t < u.bt[g])
          m &= ~(1u << g), u.won |= 1u << g;
      }
    }
    u.alive &= ~u.won;   // the occluded samples' walks end
  }
}

// The occlusion bits of ray i (origin o): its samples in union walks of
// GROUP. An inactive sample sets its bit and never walks; a sample equal
// to the one before it in its group takes that one's bit.
__device__ __forceinline__ int bundle_occlusion(const SceneView& sc,
                                                const BundleArgs& b, int i,
                                                const float* o) {
  const size_t r = (size_t)b.n_rays;
  int bits = 0;
  Union u;
  UStack st;
#pragma unroll
  for (int k = 0; k < 3; ++k) u.o[k] = o[k];
  u.dstride = r * 3;
  for (int s0 = 0; s0 < b.n_occ; s0 += GROUP) {
    u.alive = u.won = u.alias = 0;
    u.dir = b.occ_d + (size_t)s0 * r * 3 + 3 * (size_t)i;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int smp = s0 + g;
      if (smp >= b.n_occ) break;
      if (b.occ_act[smp * r + i] == 0) {
        bits |= 1 << smp;
        continue;
      }
      const float* dp = u.dir + g * u.dstride;
#pragma unroll
      for (int k = 0; k < 3; ++k) u.dd[g][k] = __ldg(dp + k);
      u.bt[g] = __ldg(b.occ_cap + smp * r + i);
      // equal to the group's sample before (dd and bt are still its world
      // direction and cap): that sample's walk is this one's
      if (g > 0 && (((u.alive | u.alias) >> (g - 1)) & 1) &&
          __float_as_int(u.bt[g]) == __float_as_int(u.bt[g - 1]) &&
          __float_as_int(u.dd[g][0]) == __float_as_int(u.dd[g - 1][0]) &&
          __float_as_int(u.dd[g][1]) == __float_as_int(u.dd[g - 1][1]) &&
          __float_as_int(u.dd[g][2]) == __float_as_int(u.dd[g - 1][2])) {
        u.alias |= 1u << g;
        continue;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        u.iw[g][k] = u.io[g][k] = inv_dir(u.dd[g][k]);
      u.alive |= 1u << g;
    }
    if (u.alive != 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) u.oo[k] = u.o[k];
      u.sp = 1;
      if (sc.stack_size > 0) st.e[0] = make_int2(sc.root, (int)u.alive);
      while (union_live(u)) union_step(u, st, sc);
    }
    unsigned won = u.won;
#pragma unroll
    for (int g = 1; g < GROUP; ++g)
      if ((u.alias >> g) & 1) won |= ((won >> (g - 1)) & 1) << g;
    bits |= (int)(won << s0);
  }
  return bits;
}

// K9: one thread a ray: the occlusion samples, then each AO sample's and
// the resolve sample's closest-hit walk (traverse).
__global__ void __launch_bounds__(THREADS, BUNDLE_BLOCKS)
bundle_kernel(SceneView sc, ResolveView rv, BundleArgs b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.n_rays) return;
  const size_t r = (size_t)b.n_rays;
  float o[3], d[3];
  load3(b.origin, i, o);
  b.bits[i] = bundle_occlusion(sc, b, i, o);
  for (int j = 0; j < b.n_ao; ++j) {
    const bool act = b.ao_act[j * r + i] != 0;
    const float cap = __ldg(b.ao_cap + j * r + i);
    load3(b.ao_d + j * r * 3, i, d);
    const Hit h = traverse<false, false, false>(sc, rv, o, d, cap, act);
    const float t = h.prim >= 0 ? h.t : cap;
    b.ao_t[j * r + i] = act ? t : -3e38f;
  }
  if (b.rs_d != nullptr) {
    load3(b.rs_d, i, d);
    const Hit h = traverse<false, false, false>(sc, rv, o, d,
                                                __ldg(b.rs_cap + i),
                                                b.rs_act[i] != 0);
    store_hit(h, i, b.rs.t, b.rs.prim, b.rs.inst, b.rs.bary);
    store_resolved<false>(rv, h, i, b.rs.uv, b.rs.normal, b.rs.mat);
  }
}

SceneView scene_view(const float* nodes, const int* codes, const float* leaf,
                     const int* leaf_prim, int nn, int nl, int root,
                     int stack_size, int cull_mask, float t_min) {
  SceneView sc;
  sc.nodes = nodes;
  sc.codes = codes;
  sc.leaf = leaf;
  sc.leaf_prim = leaf_prim;
  sc.nn = nn;
  sc.nl = nl;
  sc.root = root;
  sc.stack_size = stack_size;
  sc.cull_mask = cull_mask;
  sc.max_steps = 0;   // paged walks only
  sc.t_min = t_min;
  sc.cboxes = sc.bnodes = sc.blpos = nullptr;
  sc.ccodes = sc.bcodes = sc.blprim = nullptr;
  sc.nct = sc.nbn = sc.nbl = 0;
  return sc;
}

// the paged scene's chunk tables (nct TLAS chunk rows, nbn BLAS chunk node
// rows, nbl BLAS chunk leaves)
SceneView paged_view(SceneView sc, const float* cboxes, const int* ccodes,
                     int nct, const float* bnodes, const int* bcodes, int nbn,
                     const float* blpos, const int* blprim, int nbl,
                     int max_steps) {
  sc.cboxes = cboxes;
  sc.ccodes = ccodes;
  sc.nct = nct;
  sc.bnodes = bnodes;
  sc.bcodes = bcodes;
  sc.nbn = nbn;
  sc.blpos = blpos;
  sc.blprim = blprim;
  sc.nbl = nbl;
  sc.max_steps = max_steps;
  return sc;
}

ResolveView resolve_view(const float* tri_attr, const float* inv_rows,
                         const int* slot_mats, int n_inst, int n_slots,
                         const int* shading_model = nullptr, int n_mats = 1,
                         int smat_blk = 0) {
  ResolveView rv;
  rv.tri_attr = tri_attr;
  rv.inv_rows = inv_rows;
  rv.slot_mats = slot_mats;
  rv.n_inst = n_inst;
  rv.n_slots = n_slots;
  rv.smat_blk = smat_blk;
  rv.shading_model = shading_model;
  rv.n_mats = n_mats;
  return rv;
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// blocks of `kernel` the card runs at once: the occupancy calculator's
// blocks per SM times the SM count, read once per kernel for the library's
// life (the wrappers launch from one host thread)
int resident_blocks(const void* kernel, int* out) {
  static int sms = 0;
  static struct { const void* k; int blocks; } cache[32];
  static int n_cache = 0;
  for (int j = 0; j < n_cache; ++j)
    if (cache[j].k == kernel) {
      *out = cache[j].blocks;
      return 0;
    }
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  if (n_cache < 32) cache[n_cache++] = {kernel, *out};
  return 0;
}

// one traversal launch: a wave with an active mask runs on the persistent
// warps of trace_kernel_fetch (as many blocks as the card holds at once),
// one without on trace_kernel (a thread per ray); a shading model selects
// the alpha form, `steps` the step-count form (K7/K10 only, never with the
// alpha form)
template <bool PAGED, bool ANY_HIT, bool RESOLVE>
int launch(const SceneView& sc, const ResolveView& rv, bool steps,
           const RayArgs& ra, const Outputs& out, int* work,
           cudaStream_t stream) {
  if (steps && (RESOLVE || rv.shading_model != nullptr))
    return (int)cudaErrorInvalidValue;
  if (ra.n <= 0) return 0;
  using Kernel = void (*)(SceneView, ResolveView, RayArgs, Outputs, int*);
  const bool fetch = ra.active != nullptr;
  Kernel kernel = fetch
      ? trace_kernel_fetch<PAGED, ANY_HIT, RESOLVE, false, false>
      : trace_kernel<PAGED, ANY_HIT, RESOLVE, false, false>;
  if (rv.shading_model != nullptr)
    kernel = fetch ? trace_kernel_fetch<PAGED, ANY_HIT, RESOLVE, true, false>
                   : trace_kernel<PAGED, ANY_HIT, RESOLVE, true, false>;
  if constexpr (!RESOLVE) {
    if (steps)
      kernel = fetch ? trace_kernel_fetch<PAGED, ANY_HIT, false, false, true>
                     : trace_kernel<PAGED, ANY_HIT, false, false, true>;
  }
  int grid = blocks(ra.n);
  if (fetch) {
    int resident = 0;
    const int e = resident_blocks((const void*)kernel, &resident);
    if (e != 0) return e;
    if (resident < grid) grid = resident;
  }
  kernel<<<grid, THREADS, 0, stream>>>(sc, rv, ra, out, work);
  return (int)cudaGetLastError();
}

RayArgs ray_args(const float* ray_o, const float* ray_d, const float* t_max,
                 const unsigned char* active, int n_rays) {
  RayArgs ra;
  ra.o = ray_o;
  ra.d = ray_d;
  ra.t_max = t_max;
  ra.active = active;
  ra.n = n_rays;
  return ra;
}

Outputs outputs(float* t, int* prim, int* inst, float* bary,
                float* uv = nullptr, float* normal = nullptr,
                int* mat = nullptr) {
  Outputs out;
  out.t = t;
  out.prim = prim;
  out.inst = inst;
  out.bary = bary;
  out.uv = uv;
  out.normal = normal;
  out.mat = mat;
  return out;
}

}  // namespace

extern "C" {

int trace_stack_max() { return STACK_MAX; }

// ints of the work counters a launch of a wave with an active mask takes
// (`work`, zeroed by the caller for each launch; null for a wave without a
// mask)
int trace_work_ints() { return SEGMENTS * COUNTER_STRIDE; }

// the occlusion samples one K9 union walk takes (trace_kernel.UNION_GROUP
// mirrors it)
int trace_union_group() { return GROUP; }

// K7: closest hit (any_hit = 0) or any hit (any_hit = 1); with a shading
// model (and the resolve tables the cutout reads) its alpha form; with
// steps = 1 its step-count form
int trace_launch(const float* nodes, const int* codes, const float* leaf,
                 const int* leaf_prim, int nn, int nl, int root,
                 int stack_size, int cull_mask, float t_min, int any_hit,
                 int steps,
                 const float* tri_attr, const float* inv_rows,
                 const int* slot_mats, int n_inst, int n_slots,
                 const int* shading_model, int n_mats, const float* ray_o,
                 const float* ray_d, const float* t_max,
                 const unsigned char* active, int n_rays, float* out_t,
                 int* out_prim, int* out_inst, float* out_bary, int* work,
                 cudaStream_t stream) {
  const SceneView sc = scene_view(nodes, codes, leaf, leaf_prim, nn, nl,
                                  root, stack_size, cull_mask, t_min);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, slot_mats, n_inst,
                                      n_slots, shading_model, n_mats);
  return (any_hit ? launch<false, true, false> : launch<false, false, false>)(
      sc, rv, steps != 0, ray_args(ray_o, ray_d, t_max, active, n_rays),
      outputs(out_t, out_prim, out_inst, out_bary), work, stream);
}

// K8: closest hit + resolve; with a shading model its alpha form
int trace_resolve_launch(const float* nodes, const int* codes,
                         const float* leaf, const int* leaf_prim, int nn,
                         int nl, int root, int stack_size, int cull_mask,
                         float t_min, const float* tri_attr,
                         const float* inv_rows, const int* slot_mats,
                         int n_inst, int n_slots, const int* shading_model,
                         int n_mats, const float* ray_o, const float* ray_d,
                         const float* t_max, const unsigned char* active,
                         int n_rays, float* out_t, int* out_prim,
                         int* out_inst, float* out_bary, float* out_uv,
                         float* out_normal, int* out_mat, int* work,
                         cudaStream_t stream) {
  const SceneView sc = scene_view(nodes, codes, leaf, leaf_prim, nn, nl,
                                  root, stack_size, cull_mask, t_min);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, slot_mats, n_inst,
                                      n_slots, shading_model, n_mats);
  return launch<false, false, true>(
      sc, rv, false, ray_args(ray_o, ray_d, t_max, active, n_rays),
      outputs(out_t, out_prim, out_inst, out_bary, out_uv, out_normal,
              out_mat), work, stream);
}

// K9: occlusion bitmask + AO t + optional resolve sample, one origin per ray
int trace_bundle_launch(const float* nodes, const int* codes,
                        const float* leaf, const int* leaf_prim, int nn,
                        int nl, int root, int stack_size, int cull_mask,
                        float t_min, const float* tri_attr,
                        const float* inv_rows, const int* slot_mats,
                        int n_inst, int n_slots, const float* origin,
                        int n_rays, const float* occ_d, const float* occ_cap,
                        const unsigned char* occ_act, int n_occ,
                        const float* ao_d, const float* ao_cap,
                        const unsigned char* ao_act, int n_ao,
                        const float* rs_d, const float* rs_cap,
                        const unsigned char* rs_act, int* out_bits,
                        float* out_ao_t, float* rs_t, int* rs_prim,
                        int* rs_inst, float* rs_bary, float* rs_uv,
                        float* rs_normal, int* rs_mat, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  if (n_occ < 0 || n_occ > 30 || n_ao < 0) return (int)cudaErrorInvalidValue;
  SceneView sc = scene_view(nodes, codes, leaf, leaf_prim, nn, nl, root,
                            stack_size, cull_mask, t_min);
  ResolveView rv = resolve_view(tri_attr, inv_rows, slot_mats, n_inst, n_slots);
  BundleArgs b;
  b.origin = origin;
  b.occ_d = occ_d;
  b.occ_cap = occ_cap;
  b.occ_act = occ_act;
  b.n_occ = n_occ;
  b.ao_d = ao_d;
  b.ao_cap = ao_cap;
  b.ao_act = ao_act;
  b.n_ao = n_ao;
  b.rs_d = rs_d;
  b.rs_cap = rs_cap;
  b.rs_act = rs_act;
  b.n_rays = n_rays;
  b.bits = out_bits;
  b.ao_t = out_ao_t;
  b.rs = outputs(rs_t, rs_prim, rs_inst, rs_bary, rs_uv, rs_normal, rs_mat);
  bundle_kernel<<<blocks(n_rays), THREADS, 0, stream>>>(sc, rv, b);
  return (int)cudaGetLastError();
}

// K10: closest hit (any_hit = 0) or any hit (any_hit = 1) over a
// PagedScene; with a shading model (and the resolve tables the cutout
// reads: chunk_smat, smat_blk ints per chunk) its alpha form; with
// steps = 1 its step-count form
int trace_paged_launch(const float* nodes, const int* codes, const float* leaf,
                       const int* leaf_prim, int nn, int nl, int root,
                       int stack_size, int cull_mask, float t_min,
                       const float* cboxes, const int* ccodes, int nct,
                       const float* bnodes, const int* bcodes, int nbn,
                       const float* blpos, const int* blprim, int nbl,
                       int max_steps, int any_hit, int steps,
                       const float* tri_attr,
                       const float* inv_rows, const int* chunk_smat,
                       int n_inst, int n_slots, int smat_blk,
                       const int* shading_model, int n_mats,
                       const float* ray_o, const float* ray_d,
                       const float* t_max, const unsigned char* active,
                       int n_rays, float* out_t, int* out_prim, int* out_inst,
                       float* out_bary, int* work, cudaStream_t stream) {
  const SceneView sc = paged_view(
      scene_view(nodes, codes, leaf, leaf_prim, nn, nl, root, stack_size,
                 cull_mask, t_min),
      cboxes, ccodes, nct, bnodes, bcodes, nbn, blpos, blprim, nbl, max_steps);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, chunk_smat, n_inst,
                                      n_slots, shading_model, n_mats,
                                      smat_blk);
  return (any_hit ? launch<true, true, false> : launch<true, false, false>)(
      sc, rv, steps != 0, ray_args(ray_o, ray_d, t_max, active, n_rays),
      outputs(out_t, out_prim, out_inst, out_bary), work, stream);
}

// K11: closest hit + resolve over a PagedScene; the material comes from
// chunk_smat (smat_blk ints per chunk, n_slots per instance); with a
// shading model its alpha form
int trace_resolve_paged_launch(
    const float* nodes, const int* codes, const float* leaf,
    const int* leaf_prim, int nn, int nl, int root, int stack_size,
    int cull_mask, float t_min, const float* cboxes, const int* ccodes,
    int nct, const float* bnodes, const int* bcodes, int nbn,
    const float* blpos, const int* blprim, int nbl, int max_steps,
    const float* tri_attr, const float* inv_rows, const int* chunk_smat,
    int n_inst, int n_slots, int smat_blk, const int* shading_model,
    int n_mats, const float* ray_o, const float* ray_d, const float* t_max,
    const unsigned char* active, int n_rays, float* out_t, int* out_prim,
    int* out_inst, float* out_bary, float* out_uv, float* out_normal,
    int* out_mat, int* work, cudaStream_t stream) {
  const SceneView sc = paged_view(
      scene_view(nodes, codes, leaf, leaf_prim, nn, nl, root, stack_size,
                 cull_mask, t_min),
      cboxes, ccodes, nct, bnodes, bcodes, nbn, blpos, blprim, nbl, max_steps);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, chunk_smat, n_inst,
                                      n_slots, shading_model, n_mats,
                                      smat_blk);
  return launch<true, false, true>(
      sc, rv, false, ray_args(ray_o, ray_d, t_max, active, n_rays),
      outputs(out_t, out_prim, out_inst, out_bary, out_uv, out_normal,
              out_mat), work, stream);
}

}  // extern "C"
