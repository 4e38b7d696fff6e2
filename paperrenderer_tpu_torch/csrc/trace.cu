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
// Design: one thread per ray (per origin for K9), each walking its own stack
// in local memory with the pop/push machine of accel.trace_scene (the plain
// PyTorch version in paperrenderer_tpu_torch/ops/accel.py): pop a tagged
// code; an instance code moves the ray to object space (the direction is not
// normalized, so t is shared by both spaces) and pushes the BLAS root when
// the instance mask meets the cull mask; a box row slab-tests both children
// and pushes the far hit child, then the near one; a leaf tests its 8
// triangles and keeps the first of the closest candidates with t < best_t.
// The TPU kernels share one scalar stack across a 1024-ray packet because
// the TPU has one scalar unit per core; a Hopper thread has its own control
// flow, so the packet, its union footprint and its (8,128) tiling are gone.
// K9 walks its samples one after another in the same thread: the origin is
// read once and every sample's result is the one its own walk gives, which
// is what the plain version (one trace per sample) computes.
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
// What bounds it: FP32 issue. A box row costs two slab tests (~40 FP32
// operations), a leaf eight Moller-Trumbore tests (~45 each); the scene
// tables are a few MB and stay in L2, the rays are read once (28 B) and the
// hits written once (20 B). Threads of a warp diverge where their rays take
// different paths; rays come in 8x128 (1080p) or 32x32 screen tiles, so
// neighbouring threads mostly walk the same nodes.

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

// slab test of one child box: (hit, tn) as _slab2's `one`
__device__ __forceinline__ bool slab(const float* b, const float* o,
                                     const float* inv_d, float t_max,
                                     float* tn_out) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (__ldg(b + k) - o[k]) * inv_d[k];
    float t1 = (__ldg(b + 3 + k) - o[k]) * inv_d[k];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  *tn_out = tn;
  return (tf >= fmaxf(tn, 0.0f)) && (tn <= t_max) && (__ldg(b) <= __ldg(b + 3));
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
  const float w0 = 1.0f - u - v;
  const float x = w0 * __ldg(a + 9) + u * __ldg(a + 11) + v * __ldg(a + 13);
  const float y = w0 * __ldg(a + 10) + u * __ldg(a + 12) + v * __ldg(a + 14);
  const float e = 1.0f - 2.0f * x;
  const float curve = (-(e * e) + 1.0f) * 0.2f;
  return fabsf(y - 0.5f) < curve;
}

template <bool PAGED, bool ANY_HIT, bool ALPHA>
__device__ Hit traverse(const SceneView& sc, const ResolveView& rv,
                        const float* o, const float* d, float t_max,
                        bool active) {
  int stack[STACK_MAX];
  const int s = sc.stack_size;
  int sp = active ? 1 : 0;
  stack[0] = sc.root;
  float best_t = t_max, bu = 0.0f, bv = 0.0f;
  int best_prim = -1, best_inst = -1, cur_inst = 0, cur_row = 0, best_row = 0;
  float oo[3] = {o[0], o[1], o[2]};
  float dd[3] = {d[0], d[1], d[2]};

  // the step bound is the paged tracer's (PagedSceneTracer._step_bound);
  // the flat walk has none, as before
  int step = 0;
  for (; sp > 0 && (!PAGED || step < sc.max_steps); ++step) {
    const int top = sp - 1;
    const int code = top < s ? stack[top] : 0;
    sp = top;
    const int typ = (code >> 28) & 3;
    const bool local = PAGED && (typ == TYPE_CHUNK || ((code >> 27) & 1));
    const bool obj = ((code >> 30) & 1) != 0;
    if (typ == TYPE_INST) {
      const float* m;
      const int* cp;
      if (PAGED) {   // instance rows live in the TLAS chunk blocks only
        const int p = clampi(code & PAYLOAD_MASK_P, 0, sc.nct - 1);
        m = sc.cboxes + (size_t)p * 12;
        cp = sc.ccodes + 2 * (size_t)p;
        cur_row = p;
      } else {
        const int p = clampi(code & PAYLOAD_MASK, 0, sc.nn - 1);
        m = sc.nodes + (size_t)p * 12;
        cp = sc.codes + 2 * (size_t)p;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float m0 = __ldg(m + 4 * k), m1 = __ldg(m + 4 * k + 1);
        const float m2 = __ldg(m + 4 * k + 2), m3 = __ldg(m + 4 * k + 3);
        oo[k] = m0 * o[0] + m1 * o[1] + m2 * o[2] + m3;
        dd[k] = m0 * d[0] + m1 * d[1] + m2 * d[2];
      }
      const int root = __ldg(cp);
      cur_inst = __ldg(cp + 1);   // the record word: data, not a code
      if (((cur_inst >> 24) & sc.cull_mask) != 0) {
        if (sp < s) stack[sp] = root;
        ++sp;
      }
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
      const float* ot = obj ? oo : o;
      const float* dt = obj ? dd : d;
      float inv_d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        inv_d[k] = 1.0f / (fabsf(dt[k]) < 1e-12f ? 1e-12f : dt[k]);
      float tn0, tn1;
      const bool h0 = slab(row, ot, inv_d, best_t, &tn0);
      const bool h1 = slab(row + 6, ot, inv_d, best_t, &tn1);
      int c0 = __ldg(cp), c1 = __ldg(cp + 1);
      if (local) {
        c0 = rebase(c0, base_row, base_leaf);
        c1 = rebase(c1, base_row, base_leaf);
      }
      const bool first0 = tn0 <= tn1;
      const int near_c = first0 ? c0 : c1, far_c = first0 ? c1 : c0;
      const bool near_h = first0 ? h0 : h1, far_h = first0 ? h1 : h0;
      if (far_h) {
        if (sp < s) stack[sp] = far_c;
        ++sp;
      }
      if (near_h) {
        if (sp < s) stack[sp] = near_c;
        ++sp;
      }
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
      for (int k = 0; k < K; ++k) {
        const int tag = __ldg(prim + k);
        const float* tri = row + 9 * k;
        const float a0 = __ldg(tri), a1 = __ldg(tri + 1), a2 = __ldg(tri + 2);
        const float e10 = __ldg(tri + 3), e11 = __ldg(tri + 4), e12 = __ldg(tri + 5);
        const float e20 = __ldg(tri + 6), e21 = __ldg(tri + 7), e22 = __ldg(tri + 8);
        // Moller-Trumbore on (a, e1, e2), bvh.moller_trumbore_edges' order
        const float p0 = dd[1] * e22 - dd[2] * e21;
        const float p1 = dd[2] * e20 - dd[0] * e22;
        const float p2 = dd[0] * e21 - dd[1] * e20;
        const float det = e10 * p0 + e11 * p1 + e12 * p2;
        const bool ok = fabsf(det) > 1e-12f;
        const float inv = 1.0f / (ok ? det : 1.0f);
        const float s0 = oo[0] - a0, s1 = oo[1] - a1, s2 = oo[2] - a2;
        const float u = (s0 * p0 + s1 * p1 + s2 * p2) * inv;
        const float q0 = s1 * e12 - s2 * e11;
        const float q1 = s2 * e10 - s0 * e12;
        const float q2 = s0 * e11 - s1 * e10;
        const float v = (dd[0] * q0 + dd[1] * q1 + dd[2] * q2) * inv;
        const float t = (e20 * q0 + e21 * q1 + e22 * q2) * inv;
        const bool hit = ok && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f &&
                         t > sc.t_min;
        // first of the closest candidates (argmin over t where cand) that
        // the leaf cutout keeps
        if (hit && tag >= 0 && t < best_t && t < kt &&
            (!ALPHA || alpha_keep<PAGED>(rv, tag, cur_inst, cur_row, u, v))) {
          kt = t;
          ku = u;
          kv = v;
          ktag = tag;
          win = true;
        }
      }
      if (win) {
        best_t = kt;
        best_prim = ktag & 0x00FFFFFF;
        best_inst = cur_inst & INST_ID_MASK;
        best_row = cur_row;
        bu = ku;
        bv = kv;
        if (ANY_HIT) sp = 0;
      }
    }
  }
  Hit h;
  h.prim = best_prim;
  h.t = best_prim < 0 ? CUDART_INF_F : best_t;
  h.inst = best_prim < 0 ? -1 : best_inst;
  h.u = bu;
  h.v = bv;
  h.irow = best_row;
  h.steps = step;
  return h;
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
  const float* a = rv.tri_attr + (size_t)pid * 16;
  const float* inv = rv.inv_rows + (size_t)iid * 12;
  float no[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    no[k] = w0 * __ldg(a + k) + u * __ldg(a + 3 + k) + v * __ldg(a + 6 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    n[k] = __ldg(inv + k) * no[0] + __ldg(inv + k + 4) * no[1] +
           __ldg(inv + k + 8) * no[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    uv[k] = w0 * __ldg(a + 9 + k) + u * __ldg(a + 11 + k) + v * __ldg(a + 13 + k);
  const int slot = clampi((int)__ldg(a + 15), 0, rv.n_slots - 1);
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
  bary[2 * (size_t)i] = h.u;
  bary[2 * (size_t)i + 1] = h.v;
}

template <bool PAGED>
__device__ __forceinline__ void store_resolved(const ResolveView& rv,
                                               const Hit& h, int i, float* uv,
                                               float* normal, int* material) {
  float a[2], n[3];
  int mat;
  resolve<PAGED>(rv, h, a, n, &mat);
  uv[2 * (size_t)i] = a[0];
  uv[2 * (size_t)i + 1] = a[1];
  normal[3 * (size_t)i] = n[0];
  normal[3 * (size_t)i + 1] = n[1];
  normal[3 * (size_t)i + 2] = n[2];
  material[i] = mat;
}

template <bool PAGED, bool ANY_HIT, bool RESOLVE, bool ALPHA, bool STEPS>
__global__ void __launch_bounds__(THREADS)
trace_kernel(SceneView sc, ResolveView rv, const float* __restrict__ ray_o,
             const float* __restrict__ ray_d, const float* __restrict__ t_max,
             const unsigned char* __restrict__ active, int n_rays,
             float* out_t, int* out_prim, int* out_inst, float* out_bary,
             float* out_uv, float* out_normal, int* out_mat) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float o[3], d[3];
  load3(ray_o, i, o);
  load3(ray_d, i, d);
  const bool act = active == nullptr || active[i] != 0;
  Hit h = traverse<PAGED, ANY_HIT, ALPHA>(sc, rv, o, d, __ldg(t_max + i),
                                          act);
  if (STEPS) h.u = (float)h.steps;
  store_hit(h, i, out_t, out_prim, out_inst, out_bary);
  if (RESOLVE) store_resolved<PAGED>(rv, h, i, out_uv, out_normal, out_mat);
}

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
};

__global__ void __launch_bounds__(THREADS)
bundle_kernel(SceneView sc, ResolveView rv, BundleArgs b, int* out_bits,
              float* out_ao_t, float* rs_t, int* rs_prim, int* rs_inst,
              float* rs_bary, float* rs_uv, float* rs_normal, int* rs_mat) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t r = (size_t)b.n_rays;
  if (i >= b.n_rays) return;
  float o[3], d[3];
  load3(b.origin, i, o);
  int bits = 0;
  for (int s = 0; s < b.n_occ; ++s) {
    const bool act = b.occ_act[s * r + i] != 0;
    load3(b.occ_d + s * r * 3, i, d);
    const Hit h = traverse<false, true, false>(
        sc, rv, o, d, __ldg(b.occ_cap + s * r + i), act);
    bits |= (int)(h.prim >= 0 || !act) << s;
  }
  out_bits[i] = bits;
  for (int j = 0; j < b.n_ao; ++j) {
    const bool act = b.ao_act[j * r + i] != 0;
    const float cap = __ldg(b.ao_cap + j * r + i);
    load3(b.ao_d + j * r * 3, i, d);
    const Hit h = traverse<false, false, false>(sc, rv, o, d, cap, act);
    const float t = h.prim >= 0 ? h.t : cap;
    out_ao_t[j * r + i] = act ? t : -3e38f;
  }
  if (b.rs_d != nullptr) {
    load3(b.rs_d, i, d);
    const Hit h = traverse<false, false, false>(sc, rv, o, d,
                                                __ldg(b.rs_cap + i),
                                                b.rs_act[i] != 0);
    store_hit(h, i, rs_t, rs_prim, rs_inst, rs_bary);
    store_resolved<false>(rv, h, i, rs_uv, rs_normal, rs_mat);
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

// one trace_kernel launch; a shading model selects the alpha form, `steps`
// the step-count form (K7/K10 only, never with the alpha form)
template <bool PAGED, bool ANY_HIT, bool RESOLVE>
int launch(const SceneView& sc, const ResolveView& rv, bool steps,
           const float* ray_o, const float* ray_d, const float* t_max,
           const unsigned char* active, int n_rays, float* out_t,
           int* out_prim, int* out_inst, float* out_bary, float* out_uv,
           float* out_normal, int* out_mat, cudaStream_t stream) {
  if (steps && (RESOLVE || rv.shading_model != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  using Kernel = void (*)(SceneView, ResolveView, const float*, const float*,
                         const float*, const unsigned char*, int, float*,
                         int*, int*, float*, float*, float*, int*);
  Kernel kernel = trace_kernel<PAGED, ANY_HIT, RESOLVE, false, false>;
  if (rv.shading_model != nullptr)
    kernel = trace_kernel<PAGED, ANY_HIT, RESOLVE, true, false>;
  if constexpr (!RESOLVE) {
    if (steps) kernel = trace_kernel<PAGED, ANY_HIT, false, false, true>;
  }
  kernel<<<blocks(n_rays), THREADS, 0, stream>>>(
      sc, rv, ray_o, ray_d, t_max, active, n_rays, out_t, out_prim, out_inst,
      out_bary, out_uv, out_normal, out_mat);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int trace_stack_max() { return STACK_MAX; }

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
                 int* out_prim, int* out_inst, float* out_bary,
                 cudaStream_t stream) {
  const SceneView sc = scene_view(nodes, codes, leaf, leaf_prim, nn, nl,
                                  root, stack_size, cull_mask, t_min);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, slot_mats, n_inst,
                                      n_slots, shading_model, n_mats);
  return (any_hit ? launch<false, true, false> : launch<false, false, false>)(
      sc, rv, steps != 0, ray_o, ray_d, t_max, active, n_rays, out_t,
      out_prim, out_inst, out_bary, nullptr, nullptr, nullptr, stream);
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
                         float* out_normal, int* out_mat,
                         cudaStream_t stream) {
  const SceneView sc = scene_view(nodes, codes, leaf, leaf_prim, nn, nl,
                                  root, stack_size, cull_mask, t_min);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, slot_mats, n_inst,
                                      n_slots, shading_model, n_mats);
  return launch<false, false, true>(sc, rv, false, ray_o, ray_d, t_max,
                                    active, n_rays, out_t, out_prim, out_inst,
                                    out_bary, out_uv, out_normal, out_mat,
                                    stream);
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
  bundle_kernel<<<blocks(n_rays), THREADS, 0, stream>>>(
      sc, rv, b, out_bits, out_ao_t, rs_t, rs_prim, rs_inst, rs_bary, rs_uv,
      rs_normal, rs_mat);
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
                       float* out_bary, cudaStream_t stream) {
  const SceneView sc = paged_view(
      scene_view(nodes, codes, leaf, leaf_prim, nn, nl, root, stack_size,
                 cull_mask, t_min),
      cboxes, ccodes, nct, bnodes, bcodes, nbn, blpos, blprim, nbl, max_steps);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, chunk_smat, n_inst,
                                      n_slots, shading_model, n_mats,
                                      smat_blk);
  return (any_hit ? launch<true, true, false> : launch<true, false, false>)(
      sc, rv, steps != 0, ray_o, ray_d, t_max, active, n_rays, out_t,
      out_prim, out_inst, out_bary, nullptr, nullptr, nullptr, stream);
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
    int* out_mat, cudaStream_t stream) {
  const SceneView sc = paged_view(
      scene_view(nodes, codes, leaf, leaf_prim, nn, nl, root, stack_size,
                 cull_mask, t_min),
      cboxes, ccodes, nct, bnodes, bcodes, nbn, blpos, blprim, nbl, max_steps);
  const ResolveView rv = resolve_view(tri_attr, inv_rows, chunk_smat, n_inst,
                                      n_slots, shading_model, n_mats,
                                      smat_blk);
  return launch<true, false, true>(sc, rv, false, ray_o, ray_d, t_max,
                                   active, n_rays, out_t, out_prim, out_inst,
                                   out_bary, out_uv, out_normal, out_mat,
                                   stream);
}

}  // extern "C"
