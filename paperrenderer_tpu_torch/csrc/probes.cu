// Copy and plumbing probes for Hopper (sm_90a): K12, the port of the three
// script-local TPU kernels
//   K12a chunk_stream_launch       <- scripts/probe_smem_dma.py  kernel (:25)
//   K12b chunk_stream_sweep_launch <- scripts/probe_smem_dma2.py kernel (:23)
//   K12c pass_through_launch       <- scripts/prof_rt_floor2.py  ident  (:73)
//
// K12a: one CTA walks `order`; each step copies the chosen 24 KiB f32 block
// and 4 KiB i32 block into shared memory, waits, and one thread accumulates
// acc + f[0] + f[BLK-1] + (float)i[0] in that order (the TPU probe's sum,
// bit for bit). The TPU kernel DMAs HBM -> SMEM with pltpu.make_async_copy
// and a semaphore; the copy here has three forms:
//   PLAIN     every thread moves 16 B at a time, ld.global -> st.shared;
//   CP_ASYNC  every thread issues 16 B cp.async.cg, commit_group, wait_group;
//   BULK      one thread issues the Hopper bulk copy (TMA without a tensor
//             map), cp.async.bulk ... mbarrier::complete_tx::bytes, and
//             waits on the mbarrier: the counterpart of make_async_copy.
// K12b: the bulk form of the same chain with one f32 block of `blk` floats a
// step (the script's 1024 / 2048 / 6144 / 24576), summing s[0]; and its
// double-buffered case, which starts the copy of step k+1 into the other
// slot before waiting on step k and sums s[cur*blk] over n_iters-1 steps.
// K12c: one thread per ray reads K8's seven ray planes and writes its five
// hit planes (o0 = a0, o1 = bits(a1), o2 = bits(a2), o3 = a3, o4 = a4): the
// plumbing floor of a ray wavefront, zero traversal.
//
// What bounds them: K12a/b are one CTA on one SM, so latency: a step is one
// copy's round trip (HBM or L2 -> SMEM, ~1-2 us) plus the wait; the bytes
// (28 KiB a step) are nothing to the card's rate. Each kernel writes its own
// %globaltimer span (ns) beside the sum, so a step's time is read without
// the launch. K12c is bytes: 28 B read and 20 B written a ray.
//
// A bulk copy whose mbarrier never completes would hang the card; every
// wait is bounded (WAIT_LIMIT_NS on %globaltimer) and a timed-out kernel
// writes -1 as its span, which the wrapper reports as a failure.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr long long WAIT_LIMIT_NS = 1000000000LL;   // 1 s for one copy

enum CopyForm { PLAIN = 0, CP_ASYNC = 1, BULK = 2 };

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`. The fence orders this thread's
// earlier reads of the destination (generic proxy) before the copy's writes
// (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the single arrival of a phase, announcing the bytes its copies bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity (0 for its
// first phase, then alternating); false when it has not come by `deadline`
__device__ __forceinline__ bool bar_wait(uint64_t* bar, uint32_t parity,
                                         long long deadline) {
  do {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.b32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
  } while (globaltimer() < deadline);
  return false;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// the whole CTA copies `n16` 16-byte words from global to shared memory
template <int FORM>
__device__ __forceinline__ void cta_copy(void* dst, const void* src, int n16) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int j = threadIdx.x; j < n16; j += blockDim.x) {
    if (FORM == CP_ASYNC)
      cp_async16(d + j, s + j);
    else
      d[j] = __ldg(s + j);
  }
}

// K12a. PLAIN / CP_ASYNC run COPY_THREADS threads, BULK one.
template <int FORM>
__global__ void chunk_stream_kernel(const float* __restrict__ hf,
                                    const int* __restrict__ hi,
                                    const int* __restrict__ order, int n,
                                    int nc, int blk, int iblk,
                                    float* __restrict__ out,
                                    long long* __restrict__ span) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem + (size_t)blk * 4);
  const long long t0 = globaltimer();
  float acc = 0.0f;
  bool ok = true;
  if (FORM == BULK) {
    bar_init(&bar);
    for (int k = 0; k < n; ++k) {
      const int c = clampi(__ldg(order + k), 0, nc - 1);
      bar_expect(&bar, (uint32_t)(blk + iblk) * 4u);
      bulk_load(sf, hf + (size_t)c * blk, (uint32_t)blk * 4u, &bar);
      bulk_load(si, hi + (size_t)c * iblk, (uint32_t)iblk * 4u, &bar);
      if (!bar_wait(&bar, k & 1, t0 + WAIT_LIMIT_NS)) {
        ok = false;
        break;
      }
      acc = acc + sf[0];
      acc = acc + sf[blk - 1];
      acc = acc + (float)si[0];
    }
  } else {
    for (int k = 0; k < n; ++k) {
      const int c = clampi(__ldg(order + k), 0, nc - 1);
      cta_copy<FORM>(sf, hf + (size_t)c * blk, blk / 4);
      cta_copy<FORM>(si, hi + (size_t)c * iblk, iblk / 4);
      if (FORM == CP_ASYNC) {
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        acc = acc + sf[0];
        acc = acc + sf[blk - 1];
        acc = acc + (float)si[0];
      }
      __syncthreads();   // the block is read before the next copy lands
    }
  }
  if (threadIdx.x == 0) {
    out[0] = acc;
    span[0] = ok ? globaltimer() - t0 : -1;
  }
}

// K12b, bulk form, one thread: chained (one slot) or double-buffered (two)
template <bool DBUF>
__global__ void chunk_sweep_kernel(const float* __restrict__ hf,
                                   const int* __restrict__ order, int n_iters,
                                   int nc, int blk, float* __restrict__ out,
                                   long long* __restrict__ span) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  float* s = reinterpret_cast<float*>(smem);
  const long long t0 = globaltimer();
  const long long deadline = t0 + WAIT_LIMIT_NS;
  const uint32_t bytes = (uint32_t)blk * 4u;
  float acc = 0.0f;
  bool ok = true;
  bar_init(&bar[0]);
  bar_init(&bar[1]);
  auto start = [&](int slot, int k) {
    const int c = clampi(__ldg(order + k), 0, nc - 1);
    bar_expect(&bar[slot], bytes);
    bulk_load(s + (size_t)slot * blk, hf + (size_t)c * blk, bytes, &bar[slot]);
  };
  if (!DBUF) {
    for (int k = 0; k < n_iters; ++k) {
      start(0, k);
      if (!bar_wait(&bar[0], k & 1, deadline)) {
        ok = false;
        break;
      }
      acc = acc + s[0];
    }
  } else {
    // slot k & 1 holds step k's block; the j-th wait on a slot waits for
    // its j-th completion, parity j & 1 = (k >> 1) & 1
    start(0, 0);
    int k = 0;
    for (; k < n_iters - 1; ++k) {
      const int cur = k & 1;
      start(cur ^ 1, k + 1);
      if (!bar_wait(&bar[cur], (k >> 1) & 1, deadline)) {
        ok = false;
        break;
      }
      acc = acc + s[(size_t)cur * blk];
    }
    // the last copy started is not summed (as in the TPU probe); it must
    // land before the block exits
    if (ok) ok = bar_wait(&bar[k & 1], (k >> 1) & 1, deadline);
  }
  out[0] = acc;
  span[0] = ok ? globaltimer() - t0 : -1;
}

// a load the compiler keeps although its value is unused: the TPU kernel's
// pipeline brings all seven input blocks in
__device__ __forceinline__ void touch(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p));
}

// K12c
__global__ void __launch_bounds__(PASS_THREADS)
pass_through_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
                    const float* __restrict__ a2, const float* __restrict__ a3,
                    const float* __restrict__ a4, const float* __restrict__ a5,
                    const float* __restrict__ a6, int n,
                    float* __restrict__ o0,
                    int* __restrict__ o1, int* __restrict__ o2,
                    float* __restrict__ o3, float* __restrict__ o4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  touch(a5 + i);
  touch(a6 + i);
  o0[i] = __ldg(a0 + i);
  o1[i] = __float_as_int(__ldg(a1 + i));
  o2[i] = __float_as_int(__ldg(a2 + i));
  o3[i] = __ldg(a3 + i);
  o4[i] = __ldg(a4 + i);
}

using StreamKernel = void (*)(const float*, const int*, const int*, int, int,
                             int, int, float*, long long*);
using SweepKernel = void (*)(const float*, const int*, int, int, int, float*,
                             long long*);

// one single-CTA launch with `smem` bytes of dynamic shared memory (above
// 48 KiB only after the attribute is raised; a refused launch never runs)
template <typename Kernel, typename... Args>
int launch_one_cta(Kernel kernel, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K12a: form 0 plain, 1 cp.async, 2 bulk copy
int chunk_stream_launch(const float* hf, const int* hi, const int* order,
                        int n, int nc, int blk, int iblk, int form, float* out,
                        long long* span, cudaStream_t stream) {
  StreamKernel kernel;
  int threads = COPY_THREADS;
  switch (form) {
    case PLAIN:
      kernel = chunk_stream_kernel<PLAIN>;
      break;
    case CP_ASYNC:
      kernel = chunk_stream_kernel<CP_ASYNC>;
      break;
    case BULK:
      kernel = chunk_stream_kernel<BULK>;
      threads = 1;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return launch_one_cta(kernel, threads, (size_t)(blk + iblk) * 4, stream, hf,
                        hi, order, n, nc, blk, iblk, out, span);
}

// K12b: bulk copies of `blk` floats, chained (dbuf = 0) or double-buffered
int chunk_stream_sweep_launch(const float* hf, const int* order, int n_iters,
                              int nc, int blk, int dbuf, float* out,
                              long long* span, cudaStream_t stream) {
  const SweepKernel kernel =
      dbuf ? chunk_sweep_kernel<true> : chunk_sweep_kernel<false>;
  return launch_one_cta(kernel, 1, (size_t)blk * 4 * (dbuf ? 2 : 1), stream,
                        hf, order, n_iters, nc, blk, out, span);
}

// K12c
int pass_through_launch(const float* a0, const float* a1, const float* a2,
                        const float* a3, const float* a4, const float* a5,
                        const float* a6, int n, float* o0, int* o1, int* o2,
                        float* o3, float* o4, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + PASS_THREADS - 1) / PASS_THREADS;
  pass_through_kernel<<<blocks, PASS_THREADS, 0, stream>>>(
      a0, a1, a2, a3, a4, a5, a6, n, o0, o1, o2, o3, o4);
  return (int)cudaGetLastError();
}

}  // extern "C"
