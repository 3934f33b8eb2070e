// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over [B, S, W] f32,
// forward and reverse-scan backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py::
// rglru_scan_pallas (body _rglru_kernel), which has no backward: the JAX
// package differentiates its plain scan.  Here the backward is a kernel too,
// the same first-order recurrence run from t = S-1 down to 0:
//   carry = dh_final (or 0)
//   g_t   = dh_t + carry          -> db_t = g_t
//   da_t  = g_t * h_{t-1}         (h_{-1} = h0, or 0)
//   carry = a_t * g_t             -> dh0 = carry after t = 0
// which is g_t = dh_t + a_{t+1} g_{t+1}, g_{S-1} = dh_{S-1} + dh_final.
//
// Layout and parallelism: one thread per (batch, channel) walks the
// sequence, so neighbouring threads read neighbouring channels (W is
// innermost) and every load and store is coalesced.  The recurrence is
// elementwise in W and sequential in S; the only parallelism that keeps the
// plain version's association (and so its bits) is B*W, 4096 threads at the
// training path's batch 1.
//
// What bounds it on the H100: bytes in principle (forward 12, backward 20
// bytes per element against 2-3 flops), but with ~4096 threads the card
// cannot keep enough loads in flight to reach 3.35 TB/s, so in practice it
// is load latency.  Design against that: the inputs of a group of GROUP
// timesteps do not depend on h, so they are copied into shared memory with
// cp.async, STAGES - 1 groups ahead of the group whose dependent
// multiply-add chain runs; each thread copies and reads only its own
// channel's values, so no barrier is needed, only cp.async.wait_group.
// Plain loads into registers do not do this reliably: the compiler sinks
// each load to its use and keeps a few in flight.  Blocks are one warp
// each, so the few threads spread over every SM.  A chunked two-pass scan
// over S would expose more parallelism but changes the association, and so
// the bits: later speed work.
//
// Bit-exactness: every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn) and the unit is compiled with --fmad=false, so no
// multiply and add contract into an FMA.  The plain PyTorch versions
// (ops.py::rglru_scan_plain / rglru_scan_bwd_plain) do one multiply and one
// add per step, each rounded, in the same order: bitwise equal on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;    // one warp a block
constexpr int GROUP = 32;      // timesteps a stage holds
constexpr int STAGES = 4;      // forward: 32 KB of shared memory a block
constexpr int BWD_STAGES = 3;  // backward, three inputs: 36 KB

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
    rglru_fwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                     const float* __restrict__ h0, float* __restrict__ h,
                     float* __restrict__ hfin, int64_t B, int64_t S,
                     int64_t W) {
  __shared__ float sa[STAGES][GROUP][THREADS];
  __shared__ float sb[STAGES][GROUP][THREADS];
  const int lane = threadIdx.x;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + lane;
  if (idx >= B * W) return;
  const int64_t bi = idx / W, w = idx - bi * W;
  const int64_t base = bi * S * W + w;
  const int64_t groups = S / GROUP;
  auto issue = [&](int64_t g) {  // group g: t = g*GROUP ... g*GROUP+GROUP-1
    const int st = (int)(g % STAGES);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int64_t o = base + (g * GROUP + u) * W;
      copy_async(&sa[st][u][lane], a + o);
      copy_async(&sb[st][u][lane], b + o);
    }
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < groups) issue(g);
    commit();
  }
  float hv = h0 ? h0[idx] : 0.f;
  for (int64_t g = 0; g < groups; ++g) {
    if (g + STAGES - 1 < groups) issue(g + STAGES - 1);
    commit();
    wait_pending<STAGES - 1>();  // group g has landed
    const int st = (int)(g % STAGES);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      hv = __fadd_rn(__fmul_rn(sa[st][u][lane], hv), sb[st][u][lane]);
      h[base + (g * GROUP + u) * W] = hv;
    }
  }
  for (int64_t t = groups * GROUP; t < S; ++t) {
    const int64_t o = base + t * W;
    hv = __fadd_rn(__fmul_rn(a[o], hv), b[o]);
    h[o] = hv;
  }
  hfin[idx] = hv;
}

__global__ void __launch_bounds__(THREADS)
    rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ h0,
                     const float* __restrict__ dh,
                     const float* __restrict__ dhfin, float* __restrict__ db,
                     float* __restrict__ da, float* __restrict__ dh0,
                     int64_t B, int64_t S, int64_t W) {
  __shared__ float sd[BWD_STAGES][GROUP][THREADS];
  __shared__ float sa[BWD_STAGES][GROUP][THREADS];
  __shared__ float sh[BWD_STAGES][GROUP][THREADS];
  const int lane = threadIdx.x;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + lane;
  if (idx >= B * W) return;
  const int64_t bi = idx / W, w = idx - bi * W;
  const int64_t base = bi * S * W + w;
  const int64_t groups = S / GROUP;
  // group g: t = S-1-g*GROUP down to S-g*GROUP-GROUP; the S % GROUP
  // timesteps at the start of the sequence are the tail
  auto issue = [&](int64_t g) {
    const int st = (int)(g % BWD_STAGES);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int64_t tt = S - 1 - g * GROUP - u;
      const int64_t o = base + tt * W;
      copy_async(&sd[st][u][lane], dh + o);
      copy_async(&sa[st][u][lane], a + o);
      // h_{t-1}; at t = 0 a valid address, its value replaced by h0 below
      copy_async(&sh[st][u][lane], h + (tt > 0 ? o - W : o));
    }
  };
#pragma unroll
  for (int g = 0; g < BWD_STAGES - 1; ++g) {
    if (g < groups) issue(g);
    commit();
  }
  const float hinit = h0 ? h0[idx] : 0.f;
  float carry = dhfin ? dhfin[idx] : 0.f;
  for (int64_t g = 0; g < groups; ++g) {
    if (g + BWD_STAGES - 1 < groups) issue(g + BWD_STAGES - 1);
    commit();
    wait_pending<BWD_STAGES - 1>();  // group g has landed
    const int st = (int)(g % BWD_STAGES);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int64_t tt = S - 1 - g * GROUP - u;
      const int64_t o = base + tt * W;
      const float g_t = __fadd_rn(sd[st][u][lane], carry);
      db[o] = g_t;
      da[o] = __fmul_rn(g_t, tt > 0 ? sh[st][u][lane] : hinit);
      carry = __fmul_rn(sa[st][u][lane], g_t);
    }
  }
  for (int64_t t = S - 1 - groups * GROUP; t >= 0; --t) {
    const int64_t o = base + t * W;
    const float g_t = __fadd_rn(dh[o], carry);
    db[o] = g_t;
    da[o] = __fmul_rn(g_t, t > 0 ? h[o - W] : hinit);
    carry = __fmul_rn(a[o], g_t);
  }
  if (dh0) dh0[idx] = carry;
}

int grid_for(int64_t n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// Plain C entry points (bound with ctypes).  Every array is contiguous f32:
// b, a, h, dh, db, da [B, S, W]; h0, hfin, dhfin, dh0 [B, W].  h0 may be
// null (zero initial state), and in the backward dhfin (no gradient on the
// final state) and dh0 (no gradient wanted for h0).  Returns a cudaError_t.
extern "C" int rglru_fwd_f32(const float* b, const float* a, const float* h0,
                             float* h, float* hfin, long long B, long long S,
                             long long W, int device, void* stream) {
  if (B * W <= 0) return 0;
  // this library carries its own (static) CUDA runtime: select the
  // buffers' device before launching on a stream of it
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  rglru_fwd_kernel<<<grid_for(B * W), THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      b, a, h0, h, hfin, B, S, W);
  return (int)cudaGetLastError();
}

extern "C" int rglru_bwd_f32(const float* a, const float* h, const float* h0,
                             const float* dh, const float* dhfin, float* db,
                             float* da, float* dh0, long long B, long long S,
                             long long W, int device, void* stream) {
  if (B * W <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  rglru_bwd_kernel<<<grid_for(B * W), THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      a, h, h0, dh, dhfin, db, da, dh0, B, S, W);
  return (int)cudaGetLastError();
}
