// RWKV-6 WKV, chunked (T = 32), forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::rwkv6_pallas
// (body _rwkv6_kernel), which has no backward: the JAX package
// differentiates ops.py::_chunked_jnp.  Here the backward is a kernel too.
// Per (batch, head), state S [D_k, D_v], per chunk of T tokens:
//   logw = log(max(w, 1e-30)),  lw_inc = cumsum_t logw,  lw_exc = lw_inc - logw
//   rd = r e^{lw_exc},  kd = k e^{-lw_inc},  ke = k e^{lw_end - lw_inc}
//   A  = strict_lower(rd kd^T) + diag(sum_i r u k)
//   o  = A v + rd S_in
//   S_out = e^{lw_end} S_in + ke^T v
// and the backward, carrying the state cotangent dS from the last chunk:
//   dS_in = rd^T do + e^{lw_end} dS_out
//   dv  = A^T do + ke dS_out
//   dA  = strict_lower(do v^T), ddiag_t = do_t . v_t
//   drd = dA kd + do S_in^T,  dkd = dA^T rd,  dke = v dS_out^T
//   dr  = drd e^{lw_exc} + ddiag u k,  dk = dkd e^{-lw_inc} + dke e^{..} + ddiag u r
//   du  = sum ddiag r k;  the log-decay gradients run back through both
//   cumulative sums to logw, and dw = dlogw / w where w > 1e-30.
// The plain PyTorch versions (ops.py::rwkv6_chunked_plain / rwkv6_bwd_plain)
// do the same operations; the products are f32 FMAs on the CUDA cores
// (explicit fmaf; the unit builds with --fmad=false, so nothing else
// contracts), each summed in order over its short inner dimension.  Where
// the plain version's matrix product accumulates in that order too, the
// results are bitwise equal on the card (the chunk-start states, S_final,
// ds0, dr and dk at every shape tested); A's diagonal and
// the plain version's reductions sum in another order, so o, dv, dw and du
// are held to a stated tolerance, not bitwise.
//
// Layout: r, k, v, w, do and the gradients are read and written in the
// model's [B, S, H, D] through their strides (no transpose to [B*H, S, D]);
// u [H, D]; s0, S_final, ds_final, ds0 [B, H, D, D]; the chunk-start states
// and their cotangents [B, H, NC, D, D].  D is a template parameter (64, the
// model's head size, and 32); a ragged last chunk is masked as the plain
// version pads: r = k = v = do = 0 and w = 1 beyond S.
//
// Forward.  Only S_out = e^{lw_end} S_in + ke^T v needs the chunk before;
// everything else is per chunk.  So the forward is three launches in one C
// call, and no matrix product sits on the sequential path:
//   1. state contributions, one CTA of 256 threads per (b*h, chunk) — 8,192
//      at the training path's B = 1, S = 8192, H = 32, D = 64: the chunk's
//      decays (log w, then the cumulative sum, one thread a channel, then
//      ke; all in shared memory), dS = ke^T v [D, D] into the chunk's slot
//      of `states`, e^{lw_end} into the scratch ew [B, H, NC, D];
//   2. the state scan, elementwise: one thread per (b*h, i, j) — 131,072 —
//      walks the chunks, reads dS_c, writes S_in in its place and sets
//      S = e^{lw_end}[i] S + dS_c (a multiply, then an add), with 8 chunks'
//      loads in flight ahead of the chain; it writes S_final (s0 or 0 when
//      S = 0);
//   3. outputs, one CTA per (b*h, chunk): the decays again (rd, kd), A's
//      diagonal beside them, then A's strictly lower part (threads 0..127)
//      beside rd S_in (threads 128..255, 4 rows x 4 columns each), then
//      o = A v + rd S_in.
// Every sum keeps the single-walk kernel's order (A over kk, dS over t, the
// state update as written), so o, S_final and the states are bitwise those
// of that kernel.  The chunk-start states are written on every call: they
// are the scan's scratch too (134 MB at the path's shape; under remat both
// forward calls of a layer keep them for the backward anyway), so the
// backward never replays the forward scan.
//
// Backward.  Only dS_in = rd^T do + e^{lw_end} dS_out needs the chunk after,
// so the backward has the forward's shape, run from the last chunk, in four
// launches of one C call:
//   1. contributions, one CTA per (b*h, chunk): the decays as the forward's
//      pass 1 computes them (lw_exc instead of lw_inc), C_c = rd^T do [D, D]
//      summed over t into the chunk's slot of `dstates`, e^{lw_end} into the
//      scratch ew (the forward's pass-1 body, shared);
//   2. the reverse scan, elementwise (the forward's scan body, walking from
//      the last chunk): writes dS_out over C_c, dS = e^{lw_end}[i] dS + C_c
//      from ds_final (or 0), and ds0;
//   3. gradients, one CTA of 256 threads per (b*h, chunk), two CTAs an SM
//      (108.75 KB of shared memory at D = 64: S_in and dS_out unpadded with
//      swizzled 16-byte chunks; rd, kd and ke formed in place of r, k and
//      lw_inc; lw_exc and later A^T do aliased onto A and dA; the
//      products' results onto S_in and dS_out once dead), staged with
//      cp.async: log w elementwise; the cumulative sums (64 threads) beside
//      the row dots S_in.dS_out and A's diagonal; e^{lw_exc}, e^{-lw_inc},
//      e^{lw_end - lw_inc} and rd, kd, ke elementwise, the exponentials
//      kept for the end; A and dA (with ddiag as its diagonal) as 2 x 4
//      tiles summed over the channels; the products split between the
//      CTA's halves (ke dS_out and v dS_out^T; dA kd + do S_in^T, dA^T rd,
//      A^T do), 4 rows x 4 columns a thread, read 16 bytes at a time; then
//      dv, dr, dk elementwise, and X, P, G and du's terms for the
//      per-channel reverse sums to dw and the chunk's partial du;
//   4. du [H, D] summed over batch and chunks in that order, 32 loads in
//      flight ahead of the adds.
// Every product sums over its inner index in order, as the plain version's
// products do (the triangles' with exact zero terms where a 4-wide step
// overhangs the triangle: adding +0 leaves every finite sum as it was), and
// every elementwise step evaluates the plain version's expression.  So two
// revisions that keep these orders agree bit for bit on every output, ds0
// and the state cotangents included (scripts/rwkv6_stages.py --bwd checks
// it); the zero terms would turn an infinite kd or rd (outside the
// numerical domain below) into NaN where a revision without them skipped it.
//
// What bounds it on the H100, at the path's [1, 8192, 32, 64] f32:
//   forward: bytes 20 B an element of r, k, v, w, o (335.5 MB, 0.100 ms at
//   3.35 TB/s; with the states 469.8 MB, 0.140 ms); operations 786,432 per
//   (b, h, chunk) x 256 chunks x 32 heads = 6.44 GFLOP, 0.096 ms at 67
//   TFLOP/s f32: bound 0.140 ms, by bytes.  Backward: 36 B an element (read
//   r, k, v, w, do; write dr, dk, dv, dw) plus the states, 738 MB, 0.220 ms;
//   1,703,936 flops per (b, h, chunk), 13.96 GFLOP, 0.208 ms: bound 0.220
//   ms, by bytes.  Each direction's own traffic is more than its bound's,
//   for 8,192-way parallelism in the chunk passes: forward, pass 1 reads k,
//   v, w and writes dS (0.34 GB), the scan reads and rewrites the states
//   (0.27 GB), pass 3 reads r, k, v, w and the states and writes o (0.47
//   GB): 1.08 GB, 0.32 ms at 3.35 TB/s; backward, pass 1 reads r, w, do and
//   writes C (0.34 GB), the scan reads and rewrites the cotangents (0.27
//   GB), pass 3 reads r, k, v, w, do and both state tensors and writes the
//   four gradients (0.87 GB): 1.48 GB, 0.44 ms.  No tensor cores: TF32 or
//   wgmma would change the numerics (this model's backward amplifies f32
//   rounding about 1e5-fold), and both directions sit below the f32
//   CUDA-core ridge.  The gradient pass is bound by its arithmetic, not its
//   loads: on an H100 (700 W) it took as long with its staging loads
//   removed, and cutting its stages one at a time (scripts/rwkv6_stages.py
//   --bwd) left the products about 40% of its time, A and dA and the
//   decays about 12% each; the products run at about 40% of the f32 rate,
//   held back by shared-memory reads (a 16-byte read a warp costs four
//   bank cycles; one feeds 8 FMAs a thread).

// Numerical domain (the reference's own, not guarded in either package):
// e^{-lw_inc} overflows f32 once 32 |log w| passes ~88.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;          // chunk length (the TPU kernel's default)
constexpr int NT_CHUNK = 256;  // threads of a backward-chunk CTA
constexpr int NT_PASS = 256;   // threads of the other CTAs
constexpr int SCAN_AHEAD = 8;  // chunks a scan thread loads ahead
constexpr int DU_AHEAD = 32;   // chunks' du partials a du thread loads ahead

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fill4(float* dst, float x) {
  dst[0] = x; dst[1] = x; dst[2] = x; dst[3] = x;
}

// offset of row (b, t, h) of a [B, S, H, D] tensor
__device__ __forceinline__ int64_t row_of(int64_t b, int64_t t, int64_t h,
                                          int64_t S, int64_t H, int D) {
  return ((b * S + t) * H + h) * D;
}

// ---------------------------------------------------------------------------
// the state passes, shared by the forward and the backward
// ---------------------------------------------------------------------------
template <int D>
struct StateSmem {
  static constexpr int LD = D + 4;   // 16-byte rows, read along a row only
  // x is k (forward) or r (backward) and becomes ke or rd in place; y is v
  // or do; w becomes lw_inc (forward) or lw_exc (backward) in place
  float x[T][LD], y[T][LD], w[T][LD];
};

// One chunk's contribution to the state scan, in the CTA (b*h, chunk):
// forward  dS_c = ke^T v,  ke = k e^{lw_end - lw_inc};
// backward C_c  = rd^T do, rd = r e^{lw_exc};
// [D, D] into out[c], summed over t in order, and e^{lw_end} into ew[c].
// The decays: log w elementwise, its cumulative sum in order (one thread a
// channel), the exponentials elementwise.
template <int D, bool BWD>
__device__ __forceinline__ void state_contribution(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, float* __restrict__ out,
    float* __restrict__ ew, int64_t S, int64_t H, int64_t NC) {
  using Sm = StateSmem<D>;
  constexpr int V4 = D / 4;
  constexpr int RI = D * D / (4 * NT_PASS);   // rows of dS a thread sums
  static_assert(RI >= 1, "dS: at least one row a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / NC, c = blockIdx.x - bh * NC;
  const int64_t b = bh / H, h = bh - b * H;

  for (int idx = tid; idx < T * V4; idx += NT_PASS) {
    const int t = idx / V4, q = (idx % V4) * 4;
    const int64_t tt = c * T + t;
    if (tt < S) {
      const int64_t g = row_of(b, tt, h, S, H, D) + q;
      copy16(&sm.x[t][q], x + g);
      copy16(&sm.y[t][q], y + g);
      copy16(&sm.w[t][q], w + g);
    } else {
      fill4(&sm.x[t][q], 0.f);
      fill4(&sm.y[t][q], 0.f);
      fill4(&sm.w[t][q], 1.f);
    }
  }
  commit();
  wait_pending<0>();
  __syncthreads();
  // log w, then lw_inc (or lw_exc = lw_inc - log w) in order, then ke (or
  // rd) and e^{lw_end}
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.w[t][i] = logf(fmaxf(sm.w[t][i], 1e-30f));
  }
  __syncthreads();
  if (tid < D) {
    float inc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float lw = sm.w[t][tid];
      inc = inc + lw;
      sm.w[t][tid] = BWD ? inc - lw : inc;
    }
    ew[(bh * NC + c) * D + tid] = expf(inc);
  }
  __syncthreads();
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.x[t][i] = BWD ? sm.x[t][i] * expf(sm.w[t][i])
                     : sm.x[t][i] * expf(sm.w[T - 1][i] - sm.w[t][i]);
  }
  __syncthreads();

  // RI rows x 4 columns a thread, each summed over t in order
  const int jq = (tid % V4) * 4, i0 = (tid / V4) * RI;
  float acc[RI][4] = {};
  for (int t = 0; t < T; ++t) {
    const float4 vv = *reinterpret_cast<const float4*>(&sm.y[t][jq]);
    float x4[RI];
    if constexpr (RI == 4) {
      const float4 kq = *reinterpret_cast<const float4*>(&sm.x[t][i0]);
      x4[0] = kq.x; x4[1] = kq.y; x4[2] = kq.z; x4[3] = kq.w;
    } else {
#pragma unroll
      for (int ri = 0; ri < RI; ++ri) x4[ri] = sm.x[t][i0 + ri];
    }
#pragma unroll
    for (int ri = 0; ri < RI; ++ri) {
      const float xv = x4[ri];
      acc[ri][0] = fmaf(xv, vv.x, acc[ri][0]);
      acc[ri][1] = fmaf(xv, vv.y, acc[ri][1]);
      acc[ri][2] = fmaf(xv, vv.z, acc[ri][2]);
      acc[ri][3] = fmaf(xv, vv.w, acc[ri][3]);
    }
  }
  float* dst = out + ((bh * NC + c) * D + i0) * D + jq;
#pragma unroll
  for (int ri = 0; ri < RI; ++ri)
    *reinterpret_cast<float4*>(dst + ri * D) =
        make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
}

// The state scan of one entry (i, j) of one (b*h): st[c * D*D] holds chunk
// c's contribution on entry and the state it starts from (forward: S_in;
// backward, walking the chunks from the last: dS_out) on exit;
// s = e[c * D] s + contribution (a multiply, then an add).  A ring of
// SCAN_AHEAD chunks' loads stays in flight ahead of the chain.
template <int D, bool REVERSE>
__device__ __forceinline__ float scan_walk(float* st, const float* e, float s,
                                           int64_t NC) {
  constexpr int64_t DD = D * D;
  auto chunk = [&](int64_t n) { return REVERSE ? NC - 1 - n : n; };
  float dn[SCAN_AHEAD] = {}, en[SCAN_AHEAD] = {};
#pragma unroll
  for (int q = 0; q < SCAN_AHEAD; ++q) {
    if (q < NC) {
      dn[q] = st[chunk(q) * DD];
      en[q] = e[chunk(q) * D];
    }
  }
  for (int64_t n0 = 0; n0 < NC; n0 += SCAN_AHEAD) {
    float d[SCAN_AHEAD], x[SCAN_AHEAD];
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      d[q] = dn[q];
      x[q] = en[q];
    }
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int64_t n = n0 + SCAN_AHEAD + q;
      if (n < NC) {
        dn[q] = st[chunk(n) * DD];
        en[q] = e[chunk(n) * D];
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int64_t n = n0 + q;
      if (n < NC) {
        st[chunk(n) * DD] = s;
        s = x[q] * s + d[q];
      }
    }
  }
  return s;
}

// ---------------------------------------------------------------------------
// forward pass 1: every chunk's state contribution, one CTA per (b*h, chunk)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT_PASS, 3)
    rwkv6_fwd_state_kernel(const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ w,
                           float* __restrict__ states, float* __restrict__ ew,
                           int64_t S, int64_t H, int64_t NC) {
  state_contribution<D, false>(k, v, w, states, ew, S, H, NC);
}

// ---------------------------------------------------------------------------
// forward pass 2: the state scan, one thread per (b*h, i, j).  states[c]
// holds dS_c on entry and S_in of chunk c on exit; S = e^{lw_end} S + dS.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT_PASS)
    rwkv6_fwd_scan_kernel(const float* __restrict__ ew,
                          const float* __restrict__ s0,
                          float* __restrict__ states,
                          float* __restrict__ sfin, int64_t BH, int64_t NC) {
  constexpr int64_t DD = D * D;
  const int64_t idx = (int64_t)blockIdx.x * NT_PASS + threadIdx.x;
  if (idx >= BH * DD) return;
  const int64_t bh = idx / DD, ij = idx - bh * DD;
  const float s = s0 ? s0[idx] : 0.f;
  sfin[idx] = scan_walk<D, false>(states + bh * NC * DD + ij,
                                  ew + bh * NC * D + ij / D, s, NC);
}

// ---------------------------------------------------------------------------
// forward pass 3: every chunk's output, one CTA per (b*h, chunk)
// ---------------------------------------------------------------------------
// the ro-th row of output group g of NG: the pair (g, 2 NG - 1 - g),
// repeated every 2 NG rows, so each thread's rows of A v sum to one length
__device__ __forceinline__ int out_row(int ro, int g, int NG) {
  const int base = (ro / 2) * 2 * NG;
  return ro % 2 == 0 ? base + g : base + 2 * NG - 1 - g;
}

template <int D>
struct FwdOutSmem {
  static constexpr int LDS = D + 4;  // staged rows (16-byte cp.async)
  static constexpr int LD = D + 1;   // computed rows (odd: no bank conflicts)
  float r[T][LDS], k[T][LDS], w[T][LDS], v[T][LDS];
  float s[D][LDS];                   // S_in
  float rd[T][LDS];                  // read 16 bytes at a time along i
  float kd[T][LD];
  float a[T][T + 1];
  alignas(16) float u[D];
};

// o = A v + rd S_in, A = strict_lower(rd kd^T) + diag(sum_i r u k)
template <int D>
__global__ void __launch_bounds__(NT_PASS, 3)
    rwkv6_fwd_out_kernel(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ states,
                         float* __restrict__ o, int64_t S, int64_t H,
                         int64_t NC) {
  using Sm = FwdOutSmem<D>;
  constexpr int LDS = Sm::LDS, LD = Sm::LD, V4 = D / 4;
  // threads 0..127 compute A, 128..255 o: NG groups of V4 threads, each
  // thread RO rows (paired t and 2 NG - 1 - t, so every thread's A v chains
  // have one total length) x 4 columns
  constexpr int NG = (NT_PASS / 2) / V4, RO = T / NG;
  static_assert(NT_PASS == 256 && T == 32 && RO % 2 == 0,
                "thread roles laid out for 256 threads and T = 32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / NC, c = blockIdx.x - bh * NC;
  const int64_t b = bh / H, h = bh - b * H;

  // 0. stage the chunk and its start state
  for (int idx = tid; idx < T * V4; idx += NT_PASS) {
    const int t = idx / V4, q = (idx % V4) * 4;
    const int64_t tt = c * T + t;
    if (tt < S) {
      const int64_t g = row_of(b, tt, h, S, H, D) + q;
      copy16(&sm.r[t][q], r + g);
      copy16(&sm.k[t][q], k + g);
      copy16(&sm.w[t][q], w + g);
      copy16(&sm.v[t][q], v + g);
    } else {
      fill4(&sm.r[t][q], 0.f);
      fill4(&sm.k[t][q], 0.f);
      fill4(&sm.w[t][q], 1.f);
      fill4(&sm.v[t][q], 0.f);
    }
  }
  const float* sin = states + (bh * NC + c) * D * D;
  for (int idx = tid; idx < D * V4; idx += NT_PASS) {
    const int i = idx / V4, q = (idx % V4) * 4;
    copy16(&sm.s[i][q], sin + i * D + q);
  }
  commit();
  if (tid < D) sm.u[tid] = u[h * D + tid];
  wait_pending<0>();
  __syncthreads();

  // 1. the decays, with only the cumulative sum left to one thread a
  //    channel: log w in place
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.w[t][i] = logf(fmaxf(sm.w[t][i], 1e-30f));
  }
  __syncthreads();

  // 2. lw_inc (into kd for now) and lw_exc (into rd), one channel a thread,
  //    beside A's diagonal (one row a thread, its r and k rows read 16
  //    bytes at a time, summed over kk in order)
  if (tid < D) {
    float inc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float lw = sm.w[t][tid];
      inc = inc + lw;
      sm.kd[t][tid] = inc;
      sm.rd[t][tid] = inc - lw;
    }
  } else if (tid < D + T) {
    const int m = tid - D;
    float x = 0.f;
    for (int kk = 0; kk < D; kk += 4) {
      const float4 rr = *reinterpret_cast<const float4*>(&sm.r[m][kk]);
      const float4 kq = *reinterpret_cast<const float4*>(&sm.k[m][kk]);
      const float4 uu = *reinterpret_cast<const float4*>(&sm.u[kk]);
      x = fmaf(rr.x, uu.x * kq.x, x);
      x = fmaf(rr.y, uu.y * kq.y, x);
      x = fmaf(rr.z, uu.z * kq.z, x);
      x = fmaf(rr.w, uu.w * kq.w, x);
    }
    sm.a[m][m] = x;
  }
  __syncthreads();

  // 3. rd = r e^{lw_exc}, kd = k e^{-lw_inc}
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.rd[t][i] = sm.r[t][i] * expf(sm.rd[t][i]);
    sm.kd[t][i] = sm.k[t][i] * expf(-sm.kd[t][i]);
  }
  __syncthreads();

  // 4. A's strictly lower part (threads 0..127: a 2 x 4 tile each) beside
  //    rd S_in (threads 128..255, in registers until A is done)
  const int q = tid - NT_PASS / 2, jq = (q % V4) * 4, g = q / V4;
  float sv[RO][4] = {};
  if (tid < NT_PASS / 2) {
    const int m0 = (tid / 8) * 2, n0 = (tid % 8) * 4;
    if (n0 < m0 + 1) {  // some entry of the tile lies below the diagonal
      float acc[2][4] = {};
      for (int kk = 0; kk < D; ++kk) {
        const float a0 = sm.rd[m0][kk], a1 = sm.rd[m0 + 1][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bj = sm.kd[n0 + j][kk];
          acc[0][j] = fmaf(a0, bj, acc[0][j]);
          acc[1][j] = fmaf(a1, bj, acc[1][j]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < m0 + mi) sm.a[m0 + mi][n0 + j] = acc[mi][j];
    }
  } else {
    for (int i = 0; i < D; i += 4) {
      float4 x[RO];
#pragma unroll
      for (int ro = 0; ro < RO; ++ro)
        x[ro] = *reinterpret_cast<const float4*>(
            &sm.rd[out_row(ro, g, NG)][i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 ss = *reinterpret_cast<const float4*>(&sm.s[i + e][jq]);
#pragma unroll
        for (int ro = 0; ro < RO; ++ro) {
          const float xe = e == 0 ? x[ro].x : e == 1 ? x[ro].y
                         : e == 2 ? x[ro].z : x[ro].w;
          sv[ro][0] = fmaf(xe, ss.x, sv[ro][0]);
          sv[ro][1] = fmaf(xe, ss.y, sv[ro][1]);
          sv[ro][2] = fmaf(xe, ss.z, sv[ro][2]);
          sv[ro][3] = fmaf(xe, ss.w, sv[ro][3]);
        }
      }
    }
  }
  __syncthreads();

  // 5. o = A v + rd S_in (threads 128..255)
  if (tid >= NT_PASS / 2) {
#pragma unroll
    for (int ro = 0; ro < RO; ++ro) {
      const int t = out_row(ro, g, NG);
      float av[4] = {};
      for (int s = 0; s <= t; ++s) {
        const float x = sm.a[t][s];
        const float4 vv = *reinterpret_cast<const float4*>(&sm.v[s][jq]);
        av[0] = fmaf(x, vv.x, av[0]);
        av[1] = fmaf(x, vv.y, av[1]);
        av[2] = fmaf(x, vv.z, av[2]);
        av[3] = fmaf(x, vv.w, av[3]);
      }
      const int64_t tt = c * T + t;
      if (tt < S)
        *reinterpret_cast<float4*>(o + row_of(b, tt, h, S, H, D) + jq) =
            make_float4(av[0] + sv[ro][0], av[1] + sv[ro][1],
                        av[2] + sv[ro][2], av[3] + sv[ro][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass 1: every chunk's C_c = rd^T do and e^{lw_end}, one CTA per
// (b*h, chunk), into the chunk's slot of dstates and into ew
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT_PASS, 3)
    rwkv6_bwd_state_kernel(const float* __restrict__ r,
                           const float* __restrict__ dout,
                           const float* __restrict__ w,
                           float* __restrict__ dstates,
                           float* __restrict__ ew, int64_t S, int64_t H,
                           int64_t NC) {
  state_contribution<D, true>(r, dout, w, dstates, ew, S, H, NC);
}

// ---------------------------------------------------------------------------
// backward pass 2: the reverse state-cotangent scan, one thread per
// (b*h, i, j).  dstates[c] holds C_c on entry and dS_out of chunk c on exit;
// dS = e^{lw_end} dS + C_c from the last chunk, starting at ds_final or 0.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT_PASS)
    rwkv6_bwd_scan_kernel(const float* __restrict__ ew,
                          const float* __restrict__ dsfin,
                          float* __restrict__ dstates,
                          float* __restrict__ ds0, int64_t BH, int64_t NC) {
  constexpr int64_t DD = D * D;
  const int64_t idx = (int64_t)blockIdx.x * NT_PASS + threadIdx.x;
  if (idx >= BH * DD) return;
  const int64_t bh = idx / DD, ij = idx - bh * DD;
  const float s = dsfin ? dsfin[idx] : 0.f;
  const float s_first = scan_walk<D, true>(dstates + bh * NC * DD + ij,
                                           ew + bh * NC * D + ij / D, s, NC);
  if (ds0) ds0[idx] = s_first;
}

// ---------------------------------------------------------------------------
// backward pass 3: every chunk's gradients, one CTA of NT_CHUNK threads per
// (b*h, chunk)
// ---------------------------------------------------------------------------
// [D, D] tiles unpadded, row i's 16-byte chunk jc stored as chunk
// jc ^ (i / 4 mod D / 4): the rows 4q + e that the lanes q read at one
// column fall in distinct bank groups, and a row read along its chunks is
// only permuted
template <int D>
__device__ __forceinline__ int swz(int i, int jc) {
  return i * D + ((jc ^ ((i >> 2) & (D / 4 - 1))) << 2);
}

template <int D>
struct ChunkSmem {
  static constexpr int LD = D + 4;   // [T, D] rows (16-byte cp.async)
  static constexpr int LA = T + 4;   // [T, T] rows
  static constexpr int NS = 2 * D * D > 4 * T * D ? 2 * D * D : 4 * T * D;
  // staged r, k, w, v, do; r, k and w become rd, kd and (through log w,
  // lw_inc) ke, and then X, G and P; do becomes du's terms and v w again
  float r[T][LD], k[T][LD], w[T][LD], v[T][LD], g[T][LD];
  union {
    float s[NS];                // S_in, then dS_out, swizzled [D, D] each
    float out[4][T * D];        // after the products: dvs, dke, drd, dkd
  } st;
  union {
    float lexc[T * D];          // lw_exc, until the exponentials
    struct {
      float a[T][LA], da[T][LA];     // A and the strict dA
    } m;
    float dvv[T * D];           // after the products: A^T do
  } tt;
  float e_exc[T * D], e_inc[T * D], e_end[T * D];
  float u[D], lend[D], ew[D], sdot[D], diag[T], ddiag[T];
};

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float* acc, float x, const float4& y) {
  acc[0] = fmaf(x, y.x, acc[0]);
  acc[1] = fmaf(x, y.y, acc[1]);
  acc[2] = fmaf(x, y.z, acc[2]);
  acc[3] = fmaf(x, y.w, acc[3]);
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y,
                                      float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// The triangles' products, summed over s in order from s_begin (a
// multiple of 4) below s_end: acc[m][.] += x(t0 + m, s) y[s][i0 .. i0+3],
// y rows of a [T, LY] tile; x a [T, T + 4] tile read along its rows,
// x(t, s) = x[t][s] (rows_product), or down its columns, x(t, s) = x[s][t]
// (cols_of_product)
template <int PM, int LY>
__device__ __forceinline__ void rows_product(float (&acc)[PM][4],
                                             const float (*x)[T + 4],
                                             const float* y, int t0, int i0,
                                             int s_begin, int s_end) {
  for (int s4 = s_begin; s4 < s_end; s4 += 4) {
    float4 x4[PM];
#pragma unroll
    for (int m = 0; m < PM; ++m) x4[m] = ld4(&x[t0 + m][s4]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 ys = ld4(y + (s4 + e) * LY + i0);
#pragma unroll
      for (int m = 0; m < PM; ++m) fma4(acc[m], lane4(x4[m], e), ys);
    }
  }
}

template <int PM, int LY>
__device__ __forceinline__ void cols_of_product(float (&acc)[PM][4],
                                                const float (*x)[T + 4],
                                                const float* y, int t0,
                                                int i0, int s_begin,
                                                int s_end) {
  static_assert(PM == 2 || PM == 4, "a thread's rows: one 8- or 16-byte load");
  for (int s = s_begin; s < s_end; ++s) {
    float xs[PM];
    if constexpr (PM == 4) {
      const float4 x4 = ld4(&x[s][t0]);
      xs[0] = x4.x; xs[1] = x4.y; xs[2] = x4.z; xs[3] = x4.w;
    } else {
      const float2 x2 = *reinterpret_cast<const float2*>(&x[s][t0]);
      xs[0] = x2.x; xs[1] = x2.y;
    }
    const float4 ys = ld4(y + s * LY + i0);
#pragma unroll
    for (int m = 0; m < PM; ++m) fma4(acc[m], xs[m], ys);
  }
}

// acc[m][e] += sum over j of x[t0 + m][j] S[i0 + e][j], j in order: x rows
// of a [T, D + 4] tile, S a swizzled [D, D] tile
template <int D, int PM>
__device__ __forceinline__ void cols_product(float (&acc)[PM][4],
                                             const float (*x)[D + 4],
                                             const float* s, int t0, int i0) {
  for (int jc = 0; jc < D / 4; ++jc) {
    float4 x4[PM];
#pragma unroll
    for (int m = 0; m < PM; ++m) x4[m] = ld4(&x[t0 + m][jc * 4]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 se = ld4(&s[swz<D>(i0 + e, jc)]);
#pragma unroll
      for (int m = 0; m < PM; ++m) acc[m][e] = dot4(x4[m], se, acc[m][e]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT_CHUNK, 2)
    rwkv6_bwd_chunk_kernel(
        const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ states,
        const float* __restrict__ dstates, const float* __restrict__ dout,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dw,
        float* __restrict__ du_part, int64_t S, int64_t H, int64_t NC) {
  using Sm = ChunkSmem<D>;
  constexpr int V4 = D / 4, DD = D * D;
  // elementwise steps: a thread owns TM rows from t0, 4 columns from i0
  constexpr int TM = T * V4 / NT_CHUNK;
  // products: each half of the CTA owns PM rows from pt0, 4 columns from pi0
  constexpr int PM = 2 * TM;
  static_assert(TM >= 1 && T * V4 == TM * NT_CHUNK, "[T, D] ownership");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / NC, c = blockIdx.x - bh * NC;
  const int64_t b = bh / H, h = bh - b * H;
  const int i0 = (tid % V4) * 4, t0 = (tid / V4) * TM;
  float* sin = sm.st.s;
  float* dso = sm.st.s + DD;

  // 0. stage the chunk (a ragged end as the plain version pads it), S_in
  //    and dS_out
  for (int idx = tid; idx < T * V4; idx += NT_CHUNK) {
    const int t = idx / V4, q = (idx % V4) * 4;
    const int64_t tt = c * T + t;
    if (tt < S) {
      const int64_t o = row_of(b, tt, h, S, H, D) + q;
      copy16(&sm.r[t][q], r + o);
      copy16(&sm.k[t][q], k + o);
      copy16(&sm.w[t][q], w + o);
      copy16(&sm.v[t][q], v + o);
      copy16(&sm.g[t][q], dout + o);
    } else {
      fill4(&sm.r[t][q], 0.f);
      fill4(&sm.k[t][q], 0.f);
      fill4(&sm.w[t][q], 1.f);
      fill4(&sm.v[t][q], 0.f);
      fill4(&sm.g[t][q], 0.f);
    }
  }
  const int64_t sb = (bh * NC + c) * DD;
  for (int idx = tid; idx < D * V4; idx += NT_CHUNK) {
    const int i = idx / V4, jc = idx % V4;
    copy16(&sin[swz<D>(i, jc)], states + sb + i * D + jc * 4);
    copy16(&dso[swz<D>(i, jc)], dstates + sb + i * D + jc * 4);
  }
  commit();
  if (tid < D) sm.u[tid] = u[h * D + tid];
  wait_pending<0>();
  __syncthreads();

  // 1. (a) log w in place, every thread
  for (int idx = tid; idx < T * D; idx += NT_CHUNK) {
    const int t = idx / D, i = idx % D;
    sm.w[t][i] = logf(fmaxf(sm.w[t][i], 1e-30f));
  }
  __syncthreads();

  // 1. (b) lw_inc in place and lw_exc, one channel a thread; beside them
  //    sum_j S_in dS_out per row and A's diagonal sum_kk r u k, one row a
  //    thread, each summed in order
  if (tid < D) {
    float inc = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float lw = sm.w[t][tid];
      inc = inc + lw;
      sm.w[t][tid] = inc;
      sm.tt.lexc[t * D + tid] = inc - lw;
    }
    sm.lend[tid] = inc;
    sm.ew[tid] = expf(inc);
  } else if (tid < 2 * D) {
    const int i = tid - D;
    float x = 0.f;
#pragma unroll
    for (int jc = 0; jc < V4; ++jc)
      x = dot4(ld4(&sin[swz<D>(i, jc)]), ld4(&dso[swz<D>(i, jc)]), x);
    sm.sdot[i] = x;
  } else if (tid < 2 * D + T) {
    const int m = tid - 2 * D;
    float x = 0.f;
#pragma unroll
    for (int q = 0; q < D; q += 4) {
      const float4 ra = ld4(&sm.r[m][q]), ka = ld4(&sm.k[m][q]);
      const float4 ua = ld4(&sm.u[q]);
      x = fmaf(ra.x, ua.x * ka.x, x);
      x = fmaf(ra.y, ua.y * ka.y, x);
      x = fmaf(ra.z, ua.z * ka.z, x);
      x = fmaf(ra.w, ua.w * ka.w, x);
    }
    sm.diag[m] = x;
  }
  __syncthreads();

  // 1. (c) e^{lw_exc}, e^{-lw_inc}, e^{lw_end - lw_inc}, and rd, kd, ke in
  //    place of r, k and lw_inc, elementwise
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + m, o = t * D + i0;
    const float4 ra = ld4(&sm.r[t][i0]), ka = ld4(&sm.k[t][i0]);
    const float4 li = ld4(&sm.w[t][i0]), le = ld4(&sm.tt.lexc[o]);
    float ex[4], ei[4], en[4], rd4[4], kd4[4], ke4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ex[e] = expf(lane4(le, e));
      ei[e] = expf(-lane4(li, e));
      en[e] = expf(sm.lend[i0 + e] - lane4(li, e));
      rd4[e] = lane4(ra, e) * ex[e];
      kd4[e] = lane4(ka, e) * ei[e];
      ke4[e] = lane4(ka, e) * en[e];
    }
    st4(&sm.e_exc[o], ex);
    st4(&sm.e_inc[o], ei);
    st4(&sm.e_end[o], en);
    st4(&sm.r[t][i0], rd4);
    st4(&sm.k[t][i0], kd4);
    st4(&sm.w[t][i0], ke4);
  }
  __syncthreads();

  // 2. A = strict_lower(rd kd^T) + diag (threads 0..127) and dA =
  //    strict_lower(do v^T) with ddiag_t = do_t . v_t (128..255): a thread
  //    owns rows m0, m0 + 1 and the columns nl + 8 j, each summed over the
  //    channels in order; a tile wholly above the diagonal is zero
  {
    const bool first = tid < NT_CHUNK / 2;
    const int tt = tid % (NT_CHUNK / 2);
    const int m0 = (tt / 8) * 2, nl = tt % 8;
    float (*x)[Sm::LD] = first ? sm.r : sm.g;
    float (*y)[Sm::LD] = first ? sm.k : sm.v;
    float acc[2][4] = {};
    if (nl <= m0 + 1) {
      for (int q = 0; q < D; q += 4) {
        const float4 x0 = ld4(&x[m0][q]), x1 = ld4(&x[m0 + 1][q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 yj = ld4(&y[nl + 8 * j][q]);
          acc[0][j] = dot4(x0, yj, acc[0][j]);
          acc[1][j] = dot4(x1, yj, acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + mi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nl + 8 * j;
        const float lower = n < m ? acc[mi][j] : 0.f;
        if (first) {
          sm.tt.m.a[m][n] = n == m ? sm.diag[m] : lower;
        } else {
          sm.tt.m.da[m][n] = lower;
          if (n == m) sm.ddiag[m] = acc[mi][j];
        }
      }
    }
  }
  __syncthreads();

  const bool first = tid < NT_CHUNK / 2;
  const int pt = tid % (NT_CHUNK / 2);
  const int pi0 = (pt % V4) * 4, pt0 = (pt / V4) * PM;
  float p0[PM][4] = {}, p1[PM][4] = {}, p2[PM][4] = {};

  // 3. the products, each summed in the plain order (zero terms of the
  //    triangles' padding added where a 4-wide step overhangs), split
  //    between the CTA's halves: threads 0..127 ke dS_out and v dS_out^T,
  //    128..255 dA kd + do S_in^T, dA^T rd and A^T do; a thread owns PM
  //    rows x 4 columns of each
  if (first) {
    // dvs = ke dS_out over i
    for (int q = 0; q < D; q += 4) {
      float4 ke4[PM];
#pragma unroll
      for (int m = 0; m < PM; ++m) ke4[m] = ld4(&sm.w[pt0 + m][q]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 ds = ld4(&dso[swz<D>(q + e, pi0 / 4)]);
#pragma unroll
        for (int m = 0; m < PM; ++m) fma4(p0[m], lane4(ke4[m], e), ds);
      }
    }
    // dke = v dS_out^T over j
    cols_product<D, PM>(p1, sm.v, dso, pt0, pi0);
  } else {
    // drd = dA kd (over s < t) + do S_in^T (over j)
    rows_product<PM, Sm::LD>(p0, sm.tt.m.da, &sm.k[0][0], pt0, pi0, 0,
                             pt0 + PM - 1);
    cols_product<D, PM>(p1, sm.g, sin, pt0, pi0);
#pragma unroll
    for (int m = 0; m < PM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p0[m][e] = p0[m][e] + p1[m][e];
        p1[m][e] = 0.f;
      }
    // dkd = dA^T rd (over s > t)
    cols_of_product<PM, Sm::LD>(p1, sm.tt.m.da, &sm.r[0][0], pt0, pi0,
                                pt0 + 1, T);
    // dvv = A^T do (over s >= t)
    cols_of_product<PM, Sm::LD>(p2, sm.tt.m.a, &sm.g[0][0], pt0, pi0, pt0,
                                T);
  }
  __syncthreads();
  // over the dead S_in and dS_out: dvs, dke (first half), drd, dkd (second
  // half); A^T do over the dead [T, T] tiles
  {
    float* o0 = sm.st.out[first ? 0 : 2];
    float* o1 = sm.st.out[first ? 1 : 3];
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int o = (pt0 + m) * D + pi0;
      st4(o0 + o, p0[m]);
      st4(o1 + o, p1[m]);
      if (!first) st4(sm.tt.dvv + o, p2[m]);
    }
  }
  __syncthreads();

  // 3. (b) the owner's gradients dv, dr, dk, elementwise, and X = drd rd,
  //    G = X - dkd kd - P, P = dke ke, du's terms and w in place of rd,
  //    kd, ke, do and v
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + m;
    const int64_t tt = c * T + t;
    const bool valid = tt < S;
    const int64_t row = valid ? row_of(b, tt, h, S, H, D) + i0 : 0;
    const int o = t * D + i0;
    const float4 rd = ld4(&sm.r[t][i0]), kd = ld4(&sm.k[t][i0]);
    const float4 ke = ld4(&sm.w[t][i0]);
    const float4 ex = ld4(&sm.e_exc[o]), ei = ld4(&sm.e_inc[o]);
    const float4 en = ld4(&sm.e_end[o]);
    const float4 dvs = ld4(&sm.st.out[0][o]), dke = ld4(&sm.st.out[1][o]);
    const float4 drd = ld4(&sm.st.out[2][o]), dkd = ld4(&sm.st.out[3][o]);
    const float4 dvv = ld4(&sm.tt.dvv[o]);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 r4 = valid ? ld4(r + row) : zero;
    const float4 k4 = valid ? ld4(k + row) : zero;
    const float4 w4 = valid ? ld4(w + row) : make_float4(1.f, 1.f, 1.f, 1.f);
    const float dd = sm.ddiag[t];
    float gv[4], gr[4], gk[4], xo[4], go[4], po[4], uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float e_exc = lane4(ex, e), e_inc = lane4(ei, e);
      const float e_end = lane4(en, e);
      const float gu = dd * sm.u[i0 + e];
      const float rr = lane4(r4, e), kk = lane4(k4, e);
      gv[e] = lane4(dvv, e) + lane4(dvs, e);
      gr[e] = lane4(drd, e) * e_exc + gu * kk;
      gk[e] = lane4(dkd, e) * e_inc + lane4(dke, e) * e_end + gu * rr;
      xo[e] = lane4(drd, e) * lane4(rd, e);
      po[e] = lane4(dke, e) * lane4(ke, e);
      go[e] = xo[e] - lane4(dkd, e) * lane4(kd, e) - po[e];
      uo[e] = dd * rr * kk;
    }
    if (valid) {
      st4(dv + row, gv);
      st4(dr + row, gr);
      st4(dk + row, gk);
    }
    st4(&sm.r[t][i0], xo);
    st4(&sm.k[t][i0], go);
    st4(&sm.w[t][i0], po);
    st4(&sm.g[t][i0], uo);
    *reinterpret_cast<float4*>(&sm.v[t][i0]) = w4;
  }
  __syncthreads();

  // 4. per channel: the log-decay gradients back through the cumulative
  //    sums, and this chunk's share of du
  if (tid < D) {
    const int i = tid;
    float pe = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) pe = pe + sm.w[t][i];
    const float dlw_end = pe + sm.ew[i] * sm.sdot[i];
    float acc = 0.f;
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      acc = acc + sm.k[t][i];
      const int64_t tt = c * T + t;
      if (tt < S) {
        const float dlogw = acc + dlw_end - sm.r[t][i];
        const float wv = sm.v[t][i];
        dw[row_of(b, tt, h, S, H, D) + i] = wv > 1e-30f ? dlogw / wv : 0.f;
      }
    }
  } else if (tid < 2 * D) {
    const int i = tid - D;
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) x = x + sm.g[t][i];
    du_part[(bh * NC + c) * D + i] = x;
  }
}

// backward pass 4: du [H, D] = sum over batch and chunks in that order, one
// thread per (h, i), DU_AHEAD loads in flight ahead of the adds
__global__ void __launch_bounds__(64)
    rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                        float* __restrict__ du, int64_t B, int64_t H,
                        int64_t NC, int D) {
  const int64_t h = blockIdx.x;
  const int i = threadIdx.x;
  float x = 0.f;
  for (int64_t b = 0; b < B; ++b) {
    const float* p = du_part + (b * H + h) * NC * D + i;
    int64_t c0 = 0;
    for (; c0 + DU_AHEAD <= NC; c0 += DU_AHEAD) {
      float y[DU_AHEAD];
#pragma unroll
      for (int q = 0; q < DU_AHEAD; ++q) y[q] = p[(c0 + q) * D];
#pragma unroll
      for (int q = 0; q < DU_AHEAD; ++q) x = x + y[q];
    }
    for (; c0 < NC; ++c0) x = x + p[c0 * D];
  }
  du[h * D + i] = x;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
int fwd(const float* r, const float* k, const float* v, const float* w,
        const float* u, const float* s0, float* o, float* sfin,
        float* states, float* ew, long long B, long long S, long long H,
        cudaStream_t stream) {
  const long long NC = (S + T - 1) / T, BH = B * H;
  if (BH * NC > 0x7fffffffLL) return -1;
  cudaError_t e;
  if (NC > 0) {
    const size_t smem1 = sizeof(StateSmem<D>);
    e = set_smem(rwkv6_fwd_state_kernel<D>, smem1);
    if (e != cudaSuccess) return (int)e;
    rwkv6_fwd_state_kernel<D><<<(unsigned)(BH * NC), NT_PASS, smem1,
                                stream>>>(k, v, w, states, ew, S, H, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = BH * D * D;
  rwkv6_fwd_scan_kernel<D><<<(unsigned)((n + NT_PASS - 1) / NT_PASS),
                             NT_PASS, 0, stream>>>(ew, s0, states, sfin, BH,
                                                   NC);
  e = cudaGetLastError();
  if (e != cudaSuccess || NC == 0) return (int)e;
  const size_t smem3 = sizeof(FwdOutSmem<D>);
  e = set_smem(rwkv6_fwd_out_kernel<D>, smem3);
  if (e != cudaSuccess) return (int)e;
  rwkv6_fwd_out_kernel<D><<<(unsigned)(BH * NC), NT_PASS, smem3, stream>>>(
      r, k, v, w, u, states, o, S, H, NC);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const float* r, const float* k, const float* v, const float* w,
        const float* u, const float* states, const float* dout,
        const float* dsfin, float* dr, float* dk, float* dv, float* dw,
        float* du, float* ds0, float* dstates, float* ew, float* du_part,
        long long B, long long S, long long H, cudaStream_t stream) {
  const long long NC = (S + T - 1) / T, BH = B * H;
  if (BH * NC > 0x7fffffffLL) return -1;
  cudaError_t e;
  if (NC > 0) {
    const size_t smem1 = sizeof(StateSmem<D>);
    e = set_smem(rwkv6_bwd_state_kernel<D>, smem1);
    if (e != cudaSuccess) return (int)e;
    rwkv6_bwd_state_kernel<D><<<(unsigned)(BH * NC), NT_PASS, smem1,
                                stream>>>(r, dout, w, dstates, ew, S, H, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = BH * D * D;
  rwkv6_bwd_scan_kernel<D><<<(unsigned)((n + NT_PASS - 1) / NT_PASS),
                             NT_PASS, 0, stream>>>(ew, dsfin, dstates, ds0,
                                                   BH, NC);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (NC > 0) {
    const size_t smem3 = sizeof(ChunkSmem<D>);
    e = set_smem(rwkv6_bwd_chunk_kernel<D>, smem3);
    if (e != cudaSuccess) return (int)e;
    rwkv6_bwd_chunk_kernel<D><<<(unsigned)(BH * NC), NT_CHUNK, smem3,
                                stream>>>(r, k, v, w, u, states, dstates,
                                          dout, dr, dk, dv, dw, du_part, S,
                                          H, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rwkv6_bwd_du_kernel<<<(unsigned)H, D, 0, stream>>>(du_part, du, B, H, NC,
                                                      D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every array is contiguous f32
// and 16-byte aligned.  s0 may be null (zero initial state); the forward
// always writes the chunk-start states [B, H, NC, D, D] (they are its scan's
// scratch too) and ew [B, H, NC, D] is scratch.  In the backward dsfin may
// be null (no cotangent on the final state) and ds0 null (no gradient for
// s0); dstates [B, H, NC, D, D] and du_part [B, H, NC, D] are scratch.
// Returns a cudaError_t, or -1 for a head size other than 32 or 64 or too
// many chunks.
extern "C" int rwkv6_fwd_f32(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             float* o, float* sfin, float* states, float* ew,
                             long long B, long long S, long long H,
                             long long D, int device, void* stream) {
  if (B * H <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return fwd<64>(r, k, v, w, u, s0, o, sfin, states, ew, B, S, H, st);
  if (D == 32)
    return fwd<32>(r, k, v, w, u, s0, o, sfin, states, ew, B, S, H, st);
  return -1;
}

extern "C" int rwkv6_bwd_f32(const float* r, const float* k, const float* v,
                             const float* w, const float* u,
                             const float* states, const float* dout,
                             const float* dsfin, float* dr, float* dk,
                             float* dv, float* dw, float* du, float* ds0,
                             float* dstates, float* ew, float* du_part,
                             long long B, long long S, long long H,
                             long long D, int device, void* stream) {
  if (B * H <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return bwd<64>(r, k, v, w, u, states, dout, dsfin, dr, dk, dv, dw, du,
                   ds0, dstates, ew, du_part, B, S, H, st);
  if (D == 32)
    return bwd<32>(r, k, v, w, u, states, dout, dsfin, dr, dk, dv, dw, du,
                   ds0, dstates, ew, du_part, B, S, H, st);
  return -1;
}
