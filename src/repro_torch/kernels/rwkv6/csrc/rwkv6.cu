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
// results are bitwise equal on the card (the chunk-start states and S_final
// at every shape tested, dr and dk at the path's shape); A's diagonal and
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
// Backward.  The state cotangent is column-separable: column j of dS needs
// only do[:, j].  So backward pass 1 runs one CTA per (b*h, group of CW = 16
// value columns), walks the chunks in reverse with its [D, 16] slice of dS
// in registers, staging the next chunk with cp.async, and writes every
// chunk's dS_out (and ds0).  With S_in and dS_out of every chunk in memory,
// the rest needs no sequence order: pass 2 runs one CTA per (b*h, chunk) —
// 8,192 at the path's shape — recomputes the chunk's decays and A, and
// writes dr, dk, dv, dw and the chunk's partial du (summed over the value
// columns inside the CTA, so no partials cross CTAs); pass 3 sums du over
// batch and chunks in a fixed order.
//
// What bounds it on the H100, at the path's [1, 8192, 32, 64] f32:
//   forward: bytes 20 B an element of r, k, v, w, o (335.5 MB, 0.100 ms at
//   3.35 TB/s; with the states 469.8 MB, 0.140 ms); operations 786,432 per
//   (b, h, chunk) x 256 chunks x 32 heads = 6.44 GFLOP, 0.096 ms at 67
//   TFLOP/s f32: bound 0.140 ms, by bytes.  Backward: 36 B an element (read
//   r, k, v, w, do; write dr, dk, dv, dw) plus the states, 738 MB, 0.220 ms;
//   1,703,936 flops per (b, h, chunk), 13.96 GFLOP, 0.208 ms: bound 0.220
//   ms, by bytes.  The forward's own traffic is more than its bound's:
//   pass 1 reads k, v, w and writes dS (0.34 GB), the scan reads and
//   rewrites the states (0.27 GB), pass 3 reads r, k, v, w and the states
//   and writes o (0.47 GB): 1.08 GB, 0.32 ms at 3.35 TB/s, 2.3x the bound's
//   bytes, for 8,192-way parallelism in the chunk passes.  Shared-memory
//   tiles have padded row strides (no bank conflicts).  No tensor cores:
//   TF32 or wgmma would change the numerics, and at 13.7 flop a byte the
//   forward is below the f32 CUDA-core ridge anyway.  The backward's pass 1
//   is still a chain of small dependent products, its loads hidden by
//   cp.async staging.
//
// Numerical domain (the reference's own, not guarded in either package):
// e^{-lw_inc} overflows f32 once 32 |log w| passes ~88.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;        // chunk length (the TPU kernel's default)
constexpr int CW = 16;       // value columns of S a backward-scan CTA owns
constexpr int NT_SCAN = 128; // threads of a backward-scan CTA
constexpr int NT_CHUNK = 256;  // threads of a backward-chunk CTA
constexpr int NT_PASS = 256;   // threads of a forward CTA
constexpr int SCAN_AHEAD = 8;  // chunks a forward-scan thread loads ahead

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

// one channel's decays over a chunk: rd, kd, ke (rows of stride ld) and
// e^{lw_end}; lw_inc kept in registers between the two passes
template <int LDS, int LD>
__device__ __forceinline__ void chunk_decays(
    const float* r, const float* k, const float* w, int i, float* rd,
    float* kd, float* ke, float* linc_out, float* ew) {
  float linc[T];
  float inc = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float lw = logf(fmaxf(w[t * LDS + i], 1e-30f));
    inc = inc + lw;
    linc[t] = inc;
    const float exc = inc - lw;
    if (rd) rd[t * LD + i] = r[t * LDS + i] * expf(exc);
    if (kd) kd[t * LD + i] = k[t * LDS + i] * expf(-inc);
    if (linc_out) linc_out[t * LD + i] = inc;
  }
  ew[i] = expf(inc);
  if (ke) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      ke[t * LD + i] = k[t * LDS + i] * expf(inc - linc[t]);
  }
}

// ---------------------------------------------------------------------------
// forward pass 1: every chunk's state contribution, one CTA per (b*h, chunk)
// ---------------------------------------------------------------------------
template <int D>
struct FwdStateSmem {
  static constexpr int LD = D + 4;   // 16-byte rows, read along a row only
  float k[T][LD], v[T][LD], w[T][LD];   // k becomes ke, w lw_inc in place
};

// dS_c = ke^T v [D, D] into states[c] and e^{lw_end} into ew[c]
template <int D>
__global__ void __launch_bounds__(NT_PASS, 3)
    rwkv6_fwd_state_kernel(const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ w,
                           float* __restrict__ states, float* __restrict__ ew,
                           int64_t S, int64_t H, int64_t NC) {
  using Sm = FwdStateSmem<D>;
  constexpr int LD = Sm::LD, V4 = D / 4;
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
      copy16(&sm.k[t][q], k + g);
      copy16(&sm.v[t][q], v + g);
      copy16(&sm.w[t][q], w + g);
    } else {
      fill4(&sm.k[t][q], 0.f);
      fill4(&sm.v[t][q], 0.f);
      fill4(&sm.w[t][q], 1.f);
    }
  }
  commit();
  wait_pending<0>();
  __syncthreads();
  // the decays as chunk_decays computes them, with only the cumulative sum
  // left to one thread a channel: log w, then lw_inc in order, then
  // ke = k e^{lw_end - lw_inc} and e^{lw_end}
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.w[t][i] = logf(fmaxf(sm.w[t][i], 1e-30f));
  }
  __syncthreads();
  if (tid < D) {
    float inc = 0.f;
    for (int t = 0; t < T; ++t) {
      inc = inc + sm.w[t][tid];
      sm.w[t][tid] = inc;
    }
    ew[(bh * NC + c) * D + tid] = expf(inc);
  }
  __syncthreads();
  for (int idx = tid; idx < T * D; idx += NT_PASS) {
    const int t = idx / D, i = idx % D;
    sm.k[t][i] = sm.k[t][i] * expf(sm.w[T - 1][i] - sm.w[t][i]);
  }
  __syncthreads();

  // RI rows x 4 columns a thread, each summed over t in order
  const int jq = (tid % V4) * 4, i0 = (tid / V4) * RI;
  float acc[RI][4] = {};
  for (int t = 0; t < T; ++t) {
    const float4 vv = *reinterpret_cast<const float4*>(&sm.v[t][jq]);
    float x4[RI];
    if constexpr (RI == 4) {
      const float4 kq = *reinterpret_cast<const float4*>(&sm.k[t][i0]);
      x4[0] = kq.x; x4[1] = kq.y; x4[2] = kq.z; x4[3] = kq.w;
    } else {
#pragma unroll
      for (int ri = 0; ri < RI; ++ri) x4[ri] = sm.k[t][i0 + ri];
    }
#pragma unroll
    for (int ri = 0; ri < RI; ++ri) {
      const float x = x4[ri];
      acc[ri][0] = fmaf(x, vv.x, acc[ri][0]);
      acc[ri][1] = fmaf(x, vv.y, acc[ri][1]);
      acc[ri][2] = fmaf(x, vv.z, acc[ri][2]);
      acc[ri][3] = fmaf(x, vv.w, acc[ri][3]);
    }
  }
  float* dst = states + ((bh * NC + c) * D + i0) * D + jq;
#pragma unroll
  for (int ri = 0; ri < RI; ++ri)
    *reinterpret_cast<float4*>(dst + ri * D) =
        make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
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
  float* st = states + bh * NC * DD + ij;             // chunk c: st[c * DD]
  const float* e = ew + bh * NC * D + ij / D;         // chunk c: e[c * D]
  float s = s0 ? s0[idx] : 0.f;
  // a ring of SCAN_AHEAD chunks' loads in flight ahead of the chain
  float dn[SCAN_AHEAD] = {}, en[SCAN_AHEAD] = {};
#pragma unroll
  for (int q = 0; q < SCAN_AHEAD; ++q) {
    if (q < NC) {
      dn[q] = st[q * DD];
      en[q] = e[q * D];
    }
  }
  for (int64_t c0 = 0; c0 < NC; c0 += SCAN_AHEAD) {
    float d[SCAN_AHEAD], x[SCAN_AHEAD];
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      d[q] = dn[q];
      x[q] = en[q];
    }
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int64_t c = c0 + SCAN_AHEAD + q;
      if (c < NC) {
        dn[q] = st[c * DD];
        en[q] = e[c * D];
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int64_t c = c0 + q;
      if (c < NC) {
        st[c * DD] = s;
        s = x[q] * s + d[q];
      }
    }
  }
  sfin[idx] = s;
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

  // 1. the decays as chunk_decays computes them, with only the cumulative
  //    sum left to one thread a channel: log w in place
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
// backward pass 1: the reverse state-cotangent scan, grid (B*H, D/CW)
// ---------------------------------------------------------------------------
template <int D>
struct ScanSmem {
  static constexpr int LDS = D + 4, LD = D + 1;
  float r[2][T][LDS], w[2][T][LDS];
  float g[2][T][CW];      // do, this CTA's columns
  float rd[T][LD];
  float ew[D];
};

template <int D>
__global__ void __launch_bounds__(NT_SCAN)
    rwkv6_bwd_scan_kernel(const float* __restrict__ r,
                          const float* __restrict__ w,
                          const float* __restrict__ dout,
                          const float* __restrict__ dsfin,
                          float* __restrict__ dstates,
                          float* __restrict__ ds0, int64_t S, int64_t H) {
  using Sm = ScanSmem<D>;
  constexpr int LDS = Sm::LDS, LD = Sm::LD;
  constexpr int E = CW * D / NT_SCAN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j0 = blockIdx.y * CW;
  const int64_t NC = (S + T - 1) / T;

  auto issue = [&](int64_t c) {
    const int st = (int)(c & 1);
    constexpr int V4 = D / 4;
    for (int idx = tid; idx < T * V4; idx += NT_SCAN) {
      const int t = idx / V4, q = (idx % V4) * 4;
      const int64_t tt = c * T + t;
      if (tt < S) {
        const int64_t g = row_of(b, tt, h, S, H, D) + q;
        copy16(&sm.r[st][t][q], r + g);
        copy16(&sm.w[st][t][q], w + g);
      } else {
        fill4(&sm.r[st][t][q], 0.f);
        fill4(&sm.w[st][t][q], 1.f);
      }
    }
    for (int idx = tid; idx < T * (CW / 4); idx += NT_SCAN) {
      const int t = idx / (CW / 4), q = (idx % (CW / 4)) * 4;
      const int64_t tt = c * T + t;
      if (tt < S)
        copy16(&sm.g[st][t][q], dout + row_of(b, tt, h, S, H, D) + j0 + q);
      else
        fill4(&sm.g[st][t][q], 0.f);
    }
  };

  const int si = tid / (CW / E), sj = (tid % (CW / E)) * E;
  const int64_t sbase = (bh * D + si) * D + j0 + sj;
  float ds[E];
#pragma unroll
  for (int e = 0; e < E; ++e) ds[e] = dsfin ? dsfin[sbase + e] : 0.f;

  if (NC > 0) issue(NC - 1);
  commit();
  for (int64_t c = NC - 1; c >= 0; --c) {
    const int st = (int)(c & 1);
    if (c > 0) issue(c - 1);
    commit();
    wait_pending<1>();
    __syncthreads();
    if (tid < D)
      chunk_decays<LDS, LD>(&sm.r[st][0][0], nullptr, &sm.w[st][0][0], tid,
                            &sm.rd[0][0], nullptr, nullptr, nullptr, sm.ew);
    __syncthreads();
    // dS_out of chunk c is the carry; dS_in = rd^T do + e^{lw_end} dS_out
    float* dst = dstates + ((bh * NC + c) * D + si) * D + j0 + sj;
    float acc[E] = {};
    for (int t = 0; t < T; ++t) {
      const float x = sm.rd[t][si];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(x, sm.g[st][t][sj + e], acc[e]);
    }
    const float ew = sm.ew[si];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[e] = ds[e];
      ds[e] = acc[e] + ew * ds[e];
    }
    __syncthreads();
  }
  if (ds0) {
#pragma unroll
    for (int e = 0; e < E; ++e) ds0[sbase + e] = ds[e];
  }
}

// ---------------------------------------------------------------------------
// backward pass 2: every chunk's gradients, grid (B*H, NC), NT_CHUNK threads
// ---------------------------------------------------------------------------
template <int D>
struct ChunkSmem {
  static constexpr int LD = D + 1;   // every row odd-strided
  float r[T][LD], k[T][LD], v[T][LD], w[T][LD], g[T][LD];   // g = do
  float sin[D][LD], dso[D][LD];
  float rd[T][LD], kd[T][LD], ke[T][LD], linc[T][LD];
  float a[T][T + 1], da[T][T + 1];
  float G[T][LD], X[T][LD], P[T][LD];
  float ddiag[T], u[D], ew[D], sdot[D];
};

template <int D>
__global__ void __launch_bounds__(NT_CHUNK)
    rwkv6_bwd_chunk_kernel(
        const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ states,
        const float* __restrict__ dstates, const float* __restrict__ dout,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dw,
        float* __restrict__ du_part, int64_t S, int64_t H) {
  using Sm = ChunkSmem<D>;
  constexpr int LD = Sm::LD;
  constexpr int V4 = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int64_t c = blockIdx.y;
  const int64_t NC = gridDim.y;

  // 0. load the chunk (float4 from global into odd-strided rows)
  for (int idx = tid; idx < T * V4; idx += NT_CHUNK) {
    const int t = idx / V4, q = (idx % V4) * 4;
    const int64_t tt = c * T + t;
    float4 xr = make_float4(0.f, 0.f, 0.f, 0.f), xk = xr, xv = xr, xg = xr;
    float4 xw = make_float4(1.f, 1.f, 1.f, 1.f);
    if (tt < S) {
      const int64_t o = row_of(b, tt, h, S, H, D) + q;
      xr = *reinterpret_cast<const float4*>(r + o);
      xk = *reinterpret_cast<const float4*>(k + o);
      xv = *reinterpret_cast<const float4*>(v + o);
      xw = *reinterpret_cast<const float4*>(w + o);
      xg = *reinterpret_cast<const float4*>(dout + o);
    }
    const float4* src[5] = {&xr, &xk, &xv, &xw, &xg};
    float* dst[5] = {&sm.r[t][q], &sm.k[t][q], &sm.v[t][q], &sm.w[t][q],
                     &sm.g[t][q]};
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      dst[a][0] = src[a]->x; dst[a][1] = src[a]->y;
      dst[a][2] = src[a]->z; dst[a][3] = src[a]->w;
    }
  }
  const int64_t sb = (bh * NC + c) * D * D;
  for (int idx = tid; idx < D * V4; idx += NT_CHUNK) {
    const int i = idx / V4, q = (idx % V4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(states + sb + i * D + q);
    const float4 y = *reinterpret_cast<const float4*>(dstates + sb + i * D + q);
    sm.sin[i][q] = x.x; sm.sin[i][q + 1] = x.y;
    sm.sin[i][q + 2] = x.z; sm.sin[i][q + 3] = x.w;
    sm.dso[i][q] = y.x; sm.dso[i][q + 1] = y.y;
    sm.dso[i][q + 2] = y.z; sm.dso[i][q + 3] = y.w;
  }
  if (tid < D) sm.u[tid] = u[h * D + tid];
  __syncthreads();

  // 1. decays (one channel a thread); sum_j S_in dS_out per row; do_t . v_t
  if (tid < D) {
    chunk_decays<LD, LD>(&sm.r[0][0], &sm.k[0][0], &sm.w[0][0], tid,
                         &sm.rd[0][0], &sm.kd[0][0], &sm.ke[0][0],
                         &sm.linc[0][0], sm.ew);
  } else if (tid < 2 * D) {
    const int i = tid - D;
    float x = 0.f;
    for (int j = 0; j < D; ++j) x = fmaf(sm.sin[i][j], sm.dso[i][j], x);
    sm.sdot[i] = x;
  } else if (tid < 2 * D + T) {
    const int t = tid - 2 * D;
    float x = 0.f;
    for (int j = 0; j < D; ++j) x = fmaf(sm.g[t][j], sm.v[t][j], x);
    sm.ddiag[t] = x;
  }
  __syncthreads();

  // 2. A (threads 0..127) and the strict dA (128..255), 2 x 4 tiles
  {
    const bool first = tid < 128;
    const int tt = first ? tid : tid - 128;
    const int m0 = (tt / 8) * 2, n0 = (tt % 8) * 4;
    float acc[2][4] = {};
    if (n0 < m0 + 1) {
      for (int kk = 0; kk < D; ++kk) {
        const float a0 = first ? sm.rd[m0][kk] : sm.g[m0][kk];
        const float a1 = first ? sm.rd[m0 + 1][kk] : sm.g[m0 + 1][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bj = first ? sm.kd[n0 + j][kk] : sm.v[n0 + j][kk];
          acc[0][j] = fmaf(a0, bj, acc[0][j]);
          acc[1][j] = fmaf(a1, bj, acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + mi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j;
        float x = 0.f;
        if (n < m) {
          x = acc[mi][j];
        } else if (n == m && first) {
          for (int kk = 0; kk < D; ++kk)
            x = fmaf(sm.r[m][kk], sm.u[kk] * sm.k[m][kk], x);
        }
        if (first) sm.a[m][n] = x;
        else sm.da[m][n] = x;
      }
    }
  }
  __syncthreads();

  // 3. per (t, i): dv, drd, dkd, dke and what follows from them.  A thread
  //    owns TM rows and 4 columns strided by D/4.
  {
    constexpr int TM = T * D / (NT_CHUNK * 4);
    const int q = tid % V4, m0 = (tid / V4) * TM;
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) {
      const int t = m0 + mi;
      float dvv[4] = {}, dvs[4] = {}, drd_a[4] = {}, drd_s[4] = {};
      float dkd[4] = {}, dke[4] = {};
      for (int s = t; s < T; ++s) {            // A^T do
        const float x = sm.a[s][t];
#pragma unroll
        for (int e = 0; e < 4; ++e) dvv[e] = fmaf(x, sm.g[s][q + e * V4], dvv[e]);
      }
      for (int i = 0; i < D; ++i) {            // ke dS_out
        const float x = sm.ke[t][i];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dvs[e] = fmaf(x, sm.dso[i][q + e * V4], dvs[e]);
      }
      for (int s = 0; s < t; ++s) {            // dA kd
        const float x = sm.da[t][s];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          drd_a[e] = fmaf(x, sm.kd[s][q + e * V4], drd_a[e]);
      }
      for (int j = 0; j < D; ++j) {            // do S_in^T, v dS_out^T
        const float x = sm.g[t][j], y = sm.v[t][j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          drd_s[e] = fmaf(x, sm.sin[q + e * V4][j], drd_s[e]);
          dke[e] = fmaf(y, sm.dso[q + e * V4][j], dke[e]);
        }
      }
      for (int s = t + 1; s < T; ++s) {        // dA^T rd
        const float x = sm.da[s][t];
#pragma unroll
        for (int e = 0; e < 4; ++e) dkd[e] = fmaf(x, sm.rd[s][q + e * V4], dkd[e]);
      }
      const int64_t tt = c * T + t;
      const bool valid = tt < S;
      const int64_t row = valid ? row_of(b, tt, h, S, H, D) : 0;
      const float dd = sm.ddiag[t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q + e * V4;
        const float lw = logf(fmaxf(sm.w[t][i], 1e-30f));
        const float li = sm.linc[t][i];
        const float e_exc = expf(li - lw);
        const float e_inc = expf(-li);
        const float e_end = expf(sm.linc[T - 1][i] - li);
        const float drd = drd_a[e] + drd_s[e];
        const float gu = dd * sm.u[i];
        const float x = drd * sm.rd[t][i];
        const float p = dke[e] * sm.ke[t][i];
        sm.X[t][i] = x;
        sm.P[t][i] = p;
        sm.G[t][i] = x - dkd[e] * sm.kd[t][i] - p;
        if (valid) {
          dv[row + i] = dvv[e] + dvs[e];
          dr[row + i] = drd * e_exc + gu * sm.k[t][i];
          dk[row + i] = dkd[e] * e_inc + dke[e] * e_end + gu * sm.r[t][i];
        }
      }
    }
  }
  __syncthreads();

  // 4. per channel: log-decay gradients back through the cumulative sums;
  //    this chunk's share of du
  if (tid < D) {
    const int i = tid;
    float pe = 0.f;
    for (int t = 0; t < T; ++t) pe = pe + sm.P[t][i];
    const float dlw_end = pe + sm.ew[i] * sm.sdot[i];
    float acc = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      acc = acc + sm.G[t][i];
      const int64_t tt = c * T + t;
      if (tt < S) {
        const float wv = sm.w[t][i];
        const float dlogw = acc + dlw_end - sm.X[t][i];
        dw[row_of(b, tt, h, S, H, D) + i] = wv > 1e-30f ? dlogw / wv : 0.f;
      }
    }
  } else if (tid < 2 * D) {
    const int i = tid - D;
    float x = 0.f;
    for (int t = 0; t < T; ++t) x = x + sm.ddiag[t] * sm.r[t][i] * sm.k[t][i];
    du_part[(bh * NC + c) * D + i] = x;
  }
}

// backward pass 3: du [H, D] = sum over batch and chunks, grid H, D threads
__global__ void rwkv6_du_kernel(const float* __restrict__ du_part,
                                float* __restrict__ du, int64_t B, int64_t H,
                                int64_t NC, int D) {
  const int64_t h = blockIdx.x;
  const int i = threadIdx.x;
  float x = 0.f;
  for (int64_t b = 0; b < B; ++b)
    for (int64_t c = 0; c < NC; ++c)
      x = x + du_part[(((b * H + h) * NC) + c) * D + i];
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
    const size_t smem1 = sizeof(FwdStateSmem<D>);
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
        float* du, float* ds0, float* dstates, float* du_part, long long B,
        long long S, long long H, cudaStream_t stream) {
  const long long NC = (S + T - 1) / T;
  if (NC == 0) return 0;
  const size_t smem1 = sizeof(ScanSmem<D>);
  cudaError_t e = set_smem(rwkv6_bwd_scan_kernel<D>, smem1);
  if (e != cudaSuccess) return (int)e;
  rwkv6_bwd_scan_kernel<D><<<dim3((unsigned)(B * H), D / CW), NT_SCAN, smem1,
                             stream>>>(r, w, dout, dsfin, dstates, ds0, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = sizeof(ChunkSmem<D>);
  e = set_smem(rwkv6_bwd_chunk_kernel<D>, smem2);
  if (e != cudaSuccess) return (int)e;
  rwkv6_bwd_chunk_kernel<D><<<dim3((unsigned)(B * H), (unsigned)NC),
                              NT_CHUNK, smem2, stream>>>(
      r, k, v, w, u, states, dstates, dout, dr, dk, dv, dw, du_part, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rwkv6_du_kernel<<<(unsigned)H, D, 0, stream>>>(du_part, du, B, H, NC, D);
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
                             float* dstates, float* du_part, long long B,
                             long long S, long long H, long long D,
                             int device, void* stream) {
  if (B * H <= 0) return 0;
  if ((S + T - 1) / T > 65535) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return bwd<64>(r, k, v, w, u, states, dout, dsfin, dr, dk, dv, dw, du,
                   ds0, dstates, du_part, B, S, H, st);
  if (D == 32)
    return bwd<32>(r, k, v, w, u, states, dout, dsfin, dr, dk, dv, dw, du,
                   ds0, dstates, du_part, B, S, H, st);
  return -1;
}
