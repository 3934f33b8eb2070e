// Wire-precision casts of the flat buckets for Hopper (sm_90a): blockwise
// int8 quantize, its dequantize, and seeded stochastic rounding to bf16.
//
// Replaces the three TPU kernels of src/repro/kernels/quantize/kernel.py:
//   * quantize_int8_pallas (body _quant_int8_kernel): per 128-lane row,
//     absmax over the row with the tail idx >= n_valid zeroed first;
//     scale = absmax * f32(1/127), or 1 where absmax > 0 is false (an
//     all-zero row, or a NaN in the row); q = clip(round(x / scale), +-127)
//     with round half to even.  A NaN quotient converts to 0, as XLA's
//     convert does.
//   * dequantize_int8_pallas (body _dequant_int8_kernel): f32(q) *
//     scale[row], tail zeroed.
//   * stochastic_round_bf16_pallas (body _sr_bf16_kernel): r = fmix32(
//     idx + seed * 0x9E3779B9) & 0xFFFF over the GLOBAL flat element index
//     (with a `seg` table, the element's position in the bucket that table
//     maps: a model rank's shards hashed at their places in JAX's global
//     bucket, seg_row / hash_pos);
//     bf16 = top 16 bits of (bits(x) + r) & 0xFFFF0000; tail zeroed.  The
//     low half is zero after the mask, so taking the top half is the exact
//     f32 -> bf16 value (a NaN keeps the payload the mask leaves).
// The per-row scales come back as f32[rows] (the Pallas kernel broadcasts
// them over a (rows, 128) tile only because a (rows, 1) block is not a
// legal TPU tile).  Given `scale_in` (f32[rows], non-null), quantize uses
// those scales and reduces no row: ranks that agreed the scales of the
// rows they share beforehand then quantize those rows alike.
//
// Bit-exactness with the plain versions (ops.py, ports of ref.py): the
// division is __fdiv_rn (IEEE, never a reciprocal), rounding is rintf
// (half to even under the default mode), the row absmax is a max and so
// exact in any reduction order, NaN-propagating like jnp.max / torch.amax,
// the constant is (float)(1.0 / 127.0) as JAX rounds it, and the unit is
// compiled with --fmad=false.  The hash is plain uint32 arithmetic.
//
// What bounds them on the H100: bytes.  Quantize reads 4 B and writes
// 1 B + 4 B/128 per element; dequantize reads 1 B + 4 B/128 and writes
// 4 B; stochastic rounding reads 4 B and writes 2 B.  Each does a handful
// of integer or float operations per element, far below the card's ~20
// operations per byte of HBM bandwidth, so the floor is bytes / 3.35 TB/s.
// Design: one launch per bucket, grid-stride loops with 16-byte f32 loads
// and neighbouring threads on neighbouring addresses.  Quantize maps one
// warp to one 128-element row (four elements a lane, one float4 load) and
// reduces the absmax with five xor-shuffles, so the row never touches
// shared memory.  The seed is read from device memory, so the
// (step, bucket) seed of a bf16sr update never synchronises to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0x85EBCA6Bu;
constexpr uint32_t M2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t seed) {
  uint32_t x = idx + seed * GOLDEN;
  x = x ^ (x >> 16);
  x = x * M1;
  x = x ^ (x >> 13);
  x = x * M2;
  x = x ^ (x >> 16);
  return x;
}

// max that lets a NaN operand win (jnp.max / torch.amax semantics)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ signed char to_int8(float x, float scale) {
  float t = rintf(__fdiv_rn(x, scale));
  if (t != t) return 0;
  t = fminf(fmaxf(t, -127.f), 127.f);
  return (signed char)__float2int_rz(t);
}

// The position the hash reads for element e = base + g of a buffer laid
// out as a `seg` table (ops.py's HashIndex): (start, inner, position,
// stride) rows sorted by start; in the last row with start <= e, j = e -
// start, position + (j / inner) * stride + j % inner, modulo `modulus`
// when it is not 0.  `row` is that row, found by seg_row.  j and inner are
// below 2^31, so the division is 32-bit.
__device__ __forceinline__ int seg_row(const long long* __restrict__ seg,
                                       int n_seg, long long e) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(seg + 4 * mid) <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ uint32_t hash_pos(const long long* __restrict__ seg,
                                             int n_seg, int& row,
                                             long long e, long long modulus) {
  while (row + 1 < n_seg && __ldg(seg + 4 * (row + 1)) <= e) ++row;
  const long long* s = seg + 4 * row;
  const uint32_t j = (uint32_t)(e - __ldg(s));
  const uint32_t inner = (uint32_t)__ldg(s + 1);
  long long p = __ldg(s + 2) + (long long)(j / inner) * __ldg(s + 3)
                + (long long)(j % inner);
  if (modulus) p %= modulus;
  return (uint32_t)p;
}

__device__ __forceinline__ uint32_t sr_top(float x, uint32_t idx,
                                           uint32_t seed, long long gi,
                                           long long n_valid) {
  const uint32_t r = hash_u32(idx, seed) & 0xFFFFu;
  const uint32_t rounded = (__float_as_uint(x) + r) & 0xFFFF0000u;
  return gi < n_valid ? (rounded >> 16) : 0u;
}

__global__ void __launch_bounds__(NT) sr_bf16_kernel(
    const float4* __restrict__ x, uint2* __restrict__ out,
    const long long* __restrict__ seed_p, const long long* __restrict__ seg,
    int n_seg, long long base, long long modulus, long long n4,
    long long n_valid) {
  const uint32_t seed = (uint32_t)(unsigned long long)seed_p[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = x[i];
    const long long g = 4 * i;
    uint32_t idx[4] = {(uint32_t)g, (uint32_t)g + 1, (uint32_t)g + 2,
                       (uint32_t)g + 3};
    if (seg != nullptr) {  // one search for the four, then step forward
      int row = seg_row(seg, n_seg, base + g);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        idx[k] = hash_pos(seg, n_seg, row, base + g + k, modulus);
    }
    const uint32_t h0 = sr_top(v.x, idx[0], seed, g, n_valid);
    const uint32_t h1 = sr_top(v.y, idx[1], seed, g + 1, n_valid);
    const uint32_t h2 = sr_top(v.z, idx[2], seed, g + 2, n_valid);
    const uint32_t h3 = sr_top(v.w, idx[3], seed, g + 3, n_valid);
    out[i] = make_uint2(h0 | (h1 << 16), h2 | (h3 << 16));
  }
}

__global__ void __launch_bounds__(NT) quant_int8_kernel(
    const float4* __restrict__ x, const float* __restrict__ scale_in,
    char4* __restrict__ q, float* __restrict__ scale, long long rows,
    long long n_valid) {
  const float inv127 = (float)(1.0 / 127.0);
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < rows; r += n_warps) {
    const long long i4 = r * 32 + lane;
    const long long g = 4 * i4;
    float4 v = x[i4];
    if (g >= n_valid) v.x = 0.f;
    if (g + 1 >= n_valid) v.y = 0.f;
    if (g + 2 >= n_valid) v.z = 0.f;
    if (g + 3 >= n_valid) v.w = 0.f;
    float s;
    if (scale_in != nullptr) {  // supplied (agreed) scales: no reduction
      s = scale_in[r];
    } else {
      float m = nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                        nan_max(fabsf(v.z), fabsf(v.w)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
      s = m > 0.f ? __fmul_rn(m, inv127) : 1.f;
      if (lane == 0) scale[r] = s;
    }
    q[i4] = make_char4(to_int8(v.x, s), to_int8(v.y, s), to_int8(v.z, s),
                       to_int8(v.w, s));
  }
}

__global__ void __launch_bounds__(NT) dequant_int8_kernel(
    const char4* __restrict__ q, const float* __restrict__ scale,
    float4* __restrict__ out, long long n4, long long n_valid) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const char4 c = q[i];
    const float s = scale[i >> 5];  // 32 groups of four per 128-lane row
    const long long g = 4 * i;
    float4 y;
    y.x = g < n_valid ? __fmul_rn((float)c.x, s) : 0.f;
    y.y = g + 1 < n_valid ? __fmul_rn((float)c.y, s) : 0.f;
    y.z = g + 2 < n_valid ? __fmul_rn((float)c.z, s) : 0.f;
    y.w = g + 3 < n_valid ? __fmul_rn((float)c.w, s) : 0.f;
    out[i] = y;
  }
}

int grid_for(long long threads, int max_blocks) {
  long long b = (threads + NT - 1) / NT;
  if (b > max_blocks) b = max_blocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

// Plain C entry points (bound with ctypes).  `n` is the padded buffer
// length, a multiple of 128; every pointer is 16-byte aligned (the Python
// wrappers check both; `seg` and `scale_in` may be null); `stream` is a
// stream of `device`.  Each returns a cudaError_t.  `out` of dequantize
// may alias nothing but itself; the quantize -> dequantize round trip may
// write `out` over `x`.
extern "C" int sr_bf16(const float* x, void* out, const long long* seed,
                       const long long* seg, int n_seg, long long base,
                       long long modulus, long long n, long long n_valid,
                       int max_blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n4 = n / 4;
  sr_bf16_kernel<<<grid_for(n4, max_blocks), NT, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint2*>(out),
      seed, seg, n_seg, base, modulus, n4, n_valid);
  return (int)cudaGetLastError();
}

extern "C" int quantize_int8(const float* x, const float* scale_in,
                             signed char* q, float* scale, long long n,
                             long long n_valid, int max_blocks, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long rows = n / 128;
  quant_int8_kernel<<<grid_for(rows * 32, max_blocks), NT, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), scale_in,
      reinterpret_cast<char4*>(q), scale, rows, n_valid);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_int8(const signed char* q, const float* scale,
                               float* out, long long n, long long n_valid,
                               int max_blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n4 = n / 4;
  dequant_int8_kernel<<<grid_for(n4, max_blocks), NT, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char4*>(q), scale, reinterpret_cast<float4*>(out),
      n4, n_valid);
  return (int)cudaGetLastError();
}
