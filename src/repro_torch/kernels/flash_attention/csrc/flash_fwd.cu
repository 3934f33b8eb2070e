// Blockwise online-softmax attention forward for Hopper (sm_90a) on the
// CUDA cores, f32 inputs (bf16 inputs go to the tensor-core kernel of
// flash_fwd_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _attn_kernel).  Same function: GQA through
// kv head h / (H / KVH), causal and sliding-window masks with the fully
// masked kv blocks skipped by the loop bounds (kernel.py:53-59), logit
// softcap c * tanh(s / c), output divided by max(l, 1e-30).  Unlike the
// Pallas kernel it also writes lse = m + log(max(l, 1e-30)) per row, which
// the recompute backward (ops.py, a port of flash.py::_global_bwd /
// _local_bwd) reads, and it masks ragged Sq/Sk instead of asserting that
// they tile.
//
// Input type: like the Pallas kernel, which loads any dtype to f32,
// accumulates in f32 and writes q's dtype (kernel.py:63-65, :150), the
// kernel is a template on the input type; it is instantiated for f32 only.
// It stays on the CUDA cores: TF32 tensor cores would break the f32
// paths' 1e-4 agreement with the plain version.
//
// Scale: q is multiplied by sm_scale = 1/sqrt(D) while it is staged, as
// the Pallas kernel does (kernel.py:63); the JAX blockwise path divides by
// sqrt(D) (flash.py:88).  For D = 256 the two are the same number; for
// other D they differ by at most one rounding of each q element, far
// inside the kernel's stated tolerance.
//
// What bounds it on the H100: arithmetic.  Per (query, key) pair the
// kernel does 2*D multiply-adds (scores, then P.V) against 4*D bytes of
// K/V that are re-read once per 64-row query block; at Sq = 8192 that is
// about 32 flops per byte of K/V traffic from L2/HBM.  This first version
// runs those products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), not
// on the tensor cores, so the FMA pipe is the ceiling.  Design:
//   * one CTA per (64 query rows, head, batch); the kv-block loop inside
//     the CTA replaces the Pallas grid's sequential kv axis, and its
//     bounds skip blocks that are wholly above the diagonal or left of
//     the window;
//   * Q (pre-scaled), K and V tiles and the 64x64 score tile live in
//     dynamic shared memory (211 KB at D = 256, above the 48 KB static
//     limit, so the launcher raises cudaFuncAttributeMaxDynamicSharedMemorySize);
//     Q/K rows are padded by 4 floats so the float4 reads of 8 rows hit
//     32 distinct banks;
//   * the running max and sum of a row live in registers of the four
//     threads that own the row in the softmax phase; the output
//     accumulator (BQ x D f32) is spread over the 256 threads' registers
//     (64 floats each at D = 256);
//   * masked scores are -inf inside the kernel, so they contribute
//     exactly 0 to the sums (the Pallas kernel's -1e30 gives the same
//     result for every row that has one visible key).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BK = 64;    // keys per kv block
constexpr int NT = 256;   // threads per CTA (4 per query row in the softmax phase)
constexpr int QKPAD = 4;  // float pad per Q/K tile row (keeps float4 alignment)
constexpr int SPAD = 1;   // float pad per score-tile row
constexpr float NEG = -1e30f;

static_assert(NT == 4 * BQ, "softmax phase maps four threads to a row");

// four consecutive elements of a row
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 y) {
  *reinterpret_cast<float4*>(p) = y;
}

template <int D>
struct Tile {
  static constexpr int QS = D + QKPAD;  // Q/K row stride (floats)
  static constexpr int SS = BK + SPAD;  // score row stride (floats)
  static constexpr int D4 = D / 4;
  // output accumulator mapping: TPR threads share a row group, each
  // owning CJ float4 column chunks of RI rows
  static constexpr int TPR = D4 < 32 ? D4 : 32;
  static constexpr int CJ = D4 / TPR;
  static constexpr int RG = NT / TPR;
  static constexpr int RI = BQ / RG;
  static constexpr size_t floats = (size_t)BQ * QS + (size_t)BK * QS +
                                   (size_t)BK * D + (size_t)BQ * SS + 2 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int D, typename T>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int H, int KVH, int Sq, int Sk, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, int causal, int window, float softcap, float sm_scale) {
  using TL = Tile<D>;
  constexpr int QS = TL::QS, SS = TL::SS, D4 = TL::D4;
  constexpr int TPR = TL::TPR, CJ = TL::CJ, RG = TL::RG, RI = TL::RI;
  constexpr int TX = BK / 4;       // score micro-tile: 4x4 per thread
  constexpr int TY = NT / TX;
  constexpr int RS = BQ / TY;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* Ks = Qs + BQ * QS;                     // [BK][QS]
  float* Vs = Ks + BK * QS;                     // [BK][D]
  float* Ss = Vs + BK * D;                      // [BQ][SS]
  float* alpha_s = Ss + BQ * SS;                // [BQ]
  float* l_s = alpha_s + BQ;                    // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  // stage Q, pre-scaled; rows past Sq are zero and never stored
  for (int i = tid; i < BQ * D4; i += NT) {
    const int r = i / D4, c = i % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qb + (int64_t)(q0 + r) * qss + 4 * c);
      x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
    }
    *reinterpret_cast<float4*>(Qs + r * QS + 4 * c) = x;
  }

  // kv blocks this query block can see (structural skip)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kb_lo = k_lo / BK;
  const int kb_hi = k_hi > 0 ? (k_hi + BK - 1) / BK : 0;

  const int ty = tid / TX, tx = tid % TX;       // score phase
  const int srow = tid >> 2, spart = tid & 3;   // softmax phase
  const int rg = tid / TPR, lc = tid % TPR;     // P.V phase

  float m_r = NEG, l_r = 0.f;
  float4 acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();  // the previous block's readers of Ks/Vs/Ss are done
    for (int i = tid; i < BK * D4; i += NT) {
      const int r = i / D4, c = i % D4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Sk) {
        kx = load4(kb + (int64_t)(k0 + r) * kss + 4 * c);
        vx = load4(vb + (int64_t)(k0 + r) * vss + 4 * c);
      }
      *reinterpret_cast<float4*>(Ks + r * QS + 4 * c) = kx;
      *reinterpret_cast<float4*>(Vs + r * D + 4 * c) = vx;
    }
    __syncthreads();

    // scores: rows ty + TY*i, keys tx + TX*j
    float s[RS][4];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 qv[RS], kv[4];
#pragma unroll
      for (int i = 0; i < RS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * QS + 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * QS + 4 * d4);
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + TY * i, c = tx + TX * j;
        const int qp = q0 + r, kp = k0 + c;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        Ss[r * SS + c] = ok ? x : -INFINITY;
      }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      float* row = Ss + srow * SS + spart * (BK / 4);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float p = expf(row[c] - m_new);  // masked: exp(-inf) = 0
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_r - m_new);
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if (spart == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float a = alpha_s[rg + RG * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        acc[i][j].x *= a; acc[i][j].y *= a; acc[i][j].z *= a; acc[i][j].w *= a;
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 vv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        vv[j] = *reinterpret_cast<const float4*>(Vs + kk * D + 4 * (lc + TPR * j));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ss[(rg + RG * i) * SS + kk];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc[i][j].x = fmaf(p, vv[j].x, acc[i][j].x);
          acc[i][j].y = fmaf(p, vv[j].y, acc[i][j].y);
          acc[i][j].z = fmaf(p, vv[j].z, acc[i][j].z);
          acc[i][j].w = fmaf(p, vv[j].w, acc[i][j].w);
        }
      }
    }
  }

  // finalize: out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
  if (spart == 0) {
    const float l = fmaxf(l_r, 1e-30f);
    l_s[srow] = l;
    if (q0 + srow < Sq)
      lse[((int64_t)b * H + h) * Sq + q0 + srow] = m_r + logf(l);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = rg + RG * i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
    T* orow = o + b * osb + (int64_t)(q0 + r) * oss + h * osh;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      float4 y = acc[i][j];
      y.x = y.x / l; y.y = y.y / l; y.z = y.z / l; y.w = y.w / l;
      store4(orow + 4 * (lc + TPR * j), y);
    }
  }
}

template <int D, typename T>
int launch(const T* q, const T* k, const T* v, T* o,
           float* lse, int B, int H, int KVH, int Sq, int Sk, int64_t qsb,
           int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
           int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
           int64_t osh, int causal, int window, float softcap,
           float sm_scale, cudaStream_t stream) {
  const int smem = (int)Tile<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(
      q, k, v, o, lse, H, KVH, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, vsb,
      vss, vsh, osb, oss, osh, causal, window, softcap, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, float* lse, int B,
             int H, int KVH, int Sq, int Sk, int D, long long qsb,
             long long qss, long long qsh, long long ksb, long long kss,
             long long ksh, long long vsb, long long vss, long long vsh,
             long long osb, long long oss, long long osh, int causal,
             int window, float softcap, float sm_scale, int device,
             void* stream) {
  // this library carries its own (static) CUDA runtime: select the
  // tensors' device before touching the function attribute or launching
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FLASH_CASE(DD)                                                       \
  case DD:                                                                   \
    return launch<DD, T>(q, k, v, o, lse, B, H, KVH, Sq, Sk, qsb, qss, qsh,  \
                         ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,        \
                         causal, window, softcap, sm_scale, st);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return -1;
  }
#undef FLASH_CASE
}

}  // namespace

// Plain C entry point (bound with ctypes) for f32 inputs.  Strides
// are in elements; the last (head-dim) stride must be 1 and every row
// aligned to four elements (the Python wrapper checks both); `stream` is
// a stream of `device`.  Returns a cudaError_t, or -1 for an unsupported
// head dim.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      float* lse, int B, int H, int KVH, int Sq, int Sk,     \
                      int D, long long qsb, long long qss, long long qsh,    \
                      long long ksb, long long kss, long long ksh,           \
                      long long vsb, long long vss, long long vsh,           \
                      long long osb, long long oss, long long osh,           \
                      int causal, int window, float softcap, float sm_scale, \
                      int device, void* stream) {                            \
    return dispatch<T>(static_cast<const T*>(q), static_cast<const T*>(k),   \
                       static_cast<const T*>(v), static_cast<T*>(o), lse, B, \
                       H, KVH, Sq, Sk, D, qsb, qss, qsh, ksb, kss, ksh, vsb, \
                       vss, vsh, osb, oss, osh, causal, window, softcap,     \
                       sm_scale, device, stream);                            \
  }
FLASH_ENTRY(flash_fwd_f32, float)
#undef FLASH_ENTRY
