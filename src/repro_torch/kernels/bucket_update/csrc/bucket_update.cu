// Fused AdamW / SGD-momentum update over one flat f32 bucket buffer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bucket_update/kernel.py::
// bucket_update_pallas (body _update_kernel).  Same function, same
// expression order as its plain version (ref.py::bucket_update_ref and
// the port's bucket_update_ref):
//   ghat = (g * gs) * clip
//   AdamW: m' = b1*m + (1-b1)*ghat;  v' = b2*v + ((1-b2)*ghat)*ghat
//          u  = (m'/bc1) / (sqrt(v'/bc2) + eps)
//   SGD:   m' = mu*m + ghat;  u = m'
//   u += wd*p (when decayed);  p' = p - (lr*sc)*u
// Elements at or past n_valid keep p/m/v; with zero_grads the gradient
// buffer is zeroed in the same pass.  Scalars [gs, clip, lr, bc1, bc2]
// are read from device memory (the global-norm clip is computed on the
// device and never synchronised to the host).  (sc, wd) come as kernel
// arguments for a uniform bucket, else as per-element arrays.
//
// Bit-exactness: every operation is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so
// nvcc cannot contract a multiply and an add into an FMA; the unit is also
// compiled with --fmad=false.  The result is bitwise equal to the plain
// PyTorch version on the card, whose elementwise kernels round each
// operation separately.  (1-b1) and (1-b2) arrive precomputed on the host
// in double and rounded to f32, as JAX and PyTorch both do with a Python
// float constant.
//
// What bounds it on the H100: bytes.  AdamW reads p, m, v, g and writes
// p, m, v (and g when zeroing): 28-32 bytes per element against ~15
// flops, far below the card's ~20 flops per byte of HBM bandwidth, so the
// floor is bytes / 3.35 TB/s.  Design: one launch per bucket, a
// grid-stride loop of 16-byte (float4) loads and stores with neighbouring
// threads on neighbouring addresses, no shared memory, and the tail mask
// computed from the element index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float sc, wd;          // uniform lr scale / weight decay
  int has_wd;            // apply u += wd*p (uniform: wd != 0; arrays: always)
  int adam;              // AdamW, else SGD-momentum
  float b1, c1, b2, c2;  // beta1, 1-beta1, beta2, 1-beta2
  float eps, momentum;
  int zero_grads;
};

__device__ __forceinline__ void update_one(float& p, float& m, float& v,
                                           float g, float sc, float wd,
                                           const Hyper& hp, float gs,
                                           float clip, float lr, float bc1,
                                           float bc2) {
  const float gh = __fmul_rn(__fmul_rn(g, gs), clip);
  float u, mn, vn = v;
  if (hp.adam) {
    mn = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.c1, gh));
    vn = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(__fmul_rn(hp.c2, gh), gh));
    u = __fdiv_rn(__fdiv_rn(mn, bc1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), hp.eps));
  } else {
    mn = __fadd_rn(__fmul_rn(hp.momentum, m), gh);
    u = mn;
  }
  if (hp.has_wd) u = __fadd_rn(u, __fmul_rn(wd, p));
  p = __fsub_rn(p, __fmul_rn(__fmul_rn(lr, sc), u));
  m = mn;
  v = vn;
}

__global__ void bucket_update_kernel(float* __restrict__ p,
                                     float* __restrict__ m,
                                     float* __restrict__ v,
                                     float* __restrict__ g,
                                     const float* __restrict__ sc_arr,
                                     const float* __restrict__ wd_arr,
                                     const float* __restrict__ scalars,
                                     int64_t n4, int64_t n_valid, Hyper hp) {
  const float gs = scalars[0], clip = scalars[1], lr = scalars[2];
  const float bc1 = scalars[3], bc2 = scalars[4];
  const bool elem = sc_arr != nullptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 p4 = reinterpret_cast<float4*>(p)[i];
    float4 m4 = reinterpret_cast<float4*>(m)[i];
    float4 v4 = hp.adam ? reinterpret_cast<float4*>(v)[i]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    float4 sc4 = make_float4(hp.sc, hp.sc, hp.sc, hp.sc);
    float4 wd4 = make_float4(hp.wd, hp.wd, hp.wd, hp.wd);
    if (elem) {
      sc4 = reinterpret_cast<const float4*>(sc_arr)[i];
      wd4 = reinterpret_cast<const float4*>(wd_arr)[i];
    }
    float pp[4] = {p4.x, p4.y, p4.z, p4.w};
    float mm[4] = {m4.x, m4.y, m4.z, m4.w};
    float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
    const float ss[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const float ww[4] = {wd4.x, wd4.y, wd4.z, wd4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * i + e < n_valid)  // the padded tail keeps p/m/v
        update_one(pp[e], mm[e], vv[e], gg[e], ss[e], ww[e], hp, gs, clip,
                   lr, bc1, bc2);
    }
    reinterpret_cast<float4*>(p)[i] = make_float4(pp[0], pp[1], pp[2], pp[3]);
    reinterpret_cast<float4*>(m)[i] = make_float4(mm[0], mm[1], mm[2], mm[3]);
    if (hp.adam)
      reinterpret_cast<float4*>(v)[i] = make_float4(vv[0], vv[1], vv[2], vv[3]);
    if (hp.zero_grads)
      reinterpret_cast<float4*>(g)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All buffers are f32 of
// `padded` elements (a multiple of 4, 16-byte aligned; the Python wrapper
// checks); v is null for SGD, sc_arr/wd_arr are null for a uniform
// bucket; scalars points at 5 f32 on the device.  Returns a cudaError_t.
extern "C" int bucket_update_f32(float* p, float* m, float* v, float* g,
                                 const float* sc_arr, const float* wd_arr,
                                 const float* scalars, long long padded,
                                 long long n_valid, float sc, float wd,
                                 int has_wd, int adam, float b1, float c1,
                                 float b2, float c2, float eps,
                                 float momentum, int zero_grads,
                                 int max_blocks, int device, void* stream) {
  if (padded <= 0) return 0;
  // this library carries its own (static) CUDA runtime: select the
  // buffers' device before launching on a stream of it
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Hyper hp{sc, wd, has_wd, adam, b1, c1, b2, c2, eps, momentum, zero_grads};
  const int64_t n4 = padded / 4;
  const int threads = 256;
  int64_t blocks = (n4 + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  bucket_update_kernel<<<(unsigned)blocks, threads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      p, m, v, g, sc_arr, wd_arr, scalars, n4, n_valid, hp);
  return (int)cudaGetLastError();
}
