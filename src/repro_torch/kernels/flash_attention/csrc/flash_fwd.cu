// Online-softmax attention forward on f32 inputs for Hopper (sm_90a): both
// products on the TF32 tensor cores in split form (3xTF32), so the result
// keeps f32 accuracy.  bf16 inputs go to flash_fwd_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _attn_kernel) for f32 q/k/v, and computes at
// a value head dim DV other than the query/key head dim DQK (MLA: 192 / 128)
// what src/repro/kernels/flash_attention/flash.py::_global_fwd_impl computes,
// which the Pallas kernel cannot.  Same function:
// GQA through kv head h / (H / KVH), causal and sliding-window masks
// (kp > qp - window) with the kv blocks wholly above the diagonal or left of
// the window skipped by the loop bounds (kernel.py:53-59), logit softcap
// c * tanh(s / c), q scaled by sm_scale = 1/sqrt(DQK) (kernel.py:63), masked
// scores -inf with the running max starting at the finite -1e30, and
// out = acc / max(l, 1e-30).  It also writes lse = m + log(max(l, 1e-30))
// per row in f32, which the recompute backward (ops.py) reads, and it masks
// ragged Sq and Sk instead of asserting that they tile.
//
// Numerics.  A single TF32 product (10 explicit mantissa bits) moves out by
// about 1.5e-3 and fails the f32 paths' 1e-4 agreement with the plain
// version.  Every operand x is therefore split into hi = tf32_rna(x) and
// lo = tf32_rna(x - hi) (the subtraction is exact), so x = hi + lo to about
// 2^-22 relative, and each product a.b runs as three TF32 wgmmas,
// a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, in f32 accumulators (the dropped
// a_lo.b_lo is about 2^-22 of a.b).  With f32 FMAs in place of the tensor
// cores this arithmetic keeps the f32 training paths within their limits
// of the plain run.  The tensor cores, though, accumulate with truncation:
// with O as the accumulator of every key's P.V (up to 3 x 1024 k8 steps at
// S = 8192) out moved by 7.7e-6 and gemma2-2b's params by 5.6e-4 from the
// plain run (limit 1e-4).  So no accumulator runs long: P.V sums afresh per
// stage and joins O through an fma (below), and for S the small terms sum
// apart from hi.hi and join it on the CUDA cores.  Softcap, the online
// softmax and the final division stay f32 on the CUDA cores: the softmax in
// the exp2 domain, the cap as c * tanhf(s * (1 / c)).  tanh as
// 1 - 2 / (1 + 2^(2x log2 e)) loses digits to cancellation at the small
// x = s / c of a cap of 50 (2.6e-6 more lse error); tanh.approx is never
// used.  PERF.md has the readings.
//
// What bounds it on the H100: arithmetic on the tensor cores.  The function
// needs 2 * (DQK + DV) flops per visible (query, key) pair (4 D when square), at 495 TFLOP/s TF32 the
// bound chip_smoke.py reports; the split form issues three times as many,
// so it cannot come nearer than a third of that bound.  Every 64-row
// query block also reads the hi and lo of K and V from L2, 1 KiB * D per 64
// keys (48 flops a byte): 17.3 GB at gemma2-2b's global layer.  Measured
// (PERF.md): a build that skips the ring's refills is within 1% of this
// one, while one without the wgmmas streams the same bytes in half the
// time, so L2 is not the limit.  The pace is set by the one warpgroup's
// serial chain, S's wgmmas, the softmax on the CUDA cores and P.V's wgmmas,
// with the tensor cores idle during the softmax.  At D = 256 Q's hi and lo
// take 128 KiB of shared memory, so a second warpgroup with 64 rows of its
// own does not fit, and 254 registers are in use, so a second S or P.V
// accumulator does not either; a second warpgroup on the same rows, taking
// every other kv block through a ring of its own, is not tried.
// Design:
//   * a split pass (flash_split_kernel) writes, once per call, K and V as
//     hi and lo into one scratch buffer, in 64-key blocks laid out exactly as
//     the main kernel's shared-memory stages (128-byte swizzle), zero past
//     Sk: K as [keys][DQK] (K-major, DQK contiguous), V transposed as
//     [DV][keys]
//     with the keys of each group of 8 stored as (0, 2, 4, 6, 1, 3, 5, 7).
//     TF32 wgmma takes only K-major operands, so P.V needs V's keys
//     contiguous; the permutation lets the S accumulator, whose thread holds
//     columns 2t and 2t + 1 of each 8-key group, serve as the register A
//     operand of P.V, which wants columns t and t + 4.  Each K/V element is
//     read by every query block and head of its kv head, so it is split once.
//     Measured (PERF.md, scripts/flash_f32_revisions.py --cuts): bringing
//     raw f32 stages (half the bytes) and splitting them in shared memory
//     costs 1.55x this kernel's time when the consumers split and 2.5x when
//     the producer warp does, even without V's transpose;
//   * the main kernel (flash_fwd_tf32_kernel): one CTA per (64 query rows,
//     head, batch), one consumer warpgroup and one producer warp.  The
//     consumers load Q, scale it, split it into hi and lo and store both in
//     shared memory in the swizzle (128 KiB at D = 256).  The producer's lane
//     0 streams the visible kv blocks' stages (a stage is the hi and lo of
//     64 keys x DC d-columns of K, or of DC d-rows x 64 keys of V, DC =
//     min(DQK, DV, 64): 32 KiB at DC 64; DQK / DC K stages and DV / DC V
//     stages a kv block, so every stage of the ring has one size)
//     into a ring with one bulk copy each (cp.async.bulk, completion on a
//     full mbarrier), refilling a stage once the 128 consumers have arrived
//     on its empty mbarrier;
//   * per kv block the consumers run S = Q.K^T over DQK / DC K stages
//     (m64n64k8, both operands from shared memory), releasing each stage
//     while the next one's wgmmas run; scale is already in Q; cap, mask (only
//     on blocks that cut a mask edge) and the online softmax run on the
//     registers (a row lives in a quad of threads); P = exp(S - m) is split
//     into hi and lo in the register-A layout; then P.V over DV / DC V stages
//     (m64n32k8, A from registers, 32 d-rows at a time into a fresh
//     accumulator that an fma adds to O * alpha), each stage giving DC of
//     O's DV columns.  Registers: O takes DV / 2, P's hi and lo 64, the fresh
//     sum 16 (254 at D = 256, no spills; a second sum to overlap the fma with
//     the next wgmmas spills);
//   * grid (H, query blocks, B): the query heads of one kv head are adjacent
//     in launch order, and the query blocks run last to first, heaviest
//     causal blocks first.  The CTAs in flight (one per SM) then cover
//     about SMs / KVH query blocks of each kv head, and share its K/V
//     through L2.  Where that is fewer than QFAST_SHARE (KVH > 33 on the
//     H100's 132 SMs: MLA's 128 heads), nearly every CTA in flight has a kv
//     head of its own and K/V stream from HBM once per query block (43.6 GB
//     at MLA's [1, 4096, 128, 192 / 128]); there the grid is (query
//     blocks, H, B), so the CTAs in flight share a few heads' K/V.  At 16
//     kv heads (seamless-m4t) heads-first shares 8 ways and is the faster
//     order (PERF.md).
// Tiles (BQ = 64, BK = 64; a stage holds DC = min(DQK, DV, 64) columns or
// rows), DQK / DV:
//   256 / 256: Q 128 KiB + 3 stages of 32 KiB   128 / 128: Q 64 KiB + 5 stages
//   192 / 128: Q 96 KiB + 4 stages of 32 KiB    64 / 64: Q 32 KiB + 6 stages
//    64 /  32: Q 32 KiB + 12 stages of 16 KiB   32 / 32: Q 16 KiB + 13 of 16 KiB
// Not here: overlap of the softmax with the tensor cores, TMA multicast of
// a stage to the CTAs that share a kv head, a persistent scheduler.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per CTA: one warpgroup
constexpr int BK = 64;              // keys per kv block
constexpr int NC = 128;             // consumer threads
constexpr int NT = NC + 32;         // and one producer warp
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a CTA may use
constexpr int SLACK = 1024;         // to align the tiles to the swizzle atom
constexpr int BAR_BYTES = 256;      // mbarriers after the tiles
constexpr int SPLIT_NT = 256;       // threads of a split-pass CTA
constexpr int QFAST_SHARE = 4;      // heads-first below this many CTAs a kv head
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DQK, int DV>
struct Cfg {
  static constexpr int DMIN = DQK < DV ? DQK : DV;
  static constexpr int DC = DMIN < 64 ? DMIN : 64;  // columns (K) / rows (V) of a stage
  static constexpr int NCHK = DQK / DC;        // K stages a kv block
  static constexpr int NCHV = DV / DC;         // V stages a kv block
  static constexpr int NCH = NCHK + NCHV;      // a kv block's stages, K's first
  static constexpr int HALF = BK * DC * 4;     // the hi (or lo) half of a stage
  static constexpr int STAGE = 2 * HALF;
  static constexpr int Q_HALF = BQ * DQK * 4;
  static constexpr int STAGES = (SMEM_MAX - SLACK - BAR_BYTES - 2 * Q_HALF) / STAGE;
  static constexpr int SMEM = SLACK + 2 * Q_HALF + STAGES * STAGE + BAR_BYTES;
  static_assert(DC % 32 == 0 && DQK % DC == 0 && DV % DC == 0, "head dims");
  static_assert(STAGES >= 2 && 16 * STAGES <= BAR_BYTES, "tiles");
};

// byte offset of the 16 bytes holding columns 4u .. 4u + 3 of row r of a
// 32-column chunk in the 128-byte swizzle (chunk base aligned to 1024)
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * 128 + ((u ^ (r & 7)) << 4));
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
  lo = make_float4(tf32(x.x - hi.x), tf32(x.y - hi.y), tf32(x.z - hi.z),
                   tf32(x.w - hi.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// the split pass: one CTA per (stage column/row chunk c, kv block, b * KVH);
// chunk c writes K's stage c (c < NCHK) and V's stage c (c < NCHV)
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__global__ void __launch_bounds__(SPLIT_NT) flash_split_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ split, int KVH, int Sk, int nkb, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh) {
  using C = Cfg<DQK, DV>;
  constexpr int DC = C::DC;
  __shared__ float vt[BK][DC + 1];     // V's tile, keys x d
  const int c = blockIdx.x, kb = blockIdx.y, bh = blockIdx.z;
  const int b = bh / KVH, kvh = bh % KVH;
  const int k0 = kb * BK;
  // the kv block's stages: K's NCHK, then V's NCHV
  float* blk = split + ((int64_t)bh * nkb + kb) * C::NCH * (C::STAGE / 4);

  // K: four d-columns of one key a thread
  if (c < C::NCHK) {
    float* kst = blk + c * (C::STAGE / 4);
    const float* kb_ = k + b * ksb + kvh * ksh + c * DC;
    for (int i = threadIdx.x; i < BK * DC / 4; i += SPLIT_NT) {
      const int r = i / (DC / 4), e4 = i % (DC / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Sk) x = load4(kb_ + (int64_t)(k0 + r) * kss + 4 * e4);
      float4 hi, lo;
      split4(x, hi, lo);
      const uint32_t off = ((e4 / 8) * BK * 128 + swz(r, e4 % 8)) / 4;
      *reinterpret_cast<float4*>(kst + off) = hi;
      *reinterpret_cast<float4*>(kst + C::HALF / 4 + off) = lo;
    }
  }
  if (c >= C::NCHV) return;
  // V into shared memory, then V^T: key positions 4u16 .. 4u16 + 3 of one
  // d-row a thread; positions 0-3 of a group of 8 hold keys 0, 2, 4, 6 and
  // positions 4-7 keys 1, 3, 5, 7
  float* vst = blk + (C::NCHK + c) * (C::STAGE / 4);
  const float* vb_ = v + b * vsb + kvh * vsh + c * DC;
  for (int i = threadIdx.x; i < BK * DC / 4; i += SPLIT_NT) {
    const int r = i / (DC / 4), e4 = i % (DC / 4);
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < Sk) y = load4(vb_ + (int64_t)(k0 + r) * vss + 4 * e4);
    vt[r][4 * e4] = y.x;
    vt[r][4 * e4 + 1] = y.y;
    vt[r][4 * e4 + 2] = y.z;
    vt[r][4 * e4 + 3] = y.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < DC * BK / 4; i += SPLIT_NT) {
    const int r = i / (BK / 4), u16 = i % (BK / 4);
    const int key = 8 * (u16 / 2) + (u16 % 2);
    const float4 x = make_float4(vt[key][r], vt[key + 2][r], vt[key + 4][r],
                                 vt[key + 6][r]);
    float4 hi, lo;
    split4(x, hi, lo);
    const uint32_t off = ((u16 / 8) * DC * 128 + swz(r, u16 % 8)) / 4;
    *reinterpret_cast<float4*>(vst + off) = hi;
    *reinterpret_cast<float4*>(vst + C::HALF / 4 + off) = lo;
  }
}

// ---------------------------------------------------------------------------
// the main kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// a wait that cannot end (a lost transaction, a miscounted arrival) traps
// after about 2^26 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// one contiguous global -> shared copy, completion on an mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address, leading byte offset 16 (unused), stride 1024 bytes between
// groups of 8 rows; base offset 0 (tiles are aligned to the swizzle atom)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers an async wgmma reads or writes across its issue and wait
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float* d, const uint32_t* a,
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// cap and (when MASK) mask one block's scores in place; returns the two
// rows' maxima over this thread's columns.  Element 4j+e of the m64n64
// accumulator is row r0 + 8 * (e / 2), column 8j + cq + (e % 2).
template <bool MASK, bool CAP>
__device__ __forceinline__ void scores(float* sc, float& mx0, float& mx1,
                                       float softcap, float inv_cap, int k0,
                                       int cq, int qp0, int Sk, int causal,
                                       int window) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (CAP) x = softcap * tanhf(x * inv_cap);
      if (MASK) {
        const int kp = k0 + 8 * j + cq + (e & 1);
        const int qp = qp0 + 8 * (e >> 1);
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        x = ok ? x : -INFINITY;
      }
      sc[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ split,
    float* __restrict__ o, float* __restrict__ lse, int H, int KVH, int Sq,
    int Sk, int nkb, int64_t qsb, int64_t qss, int64_t qsh, int64_t osb,
    int64_t oss, int64_t osh, int causal, int window, float softcap,
    float inv_cap, float sm_scale, int qfast) {
  using C = Cfg<DQK, DV>;
  constexpr int DC = C::DC, NCHK = C::NCHK, NCHV = C::NCHV;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQh = (raw + SLACK - 1) & ~uint32_t(SLACK - 1);
  const uint32_t sQl = sQh + C::Q_HALF;
  const uint32_t sSt = sQl + C::Q_HALF;               // stage s: + s * STAGE
  const uint32_t full0 = sSt + STAGES * C::STAGE;     // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;
  uint8_t* const gQh = smem_raw + (sQh - raw);        // generic address of sQh

  const int tid = threadIdx.x;
  const int h = qfast ? blockIdx.y : blockIdx.x;
  const int nqb = qfast ? gridDim.x : gridDim.y;
  const int q0 = (nqb - 1 - (qfast ? blockIdx.x : blockIdx.y)) * BQ;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);

  // kv blocks this query block can see (structural skip)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kb_lo = k_lo / BK;
  const int nblk = max(0, (k_hi + BK - 1) / BK - kb_lo);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC) {
    // ---- producer: lane 0 streams the visible blocks' stages in order.
    // A kv block's NCH stages are contiguous in the split buffer, and so
    // are consecutive blocks, so item n sits n stages past the first.
    if (tid == NC) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(split) +
                           ((int64_t)(b * KVH + kvh) * nkb + kb_lo) * C::NCH *
                               (int64_t)C::STAGE;
      const int items = nblk * C::NCH;
      for (int n = 0; n < items; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(empty0 + 8 * s, (n / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, C::STAGE);
        bulk_load(sSt + s * C::STAGE, src + (int64_t)n * C::STAGE, C::STAGE,
                  full0 + 8 * s);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows ----
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;    // rows r0 and r0 + 8
  const int cq = 2 * (lane % 4);                // column within an 8-group
  const int qp0 = q0 + r0;

  // Q, scaled, split into hi and lo, as column chunks of 32 in the swizzle
  {
    const float* qb = q + b * qsb + h * qsh;
    for (int i = tid; i < BQ * DQK / 4; i += NC) {
      const int r = i / (DQK / 4), e4 = i % (DQK / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) {
        x = load4(qb + (int64_t)(q0 + r) * qss + 4 * e4);
        x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
      }
      float4 hi, lo;
      split4(x, hi, lo);
      const uint32_t off = (e4 / 8) * BQ * 128 + swz(r, e4 % 8);
      *reinterpret_cast<float4*>(gQh + off) = hi;
      *reinterpret_cast<float4*>(gQh + C::Q_HALF + off) = lo;
    }
    // the wgmmas read Q through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
  }

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  int s = 0;
  uint32_t ph = 0;                  // the ring's stage and its fill parity
  auto next = [&]() {
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  };

  for (int i = 0; i < nblk; ++i) {
    const int k0 = (kb_lo + i) * BK;
    // the Q descriptors are rebuilt from an opaque base each block: hoisted
    // out of the loop they would hold registers for its whole length
    uint32_t qh;
    asm volatile("mov.b32 %0, %1;\n" : "=r"(qh) : "r"(sQh));

    // S = Q.K^T = Qh.Kh + (Qh.Kl + Ql.Kh), one K stage (64 d-columns) at a
    // time; the small terms (about 2^-11 of S) sum in an accumulator of
    // their own, so the tensor cores' truncating accumulation adds S's error
    // over DQK / 8 steps, not 3 DQK / 8
    float sc[BK / 2], sl[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      sc[j] = 0.f;
      sl[j] = 0.f;
      pin(sc[j]);
      pin(sl[j]);
    }
    wgmma_fence();
    int prev = 0;
#pragma unroll
    for (int c = 0; c < NCHK; ++c) {
      mbar_wait(full0 + 8 * s, ph);
      const uint32_t kh = sSt + s * C::STAGE, kl = kh + C::HALF;
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        const int d8 = c * (DC / 8) + kk;         // k8 step along D
        const uint32_t qo = (d8 / 4) * BQ * 128 + (d8 % 4) * 32;
        const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32_ss_n64(sc, desc(qh + qo), desc(kh + ko));
        wgmma_tf32_ss_n64(sl, desc(qh + qo), desc(kl + ko));
        wgmma_tf32_ss_n64(sl, desc(qh + C::Q_HALF + qo), desc(kh + ko));
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      next();
    }
    wgmma_wait<0>();
    mbar_arrive(empty0 + 8 * prev);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      pin(sc[j]);
      pin(sl[j]);
      sc[j] += sl[j];
    }

    // cap, mask (only where the block cuts a mask edge), online softmax
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0) &&
                       (window <= 0 || k0 > q0 + BQ - 1 - window);
#define SCORES(MASK, CAP)                                                 \
  scores<MASK, CAP>(sc, mx0, mx1, softcap, inv_cap, k0, cq, qp0, Sk,     \
                    causal, window)
    if (softcap > 0.f) {
      if (whole) SCORES(false, true);
      else SCORES(true, true);
    } else {
      if (whole) SCORES(false, false);
      else SCORES(true, false);
    }
#undef SCORES
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f((m0 - mn0) * LOG2E);
    const float al1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;

    // P = exp(S - m) split into hi + lo in the register-A layout of k8 step
    // j: (r0, t), (r0 + 8, t), (r0, t + 4), (r0 + 8, t + 4), where column t
    // holds key 2t = cq and column t + 4 key 2t + 1 (V's key order)
    uint32_t phi[BK / 2], plo[BK / 2];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p[4] = {exp2f(fmaf(sc[4 * j], LOG2E, -ml0)),
                          exp2f(fmaf(sc[4 * j + 2], LOG2E, -ml1)),
                          exp2f(fmaf(sc[4 * j + 1], LOG2E, -ml0)),
                          exp2f(fmaf(sc[4 * j + 3], LOG2E, -ml1))};
      ps0 += p[0] + p[2];
      ps1 += p[1] + p[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32(p[e]);
        phi[4 * j + e] = __float_as_uint(hi);
        plo[4 * j + e] = __float_as_uint(tf32(p[e] - hi));
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;

    // O = O * alpha + P.V, one V stage (DC d-rows) at a time: for each 32
    // of its d-rows P.V = Ph.Vh + Ph.Vl + Pl.Vh sums afresh (24 k8 steps of
    // m64n32k8) and joins O through one fma on the CUDA cores, so the
    // tensor cores' truncating accumulation never runs over O itself
#pragma unroll
    for (int c = 0; c < NCHV; ++c) {
      mbar_wait(full0 + 8 * s, ph);
      const uint32_t vh = sSt + s * C::STAGE, vl = vh + C::HALF;
#pragma unroll
      for (int n2 = 0; n2 < DC / 32; ++n2) {   // 32 of the stage's d-rows
        float* oc = acc + c * (DC / 2) + 16 * n2;
        float t[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint32_t vo = (kk / 4) * DC * 128 + n2 * 32 * 128 + (kk % 4) * 32;
          wgmma_tf32_rs_n32(t, phi + 4 * kk, desc(vh + vo), kk > 0);
          wgmma_tf32_rs_n32(t, phi + 4 * kk, desc(vl + vo));
          wgmma_tf32_rs_n32(t, plo + 4 * kk, desc(vh + vo));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          pin(t[j]);
          oc[j] = fmaf(oc[j], (j & 2) ? al1 : al0, t[j]);
        }
      }
      mbar_arrive(empty0 + 8 * s);
      next();
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      pin(phi[j]);
      pin(plo[j]);
    }
  }

  // epilogue: out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)).
  // Division by a reciprocal (div.approx, 2 ulp): an IEEE division's slow
  // path is a call that would spill the live accumulator around it.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  if (lane % 4 == 0) {
    float* lrow = lse + ((int64_t)b * H + h) * Sq;
    if (qp0 < Sq) lrow[qp0] = m0 + logf(l0);
    if (qp0 + 8 < Sq) lrow[qp0 + 8] = m1 + logf(l1);
  }
  float* ob = o + b * osb + h * osh + cq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = qp0 + 8 * half;
    if (qp >= Sq) continue;
    const float il = __fdividef(1.f, half ? l1 : l0);
    float* orow = ob + (int64_t)qp * oss;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
          acc[4 * j + 2 * half] * il, acc[4 * j + 2 * half + 1] * il);
  }
}

template <int DQK, int DV>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, float* split, int B, int H, int KVH, int Sq, int Sk,
           long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, long long osb, long long oss, long long osh,
           int causal, int window, float softcap, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const int nkb = (Sk + BK - 1) / BK;
  const int chunks = C::NCHK > C::NCHV ? C::NCHK : C::NCHV;
  flash_split_kernel<DQK, DV><<<dim3(chunks, nkb, B * KVH), SPLIT_NT, 0,
                                 stream>>>(
      k, v, split, KVH, Sk, nkb, ksb, kss, ksh, vsb, vss, vsh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DQK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  // query blocks fastest where heads-first would give each kv head fewer
  // than QFAST_SHARE of the CTAs in flight (see the grid note above); the
  // CTAs a device holds at once are read on its first launch only, as the
  // occupancy query is host time on the launch path of small shapes
  static int in_flight[MAX_DEVICES];
  int device = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (in_flight[device] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_fwd_tf32_kernel<DQK, DV>, NT, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    in_flight[device] = sms * per_sm;
  }
  const int qfast = in_flight[device] < QFAST_SHARE * KVH;
  const int nqb = (Sq + BQ - 1) / BQ;
  const dim3 grid(qfast ? nqb : H, qfast ? H : nqb, B);
  flash_fwd_tf32_kernel<DQK, DV><<<grid, NT, C::SMEM, stream>>>(
      q, split, o, lse, H, KVH, Sq, Sk, nkb, qsb, qss, qsh, osb, oss, osh,
      causal, window, softcap, softcap > 0.f ? 1.f / softcap : 0.f, sm_scale,
      qfast);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes) for f32 inputs: the split pass,
// then the main kernel, on `stream` (a stream of `device`), at query/key
// head dim D and value head dim DV.  `split` is scratch of B * KVH *
// ceil(Sk / 64) * 128 * (D + DV) floats, 16-byte aligned (the Python wrapper
// allocates it).  Strides are in elements; the head-dim stride must be 1 and
// every row aligned to four elements (the wrapper checks both); Sk must be
// at least 1.  Returns a cudaError_t, or -1 for a (D, DV) pair that is not
// instantiated (the wrapper zero-pads to one that is).
extern "C" int flash_fwd_f32(
    const void* q, const void* k, const void* v, void* o, float* lse,
    void* split, int B, int H, int KVH, int Sq, int Sk, int D, int DV,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, float softcap,
    float sm_scale, int device, void* stream) {
  // this library carries its own (static) CUDA runtime: select the
  // tensors' device before touching the function attribute or launching
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define TF32_CASE(DQ, DVV)                                                    \
  if (D == DQ && DV == DVV)                                                   \
    return launch<DQ, DVV>(static_cast<const float*>(q),                      \
                           static_cast<const float*>(k),                      \
                           static_cast<const float*>(v),                      \
                           static_cast<float*>(o), lse,                       \
                           static_cast<float*>(split), B, H, KVH, Sq, Sk,     \
                           qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb,  \
                           oss, osh, causal, window, softcap, sm_scale, st);
  TF32_CASE(32, 32)
  TF32_CASE(64, 64)
  TF32_CASE(128, 128)
  TF32_CASE(256, 256)
  TF32_CASE(192, 128)     // MLA: qk_nope + qk_rope over v_head_dim
  TF32_CASE(64, 32)       // MLA at smoke size (48 / 32, padded)
  return -1;
#undef TF32_CASE
}
