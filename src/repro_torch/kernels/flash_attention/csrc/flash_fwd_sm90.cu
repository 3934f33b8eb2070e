// Online-softmax attention forward on bf16 inputs for Hopper (sm_90a):
// TMA loads into shared-memory rings and two warpgroups taking turns at
// the tensor cores with wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _attn_kernel) for bf16 q/k/v; f32 inputs
// take the split-TF32 kernel in flash_fwd.cu.  Same function as that one,
// at a query/key head dim D and a value head dim DV that may differ (MLA:
// 192 / 128): GQA through kv head h / (H / KVH), causal and sliding-window
// masks (kp > qp - window) with the kv blocks wholly above the diagonal or
// left of the window skipped by the loop bounds, logit softcap
// c * tanh(s / c), out = acc / max(l, 1e-30) rounded to nearest-even bf16,
// and lse = m + log(max(l, 1e-30)) in f32 (natural log) for the recompute
// backward.  Ragged Sq and Sk are masked (TMA fills rows past the end with
// zeros), not asserted; so is a D below the instantiated one (columns).
//
// Numerics (the Pallas kernel and flash.py compute P.V in f32):
//   * S = Q.K^T: bf16 x bf16 products are exact, accumulated in f32 by
//     wgmma; the caller's sm_scale (1/sqrt(D) of the unpadded D)
//     multiplies the f32 scores after the product, so q stays bf16 in
//     shared memory.
//   * softcap as c * tanh(s / c) with tanh(x) = 1 - 2 / (1 + 2^(2x log2 e))
//     (ex2, about 2^-22 relative; tanh.approx's 2^-11 would move scores by
//     up to 0.02 at c = 50); masked scores are -inf and the running max
//     starts at the finite -1e30, so a block fully masked for a row gives
//     exp(-inf) = 0 and a rescale of 1, never NaN.
//   * the online softmax runs in f32 in the exp2 domain (scores times
//     log2 e once, through one fma per element); m and lse stay natural.
//   * P.V: a single bf16 P would round each probability to 2^-9 and fails
//     the bf16 output check (out within one bf16 step, 2^-7 relative).  P
//     is split into hi = bf16_rn(p) and lo = bf16_rn(p - hi), and two
//     wgmmas accumulate hi.V + lo.V into the same f32 O (p to about 2^-17).
//     That costs 2 D + 4 DV flops a visible pair against the function's
//     2 (D + DV): 896 against 640 at (192, 128).
//
// What bounds it on the H100: the tensor cores, at the clock the card
// holds under load.  At MLA's [1, 4096, 128] causal (192, 128) the function's
// bound is 0.695 ms at 989 TFLOP/s and the split work's 0.973 ms; K/V must
// then come from L2 (the grid order below), about 184 flops a byte of it
// at BK = 128.  Under that load the SM clock falls from 1980 MHz (to
// 1635-1755 MHz at the lowest samples of scripts/flash_sm90_layouts.py on
// an H100 SXM at 700 W), so the split work is paid for in clock as well
// as in time; the kernel reaches about 600 TFLOP/s of it (PERF.md).
// Design:
//   * one CTA per (128 query rows, head, batch), 256 threads: two
//     warpgroups of 64 query rows each and no producer warp.  A ninth
//     warp (or a producer warpgroup with setmaxnreg) shares an SM
//     sub-partition's 16384 registers three ways, so ptxas caps every
//     thread at 168: 400 bytes of spills at D = 256 and every wgmma
//     serialised (1.25 / 0.96 ms against 0.74 / 0.58 ms at gemma2's
//     shapes on an H100 SXM at 700 W; PERF.md);
//   * K and V have rings of their own, STAGES stages of BK keys each, and
//     an mbarrier pair per stage (full: the TMA's bytes; empty: all 256
//     threads).  Thread 0 loads Q and the first STAGES blocks; every
//     refill is issued by warpgroup 1's first thread, after its own
//     warpgroup released the stage: warpgroup 1 trails warpgroup 0 at the
//     tensor cores (below), so warpgroup 0 has released it by then and no
//     thread of the leading warpgroup ever waits on a refill.  A K stage
//     goes back as soon as its S = Q.K^T is done, a V stage when its P.V
//     is; both are refilled once the warpgroup's P.V is done, where no
//     wgmma is in flight (a branch while one is makes ptxas serialise
//     every wgmma: C7520), and then have about one and a half kv blocks of
//     compute to land;
//   * per kv block i each warpgroup, in its turn (named barriers 1 and 2,
//     256 threads: bar.sync on its own, bar.arrive on the other's once
//     issued), issues S_i = Q.K_i^T (m64nBKk16, both operands from shared
//     memory) and then block i - 1's O += hi.V + lo.V (m64nDVk16, A from
//     registers: the m64nN accumulator layout is the register-A layout of
//     the next wgmma), two commit groups.  It waits for S_i alone, scales,
//     caps and masks it (the mask only on blocks that cut the diagonal, the
//     window edge or Sk), runs the online softmax in registers (a row
//     lives in a quad of threads: two shfl.xor per reduction; l stays per
//     thread until the epilogue) and exponentiates in place, while the
//     tensor cores run its P.V and the other warpgroup's S and P.V; then it
//     waits for its P.V, rescales O (skipped where no row of the warp
//     raised its max: a multiply by 1 is exact) and splits p into P's bf16
//     hi and lo.  Each warpgroup's softmax thus overlaps the other's
//     products and its own P.V, and O, the scores and P (DV / 2 + BK / 2 +
//     BK / 2 registers) are live together, as in the serial kernel's
//     conversion: 253 registers at (192, 128), no spills.  The first block
//     (no P.V before it) is peeled, so that no wgmma is issued under a
//     branch;
//   * tiles sit in shared memory in the TMA's 128-byte swizzle (64-byte
//     for a head dim of 32), as column chunks of 64 (32) elements, one TMA
//     box each; the wgmma descriptors carry the same swizzle.  Q and K are
//     K-major (D contiguous, D / 64 chunks: three at D = 192); V is the
//     MN-major B operand of P.V (keys are the reduction, DV contiguous),
//     read with wgmma's transpose bit, with a tensor map of its own at DV
//     (its swizzle set by DV, so (64, 32) swizzles K by 128 bytes and V by
//     64);
//   * grid: heads first, (H, query blocks, B), puts the query heads of one
//     kv head side by side in launch order, so about SMs / KVH query blocks
//     of each kv head are in flight and share its K/V through L2.  Where
//     that is fewer than QFAST_SHARE (KVH > 33 on the H100's 132 SMs: MLA's
//     128 heads, each with its own K/V) nearly every CTA in flight has a kv
//     head of its own and K/V stream from HBM once per query block (5.54 GB
//     at MLA's [1, 4096, 128]); there the grid is (query blocks, H, B), the
//     CTAs in flight share about four heads' K/V (10.5 MB of the 50 MB L2)
//     and HBM sees K/V once, 0.67 GB with Q and O.  Either way the query
//     blocks run last to first, heaviest causal blocks first.
// Tiles (BQ = 128 everywhere; shared memory filled up to the 227 KB; the
// stages counted per (D, DV) pair, a stage holding K at D and V at DV):
//   256 / 256: BK =  64, 2 stages, 193 KiB   128 / 128: BK = 128, 3 stages, 225 KiB
//    64 /  64: BK = 128, 6 stages, 209 KiB    32 /  32: BK = 128, 13 stages, 217 KiB
//   192 / 128: BK = 128, 2 stages, 209 KiB    64 /  32: BK = 128, 8 stages, 209 KiB
// (192 / 128 is MLA's d_qk / d_v; 64 / 32 holds MLA at smoke size, 48 / 32
// read at 48.  At 192 / 128, 64 keys with 4 stages is slower than 128 with
// 2: scripts/flash_sm90_layouts.py's mla_bk64 cut, PERF.md.)
// Not here: a persistent scheduler, TMA multicast of K/V to the CTAs that
// share a kv head, more than 128 query rows a CTA.
//
// The tensor maps are encoded per call on the host from the tensors'
// strides (cuTensorMapEncodeTiled, looked up in the loaded libcuda with
// dlsym, so this library does not link against it); TMA needs a
// 16-byte-aligned base and strides that are multiples of 16 bytes, which
// the Python wrapper checks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;             // query rows per CTA
constexpr int NT = 256;             // two warpgroups of 64 query rows
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a CTA may use
constexpr int SLACK = 1024;         // to align the tiles to the swizzle atom
constexpr int BAR_BYTES = 512;      // mbarriers after the tiles
constexpr int QFAST_SHARE = 4;      // heads-first below this many CTAs a kv head
constexpr int MAX_DEVICES = 64;
// the two warpgroups take turns at the tensor cores (named barriers 1 and
// 2); false lets them issue at will (scripts/flash_sm90_layouts.py's
// no_pingpong cut)
constexpr bool PINGPONG = true;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int DV>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;     // keys per kv block
  static constexpr int SW = D >= 64 ? 128 : 64;      // Q, K: bytes per chunk row
  static constexpr int CE = SW / 2;                  // elements per chunk row
  static constexpr int KPC = SW / 32;                // k16 steps per chunk
  static constexpr int SWV = DV >= 64 ? 128 : 64;    // V: bytes per chunk row
  static constexpr int CEV = SWV / 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;         // one K stage
  static constexpr int V_BYTES = BK * DV * 2;        // one V stage
  static constexpr int STAGES =
      (SMEM_MAX - SLACK - BAR_BYTES - Q_BYTES) / (K_BYTES + V_BYTES);
  static constexpr int SMEM =
      SLACK + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + BAR_BYTES;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // descriptor swizzle
  static constexpr uint64_t LAYOUT_V = SWV == 128 ? 1 : 2;
  static_assert(STAGES >= 2 && 8 * (1 + 4 * STAGES) <= BAR_BYTES, "tiles");
  static_assert(D % CE == 0 && DV % CEV == 0, "head dims");
};

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
// a wait that cannot end (a lost TMA transaction, a miscounted arrival)
// traps after about 2^26 polls instead of hanging the card
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode; base offset 0 (tiles are aligned
// to the swizzle atom)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's commit groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers an async wgmma reads or writes across its issue and wait
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float tanh_ex2(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.f - __fdividef(2.f, 1.f + exp2f(x * (2.f * LOG2E)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// scale, cap and (when MASK) mask one block's scores in place; returns the
// two rows' maxima over this thread's columns.  Element 4j+e of the
// m64nBK accumulator is row r0 + 8 * (e / 2), column 8j + cq + (e % 2).
template <int BK, bool MASK, bool CAP>
__device__ __forceinline__ void scores(float* sc, float& mx0, float& mx1,
                                       float sm_scale, float softcap,
                                       float inv_cap, int k0, int cq, int qp0,
                                       int Sk, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * sm_scale;
      if (CAP) x = softcap * tanh_ex2(x * inv_cap);
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

// named barrier `id` over both warpgroups: the caller's warpgroup waits for
// the other's bar_arrive (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}

// O += hi.V + lo.V over the V stage at sVs, one commit group; V is the
// MN-major B operand of P.V (keys are the reduction: transpose bit)
template <int D, int DV>
__device__ __forceinline__ void pv(float* acc, const uint32_t* ph,
                                   const uint32_t* pl, uint32_t sVs) {
  using C = Cfg<D, DV>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint64_t dv =
        desc(sVs + kk * 16 * C::SWV, C::BK * C::SWV, 8 * C::SWV, C::LAYOUT_V);
    wgmma_rs<DV>(acc, ph + 4 * kk, dv);
    wgmma_rs<DV>(acc, pl + 4 * kk, dv);
  }
  wgmma_commit();
}
template <int BK, int DV>
__device__ __forceinline__ void pin_pv(float* acc, uint32_t* ph,
                                       uint32_t* pl) {
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) pin(acc[j]);
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    pin(ph[j]);
    pin(pl[j]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(NT, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int KVH, int Sq, int Sk, int64_t osb,
    int64_t oss, int64_t osh, int causal, int window, float softcap,
    float inv_cap, float sm_scale, int qfast) {
  using C = Cfg<D, DV>;
  constexpr int BK = C::BK, SW = C::SW, SWV = C::SWV, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + SLACK - 1) & ~uint32_t(SLACK - 1);
  const uint32_t sK = sQ + C::Q_BYTES;               // stage s: + s * K_BYTES
  const uint32_t sV = sK + ST * C::K_BYTES;          // stage s: + s * V_BYTES
  const uint32_t q_bar = sV + ST * C::V_BYTES;
  const uint32_t full_k = q_bar + 8;                 // full_k[s] = + 8 s
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;

  const int tid = threadIdx.x;
  const int nqb = qfast ? gridDim.x : gridDim.y;
  const int h = qfast ? blockIdx.y : blockIdx.x;
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

  // K and V of kv block i go to stage i % ST of their own rings
  auto load_k = [&](int i) {
    const int s = i % ST;
    mbar_expect_tx(full_k + 8 * s, C::K_BYTES);
    for (int c = 0; c < D / C::CE; ++c)
      tma_load_4d(sK + s * C::K_BYTES + c * BK * SW, &tm_k, full_k + 8 * s,
                  c * C::CE, kvh, (kb_lo + i) * BK, b);
  };
  auto load_v = [&](int i) {
    const int s = i % ST;
    mbar_expect_tx(full_v + 8 * s, C::V_BYTES);
    for (int c = 0; c < DV / C::CEV; ++c)
      tma_load_4d(sV + s * C::V_BYTES + c * BK * SWV, &tm_v, full_v + 8 * s,
                  c * C::CEV, kvh, (kb_lo + i) * BK, b);
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, NT);
      mbar_init(empty_v + 8 * s, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, C::Q_BYTES);
    for (int c = 0; c < D / C::CE; ++c)
      tma_load_4d(sQ + c * BQ * SW, &tm_q, q_bar, c * C::CE, h, q0, b);
    for (int i = 0; i < min(nblk, ST); ++i) {
      load_k(i);
      load_v(i);
    }
  }

  {
    // ---- two warpgroups of 64 query rows each ----
    const int wg = tid / 128;
    const int wt = tid % 128;
    const int lane = wt % 32;
    const int r0 = 16 * (wt / 32) + lane / 4;   // rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);              // column within an 8-group
    const int qa = q0 + 64 * wg;                // this warpgroup's first row
    const int qp0 = qa + r0;
    const uint32_t sQw = sQ + 64 * wg * SW;
    // warpgroup 1 trails warpgroup 0 at the tensor cores, so the refills
    // are its first thread's: the other warpgroup has released the stage
    // by the time it asks
    const bool loader = tid == 128;

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
    float sc[BK / 2];                 // block i's scores, then its p
    uint32_t ph[BK / 4], pl[BK / 4];  // block i - 1's P as bf16 hi and lo

    mbar_wait(q_bar, 0);
    if (PINGPONG && wg == 1 && nblk > 0) bar_arrive(1);   // 0 goes first
    // kv block i: in this warpgroup's turn S_i = Q.K_i^T and block i - 1's
    // P.V, then S_i's softmax while the tensor cores run both and the other
    // warpgroup's; the first block has no P.V before it (peeled, so that
    // no wgmma is issued or waited for under a branch)
    auto step = [&](auto first, int i) {
      constexpr bool FIRST = decltype(first)::value;
      const int s = i % ST, sp = (i + ST - 1) % ST;   // sp: block i - 1's
      const int k0 = (kb_lo + i) * BK;
      const uint32_t sKs = sK + s * C::K_BYTES;
      mbar_wait(full_k + 8 * s, (i / ST) & 1);
      if (!FIRST) mbar_wait(full_v + 8 * sp, ((i - 1) / ST) & 1);
      // the Q descriptors are rebuilt from an opaque base each block: hoisted
      // out of the loop they would hold D / 8 registers for its whole length
      uint32_t sQb;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(sQb) : "r"(sQw));
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = 0.f;
        pin(sc[j]);
      }

      // S = Q.K^T, both K-major in shared memory, then block i - 1's P.V
      if (PINGPONG) bar_sync(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % C::KPC) * 32;
        wgmma_ss<BK>(sc,
                     desc(sQb + (kk / C::KPC) * BQ * SW + off, 16, 8 * SW,
                          C::LAYOUT),
                     desc(sKs + (kk / C::KPC) * BK * SW + off, 16, 8 * SW,
                          C::LAYOUT),
                     kk > 0);
      }
      wgmma_commit();
      if (!FIRST) pv<D, DV>(acc, ph, pl, sV + sp * C::V_BYTES);
      if (PINGPONG) bar_arrive(2 - wg);        // the other warpgroup's turn
      wgmma_wait<FIRST ? 0 : 1>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) pin(sc[j]);
      mbar_arrive(empty_k + 8 * s);

      // scale, cap, mask (only where the block cuts a mask edge)
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= qa) &&
                         (window <= 0 || k0 > qa + 63 - window);
#define SCORES(MASK, CAP)                                                  \
  scores<BK, MASK, CAP>(sc, mx0, mx1, sm_scale, softcap, inv_cap, k0, cq,  \
                        qp0, Sk, causal, window)
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

      // p = exp(S - m), in place
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float ml = e == 0 ? ml0 : ml1;
          const float pa = exp2f(fmaf(sc[4 * j + e], LOG2E, -ml));
          const float pb = exp2f(fmaf(sc[4 * j + e + 1], LOG2E, -ml));
          if (e == 0) ps0 += pa + pb;
          else ps1 += pa + pb;
          sc[4 * j + e] = pa;
          sc[4 * j + e + 1] = pb;
        }

      // block i - 1's P.V is done: the refills (the loader's, after the
      // other warpgroup released the stages too), O rescaled, P split into
      // bf16 hi + lo in the register-A layout (k16 step kk takes fragments
      // 4kk .. 4kk + 3)
      wgmma_wait<0>();
      pin_pv<BK, DV>(acc, ph, pl);
      if (!FIRST) mbar_arrive(empty_v + 8 * sp);
      if (loader) {
        if (i + ST < nblk) {
          mbar_wait(empty_k + 8 * s, (i / ST) & 1);
          load_k(i + ST);
        }
        if (!FIRST && i - 1 + ST < nblk) {
          mbar_wait(empty_v + 8 * sp, ((i - 1) / ST) & 1);
          load_v(i - 1 + ST);
        }
      }
      __syncwarp();
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      // O rescaled unless no row of the warp raised its max (alpha 1: the
      // multiply is exact, and DV / 2 of them are the softmax's largest
      // single cost at DV = 256)
      if (!__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
        for (int j = 0; j < DV / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float pa = sc[4 * j + e], pb = sc[4 * j + e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
          const float2 hf = __bfloat1622float2(hi);
          ph[2 * j + e / 2] = bf16x2_bits(hi);
          pl[2 * j + e / 2] =
              bf16x2_bits(__floats2bfloat162_rn(pa - hf.x, pb - hf.y));
        }
    };

    if (nblk > 0) {
      step(std::true_type{}, 0);
      for (int i = 1; i < nblk; ++i) step(std::false_type{}, i);
      // the last block's P.V, in this warpgroup's turn
      const int sl = (nblk - 1) % ST;
      mbar_wait(full_v + 8 * sl, ((nblk - 1) / ST) & 1);
      if (PINGPONG) bar_sync(1 + wg);
      wgmma_fence();
      pv<D, DV>(acc, ph, pl, sV + sl * C::V_BYTES);
      if (PINGPONG) bar_arrive(2 - wg);
      wgmma_wait<0>();
      pin_pv<BK, DV>(acc, ph, pl);
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
    __nv_bfloat16* ob = o + b * osb + h * osh + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = qp0 + 8 * half;
      if (qp >= Sq) continue;
      const float il = __fdividef(1.f, half ? l1 : l0);
      __nv_bfloat16* orow = ob + (int64_t)qp * oss;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] * il, acc[4 * j + 2 * half + 1] * il);
    }
    // warpgroup 1's last turn handed one back that warpgroup 0 takes here
    if (PINGPONG && wg == 0 && nblk > 0) bar_sync(1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* drv = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (drv == nullptr) drv = dlopen("libcuda.so.1", RTLD_NOW);
    if (drv != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(drv, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [B, S, heads, D] bf16 with element strides (sb, ss, sh, 1) as a 4-d
// tensor map {D, heads, S, B}; one box is `rows` rows of one chunk of
// `sw / 2` columns, in the matching swizzle
int encode(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B,
           long long sh, long long ss, long long sb, int rows, int sw) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(sw / 2), 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int Sq, int Sk, int d, long long qsb,
           long long qss, long long qsh, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh,
           long long osb, long long oss, long long osh, int causal,
           int window, float softcap, float sm_scale, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  // Q and K at their own head dim d <= D: TMA fills the box's columns past
  // it with zeros, which add exact zeros to every score
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, H, Sq, B, qsh, qss, qsb, BQ, C::SW);
  if (!err) err = encode(&tk, k, d, KVH, Sk, B, ksh, kss, ksb, C::BK, C::SW);
  if (!err) err = encode(&tv, v, DV, KVH, Sk, B, vsh, vss, vsb, C::BK, C::SWV);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  // query blocks fastest where heads-first would give each kv head fewer
  // than QFAST_SHARE of the CTAs in flight (the grid note above); the CTAs
  // a device holds at once are read on its first launch only, as the
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
          &per_sm, flash_fwd_sm90_kernel<D, DV>, NT, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    in_flight[device] = sms * per_sm;
  }
  const int qfast = in_flight[device] < QFAST_SHARE * KVH;
  const int nqb = (Sq + BQ - 1) / BQ;
  const dim3 grid(qfast ? nqb : H, qfast ? H : nqb, B);
  flash_fwd_sm90_kernel<D, DV><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, KVH, Sq, Sk, osb,
      oss, osh, causal, window, softcap, softcap > 0.f ? 1.f / softcap : 0.f,
      sm_scale, qfast);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes), the arguments of flash_fwd.cu's
// but its split scratch: query/key head dim D, value head dim DV.  The
// kernel runs at the first instantiated pair below with DV its own and D
// no wider than its d_qk (the Python wrapper's ``kernel_dims``, V padded to
// that d_v), Q and K read at D.  Strides are in elements; the head-dim
// stride must be 1, the bases 16-byte aligned and every other stride a
// multiple of 8 elements (the Python wrapper checks all three); `stream`
// is a stream of `device`.  Returns a cudaError_t, -1 for a (D, DV) pair
// no instantiation holds, -2 if libcuda has no cuTensorMapEncodeTiled, -3
// if it refused a tensor map.
extern "C" int flash_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int KVH, int Sq, int Sk, int D, int DV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    int causal, int window, float softcap, float sm_scale, int device,
    void* stream) {
  // this library carries its own (static) CUDA runtime: select the
  // tensors' device before touching the function attribute or launching
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D < 1) return -1;
#define SM90_CASE(DQ, DVV)                                                    \
  if (D <= DQ && DV == DVV)                                                   \
    return launch<DQ, DVV>(q, k, v, o, lse, B, H, KVH, Sq, Sk, D, qsb, qss,  \
                           qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,  \
                           causal, window, softcap, sm_scale, st);
  SM90_CASE(32, 32)
  SM90_CASE(64, 32)       // MLA at smoke size (48 / 32)
  SM90_CASE(64, 64)
  SM90_CASE(128, 128)
  SM90_CASE(192, 128)     // MLA: qk_nope + qk_rope over v_head_dim
  SM90_CASE(256, 256)
  return -1;
#undef SM90_CASE
}
