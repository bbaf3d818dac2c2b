// The Hopper (sm_90a) matrix-product mainloop shared by elk_matmul.cu and
// fused_mlp.cu: TMA loads into a ring of shared-memory stages under
// mbarriers, one producer warp, one or two consumer warpgroups on wgmma, and
// an epilogue chosen at run time (a bf16 store, an activation, a gated
// product, or fp32 partial sums of a split of K).  flash_attention.cu and
// decode_attention.cu take its PTX wrappers (mbarriers, TMA, wgmma, the
// swizzle descriptors, cluster loads and barriers) and its tensor maps.
//
//   out (m, n) = epilogue( a (m, K) @ b_j (K, n) ),  j < NB (1, or 2 for a
//   gate and an up product that share the a tile)
//
// a is x, row-major with a row stride of its own, or (A_MNMAJOR) read as
// the transpose of a stored (K, m) matrix: a weight gradient's x^T dy, the
// box over the stored layout landing as the MN-major tile wgmma reads with
// its transpose bit for A.  A two-part sum (TWO, compiled apart so that the
// one-part instances keep no test of it) walks a second (a1, b1) pair after
// the first's K tiles, in the same accumulator: the MLP's dx = dg w_gate^T +
// du w_up^T.  b is taken as stored:
// MN-major, a (K, n) row-major weight (every weight of the models here), or
// K-major, the transpose of an (n, K) row-major tensor (embed.t() of a tied
// LM head).  The wgmma descriptor's transpose bit says which; get it wrong
// and the product is that of the transposed operand, with the same shape
// whenever n == K, which is why the sweeps in chip_smoke.py are not square.
//
// It replaces the inner loops of the TPU kernels
// src/repro/kernels/elk_matmul/kernel.py:31 (_matmul_kernel) and
// src/repro/kernels/fused_mlp/kernel.py:38 (_make_kernel): there the
// sequential grid walks K and the MXU reads VMEM tiles; here a block walks
// its K range itself and the tensor cores read shared memory.
//
// What bounds it on an H100 SXM (datasheet: 989 TFLOP/s dense bf16,
// 3.35 TB/s, 227 KB of shared memory a block, 132 SMs): the products of a
// prefill (m = 4096) are bound by operations, those of a decode step
// (m <= 32) by reading the weight once.  What held the kernels it replaces
// back (PERF.md): mma.sync and wmma need every operand fragment
// loaded from shared memory into registers, by 32-bit loads or 512-byte
// fragments, and a cp.async ring filled by all threads needs a block-wide
// barrier every K step, so loads, products and barriers add up instead of
// overlapping.  Here:
//   * one thread of the producer warpgroup issues a TMA copy per operand
//     tile (one per 64 columns of an MN-major b) into stage s and tells
//     full[s] how many bytes to expect; TMA computes the addresses, applies
//     the 128-byte swizzle that wgmma reads without bank conflicts, and
//     zero-fills what lies past the tensor's edge, so ragged m, n and K
//     need no masked loads (only the stores are masked);
//   * each consumer warpgroup (64 rows of the tile) waits on full[s],
//     issues BK / 16 wgmma m64nNk16 per operand straight from shared memory,
//     commits them as one group, and releases stage s - 1 on empty[s - 1]
//     once wgmma.wait_group 1 says the group that read it has retired: the
//     products of one stage run while the next stages are in flight, and no
//     barrier spans the block after the start;
//   * with two consumer warpgroups (384 threads) setmaxnreg hands the
//     producer's registers to the consumers (40 and 232 a thread, from the
//     168 that __launch_bounds__(384, 1) gives): a 128 x 256 fp32
//     accumulator, or two of 128 x 128, is 128 registers a consumer thread.
//     One consumer warpgroup (256 threads) runs two blocks an SM and needs
//     no rebalancing;
//   * the output tiles are visited in groups of group_m row tiles, so that
//     a wave of blocks shares its weight tiles and its x tiles in the 50 MB
//     L2;
//   * a split of K (decode products: too few output tiles for 132 SMs)
//     runs as one thread-block cluster a tile, one block a split (at most
//     8, the portable cluster size): each block leaves its fp32 sums in its
//     own shared memory, and after a cluster barrier every block adds up
//     its share of the tile over the cluster's distributed shared memory,
//     rank by rank, and stores it.  One launch, no partials in device
//     memory.  (A separate reduce kernel over partials in device memory
//     cost a second launch a product; summing them in the last block of a
//     tile, picked by an integer ticket, ran that block's loads one split
//     after another and made the products 2-3x slower.)
//   * determinism: a block owns its output tile and its K range, and sums
//     its K steps in order; the splits of a tile are added in rank order.
//     No atomics: the same inputs give the same bits on every run,
//     whatever m is.
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, whose
// entry point cudaGetDriverEntryPoint returns at run time, so the library
// is not linked against libcuda (no -lcuda in _build.NVCC_FLAGS).  They are
// passed as __grid_constant__ kernel parameters and cached by (pointer,
// shape, stride, box): a weight's data_ptr() is the same every step (under
// elk_stream it cycles over the window's buffers).
//
// TMA's rules decide which products the mainloop takes: bf16, every base
// 16-byte aligned and every row stride a multiple of 16 bytes.  The callers
// check them before the launch and route what breaks them to their older
// kernels; the launch functions here check them again and refuse (-1).  One
// exception: an MN-major b that TMA refuses (a row stride or a base off 16
// bytes: hymba's untied LM head, (1600, 32001), has rows of 64002 bytes) can
// be loaded by the producer warpgroup itself (B_LDG, one consumer
// warpgroup): its 128 threads read each row's 16-byte-aligned pieces once
// (ld.global.nc.v4, all of a stage in flight at once; the piece a lane's 8
// elements spill into comes from the next lane by a shuffle), realign them
// in registers by the row's byte offset (funnel shifts), zero
// what lies past n or K, and store them into the same 128-byte-swizzled tile
// a TMA box would fill; after a proxy fence each thread arrives on full[s],
// which completes on the a tile's bytes and those 128 arrivals.  The
// consumers, the split of K over a cluster and the epilogue are unchanged,
// and the weight keeps the layout the model, its checkpoints and its
// streamed records give it.
//
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): the
// products at m = 4096 run at 55-66 % of the tensor cores' dense peak
// (q/o 0.391 ms against a bound of 0.217), where torch.matmul runs at
// 75-80 %; gemm_kernel gives a block one tile, so a tile's prologue and
// epilogue do not overlap another's products.  Pairs of blocks sharing
// their b tiles by TMA multicast were measured and were slower (PERF.md).
// The products of a decode step reach 29 % (k/v, 0.0110 ms) to 89 % (the
// LM head) of what reading the weight once at the memory rate takes.
//
// One instance is persistent (GemmCfg::PERSIST, gemm_xt_kernel), compiled
// for the x^T dy of a weight gradient (A_MNMAJOR) and nothing else: a block
// an SM (two at one consumer warpgroup) walks a static list of output tiles
// in the group_m order; the producer runs on into the next tile's stages
// while the consumers store the last one, through a padded bf16 tile in
// shared memory and out by 16-byte stores; and where the tiles leave a
// short last wave (k/v of qwen3-14b: 160 tiles of 128 x 256 on 132 SMs) the
// tiles of that wave are split over clusters of blocks by K, the pieces
// summed in rank order over distributed shared memory (launch_gemm_xt and
// chip/h100.xt_schedule say how).  No atomics: the same inputs give the
// same bits on every run.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

// Everything here has internal linkage: two libraries of the process include
// this header, and the statics of inline and template functions (the
// tensor-map cache, the devices a kernel's shared-memory limit is set on)
// would otherwise be one object shared by both.
namespace hg {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                // K depth of a stage: one 128-byte swizzled row of bf16
constexpr int kSmemBudget = 232448;    // shared memory a block may opt in to (227 KB)
constexpr int kSmemReserve = 2048;     // alignment slack and the mbarriers
constexpr int kMaxStages = 8;          // the ring never grows past this
// the plan in chip/h100.py repeats these four constants and stages_for
// (tests/test_torch_elk_matmul.py reads them from here)

// Stages of the ring: what the block's share of shared memory holds, with
// two blocks an SM at one consumer warpgroup and one at two.
constexpr int stages_for(int wg, int bn, int nb) {
  const int stage = 64 * wg * kBK * 2 + nb * bn * kBK * 2;
  const int budget = wg == 1 ? kSmemBudget / 2 - 1024 : kSmemBudget;
  const int s = (budget - kSmemReserve) / stage;
  return s > kMaxStages ? kMaxStages : s;
}

// The persistent instance's epilogue tile: a consumer warpgroup's 64 rows
// of bn bf16, each row padded by kEpiPad bytes so that the accumulators'
// pairs land on distinct banks.
constexpr int kEpiPad = 16;

// Stages of the persistent instance's ring: stages_for's budget less the
// epilogue tile.
constexpr int xt_stages_for(int wg, int bn) {
  const int stage = 64 * wg * kBK * 2 + bn * kBK * 2;
  const int budget = (wg == 1 ? kSmemBudget / 2 - 1024 : kSmemBudget) - 64 * wg * (bn * 2 + kEpiPad);
  const int s = (budget - kSmemReserve) / stage;
  return s > kMaxStages ? kMaxStages : s;
}

enum : int { kActSilu = 0, kActGelu = 1, kActRelu = 2 };
// kEpiPre and kEpiDeriv are the MLP backward's FMA tile kernel's
// (fused_mlp_bwd.cu): the pre-activations in fp32, and the derivative of the
// activation applied to dh = dy w_down^T
enum : int { kEpiStore = 0, kEpiAct = 1, kEpiGated = 2, kEpiPre = 3, kEpiDeriv = 4 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActSilu) return v / (1.0f + expf(-v));
  if (act == kActGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return fmaxf(v, 0.0f);
}

// d act / d v at v, of the same three activations.
__device__ __forceinline__ float act_grad(float v, int act) {
  if (act == kActSilu) {
    const float sg = 1.0f / (1.0f + expf(-v));
    return sg * (1.0f + v * (1.0f - sg));
  }
  if (act == kActGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float t = tanhf(c * (v + 0.044715f * v * v * v));
    return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * v * v);
  }
  return v > 0.0f ? 1.0f : 0.0f;
}

// The attention kernels' int8 KV ring, dequantized as the reference's
// _dequantize_kv: (q * scale) in fp32 rounded to bf16, every route of both
// kernels through i8f.  i8f: byte i (0-3) of four int8 values, given with
// their sign bits flipped (w ^ 0x80808080), as the exact fp32 value: a byte
// permute puts q + 128 into the mantissa of 2^23 and one subtraction takes
// 2^23 + 128 away, in place of an integer conversion (I2F runs at an eighth
// of the FP32 pipe's rate; tests/test_torch_int8_kv.py checks all 256
// bytes).  deq_pair8: two such values times their scales, rounded to bf16
// and packed, the lower at the lower address.
__device__ __forceinline__ float i8f(uint32_t wx, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + i)), 8388736.0f);
}

__device__ __forceinline__ uint32_t deq_pair8(float lo, float s_lo, float hi, float s_hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(lo, s_lo), __fmul_rn(hi, s_hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element i (0-3) of the four int8 values in w, dequantized, widened back
// to fp32 (the "fma" routes).
__device__ __forceinline__ float deq(uint32_t w, int i, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(i8f(w ^ 0x80808080u, i), scale)));
}

// Eight int8 values (w0, then w1) with one scale, dequantized into one
// 16-byte piece of bf16, lower elements at lower addresses.
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, float scale) {
  const uint32_t x0 = w0 ^ 0x80808080u, x1 = w1 ^ 0x80808080u;
  return make_uint4(deq_pair8(i8f(x0, 0), scale, i8f(x0, 1), scale),
                    deq_pair8(i8f(x0, 2), scale, i8f(x0, 3), scale),
                    deq_pair8(i8f(x1, 0), scale, i8f(x1, 1), scale),
                    deq_pair8(i8f(x1, 2), scale, i8f(x1, 3), scale));
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by one bulk copy whose bytes complete on `bar` (the int8 ring's
// scales, beside the TMA boxes of K and V).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.  A wait
// that never ends (a count of arrivals or bytes that cannot be met) traps
// after 2^26 tries, seconds of waiting, so that the launch fails with an
// error the wrapper raises instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The box of `map` at (c0 inner, c1 outer) into shared memory at dst; its
// bytes complete on `bar`.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a 3D `map` at (c0 inner, c1, c2 outer) into shared memory at dst;
// its bytes complete on `bar`.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor for a tile stored with the 128-byte
// swizzle (rows of 128 bytes in atoms of 8 rows, 1024-byte aligned).
//   K-major (a, and a K-major b): rows are M or N, 64 K elements a row;
//     sbo = 1024 (the next 8 rows), lbo unused; a K step of 16 moves the
//     start by 32 bytes inside the atom.
//   MN-major b: rows are K, 64 N elements a row, one 64-column block after
//     the other; lbo = the next 64 columns, sbo = 1024 (the next 8 K rows);
//     a K step of 16 moves the start by 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // layout type 1: 128-byte swizzle
  return d;
}

// d (64 x 64, fp32, the accumulator layout of wgmma) += A (64 x 16) B (16 x 64),
// both bf16 in shared memory, by descriptor; TRANS_B 1 takes B MN-major,
// TRANS_A 1 takes A MN-major (rows K, M contiguous: the transpose of a stored
// (K, M) matrix, x^T of a weight gradient).  scale_d 0: d = A B, d's old
// value not read (the attention backward's first products of a tile).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// d (64 x 128, fp32, the accumulator layout of wgmma) += A (64 x 16) B (16 x 128),
// both bf16 in shared memory, by descriptor; TRANS_B 1 takes B MN-major,
// TRANS_A 1 takes A MN-major (rows K, M contiguous: the transpose of a stored
// (K, M) matrix, x^T of a weight gradient).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

// d (64 x 256, fp32, the accumulator layout of wgmma) += A (64 x 16) B (16 x 256),
// both bf16 in shared memory, by descriptor; TRANS_B 1 takes B MN-major,
// TRANS_A 1 takes A MN-major (rows K, M contiguous: the transpose of a stored
// (K, M) matrix, x^T of a weight gradient).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %132, %131;\n"
      "}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

template <int BN, int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 64) wgmma_m64n64<TRANS_B, TRANS_A>(d, desc_a, desc_b);
  else if constexpr (BN == 128) wgmma_m64n128<TRANS_B, TRANS_A>(d, desc_a, desc_b);
  else wgmma_m64n256<TRANS_B, TRANS_A>(d, desc_a, desc_b);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// WG consumer warpgroups (BM = 64 WG rows), BN columns, NB b operands, b
// K-major or MN-major; a K-major (x) or MN-major (A_MNMAJOR: x stored as
// (K, m), read as its transpose: the x^T dy of a weight gradient, whose K is
// the tokens); BWD compiles the MLP backward's epilogue, and only it: two b
// operands and two outputs, acc[0] -> out and acc[1] -> out2 (its dw_gate =
// x^T dg and dw_up = x^T du on one x^T tile); TWO a second (a1, b1) part
// after the first's K tiles;
// B_LDG an MN-major b TMA refuses, loaded and realigned by the producer
// warpgroup's threads (one consumer warpgroup, one b, one part);
// PERSIST the persistent x^T dy kernel (gemm_xt_kernel: A_MNMAJOR, one b,
// one part, a plain store).
template <int WG_, int BN_, int NB_, bool B_KMAJOR_, bool A_MNMAJOR_ = false, bool BWD_ = false,
          bool TWO_ = false, bool B_LDG_ = false, bool PERSIST_ = false>
struct GemmCfg {
  static constexpr int WG = WG_, BM = 64 * WG_, BN = BN_, NB = NB_;
  static constexpr bool B_KMAJOR = B_KMAJOR_, A_MNMAJOR = A_MNMAJOR_, BWD = BWD_, TWO = TWO_;
  static constexpr bool B_LDG = B_LDG_, PERSIST = PERSIST_;
  static constexpr int THREADS = 128 * (WG + 1);
  static constexpr int MIN_BLOCKS = WG == 1 ? 2 : 1;
  static constexpr int A_BYTES = BM * kBK * 2;
  static constexpr int B_BYTES = BN * kBK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int STAGES = PERSIST ? xt_stages_for(WG, BN) : stages_for(WG, BN, NB);
  static constexpr int EPI_PITCH = BN * 2 + kEpiPad;          // bytes a row of the epilogue tile
  static constexpr int EPI_BYTES = PERSIST ? BM * EPI_PITCH : 0;
  static constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + kSmemReserve;
  static_assert(WG == 1 || WG == 2, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma widths compiled here");
  static_assert(NB * BN <= (WG == 1 ? 128 : 256), "accumulators a consumer thread can hold");
  static_assert(STAGES >= 2, "a stage is filled while another is read");
  static_assert(SMEM <= kSmemBudget, "a block has 227 KB of shared memory");
  static_assert(!B_LDG || (WG == 1 && NB == 1 && !B_KMAJOR && !A_MNMAJOR && !TWO && !BWD),
                "the realigned b: one consumer warpgroup, one MN-major b, one part");
  static_assert(!BWD || NB == 2, "the MLP backward's epilogue stores two outputs");
  static_assert(!PERSIST || (A_MNMAJOR && NB == 1 && !B_KMAJOR && !BWD && !TWO && !B_LDG),
                "the persistent instance is the x^T dy of a weight gradient");
  static_assert(!PERSIST || BM * BN * 4 <= STAGES * STAGE_BYTES,
                "a split tile's fp32 sums fit the ring");
};

struct EpiArgs {
  void* out;            // (m, n) in bf16, row stride ldo elements
  const bf16* bias;     // (n,), added before the activation or the store; may be null
  int ldo;
  int mode;             // kEpiStore: a [+ bias]; kEpiAct: act(a [+ bias]); kEpiGated: act(a) * a2
  int act;
  void* out2;           // GemmCfg::BWD: the second output, (m, n) bf16 at ldo
};

struct GemmParams {
  CUtensorMap a, b0, b1;  // b1 only with two b operands, or a second part
  CUtensorMap a1;       // GemmCfg::TWO: the second part's a (b1 its b)
  int k_tiles0;         // TWO: K tiles of a part; else 0
  int m, n, k;          // k: of one part
  int k_tiles;          // ceil(K / kBK), twice that with two parts
  int k_per_split;      // K tiles of one split (blockIdx.y, its rank in the cluster)
  int splits;           // blocks of a cluster; 1: no cluster
  int m_tiles, n_tiles, group_m;
  EpiArgs epi;
  const bf16* b_ptr;    // GemmCfg::B_LDG: b (k, n) row-major, row stride ldb elements
  long long ldb;
};

// Stores (v0, v1) at (row, col), (row, col + 1) of the bf16 output o (m, n)
// at row stride ldo; col + 1 only if `two`.
__device__ __forceinline__ void store_bf16_pair(void* o, int ldo, int row, int col, bool two,
                                                float v0, float v1) {
  bf16* d = reinterpret_cast<bf16*>(o) + (size_t)row * ldo + col;
  if (two && (ldo & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v0, v1);
  } else {
    d[0] = __float2bfloat16(v0);
    if (two) d[1] = __float2bfloat16(v1);
  }
}

// Stores the pair (row, col), (row, col + 1) of the output: a0, a1 [+ bias],
// through the activation or the gate (g0, g1 the second operand's sums); BWD:
// a0, a1 to out and g0, g1 to out2 (the MLP backward's two weight gradients).
template <bool BWD>
__device__ __forceinline__ void store_pair(const GemmParams& p, int row, int col, float a0,
                                           float a1, float g0, float g1) {
  if (row >= p.m || col >= p.n) return;
  const bool two = col + 1 < p.n;
  const EpiArgs& e = p.epi;
  if constexpr (BWD) {
    store_bf16_pair(e.out, e.ldo, row, col, two, a0, a1);
    store_bf16_pair(e.out2, e.ldo, row, col, two, g0, g1);
    return;
  }
  float v0 = a0, v1 = a1;
  if (e.bias != nullptr) {
    v0 += __bfloat162float(e.bias[col]);
    if (two) v1 += __bfloat162float(e.bias[col + 1]);
  }
  if (e.mode == kEpiAct) {
    v0 = apply_act(v0, e.act);
    v1 = apply_act(v1, e.act);
  } else if (e.mode == kEpiGated) {
    v0 = apply_act(a0, e.act) * g0;
    v1 = apply_act(a1, e.act) * g1;
  }
  store_bf16_pair(e.out, e.ldo, row, col, two, v0, v1);
}

// The fp32 at the same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ float ld_cluster(const float* local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The generic address of `local`'s counterpart in the shared memory of block
// `rank` of the cluster, or `local` itself outside a cluster.  Plain loads
// through it reach the other block's shared memory and, unlike ld_cluster,
// may be issued together.
template <typename T>
__device__ __forceinline__ const T* cluster_ptr(const T* local, int rank, bool cluster) {
  if (!cluster) return local;
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(local)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

// Every thread of every block of the cluster: what each wrote to its shared
// memory before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The 16-byte-aligned piece of b at `p` (ld.global.nc: b is read-only for
// the kernel's life).
__device__ __forceinline__ uint4 ldg16(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Eight bf16 from the 32 bytes (lo, hi) starting `off` bytes into lo (off
// even: bf16 elements), shifted by 8, 4 and 2 bytes in registers; elements
// from `live` on are zeros.
__device__ __forceinline__ uint4 realign8(uint4 lo, uint4 hi, unsigned off, int live) {
  const bool s8 = off & 8, s4 = off & 4, s2 = off & 2;
  const uint32_t a0 = s8 ? lo.z : lo.x, a1 = s8 ? lo.w : lo.y, a2 = s8 ? hi.x : lo.z,
                 a3 = s8 ? hi.y : lo.w, a4 = s8 ? hi.z : hi.x, a5 = s8 ? hi.w : hi.y;
  const uint32_t b0 = s4 ? a1 : a0, b1 = s4 ? a2 : a1, b2 = s4 ? a3 : a2, b3 = s4 ? a4 : a3,
                 b4 = s4 ? a5 : a4;
  uint32_t w[4] = {s2 ? __funnelshift_r(b0, b1, 16) : b0, s2 ? __funnelshift_r(b1, b2, 16) : b1,
                   s2 ? __funnelshift_r(b2, b3, 16) : b2, s2 ? __funnelshift_r(b3, b4, 16) : b3};
  if (live < 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = 2 * i >= live ? 0u : 2 * i + 1 >= live ? (w[i] & 0xFFFFu) : w[i];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The producer warpgroup's share of a B_LDG stage: the (kBK, BN) tile of b at
// (k0, n0) into BN / 64 column blocks of kBK rows x 128 bytes, swizzled as a
// TMA box lands (16-byte piece c of row r at c ^ (r % 8)); then the proxy
// fence that lets wgmma see the stores.  Piece c of a row (8 columns) lies
// `off` bytes into the aligned piece lo_c and, unless off is 0, spills into
// the next, lo_{c+1}: the piece the next lane of the warp loads (a row's
// BN / 8 pieces are adjacent lanes of one warp), passed over by a shuffle;
// the row's last lane loads it itself.  So each aligned piece is read once,
// only where it holds some element of the row's live columns (never a
// piece past the row's end or past b), and every load of the stage is in
// flight before the first is used.
template <int BN>
__device__ __forceinline__ void load_b_tile(const GemmParams& p, unsigned char* dst, int k0,
                                            int n0, int t) {
  constexpr int PPR = BN / 8;                  // 16-byte pieces of a row
  constexpr int PER = kBK * PPR / 128;          // of a thread
  static_assert(32 % PPR == 0, "a row's pieces are lanes of one warp");
  // lo[u]: the aligned piece piece u starts in; last[u]: the one after it,
  // loaded by a row's last lane (t % PPR is the same for all of its pieces)
  uint4 lo[PER], last[PER];
  // where piece u of this thread lies: its row's pointer, byte offset, live
  // elements (recomputed after the loads rather than held in registers)
  auto where = [&](int u, const uint4*& lo_p, uintptr_t& end, unsigned& off, int& live) {
    const int e = u * 128 + t, r = e / PPR, c = e % PPR;
    const int row = k0 + r, col = n0 + 8 * c;
    const bf16* rp = p.b_ptr + (size_t)(row < p.k ? row : 0) * p.ldb;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(rp + col);
    end = reinterpret_cast<uintptr_t>(rp + p.n);  // past the row's last element
    off = (unsigned)(addr & 15);
    live = row < p.k ? min(8, p.n - col) : 0;
    lo_p = reinterpret_cast<const uint4*>(addr - off);
  };
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const uint4* lo_p;
    uintptr_t end;
    unsigned off;
    int live;
    where(u, lo_p, end, off, live);
    const bool in_b = k0 + (u * 128 + t) / PPR < p.k;
    lo[u] = in_b && reinterpret_cast<uintptr_t>(lo_p) < end ? ldg16(lo_p)
                                                           : make_uint4(0u, 0u, 0u, 0u);
    last[u] = t % PPR == PPR - 1 && live > 0 && off + 2 * live > 16
                  ? ldg16(lo_p + 1)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = u * 128 + t, r = e / PPR, c = e % PPR;
    const uint4* lo_p;
    uintptr_t end;
    unsigned off;
    int live;
    where(u, lo_p, end, off, live);
    uint4 hi;  // the next lane's piece: lo_{c+1} of the same row
    hi.x = __shfl_down_sync(0xffffffffu, lo[u].x, 1);
    hi.y = __shfl_down_sync(0xffffffffu, lo[u].y, 1);
    hi.z = __shfl_down_sync(0xffffffffu, lo[u].z, 1);
    hi.w = __shfl_down_sync(0xffffffffu, lo[u].w, 1);
    if (c == PPR - 1) hi = last[u];
    const uint4 v = live > 0 ? realign8(lo[u], hi, off, live) : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + (c >> 3) * (kBK * 128) + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  // the output tile, in groups of group_m row tiles
  const int tile = blockIdx.x;
  const int per_group = p.group_m * p.n_tiles;
  const int first_m = (tile / per_group) * p.group_m;
  const int gm = min(p.group_m, p.m_tiles - first_m);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % gm) * C::BM;
  const int n0 = (in_group / gm) * C::BN;
  const int split = blockIdx.y;
  const int kt0 = split * p.k_per_split;
  const int nk = min(p.k_per_split, p.k_tiles - kt0);

  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < C::STAGES; ++s) {
      // B_LDG: the a tile's expect_tx and the producer warpgroup's 128 stores
      mbar_init(&full[s], C::B_LDG ? 129 : 1);
      mbar_init(&empty[s], 4 * C::WG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    if constexpr (C::WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (C::B_LDG) {
      // one thread issues the a tile's copy, all 128 load the b tile
#pragma unroll 1
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE_BYTES;
        const int k0 = (kt0 + i) * kBK;
        if (threadIdx.x == 0) {
          mbar_expect_tx(&full[s], C::A_BYTES);
          tma_load_2d(st, &p.a, &full[s], k0, m0);
        }
        load_b_tile<C::BN>(p, st + C::A_BYTES, k0, n0, threadIdx.x);
        mbar_arrive(&full[s]);
      }
    } else if (threadIdx.x == 0) {
#pragma unroll 1
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        // the second part of a two-part sum reads (a1, b1) from its K tile 0
        const bool second = C::TWO && kt0 + i >= p.k_tiles0;
        const int k0 = (kt0 + i - (second ? p.k_tiles0 : 0)) * kBK;
        const CUtensorMap* amap = second ? &p.a1 : &p.a;
        if constexpr (C::A_MNMAJOR) {
#pragma unroll
          for (int c = 0; c < C::WG; ++c)
            tma_load_2d(st + c * 64 * 128, amap, &full[s], m0 + 64 * c, k0);
        } else {
          tma_load_2d(st, amap, &full[s], k0, m0);
        }
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          const CUtensorMap* map = j == 0 && !second ? &p.b0 : &p.b1;
          unsigned char* dst = st + C::A_BYTES + j * C::B_BYTES;
          if constexpr (C::B_KMAJOR) {
            tma_load_2d(dst, map, &full[s], k0, n0);
          } else {
#pragma unroll
            for (int c = 0; c < C::BN / 64; ++c)
              tma_load_2d(dst + c * 64 * 128, map, &full[s], n0 + 64 * c, k0);
          }
        }
      }
    }
  } else {
    if constexpr (C::WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // this consumer's 64 rows of the tile
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    float acc[C::NB][C::BN / 2];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < C::BN / 2; ++e) acc[j][e] = 0.0f;

#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_base = smem_u32(smem + s * C::STAGE_BYTES) + cw * 64 * 128;
      const uint32_t b_base = smem_u32(smem + s * C::STAGE_BYTES + C::A_BYTES);
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // an MN-major a: rows of K, this warpgroup's 64 m a row (one box)
        const uint64_t da = C::A_MNMAJOR ? desc_sw128(a_base + kk * 16 * 128, 64 * 128, 1024)
                                         : desc_sw128(a_base + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          const uint32_t bb = b_base + j * C::B_BYTES;
          const uint64_t db = C::B_KMAJOR ? desc_sw128(bb + kk * 32, 16, 1024)
                                          : desc_sw128(bb + kk * 16 * 128, 64 * 128, 1024);
          wgmma_tile<C::BN, C::B_KMAJOR ? 0 : 1, C::A_MNMAJOR ? 1 : 0>(acc[j], da, db);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_acc(acc[j]);
      wgmma_wait<1>();  // the products of step i - 1 have retired
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::NB; ++j) fence_acc(acc[j]);

    // accumulator layout: register 4 c + 2 h + e holds row 16 warp + lane / 4
    // + 8 h, column 8 c + 2 (lane % 4) + e of this warpgroup's 64 x BN
    const int row0 = m0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    if (p.splits == 1) {
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * c + 2 * h;
          const float g0 = C::NB == 2 ? acc[C::NB - 1][r] : 0.0f;
          const float g1 = C::NB == 2 ? acc[C::NB - 1][r + 1] : 0.0f;
          store_pair<C::BWD>(p, row0 + 8 * h, col0 + 8 * c, acc[0][r], acc[0][r + 1], g0, g1);
        }
      }
    } else {
      // a split of K: this block's sums stay in its shared memory, over the
      // ring, which both warpgroups have finished reading
      if constexpr (C::WG > 1) asm volatile("bar.sync 1, %0;\n" ::"n"(128 * C::WG) : "memory");
      float* red = reinterpret_cast<float*>(smem);
      const int r0 = cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = red + (r0 + 8 * h) * C::BN + 8 * c + 2 * (lane % 4);
          dst[0] = acc[0][4 * c + 2 * h];
          dst[1] = acc[0][4 * c + 2 * h + 1];
        }
    }
  }
  if (p.splits > 1) {
    cluster_sync();  // every split's sums are in its block's shared memory
    if (wg > 0) {
      // this block's share of the tile's live elements, each summed over
      // the cluster's blocks in rank order, stored once
      const float* red = reinterpret_cast<const float*>(smem);
      const int rows = min(C::BM, p.m - m0), cols = min(C::BN, p.n - n0);
      const int step = 128 * C::WG * p.splits;
      for (int e = split * 128 * C::WG + threadIdx.x - 128; e < rows * cols; e += step) {
        const int r = e / cols, c = e % cols;
        float v = 0.0f;
        for (int q = 0; q < p.splits; ++q) v += ld_cluster(red + r * C::BN + c, q);
        if (p.epi.bias != nullptr) v += __bfloat162float(p.epi.bias[n0 + c]);
        reinterpret_cast<bf16*>(p.epi.out)[(size_t)(m0 + r) * p.epi.ldo + n0 + c] =
            __float2bfloat16(v);
      }
    }
    cluster_sync();  // no block leaves while another reads its shared memory
  }
}

// The persistent kernel's schedule (launch_gemm_xt; chip/h100.xt_schedule
// mirrors it): `grid` blocks.  Block b takes the output tiles b, b + grid,
// b + 2 grid, ... below `full`, each over all of K; then, when `tail` > 0,
// the blocks run as clusters of `splits`, and cluster c < tail takes tile
// full + c, its rank r the K tiles [r per, (r + 1) per).  full is a whole
// number of waves (grid tiles each), so every block takes as many whole
// tiles as any other, and the short last wave is cut by K instead.
struct XtSched {
  int grid, full, tail, splits, per;
};

// Origin (m0, n0) of output tile `tile` in the group_m order gemm_kernel
// visits.
template <class C>
__device__ __forceinline__ void tile_origin(const GemmParams& p, int tile, int& m0, int& n0) {
  const int per_group = p.group_m * p.n_tiles;
  const int first_m = (tile / per_group) * p.group_m;
  const int gm = min(p.group_m, p.m_tiles - first_m);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % gm) * C::BM;
  n0 = (in_group / gm) * C::BN;
}

// x^T dy on the mainloop of gemm_kernel, persistent (C::PERSIST): a stored
// (K, m) x read as its MN-major transpose, dy (K, n) MN-major, out (m, n)
// bf16, one part, no bias.  The producer thread walks the block's tiles and
// their K steps as one sequence of stages, so it runs into the next tile's
// stages while the consumers store the last; each consumer warpgroup stores
// its 64 rows through its padded tile of shared memory (a named barrier
// before it is written, since the previous tile's reads, and after) and out
// in 16-byte pieces.  A tile split over a cluster leaves each block's fp32
// sums in its ring (the producer has nothing left to load: a split tile is
// a block's last), and every block adds up its share of the tile over the
// cluster's blocks in rank order.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    gemm_xt_kernel(const __grid_constant__ GemmParams p, const XtSched q) {
  static_assert(C::PERSIST, "the persistent instance");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* epi = smem + C::STAGES * C::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + C::EPI_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int blk = blockIdx.x;
  const int n_full = blk < q.full ? (q.full - 1 - blk) / q.grid + 1 : 0;
  const int rank = blk % q.splits;  // the rank in the cluster: clusters run along x
  const bool split = q.tail > 0 && blk / q.splits < q.tail;
  const int units = n_full + (split ? 1 : 0);
  // unit u of this block: a whole tile, or (the last) its cluster's split tile
  auto unit = [&](int u, int& m0, int& n0, int& kt0, int& nk) {
    const bool last = u == n_full;
    tile_origin<C>(p, last ? q.full + blk / q.splits : blk + u * q.grid, m0, n0);
    kt0 = last ? rank * q.per : 0;
    nk = last ? min(q.per, p.k_tiles - kt0) : p.k_tiles;
  };

  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::WG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (C::WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0, ph = 0;
#pragma unroll 1
      for (int u = 0; u < units; ++u) {
        int m0, n0, kt0, nk;
        unit(u, m0, n0, kt0, nk);
#pragma unroll 1
        for (int i = 0; i < nk; ++i) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          const int k0 = (kt0 + i) * kBK;
#pragma unroll
          for (int c = 0; c < C::WG; ++c)
            tma_load_2d(st + c * 64 * 128, &p.a, &full[s], m0 + 64 * c, k0);
#pragma unroll
          for (int c = 0; c < C::BN / 64; ++c)
            tma_load_2d(st + C::A_BYTES + c * 64 * 128, &p.b0, &full[s], n0 + 64 * c, k0);
          if (++s == C::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    if (split) {  // the two cluster barriers of the split tile's sum
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  if constexpr (C::WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;  // this consumer's 64 rows of the tile
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  unsigned char* etile = epi + cw * 64 * C::EPI_PITCH;
  bf16* out = reinterpret_cast<bf16*>(p.epi.out);
  const int ldo = p.epi.ldo;
  const bool vec = ldo % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  float acc[C::BN / 2];
  int s = 0, ph = 0, prev = 0;
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    int m0, n0, kt0, nk;
    unit(u, m0, n0, kt0, nk);
#pragma unroll
    for (int e = 0; e < C::BN / 2; ++e) acc[e] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      mbar_wait(&full[s], ph);
      const uint32_t a_base = smem_u32(smem + s * C::STAGE_BYTES) + cw * 64 * 128;
      const uint32_t b_base = a_base - cw * 64 * 128 + C::A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_tile<C::BN, 1, 1>(acc, desc_sw128(a_base + kk * 16 * 128, 64 * 128, 1024),
                                desc_sw128(b_base + kk * 16 * 128, 64 * 128, 1024));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the products of the previous step have retired
      if (i > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == C::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);  // the tile's last stage

    // accumulator layout: register 4 c + 2 h + e holds row 16 warp + lane / 4
    // + 8 h, column 8 c + 2 (lane % 4) + e of this warpgroup's 64 x BN
    if (u < n_full) {
      // the previous tile's reads of this warpgroup's epilogue tile are done
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(etile + (warp * 16 + lane / 4 + 8 * h) * C::EPI_PITCH +
                                             (8 * c + 2 * (lane % 4)) * 2) = v;
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      constexpr int PIECES = C::BN / 8;  // 16-byte pieces of a row
#pragma unroll 4
      for (int e = t; e < 64 * PIECES; e += 128) {
        const int r = e / PIECES, c = e % PIECES;
        const int row = m0 + cw * 64 + r, col = n0 + 8 * c;
        if (row >= p.m || col >= p.n) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(etile + r * C::EPI_PITCH + 16 * c);
        bf16* dst = out + (size_t)row * ldo + col;
        if (vec && col + 8 <= p.n) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const bf16* src = reinterpret_cast<const bf16*>(&v);
          for (int j = 0; j < 8 && col + j < p.n; ++j) dst[j] = src[j];
        }
      }
    } else {
      // this block's piece of a split tile: its sums into its ring, which
      // both warpgroups have finished reading
      if constexpr (C::WG > 1) asm volatile("bar.sync 1, %0;\n" ::"n"(128 * C::WG) : "memory");
      float* red = reinterpret_cast<float*>(smem);
      const int r0 = cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (r0 + 8 * h) * C::BN + 8 * c + 2 * (lane % 4)) =
              make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      cluster_sync();  // every piece's sums are in its block's shared memory
      // this block's share of the tile, 8 columns a thread at a time, each
      // summed over the cluster's blocks in rank order
      const int rows = min(C::BM, p.m - m0), cols = min(C::BN, p.n - n0);
      constexpr int PIECES = C::BN / 8;
      for (int e = rank * 128 * C::WG + (threadIdx.x - 128); e < rows * PIECES;
           e += 128 * C::WG * q.splits) {
        const int r = e / PIECES, c = e % PIECES;
        if (8 * c >= cols) continue;
        float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < q.splits; ++k) {
          const float4* src = reinterpret_cast<const float4*>(
              cluster_ptr(red + r * C::BN + 8 * c, k, true));
          const float4 lo = src[0], hi = src[1];
          v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
          v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
        }
        const int row = m0 + r, col = n0 + 8 * c;
        bf16* dst = out + (size_t)row * ldo + col;
        if (vec && col + 8 <= p.n) {
          uint4 w;
          uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
            wp[j] = *reinterpret_cast<const uint32_t*>(&b2);
          }
          *reinterpret_cast<uint4*>(dst) = w;
        } else {
          for (int j = 0; j < 8 && col + j < p.n; ++j) dst[j] = __float2bfloat16(v[j]);
        }
      }
      cluster_sync();  // no block leaves while another reads its shared memory
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  });
  return fn;
}

// What TMA takes: a 16-byte aligned base and a row stride of a multiple of
// 16 bytes (bf16: of 8 elements).
inline bool tma_ok(const void* ptr, long long ld_elems) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (ld_elems * 2) % 16 == 0;
}

struct MapKey {
  const void* ptr;
  unsigned long long inner, outer, stride;
  unsigned box_inner, box_outer;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && stride == o.stride &&
           box_inner == o.box_inner && box_outer == o.box_outer;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<uintptr_t>(k.ptr);
    for (unsigned long long v : {k.inner, k.outer, k.stride,
                                 (unsigned long long)k.box_inner << 32 | k.box_outer})
      h = h * 0x9E3779B97F4A7C15ull ^ (size_t)v;
    return h;
  }
};

// The tensor map of a row-major bf16 matrix (outer rows of inner elements,
// row stride stride_elems) read in boxes of box_inner x box_outer with the
// 128-byte swizzle; from the cache when this (pointer, shape, stride, box)
// was seen before.  Returns 0, or -1 if the encoding was refused.
inline int tensor_map(CUtensorMap* out, const void* ptr, long long inner, long long outer,
                      long long stride_elems, int box_inner, int box_outer) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static std::mutex mu;
  const MapKey key{ptr, (unsigned long long)inner, (unsigned long long)outer,
                   (unsigned long long)stride_elems, (unsigned)box_inner, (unsigned)box_outer};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_elems * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return 0;
}

// The tensor map of a contiguous (outer, mid, inner) tensor of elements of
// elem bytes (1: int8, 2: bf16, 4: fp32) read in boxes of 128 bytes x box_mid x 1
// with the 128-byte swizzle (the attention kernels' K and V tiles: inner the
// head dim, mid the keys, outer batch x heads); from the cache when this
// (pointer, shape, box) was seen before.  Returns 0, or -1 if the encoding
// was refused.
inline int tensor_map_3d(CUtensorMap* out, const void* ptr, int elem, long long inner,
                         long long mid, long long outer, int box_mid) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static std::mutex mu;
  const MapKey key{ptr, (unsigned long long)inner, (unsigned long long)mid,
                   (unsigned long long)outer, (unsigned)elem, (unsigned)box_mid};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr || (elem != 1 && elem != 2 && elem != 4)) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)(inner * elem), (cuuint64_t)(inner * mid * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_mid, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUtensorMap map;
  if (encode(&map,
             elem == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3,
             const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return 0;
}

// a: (m, k) row stride lda, boxes of 64 K x BM rows; MN-major (mn_major):
// stored (k, m) row stride lda, boxes of 64 m x 64 K rows (one a warpgroup).
inline int map_a(CUtensorMap* out, const void* a, int m, int k, int lda, int bm,
                 bool mn_major = false) {
  return mn_major ? tensor_map(out, a, m, k, lda, 64, kBK) : tensor_map(out, a, k, m, lda, kBK, bm);
}

// b MN-major: (k, n) row stride ldb, boxes of 64 columns x 64 K rows;
// K-major: stored (n, k) row stride ldb, boxes of 64 K x bn rows.
inline int map_b(CUtensorMap* out, const void* b, int n, int k, int ldb, bool kmajor, int bn) {
  return kmajor ? tensor_map(out, b, k, n, ldb, kBK, bn) : tensor_map(out, b, n, k, ldb, 64, kBK);
}

// Row tiles a group of the block order spans.
constexpr int kGroupM = 8;
// Splits of K at most: the blocks of a cluster that any card must take
// (chip/h100.py MAX_SPLITS).
constexpr int kMaxSplits = 8;

// Launches gemm_kernel<C> over every output tile and `splits` splits of K
// (k_per_split K tiles each; the last may hold fewer, none is empty), the
// splits of a tile as one cluster.  p.a, p.b0 (and p.b1) must be set; with
// C::TWO also p.a1 and p.b1, a second (m, k) x (k, n) product summed after
// the first (k the depth of one part, k_per_split counted over both).
// Returns 0, a CUDA error, or -1 for what it does not take.
template <class C>
int launch_gemm(GemmParams& p, int m, int n, int k, int k_per_split, cudaStream_t stream) {
  static uint64_t configured = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(gemm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << dev;
  }
  p.m = m;
  p.n = n;
  p.k = k;
  p.k_tiles0 = C::TWO ? (k + kBK - 1) / kBK : 0;
  p.k_tiles = (C::TWO ? 2 : 1) * ((k + kBK - 1) / kBK);
  p.k_per_split = k_per_split;
  p.splits = (p.k_tiles + k_per_split - 1) / k_per_split;
  p.m_tiles = (m + C::BM - 1) / C::BM;
  p.n_tiles = (n + C::BN - 1) / C::BN;
  p.group_m = kGroupM;
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  if (tiles >= (1ll << 31) || p.splits > 65535) return -1;
  if (p.splits == 1) {
    gemm_kernel<C><<<dim3((unsigned)tiles, 1), C::THREADS, C::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
  }
  // the tile's sums must fit the ring, and only a plain store is linear
  if (p.splits > kMaxSplits || C::NB != 1 || p.epi.mode != kEpiStore ||
      C::BM * C::BN * 4 > C::STAGES * C::STAGE_BYTES)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, p.splits, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gemm_kernel<C>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The schedule of the persistent kernel over `tiles` output tiles of
// k_tiles K tiles, with `cap` blocks resident at once (a multiple of s) and
// clusters of s blocks for the short last wave; false when s does not fit:
// the last wave is not short (none, or more tiles than cap / s clusters),
// or a rank would get no K tile.  s = 1: no clusters, the tiles dealt out
// over min(tiles, cap) blocks.  chip/h100.xt_schedule is the same rule.
inline bool xt_schedule(long long tiles, int k_tiles, int cap, int s, XtSched& q) {
  if (s == 1) {
    q.grid = (int)(tiles < cap ? tiles : cap);
    q.full = (int)tiles;
    q.tail = 0;
    q.splits = 1;
    q.per = k_tiles;
    return true;
  }
  const int per = (k_tiles + s - 1) / s;
  if ((k_tiles + per - 1) / per != s || cap < s) return false;
  const long long waves = tiles / cap, tail = tiles % cap;
  if (tail == 0 || tail > cap / s) return false;
  q.grid = waves > 0 ? cap : (int)tail * s;
  q.full = (int)(waves * cap);
  q.tail = (int)tail;
  q.splits = s;
  q.per = per;
  return true;
}

// Blocks of gemm_xt_kernel<C> resident at once on the current device in
// clusters of s (s = 1: no clusters): the SMs times the blocks an SM holds,
// or the clusters the card can hold at once times s; once a device and s.
// Returns 0 when it cannot tell.
template <class C>
int xt_capacity(int s) {
  static int cache[64][kMaxSplits + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || s < 1 || s > kMaxSplits) return 0;
  if (dev < 64 && cache[dev][s] > 0) return cache[dev][s];
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(gemm_xt_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_xt_kernel<C>, C::THREADS,
                                                    C::SMEM) != cudaSuccess)
    return 0;
  int cap = sms * per_sm / s * s;
  if (s > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(s * sms), 1, 1);
    cfg.blockDim = dim3(C::THREADS, 1, 1);
    cfg.dynamicSmemBytes = C::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, gemm_xt_kernel<C>, &cfg) != cudaSuccess) return 0;
    if (clusters * s < cap) cap = clusters * s;
  }
  if (dev < 64) cache[dev][s] = cap;
  return cap;
}

// Launches gemm_xt_kernel<C> for out (m, n) = x^T dy over K = k: the K
// tiles of k_per_split give the clusters' size s = ceil(K tiles /
// k_per_split) the plan chose for the short last wave (1: none); where s
// does not fit the card's resident clusters, no clusters.  p.a and p.b0
// must be set, p.epi a plain store without bias.  Returns 0, a CUDA error,
// or -1 for what it does not take.
template <class C>
int launch_gemm_xt(GemmParams& p, int m, int n, int k, int k_per_split, cudaStream_t stream) {
  if (p.epi.mode != kEpiStore || p.epi.bias != nullptr) return -1;
  p.m = m;
  p.n = n;
  p.k = k;
  p.k_tiles0 = 0;
  p.k_tiles = (k + kBK - 1) / kBK;
  p.k_per_split = k_per_split;
  p.m_tiles = (m + C::BM - 1) / C::BM;
  p.n_tiles = (n + C::BN - 1) / C::BN;
  p.group_m = kGroupM;
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  const int s = (p.k_tiles + k_per_split - 1) / k_per_split;
  if (tiles >= (1ll << 31) || s < 1 || s > kMaxSplits) return -1;
  const int cap1 = xt_capacity<C>(1);
  if (cap1 < 1) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : -1;
  }
  XtSched q;
  const int cap = s > 1 ? xt_capacity<C>(s) : 0;
  if (!(s > 1 && xt_schedule(tiles, p.k_tiles, cap, s, q)))
    xt_schedule(tiles, p.k_tiles, cap1, 1, q);
  p.splits = q.splits;
  if (q.splits == 1) {
    gemm_xt_kernel<C><<<q.grid, C::THREADS, C::SMEM, stream>>>(p, q);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)q.grid, 1, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_xt_kernel<C>, p, q);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace
}  // namespace hg
