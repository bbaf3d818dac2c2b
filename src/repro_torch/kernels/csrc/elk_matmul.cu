// ELK-blocked matrix product for Hopper (sm_90a): out = x @ y.
//
//   x (M, K), row stride lda;  y (K, N) row-major, or given as its transpose
//   (N, K) row-major (the view embed.t() of a tied embedding);  out (M, N)
//   contiguous, in x's type, from an fp32 sum.
//
// Replaces the TPU kernel src/repro/kernels/elk_matmul/kernel.py:31
// (_matmul_kernel, called by elk_matmul at :45).  Same function: output
// tiles, the K loop innermost with the fp32 accumulator held across it,
// each output element's K sum in a fixed order, ragged shapes exact.  What
// differs: the Pallas grid pads x and y to block multiples in HBM; here
// nothing is copied, the loads past M, N and K arrive as zeros and the
// stores past M and N are skipped.
//
// What bounds it on an H100 SXM (datasheet: 3.35 TB/s, 989 TFLOP/s dense
// bf16) at the serving shapes of qwen3-14b, bf16: with m <= 32 rows (decode
// steps, short chunks, the LM head) reading the weight once, q/o (5120 x
// 5120) 0.0157 ms, k/v (5120 x 1024) 0.0032 ms, the LM head (5120 x 151936)
// 0.465 ms; at m = 4096 (a lock-step prefill) the operations, q/o 0.217 ms,
// k/v 0.043 ms.
//
// Eight routes, chosen by the wrapper from dtype, m and strides before the
// launch (chip/h100.smem_plan says which, and its tiles); a refused launch
// raises there, no route stands in for another.  The TMA + wgmma routes are
// compiled here, the mma_sync and FMA kernels in elk_matmul_sync.cu (two
// libraries, so that their nvcc processes run side by side):
//   * "wgmma" (bf16, m >= 64, operands TMA takes: 16-byte aligned bases and
//     row strides of whole 16 bytes): the mainloop of hopper_gemm.cuh, TMA
//     into a ring of stages under mbarriers, a producer warp and one or two
//     consumer warpgroups on wgmma m64nNk16, (bm, bn) in {64, 128} x {64,
//     128, 256} from the plan, y MN-major as (K, N) and K-major as the
//     transpose of (N, K).  The mma_sync kernel loads every fragment
//     by 32-bit shared loads and pays a block barrier and a ring step per K
//     step; its time tracked its K steps, not its bytes (PERF.md).
//   * "splitk" (bf16, m < 64, TMA's rules): the same mainloop on one 64-row
//     tile (TMA zero-fills the rows past m; the tensor cores have time to
//     spare at these shapes) with K split over s <= 8 blocks, one cluster a
//     tile, so that the SMs stream weight (k/v at m = 8: 16 column tiles x
//     8 splits, where the mma_sync plan runs 32 blocks on 132 SMs), rows of
//     y read in pieces of 128 bytes or more, the splits summed in rank order
//     over the cluster's shared memory.  The LM head has 1187 tiles and
//     takes s = 1.
//   * "wgmma_xt" (bf16, x read transposed, the x^T dy of a weight gradient,
//     operands TMA takes, any m): the persistent instance of the mainloop
//     (GemmCfg::PERSIST, gemm_xt_kernel), a block an SM (two at 64 rows)
//     walking its output tiles in the group_m order, the producer running
//     into the next tile's stages while the consumers store the last
//     through shared memory in 16-byte pieces; its own plan
//     (chip/h100._xt_plan: (bm, bn) of ELK_XT_TILES and the clusters that
//     split a short last wave by K, from a model of the tiles' loads and
//     the last block's products).
//   * "wgmma_realign" / "splitk_realign" (bf16, x as TMA takes it, y (K, N)
//     row-major with a row stride or base TMA refuses: hymba's untied LM
//     head, rows of 32001 elements, 64002 bytes; any odd N or unaligned
//     view): the same mainloop and consumers, one consumer warpgroup (bm
//     64), the y tiles loaded by the producer warpgroup's 128 threads in
//     16-byte aligned pieces and realigned in registers (hopper_gemm.cuh,
//     B_LDG) into the swizzled tiles TMA would write.  No padded copy of the
//     weight: every model leaf, checkpoint and streamed record keeps the
//     reference's layout.
//   * "fma" / "fma_splitk" (fp32; TF32 would miss the reference's fp32
//     tolerance; elk_matmul_sync.cu): one block an output tile of the plan
//     (16 x 32 to 128 x 128), a cp.async ring of four stages, each thread's
//     register tile read from shared memory 16 bytes at a time (x four K
//     steps a row, y four columns a K step), one product a K step in order;
//     where the output tiles do not cover the SMs (hymba's w_bc, N 32, and
//     w_dt at a decode step) K is split over up to 8 blocks of a cluster and
//     the splits' sums are added in rank order over distributed shared
//     memory, as "splitk" does.
//   * "mma_sync" (bf16 that neither TMA route takes, and any forced block
//     shape; elk_matmul_sync.cu): one block owns one (bm, bn) output tile and walks K inside the block;
//     blocks share nothing.  The operand tiles go through a ring of kStages
//     shared-memory buffers filled by cp.async (16 bytes a thread, zero-
//     filled past the edges; element by element where a row does not start
//     on 16 bytes), rows padded by 16 bytes.  bf16: mma.sync m16n8k16, A
//     fragments by 32-bit shared loads, B by 32-bit loads for y given as
//     (N, K) and by ldmatrix.trans for y as (K, N); 4 warps (8 at bm =
//     128).  fp32 with a forced block shape: FMA, one product a K step in
//     order, scalar shared loads (the fp32 route until "fma" came).
// Every route sums each output element's K steps in a fixed order and uses
// no atomics: the same inputs give the same bits on every run.
//
// The training side's operands (kernels/elk_matmul/ops.py, an autograd
// Function): x given as the transpose of a stored (k, m) matrix (x_trans,
// the x^T dy of a weight gradient, contracted over the tokens) is read in
// place on every route: "wgmma_xt" loads it as MN-major A tiles, the
// mma_sync kernel keeps its (bk, BM) tile and builds A fragments by
// ldmatrix.x4.trans, the FMA kernel reads the stored tile; and a second
// pair x2, y2 (same shapes and strides, x as stored and y transposed) is
// summed after the first in the same accumulator, its K tiles after x's.
// The two-part sum is an instance of its own (TWO) on every route, so the
// one-part products of serving carry no test of it.
//
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; the
// mma_sync kernel's times in brackets): decode q/o 0.0253 ms (0.0420), k/v
// 0.0110 (0.0363), the LM head 0.523 (0.658), against bounds of 0.0157,
// 0.0032 and 0.465; a chunk of 256 q/o 0.0476 (0.151); prefill q/o 0.391
// (1.030) against 0.217.  torch.matmul is faster still at every shape, by
// 1.06x (the LM head) to 1.59x (PERF.md has every shape).  Training's x^T
// dy at 4096 tokens on "wgmma_xt": q/o 0.304 ms, k/v 0.079, the LM head
// 8.31, the MLP's dw_down 0.97, against bounds of 0.217, 0.043, 6.44 and
// 0.74; torch.matmul is 1.06-1.39x faster still.  At these shapes the
// tiles' loads into shared memory, near 8.8 TB/s all SMs together, bound
// the 128 x 128 tiles, and the products (at 0.74 of the peak) the 128 x
// 256 ones (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

// the TMA instances: (consumer warpgroups, bn); chip/h100.py WG_TILE_M x
// WG_TILE_N less the widths one warpgroup cannot hold (wg_acc_fits)
#define ELK_TMA_TILES(F) F(1, 64) F(1, 128) F(2, 64) F(2, 128) F(2, 256)

template <int WG, int BN>
int launch_tma(hg::GemmParams& p, bool y_kmajor, bool two, int m, int n, int k, int k_per_split,
               cudaStream_t stream) {
  if (two) {  // the MLP's dx = dg w_gate^T + du w_up^T: y K-major
    if (!y_kmajor) return -1;
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, true, false, false, true>>(p, m, n, k,
                                                                          k_per_split, stream);
  }
  if (y_kmajor)
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, true>>(p, m, n, k, k_per_split, stream);
  return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, false>>(p, m, n, k, k_per_split, stream);
}


// the persistent x^T dy instances (GemmCfg::PERSIST, route "wgmma_xt"):
// (consumer warpgroups, bn); chip/h100.py XT_TILES
#define ELK_XT_TILES(F) F(1, 128) F(2, 128) F(2, 256)

template <int WG, int BN>
int launch_xt(hg::GemmParams& p, int m, int n, int k, int k_per_split, cudaStream_t stream) {
  return hg::launch_gemm_xt<hg::GemmCfg<WG, BN, 1, false, true, false, false, false, true>>(
      p, m, n, k, k_per_split, stream);
}

// the realigned y's instances (GemmCfg::B_LDG): one consumer warpgroup, bn
// 64 or 128 (chip/h100.py REALIGN_TILE_N)
#define ELK_REALIGN_TILES(F) F(1, 64) F(1, 128)

template <int WG, int BN>
int launch_realign(hg::GemmParams& p, int m, int n, int k, int k_per_split,
                   cudaStream_t stream) {
  return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, false, false, false, false, true>>(
      p, m, n, k, k_per_split, stream);
}

}  // namespace

extern "C" {

// Launches out = x @ y [+ x2 @ y2] on the TMA + wgmma mainloop (routes
// "wgmma" and "splitk") on `stream`; returns cudaGetLastError() (0 =
// launched) or -1 for arguments it does not take.  bf16 only.  x (m, k) row
// stride lda (x_trans 0), or stored (k, m) row stride lda and read as its
// transpose (x_trans 1, MN-major: the x^T dy of a weight gradient, with y
// MN-major); y (k, n) row stride ldy (y_trans 0, MN-major) or stored (n, k)
// row stride ldy (y_trans 1, K-major); x2 and y2 (or null) a second part of
// the same shapes and strides, with x_trans 0 and y_trans 1, summed after
// the first in one fp32 sum;
// every base 16-byte aligned and every stride a multiple of 8 elements, but
// with `realign` 1 (routes "wgmma_realign", "splitk_realign": x_trans 0,
// y_trans 0, no second part, wg 1) y's, which may be anything.  wg
// consumer warpgroups (64 wg rows a tile), bn columns, the K tiles of both
// parts cut in splits of k_per_split tiles of 64 (at most 8 splits, each
// tile's a cluster).
int elk_matmul_tma_launch(const void* x, const void* y, void* out, const void* x2,
                          const void* y2, int m, int n, int k, int lda, int ldy, int x_trans,
                          int y_trans, int wg, int bn, int k_per_split, int realign,
                          void* stream) {
  if (m < 1 || n < 1 || k < 1 || k_per_split < 1) return -1;
  if (lda < (x_trans ? m : k) || ldy < (y_trans ? k : n)) return -1;
  if (!hg::tma_ok(x, lda) || (!realign && !hg::tma_ok(y, ldy))) return -1;
  if (realign && (x_trans || y_trans || x2 != nullptr || wg != 1)) return -1;
  if ((x2 == nullptr) != (y2 == nullptr)) return -1;
  if (x2 != nullptr && (!hg::tma_ok(x2, lda) || !hg::tma_ok(y2, ldy))) return -1;
  hg::GemmParams p{};
  p.epi.out = out;
  p.epi.bias = nullptr;
  p.epi.ldo = n;
  p.epi.mode = hg::kEpiStore;
  p.epi.act = 0;
  if (hg::map_a(&p.a, x, m, k, lda, 64 * wg, x_trans != 0) != 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (realign) {
    p.b_ptr = static_cast<const hg::bf16*>(y);
    p.ldb = ldy;
#define ELK_REALIGN_CASE(WG, BN) \
    if (bn == BN) return launch_realign<WG, BN>(p, m, n, k, k_per_split, s);
    ELK_REALIGN_TILES(ELK_REALIGN_CASE)
#undef ELK_REALIGN_CASE
    return -1;
  }
  if (hg::map_b(&p.b0, y, n, k, ldy, y_trans != 0, bn) != 0) return -1;
  p.b1 = p.b0;
  if (x2 != nullptr) {
    if (hg::map_a(&p.a1, x2, m, k, lda, 64 * wg, x_trans != 0) != 0) return -1;
    if (hg::map_b(&p.b1, y2, n, k, ldy, y_trans != 0, bn) != 0) return -1;
  }
  if (x_trans) {  // x^T dy of a weight gradient: dy (k, n) row-major
    if (y_trans || x2 != nullptr) return -1;
#define ELK_XT_CASE(WG, BN) \
    if (wg == WG && bn == BN) return launch_xt<WG, BN>(p, m, n, k, k_per_split, s);
    ELK_XT_TILES(ELK_XT_CASE)
#undef ELK_XT_CASE
    return -1;
  }
#define ELK_TMA_CASE(WG, BN)                                                                \
  if (wg == WG && bn == BN)                                                                 \
    return launch_tma<WG, BN>(p, y_trans != 0, x2 != nullptr, m, n, k, k_per_split, s);
  ELK_TMA_TILES(ELK_TMA_CASE)
#undef ELK_TMA_CASE
  return -1;
}

// Blocks of the persistent x^T dy instance (wg, bn) resident at once on the
// current device in clusters of `splits` blocks (1: no clusters), which
// launch_gemm_xt deals the tiles out over; 0 when it cannot tell, -1 for an
// instance it does not compile.  chip_smoke.py prints it beside the plan's.
int elk_matmul_xt_capacity(int wg, int bn, int splits) {
#define ELK_XT_CAP(WG, BN) \
  if (wg == WG && bn == BN)  \
    return hg::xt_capacity<hg::GemmCfg<WG, BN, 1, false, true, false, false, false, true>>(splits);
  ELK_XT_TILES(ELK_XT_CAP)
#undef ELK_XT_CAP
  return -1;
}

}  // extern "C"
