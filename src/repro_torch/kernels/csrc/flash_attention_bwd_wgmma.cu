// The backward of flash attention for Hopper (sm_90a), route "wgmma": bf16 at
// head dims 64, 72, 80, 96, 112, 128 and 256.  What it computes, the masks, GQA
// and the rows with no live key are as in flash_attention_bwd.cu, which keeps
// the routes "mma_sync" (head dims 16 and 32) and "fma" (fp32); this source
// holds the "wgmma" route only, so that its nvcc runs beside that one's.
//
//   P_ij = exp(scale q_i . k_j - lse_i) (0 where j is not live for i),
//   delta_i = sum_d dO[i, d] O[i, d], dS = P (dO V^T - delta),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO
//
// What bounds it on an H100 SXM (datasheet: 989 TFLOP/s dense bf16, 3.35
// TB/s): at qwen3-14b's training shape (B 8, Hq 40, Hkv 8, S 512, D 128,
// causal) the five products of the causal half are 54 GFLOP, 0.054 ms; the
// bytes (q, o, dO, k, v, lse in; dq, dk, dv out) 0.202 GB, 0.060 ms.  The two
// passes below run eight products (S three times, dP twice), 0.087 ms at
// the peak.  Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): 0.404 ms there, against 0.697 on route "mma_sync" and 0.319 for
// SDPA's backward; each warpgroup's chain of products and waits bounds it,
// with two consumer warpgroups an SM.
//
// Design.  Two launches on one stream, as the other routes: each output
// element is summed in one block in a fixed order (dQ: key tiles in order;
// dK, dV: the G query heads of the group, then their query tiles, in order),
// so there are no atomics and a run gives the same bits every time.
//   * dQ pass: a block owns (b, query head, 128 query rows), two consumer
//     warpgroups of 64 rows and one producer warp.  The producer loads the Q
//     and dO tiles once and then K and V tiles of 64 keys through a ring of
//     stages, all by TMA on mbarriers, the next tiles in flight while this
//     one's products run.  Each consumer first takes delta_i = rowsum(dO o O)
//     of its rows by 16-byte loads and writes (lse_i log2 e, delta_i) for the
//     dK/dV pass; then a tile is S = Q K^T and dP = dO V^T on wgmma from
//     shared memory, dS formed in registers and fed as the register A of dQ
//     += dS K (wgmma RS, K read MN-major from the same stage).
//   * dK/dV pass: a block owns (b, kv head, 64 keys), two consumer
//     warpgroups and a producer warp; K and V are loaded once by TMA, then Q
//     and dO tiles of 64 query rows and their (lse log2 e, delta) through the
//     ring.  The warpgroups split the work by output: one takes S^T = K Q^T
//     and dV += P^T dO, the other S^T, dP^T = V dO^T and dK += dS^T Q, the
//     first products on wgmma from shared memory, P^T or dS^T formed in
//     registers and fed as the register A of the last (dO or Q read MN-major
//     from the same stage).  dK or dV stays in registers to the end, D / 2
//     fp32 a thread (D / 4 at D 256, below), at most 128 accumulator
//     registers with S^T and dP^T.
//     S^T is taken twice, five products a tile where four would do: with
//     both dK and dV (and S^T, dP^T) in one warpgroup, 192 accumulators at D
//     128, ptxas spilled 256-792 bytes from D 80 up, with 288 threads as
//     with 384 and setmaxnreg giving the consumers 240 (chip_smoke.py prints
//     its counts and spills, [build]); handing P^T from one warpgroup to the
//     other through shared memory instead measured slower (0.258 against
//     0.237 ms at qwen3-14b's shape: each step waited for the hand-over).
//     64 keys a block give the causal grid twice the blocks to balance.
//   * a tile's products run one group after the other, each waited for:
//     leaving the last one (dQ, dK or dV) in flight while the next tile's
//     first products queue behind it measured no faster, and ptxas then
//     serialized the dQ pass's wgmma; two warpgroups taking turns measured
//     slower (PERF.md).
//   * masks: a tile wholly inside the mask skips the per-element test; only
//     diagonal, window-edge and ragged tiles take it, and a tile wholly
//     outside runs no product.  Causal grids start with the blocks that walk
//     the most tiles (the last query rows in the dQ pass, the first keys in
//     the dK/dV pass), so that the short ones fill the tail.
//   * strides: q, dO and dQ arrive as (B, S, Hq, D) storage viewed as (B, Hq,
//     S, D); TMA's 4D maps run over those strides, with no copy.  D 72-112
//     take the layout of 128 (two 64-column blocks of 128-byte swizzled
//     rows; TMA fills the columns past D with zeros), the products over D in
//     ceil(D / 16) k16 steps and the RS products at n = D, as the forward's.
//   * TMA zero-fills rows past S; their lse is +inf and their delta 0, so P
//     and dS are 0 there.
//   * D 256 (gemma-7b) splits each output's columns between the two consumer
//     warpgroups, so that each keeps the accumulators it keeps at D 128:
//     128 output columns (64 registers) beside S and dP (or S^T and dP^T).
//     A whole 64 x 256 output would be 128 registers a thread, 192 with S
//     and dP, where ptxas spilled past about 128 (above).  The dQ pass's
//     block owns 64 query rows; both warpgroups take S and dP of those rows
//     (each its own copy, from the same tiles) and warpgroup c dQ's columns
//     128 c .. 128 c + 127.  The dK/dV pass's block owns 64 keys and one half
//     of D's columns (two blocks a key tile): S^T and dP^T over the whole D,
//     dV or dK of its half.  S is taken twice as often as at D 128 and dP
//     twice in the dK/dV pass, 13 products of 64 x 64 x 256 a tile pair
//     where five would do; the 64-row tiles of 512 bytes a row leave room
//     for two stages a ring (kBwdSplitStages).  Handing P and dS from one
//     warpgroup to the other through shared memory would save the copies of
//     S and dP, at a wait a step; at D 128 that measured slower (above).
//     At gemma-7b's training shape (B 8, 16/16 heads, S 512, causal) the
//     bound is 0.080 ms (bytes, 0.269 GB; the five products 42.9 GFLOP,
//     0.043 ms); the plan measured 0.447 ms against 0.288 for SDPA's
//     backward (chip_smoke.py, H100 80GB HBM3 at 700 W; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper_gemm.cuh"
#include "wgmma_rs.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hg::smem_u32;

constexpr float kLog2e = 1.4426950408889634f;
// kernels/flash_attention/kernel.py repeats these (tests/test_torch_train_kernels.py
// reads them from here)
constexpr int kBwdRows = 64;           // rows of a consumer warpgroup: queries (dQ) or keys (dK/dV)
constexpr int kBwdBlockRows = 128;     // query rows of a dQ block: two consumer warpgroups
constexpr int kBwdTile = 64;           // keys of a K/V tile (dQ), queries of a Q/dO tile (dK/dV)
constexpr int kBwdDqThreads = 288;     // two consumer warpgroups and a producer warp
constexpr int kBwdDkvThreads = 288;    // the same
constexpr int kBwdDqStages = 3;        // the dQ pass's ring: (K, V) tiles
constexpr int kBwdDkvStages = 4;       // the dK/dV pass's: (Q, dO) tiles and their (lse, delta)
constexpr int kBwdSplitStages = 2;     // both rings at D 256, whose tiles are twice as wide
constexpr int kPassDq = 1;            // the passes a launch runs (`passes`)
constexpr int kPassDkv = 2;

// The shared-memory layout's head dim: 64, 128 for every D from 72 to 128,
// or 256.
constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// Shared memory of the two passes.  A tile of R rows is DP / 64 column blocks
// of R rows x 128 bytes (swizzled as TMA writes them).
//   dQ:    the Q and dO tiles of the block's ROWS rows, the ring of (K, V)
//          tiles of 64 keys, (lse log2 e, delta) of the ROWS rows, mbarriers
//   dK/dV: the K and V tiles of the block's 64 keys, the ring of (Q, dO)
//          tiles of 64 queries, their (lse log2 e, delta), mbarriers
// SPLIT (D 256): the two consumer warpgroups split the output's columns, NW
// each, on the same rows (see the top of this file).
template <int D>
struct BwdTile {
  static constexpr bool SPLIT = D > 128;
  static constexpr int NW = SPLIT ? D / 2 : D;                     // a warpgroup's output columns
  static constexpr int ROWS = SPLIT ? kBwdRows : kBwdBlockRows;    // a dQ block's query rows
  static constexpr int HALVES = SPLIT ? 2 : 1;                     // dK/dV blocks a key tile
  static constexpr int DQ_STAGES = SPLIT ? kBwdSplitStages : kBwdDqStages;
  static constexpr int DKV_STAGES = SPLIT ? kBwdSplitStages : kBwdDkvStages;
  static constexpr int DP = padded_dim(D);
  static constexpr int BLOCKS = DP / 64;
  static constexpr int TILE64 = kBwdTile * DP * 2;         // a tile of 64 rows
  static constexpr int DQ_TILE = ROWS * DP * 2;            // a dQ block's rows
  static constexpr int DQ_SMEM = 1024 + 2 * DQ_TILE + DQ_STAGES * 2 * TILE64 + ROWS * 8 +
                                 (2 * DQ_STAGES + 1) * 8;
  static constexpr int DKV_SMEM = 1024 + 2 * TILE64 + DKV_STAGES * 2 * TILE64 +
                                  DKV_STAGES * kBwdTile * 8 + (2 * DKV_STAGES + 1) * 8;
  static_assert(D == 64 || D == 72 || D == 80 || D == 96 || D == 112 || D == 128 || D == 256,
                "head dims of the wgmma backward");
  static_assert(DQ_SMEM <= hg::kSmemBudget && DKV_SMEM <= hg::kSmemBudget,
                "a block has 227 KB of shared memory");
};

struct BwdArgs {
  const bf16* o;       // (B, Hq, Sq, D) at o_sb, o_sh, o_ss
  const bf16* dout;    // (B, Hq, Sq, D) at do_sb, do_sh, do_ss
  const float* lse;    // (B, Hq, Sq), the forward's
  float2* ld;          // (B, Hq, sq_pad) of (lse log2 e, delta): the dQ pass writes it
  bf16* dq;            // (B, Hq, Sq, D) at dq_sb, dq_sh, dq_ss
  bf16* dk;            // (B, Hkv, Sk, D), contiguous
  bf16* dv;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  int b, hq, hkv, sq, sk, g, sq_pad;
  int causal, window;
  float scale, scale_log2;
};

struct BwdParams {
  CUtensorMap q_map, do_map;  // (D, Sq, Hq, B) over their strides, boxes of 64 x 64 x 1 x 1
  CUtensorMap k_map, v_map;   // (D, Sk, Hkv, B), contiguous
  BwdArgs a;
};

__device__ __forceinline__ bool live(const BwdArgs& a, int i, int j) {
  return i < a.sq && j < a.sk && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}

// Every (i, j) of queries [i0, i0 + 64) and keys [j0, j0 + 64) is live.
__device__ __forceinline__ bool tile_full(const BwdArgs& a, int i0, int j0) {
  return i0 + 63 < a.sq && j0 + 63 < a.sk && (!a.causal || j0 + 63 <= i0) &&
         (a.window <= 0 || j0 > i0 + 63 - a.window);
}

// No (i, j) of the tile is live.
__device__ __forceinline__ bool tile_dead(const BwdArgs& a, int i0, int j0) {
  return i0 >= a.sq || j0 >= a.sk || (a.causal && j0 > i0 + 63) ||
         (a.window > 0 && j0 + 63 <= i0 - a.window);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The box of a 4D map at (c0 inner, c1, c2, c3 outer) into shared memory at
// dst; its bytes complete on `bar`.  Elements outside the tensor arrive as
// zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The K-major descriptor of k16 step kk of a tile's rows starting at byte
// `row_off` inside each column block of `block_bytes` (a tile of R rows:
// block_bytes = R x 128).
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk, int block_bytes, int row_off) {
  return hg::desc_sw128(base + (kk >> 2) * block_bytes + row_off + (kk & 3) * 32, 16, 1024);
}

// The MN-major descriptor of k16 step j of a 64-row tile (rows K, D the N
// columns across its column blocks).
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int j) {
  return hg::desc_sw128(base + j * 16 * 128, kBwdTile * 128, 1024);
}

// The A operand of 16 k steps (4 x 16) in bf16 from a 64 x 64 fp32
// accumulator: keys (k) 16 j .. 16 j + 15 are its column blocks 2 j, 2 j + 1.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j][0] = pack_bf16x2(x[8 * j], x[8 * j + 1]);
    f[j][1] = pack_bf16x2(x[8 * j + 2], x[8 * j + 3]);
    f[j][2] = pack_bf16x2(x[8 * j + 4], x[8 * j + 5]);
    f[j][3] = pack_bf16x2(x[8 * j + 6], x[8 * j + 7]);
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: a relative error of
// about 2^-22, far under the bf16 rounding of P and dS that follows; the
// accurate exp2f measured slower).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(a[e]), v = __bfloat1622float2(b[e]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// dQ pass (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBwdDqThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using T = BwdTile<D>;
  const BwdArgs& a = p.a;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must start on 1024 bytes
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* do_s = q_s + T::DQ_TILE;
  unsigned char* ring = do_s + T::DQ_TILE;  // stage s: the K tile, then the V tile
  float2* ld_s = reinterpret_cast<float2*>(ring + T::DQ_STAGES * 2 * T::TILE64);
  uint64_t* full = reinterpret_cast<uint64_t*>(ld_s + T::ROWS);
  uint64_t* empty = full + T::DQ_STAGES;
  uint64_t* qbar = empty + T::DQ_STAGES;

  // the block: the last query rows first when causal (they walk the most tiles)
  const int nqb = (a.sq + T::ROWS - 1) / T::ROWS;
  const int per = a.hq * a.b;
  const int rank = blockIdx.x / per, rem = blockIdx.x % per;
  const int qb = a.causal ? nqb - 1 - rank : rank;
  const int h = rem % a.hq, b = rem / a.hq, hk = h / a.g;
  const int q0 = qb * T::ROWS;
  const int nk = (a.sk + kBwdTile - 1) / kBwdTile;
  const int q_last = min(q0 + T::ROWS, a.sq) - 1;
  const int kt_first = a.window > 0 ? max(0, (q0 - a.window + 1) / kBwdTile) : 0;
  const int kt_last = a.causal ? min(nk, q_last / kBwdTile + 1) : nk;
  const int n_tiles = max(0, kt_last - kt_first);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < T::DQ_STAGES; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hg::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: lane 0 issues every copy
    if (lane == 0) {
      hg::mbar_expect_tx(qbar, 2 * T::DQ_TILE);
#pragma unroll
      for (int c = 0; c < T::BLOCKS; ++c)
#pragma unroll
        for (int half = 0; half < T::ROWS / kBwdRows; ++half) {
          const int off = c * T::ROWS * 128 + half * kBwdRows * 128;
          tma_load_4d(q_s + off, &p.q_map, qbar, c * 64, q0 + half * kBwdRows, h, b);
          tma_load_4d(do_s + off, &p.do_map, qbar, c * 64, q0 + half * kBwdRows, h, b);
        }
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % T::DQ_STAGES;
        hg::mbar_wait(&empty[s], ((i / T::DQ_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * T::TILE64;
        const int j0 = (kt_first + i) * kBwdTile;
        hg::mbar_expect_tx(&full[s], 2 * T::TILE64);
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c) {
          tma_load_4d(st + c * kBwdTile * 128, &p.k_map, &full[s], c * 64, j0, hk, b);
          tma_load_4d(st + T::TILE64 + c * kBwdTile * 128, &p.v_map, &full[s], c * 64, j0, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows q0 + 64 cw .. + 63 and all D columns
  // of dQ, or (SPLIT) rows q0 .. q0 + 63 and columns col0 .. col0 + NW - 1
  const int cw = warp >> 2, t = tid & 127, wq = warp & 3;
  const int r0 = T::SPLIT ? 0 : cw * kBwdRows;  // the warpgroup's first row in the block
  const int col0 = T::SPLIT ? cw * T::NW : 0;
  const int i0 = q0 + r0;
  {
    // delta of each row, TPR threads a row (the block's 256 consumer threads
    // on its 64 rows when SPLIT, else each warpgroup on its own), 16-byte
    // loads of O and dO; the rows past Sq (up to sq_pad) get lse +inf and
    // delta 0
    constexpr int TPR = T::SPLIT ? 4 : 2;
    const int u = T::SPLIT ? tid : t;
    const int r = r0 + u / TPR, part = u % TPR, i = q0 + r;
    float s = 0.0f;
    if (i < a.sq) {
      const bf16* op = a.o + b * a.o_sb + h * a.o_sh + (long long)i * a.o_ss;
      const bf16* dp = a.dout + b * a.do_sb + h * a.do_sh + (long long)i * a.do_ss;
#pragma unroll
      for (int c = part; c < D / 8; c += TPR)
        s += dot8(*reinterpret_cast<const uint4*>(op + 8 * c),
                  *reinterpret_cast<const uint4*>(dp + 8 * c));
    }
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (part == 0) {
      const long long row = ((long long)b * a.hq + h) * a.sq;
      const float2 v = i < a.sq ? make_float2(a.lse[row + i] * kLog2e, s)
                                : make_float2(INFINITY, 0.0f);
      ld_s[r] = v;
      if (i < a.sq_pad) a.ld[((long long)b * a.hq + h) * a.sq_pad + i] = v;
    }
    if constexpr (T::SPLIT)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }
  const int gid = lane >> 2, tig = lane & 3;
  int qi[2];
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + wq * 16 + gid + 8 * hh;
    qi[hh] = q0 + r;
    l2[hh] = ld_s[r].x;
    dl[hh] = ld_s[r].y;
  }
  float dq[T::NW / 2];
#pragma unroll
  for (int e = 0; e < T::NW / 2; ++e) dq[e] = 0.0f;
  const uint32_t q_base = smem_u32(q_s), do_base = smem_u32(do_s);
  hg::mbar_wait(qbar, 0);

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % T::DQ_STAGES;
    const int j0 = (kt_first + it) * kBwdTile;
    hg::mbar_wait(&full[s], (it / T::DQ_STAGES) & 1);
    if (tile_dead(a, i0, j0)) {
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t k_base = smem_u32(ring + s * 2 * T::TILE64);
    const uint32_t v_base = k_base + T::TILE64;
    // S and dP as two groups: P is formed while dP still runs; a tile's
    // first products start with scale-d 0 instead of zeroed accumulators
    float sc[32], dp[32];
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      hg::wgmma_m64n64<0>(sc, kmajor(q_base, kk, T::ROWS * 128, r0 * 128),
                 kmajor(k_base, kk, kBwdTile * 128, 0), kk != 0);
    hg::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      hg::wgmma_m64n64<0>(dp, kmajor(do_base, kk, T::ROWS * 128, r0 * 128),
                 kmajor(v_base, kk, kBwdTile * 128, 0), kk != 0);
    hg::wgmma_commit();
    hg::wgmma_wait<1>();
    hg::fence_acc(sc);
    // sc becomes P, then dS = P (dP - delta); register 4 c + 2 hh + e: row
    // hh, key 8 c + 2 tig + e
    if (tile_full(a, i0, j0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = fast_exp2(sc[e] * a.scale_log2 - l2[(e >> 1) & 1]);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1, j = j0 + 8 * (e >> 2) + 2 * tig + (e & 1);
        sc[e] = live(a, qi[hh], j) ? fast_exp2(sc[e] * a.scale_log2 - l2[hh]) : 0.0f;
      }
    }
    hg::wgmma_wait<0>();
    hg::fence_acc(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= dp[e] - dl[(e >> 1) & 1];
    uint32_t af[4][4];
    acc_to_a(af, sc);
    hg::fence_acc(dq);
    hg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv<T::NW>(dq, af[j], mnmajor(k_base + col0 / 64 * kBwdTile * 128, j));
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(dq);
    __syncwarp();
    if (lane == 0) hg::mbar_arrive(&empty[s]);
  }

  bf16* dqg = a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= a.sq) continue;
    bf16* row = dqg + (long long)qi[hh] * a.dq_ss + col0 + 2 * tig;
#pragma unroll
    for (int c = 0; c < T::NW / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
          __floats2bfloat162_rn(dq[4 * c + 2 * hh] * a.scale, dq[4 * c + 2 * hh + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV pass
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBwdDkvThreads, 1)
    flash_attention_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  using T = BwdTile<D>;
  const BwdArgs& a = p.a;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + T::TILE64;
  unsigned char* ring = v_s + T::TILE64;  // stage s: the Q tile, then the dO tile
  float2* ld_s = reinterpret_cast<float2*>(ring + T::DKV_STAGES * 2 * T::TILE64);
  uint64_t* full = reinterpret_cast<uint64_t*>(ld_s + T::DKV_STAGES * kBwdTile);
  uint64_t* empty = full + T::DKV_STAGES;
  uint64_t* kvbar = empty + T::DKV_STAGES;

  // the block: the first keys first (under a causal mask they walk the most
  // tiles); SPLIT: each key tile's two blocks, one a half of D's columns
  const int per = a.hkv * a.b * T::HALVES;
  const int kb = blockIdx.x / per, rem = blockIdx.x % per;
  const int col0 = rem % T::HALVES * T::NW, hb = rem / T::HALVES;
  const int hk = hb % a.hkv, b = hb / a.hkv;
  const int j0 = kb * kBwdRows;
  const int j_last = min(j0 + kBwdRows, a.sk) - 1;
  const int nq = (a.sq + kBwdTile - 1) / kBwdTile;
  const int qt_first = a.causal ? j0 / kBwdTile : 0;
  const int qt_last =
      a.window > 0 ? min(nq, (j_last + a.window - 1) / kBwdTile + 1) : nq;
  const int per_g = max(0, qt_last - qt_first);
  const int n_steps = a.g * per_g;  // the G heads of the group, each its query tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < T::DKV_STAGES; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hg::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: lane 0 issues every copy
    if (lane == 0) {
      hg::mbar_expect_tx(kvbar, 2 * T::TILE64);
#pragma unroll
      for (int c = 0; c < T::BLOCKS; ++c) {
        tma_load_4d(k_s + c * kBwdRows * 128, &p.k_map, kvbar, c * 64, j0, hk, b);
        tma_load_4d(v_s + c * kBwdRows * 128, &p.v_map, kvbar, c * 64, j0, hk, b);
      }
      int g = 0, qt = qt_first;
#pragma unroll 1
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % T::DKV_STAGES;
        const int h = hk * a.g + g;
        hg::mbar_wait(&empty[s], ((i / T::DKV_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * T::TILE64;
        hg::mbar_expect_tx(&full[s], 2 * T::TILE64 + kBwdTile * 8);
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c) {
          tma_load_4d(st + c * kBwdTile * 128, &p.q_map, &full[s], c * 64, qt * kBwdTile, h, b);
          tma_load_4d(st + T::TILE64 + c * kBwdTile * 128, &p.do_map, &full[s], c * 64,
                      qt * kBwdTile, h, b);
        }
        hg::bulk_copy(ld_s + s * kBwdTile,
                      a.ld + ((long long)b * a.hq + h) * a.sq_pad + qt * kBwdTile, kBwdTile * 8,
                      &full[s]);
        if (++qt == qt_last) {
          qt = qt_first;
          ++g;
        }
      }
    }
    return;
  }

  // consumers, both on the block's 64 keys: warpgroup 0 takes S^T and dV +=
  // P^T dO, warpgroup 1 S^T, dP^T and dK += dS^T Q (columns col0 .. col0 +
  // NW - 1 of each)
  const bool dk_wg = warp >= 4;
  const int wk = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int kj[2] = {j0 + wk * 16 + gid, j0 + wk * 16 + gid + 8};
  float acc[T::NW / 2];  // dV, or dK
#pragma unroll
  for (int e = 0; e < T::NW / 2; ++e) acc[e] = 0.0f;
  const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);
  hg::mbar_wait(kvbar, 0);

  int qt = qt_first;
#pragma unroll 1
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % T::DKV_STAGES;
    const int qi0 = qt * kBwdTile;
    if (++qt == qt_last) qt = qt_first;
    hg::mbar_wait(&full[s], (it / T::DKV_STAGES) & 1);
    if (tile_dead(a, qi0, j0)) {
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t q_base = smem_u32(ring + s * 2 * T::TILE64);
    const uint32_t do_base = q_base + T::TILE64;
    const float2* lds = ld_s + s * kBwdTile;
    const bool full_tile = tile_full(a, qi0, j0);
    // register 4 c + 2 hh + e of S^T, dP^T: key kj[hh], query qi0 + 8 c +
    // 2 tig + e
    float st[32];
    uint32_t af[4][4];  // P^T or dS^T, the A of the step's last product
    if (dk_wg) {
      // S^T and dP^T as two groups: P^T is formed while dP^T still runs
      float dpt[32];
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk)
        hg::wgmma_m64n64<0>(st, kmajor(k_base, kk, kBwdRows * 128, 0),
                   kmajor(q_base, kk, kBwdTile * 128, 0), kk != 0);
      hg::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk)
        hg::wgmma_m64n64<0>(dpt, kmajor(v_base, kk, kBwdRows * 128, 0),
                   kmajor(do_base, kk, kBwdTile * 128, 0), kk != 0);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();
      hg::fence_acc(st);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1, il = 8 * (e >> 2) + 2 * tig + (e & 1);
        float pv = fast_exp2(st[e] * a.scale_log2 - lds[il].x);
        if (!full_tile && !live(a, qi0 + il, kj[hh])) pv = 0.0f;
        st[e] = pv;
      }
      hg::wgmma_wait<0>();
      hg::fence_acc(dpt);
      // dpt becomes dS^T
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dpt[e] = st[e] * (dpt[e] - lds[8 * (e >> 2) + 2 * tig + (e & 1)].y);
      acc_to_a(af, dpt);
    } else {
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk)
        hg::wgmma_m64n64<0>(st, kmajor(k_base, kk, kBwdRows * 128, 0),
                   kmajor(q_base, kk, kBwdTile * 128, 0), kk != 0);
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_acc(st);
      // st becomes P^T
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1, il = 8 * (e >> 2) + 2 * tig + (e & 1);
        float pv = fast_exp2(st[e] * a.scale_log2 - lds[il].x);
        if (!full_tile && !live(a, qi0 + il, kj[hh])) pv = 0.0f;
        st[e] = pv;
      }
      acc_to_a(af, st);
    }
    // dK += dS^T Q, or dV += P^T dO: Q or dO read MN-major, from column col0
    const uint32_t b_base = (dk_wg ? q_base : do_base) + col0 / 64 * kBwdTile * 128;
    hg::fence_acc(acc);
    hg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_pv<T::NW>(acc, af[j], mnmajor(b_base, j));
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);
    __syncwarp();
    if (lane == 0) hg::mbar_arrive(&empty[s]);
  }

  const long long kv0 = ((long long)b * a.hkv + hk) * a.sk * D;
  bf16* out = dk_wg ? a.dk : a.dv;
  const float mul = dk_wg ? a.scale : 1.0f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (kj[hh] >= a.sk) continue;
    bf16* row = out + kv0 + (long long)kj[hh] * D + col0 + 2 * tig;
#pragma unroll
    for (int c = 0; c < T::NW / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * hh] * mul, acc[4 * c + 2 * hh + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Map4Key {
  const void* ptr;
  long long dims[4], strides[3];
  bool operator==(const Map4Key& o) const {
    if (ptr != o.ptr) return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

struct Map4KeyHash {
  size_t operator()(const Map4Key& k) const {
    size_t h = reinterpret_cast<uintptr_t>(k.ptr);
    for (long long v : k.dims) h = h * 0x9E3779B97F4A7C15ull ^ (size_t)v;
    for (long long v : k.strides) h = h * 0x9E3779B97F4A7C15ull ^ (size_t)v;
    return h;
  }
};

// The tensor map of a bf16 (B, H, S, D) tensor at element strides (sb, sh,
// ss; the last 1), as dims (D, S, H, B) in boxes of 64 columns x 64 rows with
// the 128-byte swizzle; from the cache when seen before.  Returns 0, or -1 if
// the encoding was refused.
int map4d(CUtensorMap* out, const void* ptr, long long d, long long s, long long h, long long b,
          long long ss, long long sh, long long sb) {
  static std::unordered_map<Map4Key, CUtensorMap, Map4KeyHash> cache;
  static std::mutex mu;
  const Map4Key key{ptr, {d, s, h, b}, {ss, sh, sb}};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  hg::EncodeTiledFn encode = hg::encode_fn();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return 0;
}

// Sets `kernel`'s dynamic shared-memory limit to `bytes` once a device.
template <typename K>
int allow(K kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && (done >> dev & 1)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) done |= 1ull << dev;
  return 0;
}

template <int D>
int launch(BwdParams& p, int passes, cudaStream_t s) {
  static uint64_t dq_done = 0, dkv_done = 0;
  using T = BwdTile<D>;
  int err = allow(flash_attention_bwd_dq_kernel<D>, T::DQ_SMEM, dq_done);
  if (err == 0) err = allow(flash_attention_bwd_dkv_kernel<D>, T::DKV_SMEM, dkv_done);
  if (err != 0) return err;
  const BwdArgs& a = p.a;
  const long long dq_blocks = (long long)((a.sq + T::ROWS - 1) / T::ROWS) * a.hq * a.b;
  const long long dkv_blocks =
      (long long)((a.sk + kBwdRows - 1) / kBwdRows) * a.hkv * a.b * T::HALVES;
  if (dq_blocks >= (1ll << 31) || dkv_blocks >= (1ll << 31)) return -1;
  if (passes & kPassDq) {
    flash_attention_bwd_dq_kernel<D><<<(unsigned)dq_blocks, kBwdDqThreads, T::DQ_SMEM, s>>>(p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (passes & kPassDkv)
    flash_attention_bwd_dkv_kernel<D><<<(unsigned)dkv_blocks, kBwdDkvThreads, T::DKV_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Route "wgmma" of the backward: the dQ pass, then the dK/dV pass (those of
// `passes`: 1 the dQ pass, 2 the dK/dV pass), on `stream`; returns
// cudaGetLastError() (0 = launched) or -1 for arguments it does not take.
// The arguments are those of flash_attention_bwd_launch; dtype must be 1:
// bf16, D one of 64, 72, 80, 96, 112, 128, 256; q, o, dout, dq
// (B, Hq, Sq, D) at their element strides (the last 1, the others multiples
// of 8, bases on 16 bytes); k, v, dk, dv (B, Hkv, Sk, D) contiguous; lse (B,
// Hq, Sq) fp32 contiguous; ld (B, Hq, sq_pad) pairs of fp32, sq_pad Sq
// rounded up to 64, written by the dQ pass and read by the dK/dV pass.  Sq !=
// Sk only with causal 0 and window 0.
int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, void* ld, void* dq,
                                     void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                                     int d, long long q_sb, long long q_sh, long long q_ss,
                                     long long o_sb, long long o_sh, long long o_ss,
                                     long long do_sb, long long do_sh, long long do_ss,
                                     long long dq_sb, long long dq_sh, long long dq_ss,
                                     int causal, int window, float scale, int dtype,
                                     int passes, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1) return -1;
  if (dtype != 1 || passes < 1 || passes > 3) return -1;
  if (sq != sk && (causal || window > 0)) return -1;
  const void* bases[] = {q, k, v, o, dout, ld, dq, dk, dv};
  for (const void* ptr : bases)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return -1;
  const long long strides[] = {q_sb, q_sh, q_ss, o_sb, o_sh, o_ss,
                               do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
  for (long long st : strides)
    if (st % 8 != 0) return -1;
  BwdParams p;
  BwdArgs& a = p.a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.ld = static_cast<float2*>(ld);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.do_sb = do_sb; a.do_sh = do_sh; a.do_ss = do_ss;
  a.dq_sb = dq_sb; a.dq_sh = dq_sh; a.dq_ss = dq_ss;
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.sk = sk; a.g = hq / hkv;
  a.sq_pad = (sq + kBwdTile - 1) / kBwdTile * kBwdTile;
  a.causal = causal; a.window = window;
  a.scale = scale; a.scale_log2 = scale * kLog2e;
  const long long kv_s = d, kv_h = (long long)sk * d, kv_b = (long long)hkv * sk * d;
  if (map4d(&p.q_map, q, d, sq, hq, b, q_ss, q_sh, q_sb) != 0 ||
      map4d(&p.do_map, dout, d, sq, hq, b, do_ss, do_sh, do_sb) != 0 ||
      map4d(&p.k_map, k, d, sk, hkv, b, kv_s, kv_h, kv_b) != 0 ||
      map4d(&p.v_map, v, d, sk, hkv, b, kv_s, kv_h, kv_b) != 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch<64>(p, passes, s);
    case 72: return launch<72>(p, passes, s);
    case 80: return launch<80>(p, passes, s);
    case 96: return launch<96>(p, passes, s);
    case 112: return launch<112>(p, passes, s);
    case 128: return launch<128>(p, passes, s);
    case 256: return launch<256>(p, passes, s);
    default: return -1;
  }
}

// The name of a CUDA error the launch function returned.
const char* flash_attention_bwd_wgmma_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

}  // extern "C"
