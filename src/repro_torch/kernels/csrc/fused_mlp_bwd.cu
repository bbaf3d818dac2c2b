// The backward of the fused MLP for Hopper (sm_90a): the passes of it that
// are the MLP's own, and the column sums of its bias gradients.
//
//   forward   y = act(x w_gate) * (x w_up) @ w_down              (GLU)
//             y = act(x w_up + b_up) @ w_down + b_down            (plain)
//   backward  g = x w_gate, u = x w_up [+ b_up]                   (recompute)
//             dh = dy w_down^T, and from g, u and dh
//               GLU:   dg = dh u act'(g),  du = dh act(g),  h = act(g) u
//               plain: du = dh act'(u),                     h = act(u)
//             dw_gate = x^T dg and dw_up = x^T du               (GLU: here)
//             dw_down = h^T dy, the plain MLP's dw_up = x^T du, and
//             dx = dg w_gate^T + du w_up^T: elk_matmul.cu (x^T on its
//             transposed-x route, dx as one two-part sum)
//             db_down = colsum(dy), db_up = colsum(du)            (here)
//
// The TPU kernel src/repro/kernels/fused_mlp/kernel.py:79 (fused_mlp_kernel,
// _make_kernel :38) has no backward: the reference trains through XLA's
// gradient of its jnp composition.  The port's forward is a hand-written
// kernel (fused_mlp.cu), which autograd cannot see through, so its gradient
// is one too (kernels/fused_mlp/ops.py: an autograd Function).
//
// What bounds it on an H100 SXM (datasheet: 989 TFLOP/s dense bf16, 3.35
// TB/s): at qwen3-14b's training shape (m = 4096 tokens, d 5120, ff 17408,
// GLU, bf16) the eight products under remat (two to recompute g and u, dh,
// three weight gradients, two for dx) are 5.8 TFLOP, 5.9 ms on the tensor
// cores; dg, du and h (m, ff) in bf16 are written once and read back by the
// products after them, 0.43 GB each way.  Operations bound it.
//
// Design, bf16 operands TMA takes (route "fused"):
//   * one fused pass, a block's (128 rows, BN columns of ff) tile: g and u
//     accumulated over d (x and both weights through one ring of TMA stages,
//     the two weights' tiles side by side, so one wgmma of twice the width
//     takes both products from one read of the x tile), then dh over
//     d_out (dy and w_down read K-major, the transpose of the stored (ff,
//     d_out) matrix, in place) through the same ring, all three in registers
//     (two consumer warpgroups of 64 rows, 64 columns, and a producer
//     warp); the epilogue forms
//     dg, du and h with the forward's functions (hopper_gemm.cuh apply_act,
//     act_grad), stages them in shared memory over the ring and writes them
//     by 16-byte stores.  g and u never reach device memory.  Their K order
//     is the forward pass 1's (k16 steps of d in order), and h = act(g) u is
//     rounded to bf16 once, as there, so the h of dw_down = h^T dy is the
//     forward's h bit for bit (chip_smoke.py checks it);
//   * dw_gate and dw_up in one launch: an instance of the shared mainloop
//     (GemmCfg BWD) with x^T as the MN-major A, read once a stage, and dg, du
//     as its two b, each sum stored to its own output;
//   * fp32, and bf16 operands TMA does not take (route "fma"): the recompute
//     in fp32 and the dh pass on an FMA tile kernel (64 x 64 outputs a
//     block, 16-deep K tiles in shared memory; TF32 would miss the fp32
//     tolerance), the weight gradients on elk_matmul.
// The bias gradients are column sums, 32 columns a block in a fixed order.
// No atomics: the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hg::act_grad;
using hg::apply_act;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// dw_gate = x^T dg and dw_up = x^T du in one launch: x stored (m, d) read as
// the MN-major A, dg and du (m, ff) the two MN-major b, two outputs.
using WGrad = hg::GemmCfg<2, 128, 2, false, true, true>;

// ---------------------------------------------------------------------------
// FMA tile kernel: C_j = A (m, K) @ B_j, j < NB; B_j (K, N) row-major, or
// stored (N, K) (BT); the backward's epilogues
// ---------------------------------------------------------------------------

constexpr int kTM = 64, kTN = 64, kTK = 16, kTileThreads = 256;

template <typename T>
struct TileArgs {
  const T* a;         // (m, K) row-major
  const T* b0;        // (K, N) or stored (N, K)
  const T* b1;        // the second b (NB 2), or null
  const T* bias;      // kEpiPre: (N,) or null
  int m, n, k;
  int mode, act;      // hg::kEpiPre or hg::kEpiDeriv
  float* pre_out;     // kEpiPre: a b0 [+ bias] (m, N) fp32
  float* pre_out2;    // kEpiPre, NB 2: a b1
  const float* pre_g; // kEpiDeriv: the pre-activations, or null (plain)
  const float* pre_u;
  T* dg;              // kEpiDeriv outputs (m, N)
  T* du;
  T* h;
};

template <typename T>
__device__ __forceinline__ void tile_epilogue(const TileArgs<T>& e, int row, int col, float a,
                                              float g) {
  const size_t i = (size_t)row * e.n + col;
  if (e.mode == hg::kEpiPre) {
    if (e.bias != nullptr) a += to_f(e.bias[col]);
    e.pre_out[i] = a;
    if (e.pre_out2 != nullptr) e.pre_out2[i] = g;
    return;
  }
  const float u = e.pre_u[i];
  if (e.pre_g != nullptr) {
    const float gp = e.pre_g[i];
    const float ag = apply_act(gp, e.act);
    e.dg[i] = from_f<T>(a * u * act_grad(gp, e.act));
    e.du[i] = from_f<T>(a * ag);
    e.h[i] = from_f<T>(ag * u);
  } else {
    e.du[i] = from_f<T>(a * act_grad(u, e.act));
    e.h[i] = from_f<T>(apply_act(u, e.act));
  }
}

template <typename T, bool BT, int NB>
__global__ void __launch_bounds__(kTileThreads) tile_kernel(TileArgs<T> e) {
  __shared__ float as[kTK][kTM + 4];          // A tile, k-major
  __shared__ float bs[NB][kTK][kTN + 4];
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 x 4 outputs a thread
  float acc[NB][4][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.0f;

  for (int k0 = 0; k0 < e.k; k0 += kTK) {
    for (int idx = threadIdx.x; idx < kTM * kTK; idx += kTileThreads) {
      const int r = idx / kTK, kk = idx % kTK;
      const int gr = m0 + r, gk = k0 + kk;
      as[kk][r] = (gr < e.m && gk < e.k) ? to_f(e.a[(size_t)gr * e.k + gk]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const T* b = j == 0 ? e.b0 : e.b1;
      for (int idx = threadIdx.x; idx < kTN * kTK; idx += kTileThreads) {
        int kk, c;
        if (BT) { c = idx / kTK; kk = idx % kTK; } else { kk = idx / kTN; c = idx % kTN; }
        const int gk = k0 + kk, gc = n0 + c;
        float v = 0.0f;
        if (gk < e.k && gc < e.n) v = to_f(BT ? b[(size_t)gc * e.k + gk] : b[(size_t)gk * e.n + gc]);
        bs[j][kk][c] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[kk][ty + 16 * r];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bv = bs[j][kk][tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r][c] = fmaf(av[r], bv, acc[j][r][c]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty + 16 * r;
    if (row >= e.m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col < e.n) tile_epilogue(e, row, col, acc[0][r][c], acc[NB - 1][r][c]);
    }
  }
}

template <typename T, bool BT, int NB>
int launch_tile(const TileArgs<T>& e, cudaStream_t s) {
  const dim3 grid((e.n + kTN - 1) / kTN, (e.m + kTM - 1) / kTM);
  if (grid.y > 65535) return -1;
  tile_kernel<T, BT, NB><<<grid, kTileThreads, 0, s>>>(e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// column sums
// ---------------------------------------------------------------------------

// A block sums 32 columns: each warp the rows of its residue mod kSumGroups,
// in order, then thread 0 of each column the warps' sums, in order; a fixed
// order, so the same bits every run.
constexpr int kSumGroups = 16;

template <typename T>
__global__ void __launch_bounds__(32 * kSumGroups) colsum_kernel(const T* src, T* out, int m,
                                                                   int n) {
  __shared__ float part[kSumGroups][33];
  const int cx = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cx;
  float s = 0.0f;
  if (col < n)
    for (int r = g; r < m; r += kSumGroups) s += to_f(src[(size_t)r * n + col]);
  part[g][cx] = s;
  __syncthreads();
  if (g == 0 && col < n) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kSumGroups; ++k) t += part[k][cx];
    out[col] = from_f<T>(t);
  }
}

// ---------------------------------------------------------------------------
// the fused pass: g, u [, dh] of a tile in registers, dg, du and h out
// ---------------------------------------------------------------------------

// Two consumer warpgroups of 64 rows (BM 128) and a producer warp; BN
// columns of ff; GATED: g and u (two b operands in phase 1), else u alone.
// BN 64: g, u and dh are 96 accumulator registers a consumer thread.  At BN
// 128 (192) ptxas spilled 516-772 bytes, with a producer warp or a producer
// warpgroup and setmaxnreg, and the GLU pass ran 14.7 ms against BN 64's
// 10.1 at qwen3-14b's shape (PERF.md).
// A stage holds the a tile (x in phase 1, dy in phase 2) and the b tiles (the
// two MN-major weights, or w_down's K-major tile).  The epilogue stages dg,
// du and h in rows of BN + 8 bf16 (16 bytes of padding: the accumulator
// layout's 4-byte stores are conflict-free) over the ring.
constexpr int kFusedBN = 64;  // kernels/fused_mlp/kernel.py FUSED_BN

template <bool GATED_>
struct FusedCfg {
  static constexpr int BN = kFusedBN, BM = 128, THREADS = 288;
  static constexpr bool GATED = GATED_;
  static constexpr int NB = GATED ? 2 : 1;
  static constexpr int A_BYTES = BM * hg::kBK * 2;
  static constexpr int B_BYTES = BN * hg::kBK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int STAGES = hg::stages_for(2, BN, NB);
  static constexpr int SMEM = STAGES * STAGE_BYTES + hg::kSmemReserve;
  static constexpr int OUT_LD = BN + 8;
  static_assert(STAGES >= 2, "a stage is filled while another is read");
  static_assert(B_BYTES == 64 * 128, "the GLU's two b tiles are one 2 BN wide");
  static_assert(3 * BM * OUT_LD * 2 <= STAGES * STAGE_BYTES, "the staged outputs fit the ring");
  static_assert(SMEM <= hg::kSmemBudget, "a block has 227 KB of shared memory");
};

struct FusedParams {
  CUtensorMap x, b0, b1;  // x (m, d); b0 = w_gate (GLU) or w_up, b1 = w_up: (d, ff)
  CUtensorMap dy, wd;     // dy (m, d_out); w_down (ff, d_out), read K-major
  const bf16* b_up;       // plain: (ff,) or null
  bf16* dg;               // GLU only
  bf16* du;
  bf16* h;
  int m, ff, k1_tiles, k2_tiles, m_tiles, n_tiles, act;
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    fused_mlp_bwd_fused_kernel(const __grid_constant__ FusedParams p) {
  constexpr int BK = hg::kBK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (hg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  // the output tile, in groups of kGroupM row tiles (the weights' tiles are
  // shared by a wave in L2)
  const int per_group = hg::kGroupM * p.n_tiles;
  const int first_m = (blockIdx.x / per_group) * hg::kGroupM;
  const int gm = min(hg::kGroupM, p.m_tiles - first_m);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * C::BM;
  const int n0 = (in_group / gm) * C::BN;
  const int nk = p.k1_tiles + p.k2_tiles;

  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < C::STAGES; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread of the last warp issues every copy
    if (threadIdx.x == 256) {
#pragma unroll 1
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        hg::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE_BYTES;
        if (i < p.k1_tiles) {
          // phase 1: x and the weights of g and u, MN-major
          const int k0 = i * BK;
          hg::mbar_expect_tx(&full[s], C::STAGE_BYTES);
          hg::tma_load_2d(st, &p.x, &full[s], k0, m0);
#pragma unroll
          for (int j = 0; j < C::NB; ++j)
#pragma unroll
            for (int c = 0; c < C::BN / 64; ++c)
              hg::tma_load_2d(st + C::A_BYTES + j * C::B_BYTES + c * 64 * 128,
                              j == 0 ? &p.b0 : &p.b1, &full[s], n0 + 64 * c, k0);
        } else {
          // phase 2: dy and w_down's K-major tile
          const int k0 = (i - p.k1_tiles) * BK;
          hg::mbar_expect_tx(&full[s], C::A_BYTES + C::B_BYTES);
          hg::tma_load_2d(st, &p.dy, &full[s], k0, m0);
          hg::tma_load_2d(st + C::A_BYTES, &p.wd, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  // consumers: NB + 1 accumulators of 64 x BN, BN / 2 fp32 a thread each
  const int cw = threadIdx.x / 128;  // this consumer's 64 rows of the tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // gu: g (GLU) or u (plain) in its first BN / 2 registers, u (GLU) in the
  // next: the GLU's two weight tiles lie side by side in a stage, so one
  // wgmma of width 2 BN takes both products from one read of the x tile
  float gu[C::NB * C::BN / 2], dh[C::BN / 2];
#pragma unroll
  for (int e = 0; e < C::NB * C::BN / 2; ++e) gu[e] = 0.0f;

  // phase 1: the sums over the k16 steps of d in order, as the forward's
  // pass 1 takes them
#pragma unroll 1
  for (int i = 0; i < p.k1_tiles; ++i) {
    const int s = i % C::STAGES;
    hg::mbar_wait(&full[s], (i / C::STAGES) & 1);
    const uint32_t a_base = hg::smem_u32(smem + s * C::STAGE_BYTES) + cw * 64 * 128;
    const uint32_t b_base = hg::smem_u32(smem + s * C::STAGE_BYTES + C::A_BYTES);
    hg::fence_acc(gu);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hg::wgmma_tile<C::NB * C::BN, 1>(gu, hg::desc_sw128(a_base + kk * 32, 16, 1024),
                                       hg::desc_sw128(b_base + kk * 16 * 128, 64 * 128, 1024));
    hg::wgmma_commit();
    hg::fence_acc(gu);
    hg::wgmma_wait<1>();  // the products of step i - 1 have retired
    if (i > 0 && lane == 0) hg::mbar_arrive(&empty[(i - 1) % C::STAGES]);
  }
  // phase 1's products all retire before dh is zeroed: ptxas serializes
  // every wgmma of a kernel that defines an accumulator while a group is in
  // flight (its warning C7515)
  hg::wgmma_wait<0>();
  hg::fence_acc(gu);
  if (p.k1_tiles > 0 && lane == 0) hg::mbar_arrive(&empty[(p.k1_tiles - 1) % C::STAGES]);
#pragma unroll
  for (int e = 0; e < C::BN / 2; ++e) dh[e] = 0.0f;
  // phase 2: dh = dy w_down^T, w_down's tile K-major
#pragma unroll 1
  for (int i = p.k1_tiles; i < nk; ++i) {
    const int s = i % C::STAGES;
    hg::mbar_wait(&full[s], (i / C::STAGES) & 1);
    const uint32_t a_base = hg::smem_u32(smem + s * C::STAGE_BYTES) + cw * 64 * 128;
    const uint32_t b_base = hg::smem_u32(smem + s * C::STAGE_BYTES + C::A_BYTES);
    hg::fence_acc(dh);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hg::wgmma_tile<C::BN, 0>(dh, hg::desc_sw128(a_base + kk * 32, 16, 1024),
                               hg::desc_sw128(b_base + kk * 32, 16, 1024));
    hg::wgmma_commit();
    hg::fence_acc(dh);
    hg::wgmma_wait<1>();
    if (i > p.k1_tiles && lane == 0) hg::mbar_arrive(&empty[(i - 1) % C::STAGES]);
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(dh);

  // every consumer is done with the ring (and every copy into it landed):
  // dg, du and h of this warpgroup's rows go through it
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* out_s = reinterpret_cast<bf16*>(smem);  // [3][BM][OUT_LD]: dg, du, h
  // accumulator layout: register 4 c + 2 hh + e holds row 16 warp + lane / 4
  // + 8 hh, column 8 c + 2 (lane % 4) + e of this warpgroup's 64 x BN
  const int r_base = cw * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < C::BN / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    float bias[2] = {0.0f, 0.0f};
    if constexpr (!C::GATED) {
      if (p.b_up != nullptr && n0 + col < p.ff) {
        bias[0] = __bfloat162float(p.b_up[n0 + col]);
        bias[1] = __bfloat162float(p.b_up[n0 + col + 1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float dg_v[2], du_v[2], h_v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * c + 2 * hh + e;
        const float d = dh[r];
        if constexpr (C::GATED) {
          const float g = gu[r], u = gu[C::BN / 2 + r];
          const float ag = hg::apply_act(g, p.act);
          dg_v[e] = d * u * hg::act_grad(g, p.act);
          du_v[e] = d * ag;
          h_v[e] = ag * u;
        } else {
          const float u = gu[r] + bias[e];
          dg_v[e] = 0.0f;
          du_v[e] = d * hg::act_grad(u, p.act);
          h_v[e] = hg::apply_act(u, p.act);
        }
      }
      const int at = (r_base + 8 * hh) * C::OUT_LD + col;
      *reinterpret_cast<__nv_bfloat162*>(out_s + at) = __floats2bfloat162_rn(dg_v[0], dg_v[1]);
      *reinterpret_cast<__nv_bfloat162*>(out_s + C::BM * C::OUT_LD + at) =
          __floats2bfloat162_rn(du_v[0], du_v[1]);
      *reinterpret_cast<__nv_bfloat162*>(out_s + 2 * C::BM * C::OUT_LD + at) =
          __floats2bfloat162_rn(h_v[0], h_v[1]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // this warpgroup's rows
  // 16 bytes a thread, a row's BN / 8 pieces on neighbouring threads; ff is a
  // multiple of 8, so a piece is wholly inside or wholly past it
  constexpr int PIECES = C::BN / 8;
  bf16* outs[3] = {p.dg, p.du, p.h};
#pragma unroll
  for (int o = C::GATED ? 0 : 1; o < 3; ++o) {
#pragma unroll 4
    for (int e = t; e < 64 * PIECES; e += 128) {
      const int r = cw * 64 + e / PIECES, pc = e % PIECES;
      const int row = m0 + r, col = n0 + 8 * pc;
      if (row < p.m && col < p.ff)
        *reinterpret_cast<uint4*>(outs[o] + (size_t)row * p.ff + col) =
            *reinterpret_cast<const uint4*>(out_s + o * C::BM * C::OUT_LD + r * C::OUT_LD + 8 * pc);
    }
  }
}

template <class C>
int launch_fused(FusedParams& p, int m, int d, int ff, int dout, cudaStream_t stream) {
  static uint64_t configured = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(fused_mlp_bwd_fused_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << dev;
  }
  p.m = m;
  p.ff = ff;
  p.k1_tiles = (d + hg::kBK - 1) / hg::kBK;
  p.k2_tiles = (dout + hg::kBK - 1) / hg::kBK;
  p.m_tiles = (m + C::BM - 1) / C::BM;
  p.n_tiles = (ff + C::BN - 1) / C::BN;
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  if (tiles >= (1ll << 31)) return -1;
  fused_mlp_bwd_fused_kernel<C><<<(unsigned)tiles, C::THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int tile_pre(const void* x, const void* w_up, const void* w_gate, const void* b_up, float* pre_g,
             float* pre_u, int m, int d, int ff, cudaStream_t s) {
  TileArgs<T> e{};
  e.a = static_cast<const T*>(x);
  e.m = m; e.n = ff; e.k = d;
  e.mode = hg::kEpiPre;
  if (w_gate != nullptr) {
    e.b0 = static_cast<const T*>(w_gate);
    e.b1 = static_cast<const T*>(w_up);
    e.pre_out = pre_g;
    e.pre_out2 = pre_u;
    return launch_tile<T, false, 2>(e, s);
  }
  e.b0 = static_cast<const T*>(w_up);
  e.bias = static_cast<const T*>(b_up);
  e.pre_out = pre_u;
  return launch_tile<T, false, 1>(e, s);
}

template <typename T>
int tile_dh(const void* dy, const void* w_down, const float* pre_g, const float* pre_u, void* dg,
            void* du, void* h, int m, int ff, int dout, int act, cudaStream_t s) {
  TileArgs<T> e{};
  e.a = static_cast<const T*>(dy);
  e.b0 = static_cast<const T*>(w_down);
  e.m = m; e.n = ff; e.k = dout;
  e.mode = hg::kEpiDeriv;
  e.act = act;
  e.pre_g = pre_g;
  e.pre_u = pre_u;
  e.dg = static_cast<T*>(dg);
  e.du = static_cast<T*>(du);
  e.h = static_cast<T*>(h);
  return launch_tile<T, true, 1>(e, s);
}

}  // namespace

extern "C" {

// The recompute on the FMA tile kernel (route "fma"): pre_g = x w_gate and
// pre_u = x w_up (GLU: w_gate given), or pre_u = x w_up + b_up (plain; b_up
// may be null), fp32 (m, ff).  x (m, d), w_up / w_gate (d, ff), b_up (ff,),
// contiguous, of dtype 1 (bf16) or 0 (fp32).  Returns cudaGetLastError() (0
// = launched) or -1 for arguments it does not take.
int fused_mlp_bwd_pre_launch(const void* x, const void* w_up, const void* w_gate,
                             const void* b_up, float* pre_g, float* pre_u, int m, int d, int ff,
                             int dtype, void* stream) {
  if (m < 1 || d < 1 || ff < 1 || (w_gate != nullptr && pre_g == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return tile_pre<bf16>(x, w_up, w_gate, b_up, pre_g, pre_u, m, d, ff, s);
  return tile_pre<float>(x, w_up, w_gate, b_up, pre_g, pre_u, m, d, ff, s);
}

// The dh pass on the FMA tile kernel (route "fma"): dh = dy w_down^T with the
// activation's derivative applied in the epilogue.  dy (m, dout), w_down (ff,
// dout) as stored, pre_g (GLU, or null) and pre_u fp32 (m, ff); writes dg
// (GLU only), du and h (m, ff) in the operands' type.  Returns
// cudaGetLastError() (0 = launched) or -1.
int fused_mlp_bwd_dh_launch(const void* dy, const void* w_down, const float* pre_g,
                            const float* pre_u, void* dg, void* du, void* h, int m, int ff,
                            int dout, int act, int dtype, void* stream) {
  if (m < 1 || ff < 1 || dout < 1 || pre_u == nullptr || (pre_g != nullptr && dg == nullptr))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return tile_dh<bf16>(dy, w_down, pre_g, pre_u, dg, du, h, m, ff, dout, act, s);
  return tile_dh<float>(dy, w_down, pre_g, pre_u, dg, du, h, m, ff, dout, act, s);
}

// The fused pass (route "fused"): g = x w_gate and u = x w_up [+ b_up]
// recomputed, dh = dy w_down^T, and dg (GLU: w_gate given), du and h (m, ff)
// written in bf16 by one launch.  x (m, d), w_up / w_gate (d, ff), b_up (ff,)
// or null (plain only), dy (m, dout), w_down (ff, dout), dg / du / h (m, ff),
// all bf16, contiguous, bases on 16 bytes, d, ff and dout multiples of 8
// (what TMA takes).  Returns cudaGetLastError() (0 = launched) or -1 for
// arguments it does not take.
int fused_mlp_bwd_fused_launch(const void* x, const void* w_up, const void* w_gate,
                               const void* b_up, const void* dy, const void* w_down, void* dg,
                               void* du, void* h, int m, int d, int ff, int dout, int act,
                               void* stream) {
  if (m < 1 || d < 1 || ff < 1 || dout < 1 || (w_gate != nullptr && dg == nullptr) ||
      (w_gate != nullptr && b_up != nullptr))
    return -1;
  if (!hg::tma_ok(x, d) || !hg::tma_ok(w_up, ff) || !hg::tma_ok(dy, dout) ||
      !hg::tma_ok(w_down, dout) || !hg::tma_ok(du, ff) || !hg::tma_ok(h, ff) ||
      (w_gate != nullptr && (!hg::tma_ok(w_gate, ff) || !hg::tma_ok(dg, ff))))
    return -1;
  FusedParams p{};
  p.b_up = static_cast<const bf16*>(b_up);
  p.dg = static_cast<bf16*>(dg);
  p.du = static_cast<bf16*>(du);
  p.h = static_cast<bf16*>(h);
  p.act = act;
  if (hg::map_a(&p.x, x, m, d, d, 128) != 0 || hg::map_a(&p.dy, dy, m, dout, dout, 128) != 0 ||
      hg::map_b(&p.wd, w_down, ff, dout, dout, true, kFusedBN) != 0 ||
      hg::map_b(&p.b0, w_gate != nullptr ? w_gate : w_up, ff, d, ff, false, kFusedBN) != 0 ||
      hg::map_b(&p.b1, w_up, ff, d, ff, false, kFusedBN) != 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_gate != nullptr) return launch_fused<FusedCfg<true>>(p, m, d, ff, dout, s);
  return launch_fused<FusedCfg<false>>(p, m, d, ff, dout, s);
}

// dw_gate = x^T dg and dw_up = x^T du (d, ff) in one launch, bf16: x (m, d),
// dg and du (m, ff), contiguous, bases on 16 bytes, d and ff multiples of 8.
// Returns cudaGetLastError() (0 = launched) or -1.
int fused_mlp_bwd_wgrad_launch(const void* x, const void* dg, const void* du, void* dw_gate,
                               void* dw_up, int m, int d, int ff, void* stream) {
  if (m < 1 || d < 1 || ff < 1) return -1;
  if (!hg::tma_ok(x, d) || !hg::tma_ok(dg, ff) || !hg::tma_ok(du, ff)) return -1;
  hg::GemmParams p{};
  p.epi.mode = hg::kEpiStore;
  p.epi.out = dw_gate;
  p.epi.out2 = dw_up;
  p.epi.ldo = ff;
  if (hg::map_a(&p.a, x, d, m, d, WGrad::BM, true) != 0 ||
      hg::map_b(&p.b0, dg, ff, m, ff, false, WGrad::BN) != 0 ||
      hg::map_b(&p.b1, du, ff, m, ff, false, WGrad::BN) != 0)
    return -1;
  return hg::launch_gemm<WGrad>(p, d, ff, m, (m + hg::kBK - 1) / hg::kBK, (cudaStream_t)stream);
}

// out (n,) = the sums of the columns of src (m, n), contiguous, in fp32 in a
// fixed order (colsum_kernel); dtype 1 bf16, 0 fp32.  Returns
// cudaGetLastError() or -1.
int fused_mlp_bwd_colsum_launch(const void* src, void* out, int m, int n, int dtype,
                                void* stream) {
  if (m < 1 || n < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 32 * kSumGroups, blocks = (n + 31) / 32;
  if (dtype == 1)
    colsum_kernel<bf16><<<blocks, threads, 0, s>>>(static_cast<const bf16*>(src),
                                                    static_cast<bf16*>(out), m, n);
  else
    colsum_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(src),
                                                     static_cast<float*>(out), m, n);
  return (int)cudaGetLastError();
}

// The name of a CUDA error a launch function returned.
const char* fused_mlp_bwd_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

}  // extern "C"
