// Fused MLP for Hopper (sm_90a): out = act(x @ w_up [+ b_up]) @ w_down [+ b_down]
// or, gated, out = (act(x @ w_gate) * (x @ w_up)) @ w_down.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp/kernel.py:38
// (_make_kernel, called by fused_mlp_kernel at :79).  Same function: three
// variants (plain, plain with both biases, GLU), silu / tanh-gelu / relu,
// fp32 or bf16 inputs, fp32 accumulation, the intermediate h rounded to the
// input type before the down product (where the reference's composed_ref
// rounds it), ragged m / d / ff / d_out exact with no host padding.
//
// What bounds it on an H100 SXM (datasheet: 3.35 TB/s, 989 TFLOP/s dense
// bf16, 227 KB shared memory a block, 132 SMs), at the serving shapes d =
// d_out = 5120, ff = 17408, bf16, gated: at decode (m = 8) the 535 MB of
// weights, 0.160 ms of memory time; at prefill (m = 4096) the 2.19 TFLOP,
// 2.215 ms of tensor-core time.
//
// Three routes, chosen by the wrapper from dtype, m and strides before the
// launch (kernel.py, route_of); a refused launch raises there:
//   * "two_pass" (bf16, m > R, every operand what TMA takes): two products
//     on the mainloop of hopper_gemm.cuh (TMA ring, producer warp, wgmma
//     consumer warpgroups).  Pass 1 loads one x tile and a w_gate and a
//     w_up tile a stage (48 KB, 4 stages), keeps two 128 x 128 fp32
//     accumulators, and writes h = act(g) * u (or act(u + b_up)) in x's
//     type to scratch the wrapper allocates.  Pass 2 is the elk_matmul
//     product h @ w_down on the plan smem_plan gives it (128 x 256 tiles at
//     m = 4096), b_down added as it stores.  The trade: a 128 x 5120 fp32
//     output tile fits neither registers nor shared memory, so the
//     single-pass kernel below sums every ff chunk into fp32 partials in
//     device memory, about 68 x 4096 x 5120 x 4 B = 5.7 GB of adds at
//     m = 4096; h crossing device memory instead costs 2 m ff 2 B = 285 MB
//     there, 0.085 ms at 3.35 TB/s, about 4 % of the 2.215 ms bound.
//     R is measured (PERF.md): below it keeping h on chip would pay.  It
//     came out below 8 rows, so a decode step takes this route too; there
//     pass 1 runs 64-row tiles and pass 2 splits K as elk_matmul's splitk
//     route does, summing the splits in shared memory (the single-pass
//     kernel's 272 splits write 44.6 MB of fp32 partials and read them
//     back).
//   * "split_ff" (bf16 otherwise): the single-pass kernel below.  A block
//     owns one tile of rows and one range of ff chunks; for each chunk it
//     forms the slab h (BM x BF) in shared memory (phase 1), then walks
//     d_out in BN-wide tiles adding h @ w_down[chunk, tile] to the block's
//     own fp32 partial (phase 2); a second kernel sums the partials in
//     split order and adds b_down.  Phase 1 and phase 2 of every chunk are
//     one flat loop over one ring, so that w_down's first tiles are in
//     flight during phase 1's last steps (a ring for each phase ran dry between
//     them).  The splits are as many as can be resident (272 of one chunk
//     at m = 8): the fewest that cover the SMs (136 of two chunks) wrote
//     half the partials but measured 0.430 ms against 0.260, since each
//     block's chain of steps doubled while the SMs held half the blocks.
//   * "fma" (fp32): the same single-pass kernel with FMA loops in place of
//     the tensor cores (TF32 would not hold the fp32 tolerance).
// bf16 products of the single-pass kernel run through nvcuda::wmma
// (16x16x16, fp32 accumulate); its loads are 16-byte cp.async copies into
// a ring of stages where the row stride and the base allow it, element by
// element otherwise (d = 80, ff = 257, ...).  No route sums across blocks
// in an order that could vary: the same inputs give the same bits every
// run.
//
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; the
// former single-pass tilings' times in brackets): two_pass at m = 8 0.205
// ms (0.260) against a bound of 0.160, at m = 4096 3.38 ms (19.11) against
// 2.21; split_ff at m = 8 0.294.  Three library products with silu take
// 0.194 and 2.95 ms (PERF.md has every shape and the crossover).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using hg::apply_act;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Starts the copy of the ROWS x COLS tile at (r0, c0) of a row-major matrix
// (rows x cols, leading dimension ld == cols) into shared memory (leading
// dimension LDS).  Elements outside the matrix become zero.  With vec_ok
// (cols a multiple of the 16-byte vector width and the base aligned; c0 always
// is such a multiple) every group of 16 bytes is aligned and lies wholly
// inside or wholly outside the matrix, and travels by cp.async: no register
// holds it and nobody waits here; the caller commits the group and waits for
// it a few steps later.  Without vec_ok (d = 80, ff = 257, ...) the elements
// are loaded and stored one by one, at once.
template <typename T, int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void fill_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          int rows, int cols, int r0, int c0, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int GROUPS_PER_ROW = COLS / VEC;
  constexpr int GROUPS = ROWS * GROUPS_PER_ROW;
  constexpr int ITERS = (GROUPS + NT - 1) / NT;
  static_assert(COLS % VEC == 0 && LDS % VEC == 0, "tile rows must be 16-byte multiples");
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int g = threadIdx.x + it * NT;
    if (g >= GROUPS) break;
    const int i = g / GROUPS_PER_ROW;
    const int j = (g % GROUPS_PER_ROW) * VEC;
    const int r = r0 + i;
    const int c = c0 + j;
    T* d = dst + i * LDS + j;
    if (vec_ok) {
      const bool inside = r < rows && c < cols;
      // outside: nothing is read (all 16 bytes zero-filled), src only has to be an address
      __pipeline_memcpy_async(d, inside ? src + (size_t)r * cols + c : src, 16, inside ? 0 : 16);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (r < rows && c + e < cols) ? src[(size_t)r * cols + c + e] : from_f32<T>(0.0f);
    }
  }
}

// A warp's accumulators: TM x TN tiles of 16 x 16, fp32.
template <typename T, int TM, int TN> struct WarpAcc;

// bf16: tensor cores through wmma.
template <int TM, int TN> struct WarpAcc<bf16, TM, TN> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) wmma::fill_fragment(c[i][j], 0.0f);
  }

  // c += A @ B with A (16*TM x k, row-major, ld lda) and B (k x 16*TN,
  // row-major, ld ldb) in shared memory; k is a multiple of 16.
  __device__ __forceinline__ void mma(const bf16* a, int lda, const bf16* b, int ldb, int k) {
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[TM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < TN; ++j) wmma::load_matrix_sync(fb[j], b + kk * ldb + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
  }

  // Writes tile (i, j) as 16 x 16 fp32, row-major, to shared memory.
  __device__ __forceinline__ void store(int i, int j, float* dst) {
    wmma::store_matrix_sync(dst, c[i][j], 16, wmma::mem_row_major);
  }
};

// fp32: FMA loops; a lane owns 8 neighbouring elements of a row of each tile.
template <int TM, int TN> struct WarpAcc<float, TM, TN> {
  float c[TM][TN][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) c[i][j][e] = 0.0f;
  }

  __device__ __forceinline__ void mma(const float* a, int lda, const float* b, int ldb, int k) {
    const int lane = threadIdx.x & 31;
    const int row = lane >> 1;
    const int col0 = (lane & 1) * 8;
    for (int kk = 0; kk < k; ++kk) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = a[(i * 16 + row) * lda + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            c[i][j][e] = fmaf(av, b[kk * ldb + j * 16 + col0 + e], c[i][j][e]);
      }
    }
  }

  __device__ __forceinline__ void store(int i, int j, float* dst) {
    const int lane = threadIdx.x & 31;
    const int row = lane >> 1;
    const int col0 = (lane & 1) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[row * 16 + col0 + e] = c[i][j][e];
  }
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Tile sizes and the shared-memory layout that follows from them.
//   BM rows of x a block owns; BF width of one slab of the intermediate;
//   BN width of one product tile (of the slab in phase 1, of d_out in phase 2);
//   BK depth of one step of a product; WM x WN warps over a BM x BN tile.
template <typename T, int BM_, int BF_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tiles {
  static constexpr int BM = BM_, BF = BF_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;  // ring of operand tiles in shared memory
  static constexpr int NT = WM * WN * 32;
  static constexpr int TM = BM / (WM * 16);
  static constexpr int TN = BN / (WN * 16);
  static constexpr int PAD = 16 / sizeof(T);  // 16 bytes: keeps rows aligned, spreads banks
  static constexpr int LDX = BK + PAD;
  static constexpr int LDW = BN + PAD;
  static constexpr int LDH = BF + PAD;
  static_assert(BM % (WM * 16) == 0 && BN % (WN * 16) == 0, "warp tiles are 16 x 16");
  static_assert(BF % BN == 0 && BF % BK == 0 && BK % 16 == 0, "slab is cut in BN and BK");
  static_assert(STAGES >= 2, "a tile is filled while another is read");
  // one stage: a tile of x, one of w_up (of w_down in phase 2), one of w_gate
  static constexpr size_t ST_X = 0;
  static constexpr size_t ST_WU = ST_X + align128(sizeof(T) * BM * LDX);
  static constexpr size_t ST_WG = ST_WU + align128(sizeof(T) * BK * LDW);
  static constexpr size_t STAGE_BYTES = ST_WG + align128(sizeof(T) * BK * LDW);
  static constexpr size_t OFF_H = STAGES * STAGE_BYTES;
  static constexpr size_t OFF_ST = OFF_H + align128(sizeof(T) * BM * LDH);
  static constexpr size_t SMEM = OFF_ST + sizeof(float) * WM * WN * 2 * 256;
  static_assert(SMEM <= 232448, "a block has 227 KB of shared memory");
};

// One block: rows [m0, m0 + BM), chunks [chunk0, chunk1) of ff.  Writes its
// fp32 partial sums to partial[split][row][col].
template <typename T, typename C>
__global__ void __launch_bounds__(C::NT)
fused_mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
                         const T* __restrict__ w_gate, const T* __restrict__ w_down,
                         const T* __restrict__ b_up, float* __restrict__ partial,
                         int m, int d, int ff, int dout, int chunks, int chunks_per_split,
                         int act, int vec_x, int vec_w, int vec_wd) {
  constexpr int BM = C::BM, BF = C::BF, BN = C::BN, BK = C::BK, NT = C::NT;
  constexpr int TM = C::TM, TN = C::TN, LDX = C::LDX, LDW = C::LDW, LDH = C::LDH;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  auto xs = [&](int st) { return reinterpret_cast<T*>(smem + st * C::STAGE_BYTES + C::ST_X); };
  auto wus = [&](int st) { return reinterpret_cast<T*>(smem + st * C::STAGE_BYTES + C::ST_WU); };
  auto wgs = [&](int st) { return reinterpret_cast<T*>(smem + st * C::STAGE_BYTES + C::ST_WG); };
  T* hs = reinterpret_cast<T*>(smem + C::OFF_H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_m = warp / C::WN;
  const int warp_n = warp % C::WN;
  float* stage_u = reinterpret_cast<float*>(smem + C::OFF_ST) + warp * 512;
  float* stage_g = stage_u + 256;

  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int chunk0 = split * chunks_per_split;
  const int chunk1 = min(chunk0 + chunks_per_split, chunks);
  const bool gated = w_gate != nullptr;
  const int row_w = warp_m * TM * 16;  // the warp's first row in the block's tile
  const int col_w = warp_n * TN * 16;  // the warp's first column in a BN tile
  float* my_partial = partial + (size_t)split * m * dout;

  // Phase 1 (the slab h = act(...), BM x BF, BN columns at a time) and
  // phase 2 (partial += h @ w_down[f0 : f0 + BF, :], BN columns of d_out at
  // a time) of every chunk of the split are one flat loop of product steps
  // over one ring of STAGES tiles: while the products of step s run, the
  // tiles of the next STAGES - 1 steps are on their way, across the border
  // between the phases and between the chunks.  One barrier a step: after
  // it, step s has arrived for everyone and everyone is done with the stage
  // of step s - 1, which is then refilled; it also orders the slab's writes
  // (at the end of a phase-1 column) before phase 2 reads them, and phase
  // 2's reads before the next chunk's phase 1 writes it again.  A group is
  // committed every step, empty or not, so that "all but the newest
  // STAGES - 2 groups" always means step s.
  const int ksteps = (d + BK - 1) / BK;
  const int steps1 = (BF / BN) * ksteps;
  constexpr int KSTEPS2 = BF / BK;
  const int steps2 = ((dout + BN - 1) / BN) * KSTEPS2;
  const int per_chunk = steps1 + steps2;
  const int steps = (chunk1 - chunk0) * per_chunk;

  auto fill = [&](int s) {
    if (s < steps) {
      const int st = s % STAGES;
      const int f0 = (chunk0 + s / per_chunk) * BF;
      const int r = s % per_chunk;
      if (r < steps1) {
        const int nt = (r / ksteps) * BN;
        const int k0 = (r % ksteps) * BK;
        fill_tile<T, BM, BK, LDX, NT>(xs(st), x, m, d, m0, k0, vec_x);
        fill_tile<T, BK, BN, LDW, NT>(wus(st), w_up, d, ff, k0, f0 + nt, vec_w);
        if (gated) fill_tile<T, BK, BN, LDW, NT>(wgs(st), w_gate, d, ff, k0, f0 + nt, vec_w);
      } else {
        const int r2 = r - steps1;
        fill_tile<T, BK, BN, LDW, NT>(wus(st), w_down, ff, dout, f0 + (r2 % KSTEPS2) * BK,
                                      (r2 / KSTEPS2) * BN, vec_wd);
      }
    }
    __pipeline_commit();
  };

  // acc_u is phase 1's up (or only) product and phase 2's sum
  WarpAcc<T, TM, TN> acc_u, acc_g;
  for (int s = 0; s < STAGES - 1; ++s) fill(s);
  for (int s = 0; s < steps; ++s) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    fill(s + STAGES - 1);
    const int st = s % STAGES;
    const int chunk = chunk0 + s / per_chunk;
    const int f0 = chunk * BF;
    const int r = s % per_chunk;
    if (r < steps1) {
      const T* xs_s = xs(st);
      if (r % ksteps == 0) {
        acc_u.zero();
        acc_g.zero();
      }
      acc_u.mma(xs_s + row_w * LDX, LDX, wus(st) + col_w, LDW, BK);
      if (gated) acc_g.mma(xs_s + row_w * LDX, LDX, wgs(st) + col_w, LDW, BK);
      if (r % ksteps != ksteps - 1) continue;
      const int nt = (r / ksteps) * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_u.store(i, j, stage_u);
          if (gated) acc_g.store(i, j, stage_g);
          __syncwarp();
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int idx = it * 32 + lane;
            const int rr = idx >> 4, c = idx & 15;
            const int hc = nt + col_w + j * 16 + c;  // column in the slab
            float v = stage_u[idx];
            if (gated) {
              v = apply_act(stage_g[idx], act) * v;
            } else {
              if (b_up != nullptr && f0 + hc < ff) v += to_f32(b_up[f0 + hc]);
              v = apply_act(v, act);
            }
            // columns past ff hold act(0) = 0 and meet zero rows of w_down
            hs[(row_w + i * 16 + rr) * LDH + hc] = from_f32<T>(v);
          }
          __syncwarp();
        }
      }
      continue;
    }
    const int r2 = r - steps1;
    if (r2 % KSTEPS2 == 0) acc_u.zero();
    acc_u.mma(hs + row_w * LDH + (r2 % KSTEPS2) * BK, LDH, wus(st) + col_w, LDW, BK);
    if (r2 % KSTEPS2 != KSTEPS2 - 1) continue;
    const int n0 = (r2 / KSTEPS2) * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc_u.store(i, j, stage_u);
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const int idx = it * 32 + lane;
          const int rr = m0 + row_w + i * 16 + (idx >> 4);
          const int c = n0 + col_w + j * 16 + (idx & 15);
          if (rr < m && c < dout) {
            // No other thread touches this address, and one thread's accesses
            // to one address keep their order, so the sum is the same every
            // run.  The add goes out as a reduction that the thread does not
            // wait for; reading, adding and storing here would cost a trip
            // to device memory for every tile of every chunk.
            float* p = my_partial + (size_t)rr * dout + c;
            if (chunk == chunk0) *p = stage_u[idx];
            else atomicAdd(p, stage_u[idx]);
          }
        }
        __syncwarp();
      }
    }
  }
}

// out[r][c] = sum over splits of partial[s][r][c] (in order) [+ b_down[c]].
template <typename T>
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partial,
                                        const T* __restrict__ b_down, T* __restrict__ out,
                                        size_t n, int dout, int splits) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
    if (b_down != nullptr) s += to_f32(b_down[i % dout]);
    out[i] = from_f32<T>(s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename C>
int launch(const void* x, const void* w_up, const void* w_gate, const void* w_down,
           const void* b_up, const void* b_down, void* out, void* partial, int m, int d,
           int ff, int dout, int act, int chunks_per_split, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (ff + C::BF - 1) / C::BF;
  const int splits = (chunks + chunks_per_split - 1) / chunks_per_split;
  const int vec_x = d % VEC == 0 && aligned16(x);
  const int vec_w = ff % VEC == 0 && aligned16(w_up) && (w_gate == nullptr || aligned16(w_gate));
  const int vec_wd = dout % VEC == 0 && aligned16(w_down);
  auto kernel = fused_mlp_partial_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + C::BM - 1) / C::BM, splits);
  kernel<<<grid, C::NT, C::SMEM, stream>>>(
      (const T*)x, (const T*)w_up, (const T*)w_gate, (const T*)w_down, (const T*)b_up,
      (float*)partial, m, d, ff, dout, chunks, chunks_per_split, act, vec_x, vec_w, vec_wd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * dout;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  fused_mlp_reduce_kernel<T><<<blocks, 256, 0, stream>>>((const float*)partial,
                                                         (const T*)b_down, (T*)out, n, dout,
                                                         splits);
  return (int)cudaGetLastError();
}

// Configurations, picked by the wrapper from the type and the number of rows.
//                           T     BM   BF   BN  BK  WM WN STAGES
using TilesF32 = Tiles<float, 32, 64, 64, 32, 2, 4, 3>;
using TilesBf16Rows16 = Tiles<bf16, 16, 64, 64, 64, 1, 4, 3>;      // decode: m <= 16
using TilesBf16Rows128 = Tiles<bf16, 128, 256, 64, 64, 4, 2, 2>;  // prefill

// Two-pass route.  Pass 1: h (m x ff, bf16) = act(x @ w_gate) * (x @ w_up),
// or act(x @ w_up + b_up), on 128 x 128 tiles; pass 2: out = h @ w_down
// [+ b_down] on (64 wg2) x bn2 tiles, K cut in splits of k_per_split2 tiles
// (b_down added as the tile is stored, after the splits are summed).
using Pass1Gated = hg::GemmCfg<2, 128, 2, false>;
// at most kPass1Rows64MaxM rows: 64-row tiles, one consumer warpgroup, two
// blocks an SM, 64 columns of each weight.  qwen3-14b at m <= 128: 272 or
// 544 small tiles on 264 block slots, where 128 x 128 tiles give 136 for
// 132 SMs, a second wave of 4 big ones
using Pass1GatedRows64 = hg::GemmCfg<1, 64, 2, false>;
using Pass1PlainRows64 = hg::GemmCfg<1, 128, 1, false>;
constexpr int kPass1Rows64MaxM = 256;
// pass 1 is never split: its epilogue is not linear
inline int k_tiles1(int d) { return (d + hg::kBK - 1) / hg::kBK; }
using Pass1Plain = hg::GemmCfg<2, 128, 1, false>;

// pass 2's (consumer warpgroups, bn): elk_matmul.cu's ELK_TMA_TILES
#define FUSED_MLP_PASS2_TILES(F) F(1, 64) F(1, 128) F(2, 64) F(2, 128) F(2, 256)

}  // namespace

extern "C" {

// The two-pass route, one function a pass; each returns cudaGetLastError()
// (0 = launched) or -1 for arguments it does not take.  bf16 only; every
// matrix row-major and contiguous with its base 16-byte aligned, d, ff and
// dout multiples of 8 (what TMA takes).
//
// Pass 1: h (m, ff) = act(x @ w_gate) * (x @ w_up) with w_gate, or
// act(x @ w_up [+ b_up]) without (b_up may be null).
int fused_mlp_pass1_launch(const void* x, const void* w_up, const void* w_gate,
                           const void* b_up, void* h, int m, int d, int ff, int act,
                           void* stream) {
  if (m < 1 || d < 1 || ff < 1) return -1;
  if (!hg::tma_ok(x, d) || !hg::tma_ok(w_up, ff) || !hg::tma_ok(h, ff) ||
      (w_gate != nullptr && !hg::tma_ok(w_gate, ff)))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  hg::GemmParams p{};
  p.epi.out = h;
  p.epi.ldo = ff;
  p.epi.act = act;
  const bool rows64 = m <= kPass1Rows64MaxM;
  if (hg::map_a(&p.a, x, m, d, d, rows64 ? 64 : 128) != 0) return -1;
  if (w_gate != nullptr) {
    p.epi.mode = hg::kEpiGated;
    const int bn = rows64 ? Pass1GatedRows64::BN : Pass1Gated::BN;
    if (hg::map_b(&p.b0, w_gate, ff, d, ff, false, bn) != 0 ||
        hg::map_b(&p.b1, w_up, ff, d, ff, false, bn) != 0)
      return -1;
    return rows64 ? hg::launch_gemm<Pass1GatedRows64>(p, m, ff, d, k_tiles1(d), s)
                  : hg::launch_gemm<Pass1Gated>(p, m, ff, d, k_tiles1(d), s);
  }
  p.epi.mode = hg::kEpiAct;
  p.epi.bias = reinterpret_cast<const bf16*>(b_up);
  if (hg::map_b(&p.b0, w_up, ff, d, ff, false, 128) != 0) return -1;
  p.b1 = p.b0;
  return rows64 ? hg::launch_gemm<Pass1PlainRows64>(p, m, ff, d, k_tiles1(d), s)
                : hg::launch_gemm<Pass1Plain>(p, m, ff, d, k_tiles1(d), s);
}

// Pass 2: out (m, dout) = h @ w_down [+ b_down] (b_down may be null) on
// (64 wg2) x bn2 tiles, K cut in splits of k_per_split2 tiles (at most 8).
int fused_mlp_pass2_launch(const void* h, const void* w_down, const void* b_down, void* out,
                           int m, int ff, int dout, int wg2, int bn2, int k_per_split2,
                           void* stream) {
  if (m < 1 || ff < 1 || dout < 1 || k_per_split2 < 1) return -1;
  if (!hg::tma_ok(h, ff) || !hg::tma_ok(w_down, dout)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  hg::GemmParams p{};
  p.epi.out = out;
  p.epi.bias = reinterpret_cast<const bf16*>(b_down);
  p.epi.ldo = dout;
  p.epi.mode = hg::kEpiStore;
  if (hg::map_a(&p.a, h, m, ff, ff, 64 * wg2) != 0) return -1;
  if (hg::map_b(&p.b0, w_down, dout, ff, dout, false, bn2) != 0) return -1;
  p.b1 = p.b0;
#define FUSED_MLP_PASS2_CASE(WG, BN)                                                       \
  if (wg2 == WG && bn2 == BN)                                                               \
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, false>>(p, m, dout, ff, k_per_split2, s);
  FUSED_MLP_PASS2_TILES(FUSED_MLP_PASS2_CASE)
#undef FUSED_MLP_PASS2_CASE
  return -1;
}

// The name of a CUDA error a launch function returned.
const char* fused_mlp_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

// dtype: 0 fp32, 1 bf16.  config: 0 the only fp32 tiling; for bf16, 0 is the
// 16-row tiling and 1 the 128-row tiling.  Gives BM and BF of that tiling and
// how many of its blocks an SM holds at once (by registers and shared memory),
// from which the wrapper sizes the splits.  Returns 0, or -1 if there is none.
int fused_mlp_tiles(int dtype, int config, int* bm, int* bf, int* blocks_per_sm) {
  if (dtype == 0 && config == 0) {
    *bm = TilesF32::BM; *bf = TilesF32::BF; *blocks_per_sm = 2;
    return 0;
  }
  if (dtype == 1 && config == 0) {
    *bm = TilesBf16Rows16::BM; *bf = TilesBf16Rows16::BF; *blocks_per_sm = 3;
    return 0;
  }
  if (dtype == 1 && config == 1) {
    *bm = TilesBf16Rows128::BM; *bf = TilesBf16Rows128::BF; *blocks_per_sm = 1;
    return 0;
  }
  return -1;
}

// Launches the two kernels on `stream`; returns cudaGetLastError() (0 = launched)
// or -1 for a (dtype, config) that does not exist.  `partial` holds
// ceil(ceil(ff / BF) / chunks_per_split) * m * dout floats; w_gate, b_up and
// b_down may be null.  All matrices are row-major and contiguous.
int fused_mlp_launch(const void* x, const void* w_up, const void* w_gate, const void* w_down,
                     const void* b_up, const void* b_down, void* out, void* partial, int m,
                     int d, int ff, int dout, int dtype, int config, int act,
                     int chunks_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && config == 0)
    return launch<float, TilesF32>(x, w_up, w_gate, w_down, b_up, b_down, out, partial, m, d,
                                   ff, dout, act, chunks_per_split, s);
  if (dtype == 1 && config == 0)
    return launch<bf16, TilesBf16Rows16>(x, w_up, w_gate, w_down, b_up, b_down, out, partial,
                                         m, d, ff, dout, act, chunks_per_split, s);
  if (dtype == 1 && config == 1)
    return launch<bf16, TilesBf16Rows128>(x, w_up, w_gate, w_down, b_up, b_down, out, partial,
                                          m, d, ff, dout, act, chunks_per_split, s);
  return -1;
}

}  // extern "C"
