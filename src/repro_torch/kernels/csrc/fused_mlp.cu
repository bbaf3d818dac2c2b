// Fused MLP for Hopper (sm_90a): out = act(x @ w_up [+ b_up]) @ w_down [+ b_down]
// or, gated, out = (act(x @ w_gate) * (x @ w_up)) @ w_down.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp/kernel.py
// (_make_kernel / fused_mlp_kernel).  Same function: three variants (plain,
// plain with both biases, GLU), silu / tanh-gelu / relu, fp32 or bf16 inputs,
// fp32 accumulation, the intermediate cast to the input type before the down
// product, ragged m / d / ff / d_out masked here (no host padding), and the
// intermediate never written to device memory.
//
// What bounds it on an H100 (datasheet: 3.35 TB/s, 989 TFLOP/s dense bf16,
// 227 KB shared memory a block, 132 SMs), at the serving shapes d = d_out =
// 5120, ff = 17408, bf16, gated: at decode (m = 8) the 535 MB of weights,
// 0.16 ms of memory time; at prefill (m = 4096) the 2.19 TFLOP, 2.2 ms of
// tensor-core time.
//
// Design.  The TPU kernel walks ff sequentially and carries a (bm, d_out)
// fp32 sum on chip.  Here blocks run in no order and bm x 5120 fp32 fits
// neither registers nor shared memory, so the work is cut differently:
//   * a block owns one tile of BM rows and one range of ff ("split").  For
//     each BF-wide chunk of its range it forms the slab h (BM x BF) in shared
//     memory once (products over d, accumulators in registers), then walks
//     d_out in BN-wide tiles, each a product h @ w_down[chunk, tile] summed in
//     registers and added to the block's own fp32 partial in device memory.
//     The slab is never recomputed for a d_out tile, and each weight is read
//     once for each tile of rows.
//   * the partials (splits x m x d_out, fp32) are summed in a fixed order by
//     a second small kernel that adds b_down and casts.  Nothing is summed
//     across blocks in an order that could vary: the result is the same
//     every run.
//   * at decode one tile of rows covers the batch, so the splits of ff are
//     what fill the 132 SMs; at prefill the row tiles do and few splits keep
//     the partials small.
// bf16 products run on the tensor cores through nvcuda::wmma (16x16x16,
// fp32 accumulate); fp32 products run as FMA loops with the same tiling,
// because TF32 would not hold the fp32 tolerance.  Loads are 16 bytes a
// thread where the row stride and the base allow it, element by element
// otherwise (d = 80, ff = 257, ...).  The 16-byte loads are cp.async copies
// into a ring of stages in shared memory, so the tiles of the next steps
// travel while this step's products run, with one barrier a step.
//
// Where it stands (H100 80GB HBM3 at 700 W, chip_smoke.py): decode about 60 %
// of its bound, prefill about a ninth of its.  At prefill, switching parts off
// showed the products, the fills, the adds into the partials and the barrier
// and epilogue overhead adding up rather than overlapping, and with a 2 x 2
// warp tile for gate and up each wmma product needs a 512-byte fragment load
// from shared memory.  wgmma, TMA, warp specialisation and clusters are not
// used; they are what a faster version would be built from.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum : int { kActSilu = 0, kActGelu = 1, kActRelu = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActSilu) return v / (1.0f + expf(-v));
  if (act == kActGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return fmaxf(v, 0.0f);
}

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

  // Both phases walk their product steps in one flat loop over a ring of
  // STAGES tiles: while the products of step s run, the tiles of the next
  // STAGES - 1 steps are on their way.  One barrier a step: after it, step s
  // has arrived for everyone and everyone is done with the stage of step
  // s - 1, which is then refilled.  A group is committed every step, empty or
  // not, so that "all but the newest STAGES - 2 groups" always means step s.
  const int ksteps = (d + BK - 1) / BK;
  const int steps1 = (BF / BN) * ksteps;
  constexpr int KSTEPS2 = BF / BK;
  const int steps2 = ((dout + BN - 1) / BN) * KSTEPS2;

  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int f0 = chunk * BF;

    // Phase 1: the slab h = act(...) (BM x BF), BN columns at a time.
    auto fill1 = [&](int s) {
      if (s < steps1) {
        const int st = s % STAGES;
        const int nt = (s / ksteps) * BN;
        const int k0 = (s % ksteps) * BK;
        fill_tile<T, BM, BK, LDX, NT>(xs(st), x, m, d, m0, k0, vec_x);
        fill_tile<T, BK, BN, LDW, NT>(wus(st), w_up, d, ff, k0, f0 + nt, vec_w);
        if (gated) fill_tile<T, BK, BN, LDW, NT>(wgs(st), w_gate, d, ff, k0, f0 + nt, vec_w);
      }
      __pipeline_commit();
    };
    WarpAcc<T, TM, TN> acc_u, acc_g;
    __syncthreads();  // the ring is free: the phase before has read its last tile
    for (int s = 0; s < STAGES - 1; ++s) fill1(s);
    for (int s = 0; s < steps1; ++s) {
      __pipeline_wait_prior(STAGES - 2);
      __syncthreads();
      fill1(s + STAGES - 1);
      const T* xs_s = xs(s % STAGES);
      if (s % ksteps == 0) {
        acc_u.zero();
        acc_g.zero();
      }
      acc_u.mma(xs_s + row_w * LDX, LDX, wus(s % STAGES) + col_w, LDW, BK);
      if (gated) acc_g.mma(xs_s + row_w * LDX, LDX, wgs(s % STAGES) + col_w, LDW, BK);
      if (s % ksteps != ksteps - 1) continue;
      const int nt = (s / ksteps) * BN;
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
            const int r = idx >> 4, c = idx & 15;
            const int hc = nt + col_w + j * 16 + c;  // column in the slab
            float v = stage_u[idx];
            if (gated) {
              v = apply_act(stage_g[idx], act) * v;
            } else {
              if (b_up != nullptr && f0 + hc < ff) v += to_f32(b_up[f0 + hc]);
              v = apply_act(v, act);
            }
            // columns past ff hold act(0) = 0 and meet zero rows of w_down
            hs[(row_w + i * 16 + r) * LDH + hc] = from_f32<T>(v);
          }
          __syncwarp();
        }
      }
    }

    // Phase 2: partial (BM x d_out) += h @ w_down[f0 : f0 + BF, :], BN columns
    // at a time.  The barrier that frees the ring also makes the slab whole.
    auto fill2 = [&](int s) {
      if (s < steps2)
        fill_tile<T, BK, BN, LDW, NT>(wus(s % STAGES), w_down, ff, dout,
                                      f0 + (s % KSTEPS2) * BK, (s / KSTEPS2) * BN, vec_wd);
      __pipeline_commit();
    };
    WarpAcc<T, TM, TN> acc;
    __syncthreads();
    for (int s = 0; s < STAGES - 1; ++s) fill2(s);
    for (int s = 0; s < steps2; ++s) {
      __pipeline_wait_prior(STAGES - 2);
      __syncthreads();
      fill2(s + STAGES - 1);
      if (s % KSTEPS2 == 0) acc.zero();
      acc.mma(hs + row_w * LDH + (s % KSTEPS2) * BK, LDH, wus(s % STAGES) + col_w, LDW, BK);
      if (s % KSTEPS2 != KSTEPS2 - 1) continue;
      const int n0 = (s / KSTEPS2) * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc.store(i, j, stage_u);
          __syncwarp();
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int idx = it * 32 + lane;
            const int r = m0 + row_w + i * 16 + (idx >> 4);
            const int c = n0 + col_w + j * 16 + (idx & 15);
            if (r < m && c < dout) {
              // No other thread touches this address, and one thread's accesses
              // to one address keep their order, so the sum is the same every
              // run.  The add goes out as a reduction that the thread does not
              // wait for; reading, adding and storing here would cost a trip
              // to device memory for every tile of every chunk.
              float* p = my_partial + (size_t)r * dout + c;
              if (chunk == chunk0) *p = stage_u[idx];
              else atomicAdd(p, stage_u[idx]);
            }
          }
          __syncwarp();
        }
      }
    }
    // The next chunk writes hs only after the barrier that opens its phase 1,
    // which every warp reaches after its last read of hs here.
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

}  // namespace

extern "C" {

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
