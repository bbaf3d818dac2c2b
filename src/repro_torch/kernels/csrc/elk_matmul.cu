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
// Three routes, chosen by the wrapper from dtype, m and strides before the
// launch (chip/h100.smem_plan says which, and its tiles); a refused launch
// raises there, no route stands in for another:
//   * "wgmma" (bf16, m >= 64, operands TMA takes: 16-byte aligned bases and
//     row strides of whole 16 bytes): the mainloop of hopper_gemm.cuh, TMA
//     into a ring of stages under mbarriers, a producer warp and one or two
//     consumer warpgroups on wgmma m64nNk16, (bm, bn) in {64, 128} x {64,
//     128, 256} from the plan, y MN-major as (K, N) and K-major as the
//     transpose of (N, K).  The mma_sync kernel below loads every fragment
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
//   * "mma_sync" (what TMA cannot take, and fp32): the kernel below.
//     One block owns one (bm, bn) output tile and walks K inside the block;
//     blocks share nothing.  The operand tiles go through a ring of kStages
//     shared-memory buffers filled by cp.async (16 bytes a thread, zero-
//     filled past the edges; element by element where a row does not start
//     on 16 bytes), rows padded by 16 bytes.  bf16: mma.sync m16n8k16, A
//     fragments by 32-bit shared loads, B by 32-bit loads for y given as
//     (N, K) and by ldmatrix.trans for y as (K, N); 4 warps (8 at bm =
//     128).  fp32: FMA, one product a K step in order (TF32 would miss the
//     fp32 tolerance).
// Every route sums each output element's K steps in a fixed order and uses
// no atomics: the same inputs give the same bits on every run.
//
// The training side's operands (kernels/elk_matmul/ops.py, an autograd
// Function): x given as the transpose of a stored (k, m) matrix (x_trans,
// the x^T dy of a weight gradient, contracted over the tokens) is read in
// place on every route: "wgmma"/"splitk" load it as MN-major A tiles, the
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
// 1.06x (the LM head) to 1.59x (PERF.md has every shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPadBytes = 16;
constexpr int kStages = 3;  // the ring's buffers; chip/h100.py STAGES
int g_smem_optin = 0;       // set by elk_matmul_prepare

struct Args {
  const void* x;
  const void* y;
  const void* x2;  // a second part, out = x y + x2 y2 (same shapes and strides), or null
  const void* y2;
  void* out;
  int m, n, k;
  int lda, ldy;    // row strides of x and of y as stored, in elements
  int bk;
  int x_vec, y_vec;  // rows start on 16 bytes and hold whole 16-byte pieces
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tile in use has arrived once all but the newest kStages - 2 groups
// have.
__device__ __forceinline__ void wait_for_tile() { cp_async_wait<kStages - 2>(); }

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ bf16 zero_of(bf16) { return __float2bfloat16(0.0f); }

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) of the row-major (R, C)
// matrix g (row stride ld) into shared memory rows of lds elements; what lies
// outside (R, C) is zero.  With vec every 16-byte piece is wholly inside or
// outside and moves by cp.async; else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g, int ld, int R, int C, int r0,
                                          int c0, int rows, int cols, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = cols / V;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const int gr = r0 + r, gc = c0 + c;
      const bool inside = gr < R && gc < C;
      cp_async16(s + r * lds + c, inside ? g + (size_t)gr * ld + gc : g, inside);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      const int gr = r0 + r, gc = c0 + c;
      s[r * lds + c] = (gr < R && gc < C) ? g[(size_t)gr * ld + gc] : zero_of(T());
    }
  }
}

// Shared-memory elements of one stage: x (BM, bk), or (bk, BM) read
// transposed (xt), and y (bk, BN) or (BN, bk), rows padded.
template <typename T>
__host__ __device__ __forceinline__ int stage_elems(int bm, int bn, int bk, bool yt,
                                                    bool xt = false) {
  const int pad = kPadBytes / (int)sizeof(T);
  return (xt ? bk * (bm + pad) : bm * (bk + pad)) + (yt ? bn * (bk + pad) : bk * (bn + pad));
}

// The operands of K tile kt: the first part's, or past its nk1 tiles the
// second part's (x2, y2) from its own K tile 0.
struct Part {
  const void* x;
  const void* y;
  int k0;
};
template <bool TWO>
__device__ __forceinline__ Part part_of(const Args& a, int kt, int nk1) {
  if (TWO && kt >= nk1) return {a.x2, a.y2, (kt - nk1) * a.bk};
  return {a.x, a.y, kt * a.bk};
}

// The x tile of K tile k0: (BM rows, bk) of x (m, k), or with XT (bk rows,
// BM) of x stored (k, m), row stride lda either way.
template <bool XT, typename T>
__device__ __forceinline__ void load_x(T* xs, int ldx, const T* xg, const Args& a, int m0, int k0,
                                       int BM) {
  if (XT)
    load_tile(xs, ldx, xg, a.lda, a.k, a.m, k0, m0, a.bk, BM, a.x_vec != 0);
  else
    load_tile(xs, ldx, xg, a.lda, a.m, a.k, m0, k0, BM, a.bk, a.x_vec != 0);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of a k16 x n8 block stored k-major (rows k, n contiguous):
// matrix 0 = k 0-7 (b0), matrix 1 = k 8-15 (b1), transposed on the way.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p)));
}

// A fragment of an m16 x k16 block stored k-major (rows k, m contiguous: x
// stored (k, m)): matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
// (k 8-15, m 8-15) = a0..a3, transposed on the way; p is this lane's row:
// k (lane & 7) + 8 (lane >> 4), m 8 ((lane >> 3) & 1).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

template <int BM, int BN>
struct MmaShape {
  static constexpr int kThreads = BM >= 128 ? 256 : 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWM = BM == 16 ? 1 : (BM >= 128 ? 4 : 2);  // warps along M
  static constexpr int kWN = kWarps / kWM;                        // and along N
  static constexpr int kWTM = BM / kWM;                           // a warp's tile
  static constexpr int kWTN = BN / kWN;
  static constexpr int kMI = kWTM / 16;  // m16 fragments of a warp
  static constexpr int kNI = kWTN / 8;   // n8 fragments of a warp
  static_assert(kWTM % 16 == 0 && kWTN % 8 == 0 && kWM * kWN == kWarps, "warp tiling");
};

template <int BM, int BN, bool YT, bool XT, bool TWO>
__global__ void __launch_bounds__(MmaShape<BM, BN>::kThreads) elk_matmul_mma_kernel(Args a) {
  using S = MmaShape<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int bk = a.bk;
  const int ldx = XT ? BM + 8 : bk + 8, ldy = YT ? bk + 8 : BN + 8;
  const int x_elems = XT ? bk * ldx : BM * ldx;
  const int stage = stage_elems<bf16>(BM, BN, bk, YT, XT);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk1 = (a.k + bk - 1) / bk;
  const int nk = (TWO ? 2 : 1) * nk1;

  auto load = [&](int kt) {
    if (kt < nk) {
      bf16* xs = ring + (kt % kStages) * stage;
      bf16* ys = xs + x_elems;
      const Part pt = part_of<TWO>(a, kt, nk1);
      const int k0 = pt.k0;
      const bf16* yg = reinterpret_cast<const bf16*>(pt.y);
      load_x<XT>(xs, ldx, reinterpret_cast<const bf16*>(pt.x), a, m0, k0, BM);
      if (YT)
        load_tile(ys, ldy, yg, a.ldy, a.n, a.k, n0, k0, BN, bk, a.y_vec != 0);
      else
        load_tile(ys, ldy, yg, a.ldy, a.k, a.n, k0, n0, bk, BN, a.y_vec != 0);
    }
    cp_async_commit();  // one group a step, empty past the last tile
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int gid = lane >> 2, tig = lane & 3;  // row group, thread in group
  float c[S::kMI][S::kNI][4];
#pragma unroll
  for (int i = 0; i < S::kMI; ++i)
#pragma unroll
    for (int j = 0; j < S::kNI; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    wait_for_tile();
    __syncthreads();  // tile kt visible to all; tile kt - 1 no longer read
    load(kt + kStages - 1);  // into the stage tile kt - 1 used
    const bf16* xs = ring + (kt % kStages) * stage;
    const bf16* ys = xs + x_elems;
    for (int kk = 0; kk < bk; kk += 16) {
      uint32_t af[S::kMI][4];
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi) {
        if (XT) {
          ldmatrix_x4_trans(af[mi], xs + (kk + (lane & 7) + 8 * (lane >> 4)) * ldx +
                                        wm * S::kWTM + mi * 16 + 8 * ((lane >> 3) & 1));
        } else {
          const bf16* p = xs + (wm * S::kWTM + mi * 16 + gid) * ldx + kk + 2 * tig;
          af[mi][0] = ld32(p);
          af[mi][1] = ld32(p + 8 * ldx);
          af[mi][2] = ld32(p + 8);
          af[mi][3] = ld32(p + 8 * ldx + 8);
        }
      }
#pragma unroll
      for (int ni = 0; ni < S::kNI; ++ni) {
        const int nn = wn * S::kWTN + ni * 8;
        uint32_t b0, b1;
        if (YT) {
          const bf16* p = ys + (nn + gid) * ldy + kk + 2 * tig;
          b0 = ld32(p);
          b1 = ld32(p + 8);
        } else {
          ldmatrix_x2_trans(b0, b1, ys + (kk + (lane & 15)) * ldy + nn);
        }
#pragma unroll
        for (int mi = 0; mi < S::kMI; ++mi) mma16816(c[mi][ni], af[mi], b0, b1);
      }
    }
  }

  bf16* og = reinterpret_cast<bf16*>(a.out);
#pragma unroll
  for (int mi = 0; mi < S::kMI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < S::kNI; ++ni) {
      const int col = n0 + wn * S::kWTN + ni * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * S::kWTM + mi * 16 + gid + 8 * h;
        if (row >= a.m) continue;
        bf16* o = og + (size_t)row * a.n;
        if (col < a.n) o[col] = __float2bfloat16(c[mi][ni][2 * h]);
        if (col + 1 < a.n) o[col + 1] = __float2bfloat16(c[mi][ni][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA
// ---------------------------------------------------------------------------

template <int BM, int BN>
struct FmaShape {
  static constexpr int kThreads = BM >= 128 ? 256 : 128;
  static constexpr int kPer = BM * BN / kThreads;  // outputs a thread
  static constexpr int kTN = kPer < 8 ? kPer : 8;
  static constexpr int kTM = kPer / kTN;
  static constexpr int kCols = BN / kTN;  // threads along N
  static constexpr int kRows = BM / kTM;  // and along M
  static_assert(kCols * kRows == kThreads && kTM * kTN == kPer, "thread tiling");
};

template <int BM, int BN, bool YT, bool XT, bool TWO>
__global__ void __launch_bounds__(FmaShape<BM, BN>::kThreads) elk_matmul_fma_kernel(Args a) {
  using S = FmaShape<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int bk = a.bk;
  const int ldx = XT ? BM + 4 : bk + 4, ldy = YT ? bk + 4 : BN + 4;
  const int x_elems = XT ? bk * ldx : BM * ldx;
  const int stage = stage_elems<float>(BM, BN, bk, YT, XT);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk1 = (a.k + bk - 1) / bk;
  const int nk = (TWO ? 2 : 1) * nk1;

  auto load = [&](int kt) {
    if (kt < nk) {
      float* xs = ring + (kt % kStages) * stage;
      float* ys = xs + x_elems;
      const Part pt = part_of<TWO>(a, kt, nk1);
      const int k0 = pt.k0;
      const float* yg = reinterpret_cast<const float*>(pt.y);
      load_x<XT>(xs, ldx, reinterpret_cast<const float*>(pt.x), a, m0, k0, BM);
      if (YT)
        load_tile(ys, ldy, yg, a.ldy, a.n, a.k, n0, k0, BN, bk, a.y_vec != 0);
      else
        load_tile(ys, ldy, yg, a.ldy, a.k, a.n, k0, n0, bk, BN, a.y_vec != 0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // this thread's outputs: rows ty + i kRows, columns tx + j kCols
  const int tx = threadIdx.x % S::kCols, ty = threadIdx.x / S::kCols;
  float acc[S::kTM][S::kTN];
#pragma unroll
  for (int i = 0; i < S::kTM; ++i)
#pragma unroll
    for (int j = 0; j < S::kTN; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    wait_for_tile();
    __syncthreads();
    load(kt + kStages - 1);
    const float* xs = ring + (kt % kStages) * stage;
    const float* ys = xs + x_elems;
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      float av[S::kTM], bv[S::kTN];
#pragma unroll
      for (int i = 0; i < S::kTM; ++i)
        av[i] = XT ? xs[kk * ldx + ty + i * S::kRows] : xs[(ty + i * S::kRows) * ldx + kk];
#pragma unroll
      for (int j = 0; j < S::kTN; ++j)
        bv[j] = YT ? ys[(tx + j * S::kCols) * ldy + kk] : ys[kk * ldy + tx + j * S::kCols];
#pragma unroll
      for (int i = 0; i < S::kTM; ++i)
#pragma unroll
        for (int j = 0; j < S::kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* og = reinterpret_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < S::kTM; ++i) {
    const int row = m0 + ty + i * S::kRows;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < S::kTN; ++j) {
      const int col = n0 + tx + j * S::kCols;
      if (col < a.n) og[(size_t)row * a.n + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  return err;
}

template <typename T, int BM, int BN, bool YT, bool XT, bool TWO>
int launch_tile(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * stage_elems<T>(BM, BN, a.bk, YT, XT) * sizeof(T);
  if (g_smem_optin <= 0 || smem > (size_t)g_smem_optin) return -1;
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  if (grid.y > 65535) return -1;
  if constexpr (sizeof(T) == 2)
    elk_matmul_mma_kernel<BM, BN, YT, XT, TWO>
        <<<grid, MmaShape<BM, BN>::kThreads, smem, stream>>>(a);
  else
    elk_matmul_fma_kernel<BM, BN, YT, XT, TWO>
        <<<grid, FmaShape<BM, BN>::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the (bm, bn) instances; chip/h100.py TILE_M x TILE_N lists the same
#define ELK_MATMUL_TILES(F) \
  F(16, 32) F(16, 64) F(16, 128) F(32, 32) F(32, 64) F(32, 128) \
  F(64, 32) F(64, 64) F(64, 128) F(128, 32) F(128, 64) F(128, 128)

template <typename T, bool YT, bool XT, bool TWO = false>
int launch(const Args& a, int bm, int bn, cudaStream_t stream) {
#define ELK_CASE(BM, BN) \
  if (bm == BM && bn == BN) return launch_tile<T, BM, BN, YT, XT, TWO>(a, stream);
  ELK_MATMUL_TILES(ELK_CASE)
#undef ELK_CASE
  return -1;
}

// the TMA instances: (consumer warpgroups, bn); chip/h100.py WG_TILE_M x
// WG_TILE_N less the widths one warpgroup cannot hold (wg_acc_fits)
#define ELK_TMA_TILES(F) F(1, 64) F(1, 128) F(2, 64) F(2, 128) F(2, 256)

template <int WG, int BN>
int launch_tma(hg::GemmParams& p, bool x_trans, bool y_kmajor, bool two, int m, int n, int k,
               int k_per_split, cudaStream_t stream) {
  if (x_trans) {  // x^T dy of a weight gradient: dy (k, n) row-major
    if (y_kmajor || two) return -1;
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, false, true>>(p, m, n, k, k_per_split, stream);
  }
  if (two) {  // the MLP's dx = dg w_gate^T + du w_up^T: y K-major
    if (!y_kmajor) return -1;
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, true, false, false, true>>(p, m, n, k,
                                                                          k_per_split, stream);
  }
  if (y_kmajor)
    return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, true>>(p, m, n, k, k_per_split, stream);
  return hg::launch_gemm<hg::GemmCfg<WG, BN, 1, false>>(p, m, n, k, k_per_split, stream);
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
// every base 16-byte aligned and every stride a multiple of 8 elements.  wg
// consumer warpgroups (64 wg rows a tile), bn columns, the K tiles of both
// parts cut in splits of k_per_split tiles of 64 (at most 8 splits, each
// tile's a cluster).
int elk_matmul_tma_launch(const void* x, const void* y, void* out, const void* x2,
                          const void* y2, int m, int n, int k, int lda, int ldy, int x_trans,
                          int y_trans, int wg, int bn, int k_per_split, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k_per_split < 1) return -1;
  if (lda < (x_trans ? m : k) || ldy < (y_trans ? k : n)) return -1;
  if (!hg::tma_ok(x, lda) || !hg::tma_ok(y, ldy)) return -1;
  if ((x2 == nullptr) != (y2 == nullptr)) return -1;
  if (x2 != nullptr && (!hg::tma_ok(x2, lda) || !hg::tma_ok(y2, ldy))) return -1;
  hg::GemmParams p{};
  p.epi.out = out;
  p.epi.bias = nullptr;
  p.epi.ldo = n;
  p.epi.mode = hg::kEpiStore;
  p.epi.act = 0;
  if (hg::map_a(&p.a, x, m, k, lda, 64 * wg, x_trans != 0) != 0) return -1;
  if (hg::map_b(&p.b0, y, n, k, ldy, y_trans != 0, bn) != 0) return -1;
  p.b1 = p.b0;
  if (x2 != nullptr) {
    if (hg::map_a(&p.a1, x2, m, k, lda, 64 * wg, x_trans != 0) != 0) return -1;
    if (hg::map_b(&p.b1, y2, n, k, ldy, y_trans != 0, bn) != 0) return -1;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define ELK_TMA_CASE(WG, BN)                                                         \
  if (wg == WG && bn == BN)                                                          \
    return launch_tma<WG, BN>(p, x_trans != 0, y_trans != 0, x2 != nullptr, m, n, k, \
                              k_per_split, s);
  ELK_TMA_TILES(ELK_TMA_CASE)
#undef ELK_TMA_CASE
  return -1;
}

// Sets every instance's dynamic shared-memory limit on the current device to
// what a block may opt in to, and remembers that limit.  Call once a device
// before launching.  Returns 0 or a CUDA error.
int elk_matmul_prepare(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
#define ELK_ALLOW_ONE(K, BM, BN, YT, XT, TWO) \
  if (err == cudaSuccess) err = allow_smem(K<BM, BN, YT, XT, TWO>, optin);
#define ELK_ALLOW(BM, BN)                                                \
  ELK_ALLOW_ONE(elk_matmul_mma_kernel, BM, BN, false, false, false)      \
  ELK_ALLOW_ONE(elk_matmul_mma_kernel, BM, BN, true, false, false)       \
  ELK_ALLOW_ONE(elk_matmul_mma_kernel, BM, BN, false, true, false)       \
  ELK_ALLOW_ONE(elk_matmul_mma_kernel, BM, BN, true, false, true)        \
  ELK_ALLOW_ONE(elk_matmul_fma_kernel, BM, BN, false, false, false)      \
  ELK_ALLOW_ONE(elk_matmul_fma_kernel, BM, BN, true, false, false)       \
  ELK_ALLOW_ONE(elk_matmul_fma_kernel, BM, BN, false, true, false)       \
  ELK_ALLOW_ONE(elk_matmul_fma_kernel, BM, BN, true, false, true)
  ELK_MATMUL_TILES(ELK_ALLOW)
#undef ELK_ALLOW
#undef ELK_ALLOW_ONE
  if (err == cudaSuccess) g_smem_optin = optin;
  return (int)err;
}

// Launches out = x @ y [+ x2 @ y2] on `stream`; returns cudaGetLastError()
// (0 = launched) or -1 for arguments it does not take.  dtype 1: bf16
// (tensor cores), 0: fp32 (FMA); x, y and out of that type.  x_trans 0: x
// (m, k) with row stride lda >= k; x_trans 1: x stored as (k, m) with row
// stride lda >= m, read as its transpose (with y_trans 0 only); y_trans 0: y
// (k, n) with row stride ldy >= n; y_trans 1: y stored as (n, k) with row
// stride ldy >= k.  x2, y2: null, or a second part of the same shapes and
// strides whose product is summed after the first (x_trans 0, y_trans 1
// only).  out (m, n) contiguous.
// (bm, bn) one of the compiled tiles, bk a positive multiple of 16, and the
// ring within the opt-in shared memory (elk_matmul_prepare first).
int elk_matmul_launch(const void* x, const void* y, void* out, const void* x2, const void* y2,
                      int m, int n, int k, int lda, int ldy, int x_trans, int y_trans, int dtype,
                      int bm, int bn, int bk, void* stream) {
  if (m < 1 || n < 1 || k < 1 || bk < 16 || bk % 16 != 0) return -1;
  if (lda < (x_trans ? m : k) || ldy < (y_trans ? k : n) || (dtype != 0 && dtype != 1)) return -1;
  if ((x2 == nullptr) != (y2 == nullptr) || (x_trans && y_trans)) return -1;
  if (x2 != nullptr && (x_trans || !y_trans)) return -1;
  const int v = dtype == 1 ? 8 : 4;  // elements of 16 bytes
  auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
  Args a;
  a.x = x; a.y = y; a.x2 = x2; a.y2 = y2; a.out = out;
  a.m = m; a.n = n; a.k = k; a.lda = lda; a.ldy = ldy;
  a.bk = bk;
  a.x_vec = aligned(x) && aligned(x2) && lda % v == 0 && (x_trans ? m : k) % v == 0;
  a.y_vec = aligned(y) && aligned(y2) && ldy % v == 0 && (y_trans ? k : n) % v == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x2 != nullptr)
    return dtype == 1 ? launch<bf16, true, false, true>(a, bm, bn, s)
                      : launch<float, true, false, true>(a, bm, bn, s);
  if (dtype == 1) {
    if (x_trans) return launch<bf16, false, true>(a, bm, bn, s);
    return y_trans ? launch<bf16, true, false>(a, bm, bn, s) : launch<bf16, false, false>(a, bm, bn, s);
  }
  if (x_trans) return launch<float, false, true>(a, bm, bn, s);
  return y_trans ? launch<float, true, false>(a, bm, bn, s) : launch<float, false, false>(a, bm, bn, s);
}

// The name of a CUDA error a launch function returned.
const char* elk_matmul_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

}  // extern "C"
