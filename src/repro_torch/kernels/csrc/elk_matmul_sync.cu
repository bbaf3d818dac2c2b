// ELK-blocked matrix product for Hopper (sm_90a), the routes without TMA:
// "mma_sync" (bf16 that neither TMA route takes, any forced block shape) and
// "fma" / "fma_splitk" (fp32).  What they compute, and the TMA routes, are
// in elk_matmul.cu; this source is a library of its own so that the two
// nvcc processes run side by side.

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
// fp32, routes "fma" and "fma_splitk": register tiles read 16 bytes at a
// time, a deeper ring, K split over a cluster where the tiles are few
// ---------------------------------------------------------------------------

constexpr int kF32Stages = 4;  // the ring of the "fma" routes; chip/h100.py FMA_STAGES

// Threads, and each thread's tile: TM contiguous rows x TN columns (y as
// (K, N): groups of four adjacent columns, 4 kCols apart; y as (N, K):
// columns kCols apart).  A tile of fewer than 32 outputs a thread (the thin
// tiles of a decode step) is computed by kSlices groups of threads, each
// over its own quarter of every K tile, so that a thread reads each y value
// it loads for several rows; the slices' sums are added in order.
template <int BM, int BN>
struct F32Shape {
  static constexpr int kThreads = BM * BN >= 128 * 128 ? 256 : 128;
  static constexpr int kSlices = BM * BN / kThreads < 32 ? 4 : 1;
  static constexpr int kSliceThreads = kThreads / kSlices;
  static constexpr int kPer = BM * BN / kSliceThreads;
  static constexpr int kTN = kPer >= 64 ? 8 : 4;
  static constexpr int kTM = kPer / kTN;
  static constexpr int kCols = BN / kTN;  // threads along N
  static constexpr int kRows = BM / kTM;  // and along M
  static_assert(kCols * kRows == kSliceThreads && kTM * kTN == kPer, "thread tiling");
};

// The "fma" kernel: one (BM, BN) output tile a block and, with splits > 1
// (blockIdx.z its rank in a cluster of `splits` along z), a share of the K
// tiles of both parts; the splits' sums meet in rank order over the
// cluster's shared memory.  bk a multiple of 16 (of 4 kSlices).
template <int BM, int BN, bool YT, bool XT, bool TWO>
__global__ void __launch_bounds__(F32Shape<BM, BN>::kThreads)
    elk_matmul_f32_kernel(Args a, int k_per_split, int splits) {
  using S = F32Shape<BM, BN>;
  constexpr int TM = S::kTM, TN = S::kTN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int bk = a.bk;
  const int ldx = XT ? BM + 4 : bk + 4, ldy = YT ? bk + 4 : BN + 4;
  const int x_elems = XT ? bk * ldx : BM * ldx;
  const int stage = stage_elems<float>(BM, BN, bk, YT, XT);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk1 = (a.k + bk - 1) / bk;
  const int kt0 = blockIdx.z * k_per_split;
  const int nk = min((TWO ? 2 : 1) * nk1, kt0 + k_per_split) - kt0;

  auto load = [&](int i) {
    if (i < nk) {
      float* xs = ring + (i % kF32Stages) * stage;
      float* ys = xs + x_elems;
      const Part pt = part_of<TWO>(a, kt0 + i, nk1);
      const int k0 = pt.k0;
      const float* yg = reinterpret_cast<const float*>(pt.y);
      load_x<XT>(xs, ldx, reinterpret_cast<const float*>(pt.x), a, m0, k0, BM);
      if (YT)
        load_tile(ys, ldy, yg, a.ldy, a.n, a.k, n0, k0, BN, bk, a.y_vec != 0);
      else
        load_tile(ys, ldy, yg, a.ldy, a.k, a.n, k0, n0, bk, BN, a.y_vec != 0);
    }
    cp_async_commit();  // one group a step, empty past the last tile
  };
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) load(s);

  const int slice = threadIdx.x / S::kSliceThreads;  // its share of each K tile
  const int lt = threadIdx.x % S::kSliceThreads;
  const int tx = lt % S::kCols, ty = lt / S::kCols;
  const int row0 = ty * TM;  // this thread's rows: row0 .. row0 + TM - 1 of the tile
  const int kk0 = slice * (bk / S::kSlices), kk1 = kk0 + bk / S::kSlices;
  auto col = [&](int j) {
    return YT ? tx + j * S::kCols : (j / 4) * (4 * S::kCols) + 4 * tx + (j % 4);
  };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // tile i visible to all; tile i - 1 no longer read
    load(i + kF32Stages - 1);  // into the stage tile i - 1 used
    const float* xs = ring + (i % kF32Stages) * stage;
    const float* ys = xs + x_elems;
#pragma unroll 2
    for (int kk = kk0; kk < kk1; kk += 4) {
      // x at four K steps: a float4 along K of each row (x as stored), or
      // one element a row and step (x read transposed)
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (XT)
          av[r] = make_float4(xs[kk * ldx + row0 + r], xs[(kk + 1) * ldx + row0 + r],
                              xs[(kk + 2) * ldx + row0 + r], xs[(kk + 3) * ldx + row0 + r]);
        else
          av[r] = *reinterpret_cast<const float4*>(xs + (row0 + r) * ldx + kk);
      }
      if constexpr (YT) {
        // y as (N, K): a float4 along K of each column
        float4 bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = *reinterpret_cast<const float4*>(ys + col(j) * ldy + kk);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[r][j] = fmaf(av[r].x, bv[j].x, acc[r][j]);
            acc[r][j] = fmaf(av[r].y, bv[j].y, acc[r][j]);
            acc[r][j] = fmaf(av[r].z, bv[j].z, acc[r][j]);
            acc[r][j] = fmaf(av[r].w, bv[j].w, acc[r][j]);
          }
      } else {
        // y as (K, N): four adjacent columns a float4, one K step at a time
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bv[TN];
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                ys + (kk + q) * ldy + h * 4 * S::kCols + 4 * tx);
            bv[4 * h] = v.x;
            bv[4 * h + 1] = v.y;
            bv[4 * h + 2] = v.z;
            bv[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float x = q == 0 ? av[r].x : q == 1 ? av[r].y : q == 2 ? av[r].z : av[r].w;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(x, bv[j], acc[r][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* og = reinterpret_cast<float*>(a.out);
  if (splits == 1 && S::kSlices == 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = m0 + row0 + r;
      if (row >= a.m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + col(j);
        if (c < a.n) og[(size_t)row * a.n + c] = acc[r][j];
      }
    }
    return;
  }
  // the block's sums into its shared memory (over the ring, which every
  // thread has finished reading), the slices' added in order; then, split,
  // each block adds up its share of the tile's live elements over the
  // cluster, rank by rank
  __syncthreads();
  float* red = ring;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) red[slice * BM * BN + (row0 + r) * BN + col(j)] = acc[r][j];
  if constexpr (S::kSlices > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += S::kThreads) {
      float v = red[e];
#pragma unroll
      for (int q = 1; q < S::kSlices; ++q) v += red[q * BM * BN + e];
      if (splits == 1) {
        const int row = m0 + e / BN, c = n0 + e % BN;
        if (row < a.m && c < a.n) og[(size_t)row * a.n + c] = v;
      } else {
        red[e] = v;
      }
    }
    if (splits == 1) return;
  }
  hg::cluster_sync();
  const int rows = min(BM, a.m - m0), cols = min(BN, a.n - n0);
  const int split = blockIdx.z;
  for (int e = split * S::kThreads + threadIdx.x; e < rows * cols; e += S::kThreads * splits) {
    const int r = e / cols, c = e % cols;
    float v = 0.0f;
    for (int q = 0; q < splits; ++q) v += hg::ld_cluster(red + r * BN + c, q);
    og[(size_t)(m0 + r) * a.n + n0 + c] = v;
  }
  hg::cluster_sync();  // no block leaves while another reads its shared memory
}

template <int BM, int BN, bool YT, bool XT, bool TWO>
int launch_f32_tile(const Args& a, int k_per_split, int splits, cudaStream_t stream) {
  const size_t smem = (size_t)kF32Stages * stage_elems<float>(BM, BN, a.bk, YT, XT) * 4;
  if (g_smem_optin <= 0 || smem > (size_t)g_smem_optin) return -1;
  if ((size_t)F32Shape<BM, BN>::kSlices * BM * BN * 4 > smem) return -1;
  if (a.bk % (4 * F32Shape<BM, BN>::kSlices) != 0) return -1;
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, splits);
  if (grid.y > 65535) return -1;
  if (splits == 1) {
    elk_matmul_f32_kernel<BM, BN, YT, XT, TWO>
        <<<grid, F32Shape<BM, BN>::kThreads, smem, stream>>>(a, k_per_split, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(F32Shape<BM, BN>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, elk_matmul_f32_kernel<BM, BN, YT, XT, TWO>, a, k_per_split, splits);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the (bm, bn) instances of the "fma" routes; chip/h100.py FMA_TILES lists
// the same
#define ELK_FMA_TILES(F) F(16, 32) F(16, 64) F(32, 64) F(64, 64) F(64, 128) F(128, 128)

template <bool YT, bool XT, bool TWO = false>
int launch_f32(const Args& a, int bm, int bn, int k_per_split, int splits, cudaStream_t stream) {
#define ELK_F32_CASE(BM, BN) \
  if (bm == BM && bn == BN) return launch_f32_tile<BM, BN, YT, XT, TWO>(a, k_per_split, splits, stream);
  ELK_FMA_TILES(ELK_F32_CASE)
#undef ELK_F32_CASE
  return -1;
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

}  // namespace

extern "C" {

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
#define ELK_ALLOW_F32(BM, BN)                                            \
  ELK_ALLOW_ONE(elk_matmul_f32_kernel, BM, BN, false, false, false)      \
  ELK_ALLOW_ONE(elk_matmul_f32_kernel, BM, BN, true, false, false)       \
  ELK_ALLOW_ONE(elk_matmul_f32_kernel, BM, BN, false, true, false)       \
  ELK_ALLOW_ONE(elk_matmul_f32_kernel, BM, BN, true, false, true)
  ELK_FMA_TILES(ELK_ALLOW_F32)
#undef ELK_ALLOW_F32
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

// Launches the fp32 out = x @ y [+ x2 @ y2] of routes "fma" (splits 1) and
// "fma_splitk" (splits 2 to 8 blocks of a cluster, each k_per_split K tiles
// of bk over both parts, the last fewer, none empty) on `stream`; the
// operands, strides and returns of elk_matmul_launch; (bm, bn) one of
// ELK_FMA_TILES, bk a positive multiple of 16, the ring of kF32Stages
// within the opt-in shared memory (elk_matmul_prepare first).
int elk_matmul_fma_launch(const void* x, const void* y, void* out, const void* x2,
                          const void* y2, int m, int n, int k, int lda, int ldy, int x_trans,
                          int y_trans, int bm, int bn, int bk, int k_per_split, int splits,
                          void* stream) {
  if (m < 1 || n < 1 || k < 1 || bk < 16 || bk % 16 != 0 || k_per_split < 1) return -1;
  if (splits < 1 || splits > hg::kMaxSplits) return -1;
  const int tiles = ((x2 != nullptr ? 2 : 1) * ((k + bk - 1) / bk));
  if ((splits - 1) * k_per_split >= tiles || splits * k_per_split < tiles) return -1;
  if (lda < (x_trans ? m : k) || ldy < (y_trans ? k : n)) return -1;
  if ((x2 == nullptr) != (y2 == nullptr) || (x_trans && y_trans)) return -1;
  if (x2 != nullptr && (x_trans || !y_trans)) return -1;
  auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
  Args a;
  a.x = x; a.y = y; a.x2 = x2; a.y2 = y2; a.out = out;
  a.m = m; a.n = n; a.k = k; a.lda = lda; a.ldy = ldy;
  a.bk = bk;
  a.x_vec = aligned(x) && aligned(x2) && lda % 4 == 0 && (x_trans ? m : k) % 4 == 0;
  a.y_vec = aligned(y) && aligned(y2) && ldy % 4 == 0 && (y_trans ? k : n) % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x2 != nullptr) return launch_f32<true, false, true>(a, bm, bn, k_per_split, splits, s);
  if (x_trans) return launch_f32<false, true>(a, bm, bn, k_per_split, splits, s);
  return y_trans ? launch_f32<true, false>(a, bm, bn, k_per_split, splits, s)
                 : launch_f32<false, false>(a, bm, bn, k_per_split, splits, s);
}

// The name of a CUDA error a launch function returned.
const char* elk_matmul_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

}  // extern "C"
