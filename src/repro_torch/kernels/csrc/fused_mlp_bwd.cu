// The backward of the fused MLP for Hopper (sm_90a): the two passes of it
// that are the MLP's own, and the column sums of its bias gradients.
//
//   forward   y = act(x w_gate) * (x w_up) @ w_down              (GLU)
//             y = act(x w_up + b_up) @ w_down + b_down            (plain)
//   backward  g = x w_gate, u = x w_up [+ b_up]                   (recompute, fp32)
//             dh = dy w_down^T, and in the same epilogue
//               GLU:   dg = dh u act'(g),  du = dh act(g),  h = act(g) u
//               plain: du = dh act'(u),                     h = act(u)
//             dw_down = h^T dy, dw_gate = x^T dg, dw_up = x^T du, and
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
// GLU, bf16) the backward's seven products are 4.4 TFLOP, 4.4 ms on the
// tensor cores; the recompute writes g and u in fp32 (570 MB) and the dh
// pass reads them back and writes dg, du and h (430 MB), 0.30 ms at the
// memory rate.  Operations bound it.
//
// Design.  The recompute is pass 1 of the forward (hopper_gemm.cuh, both
// products on one x tile) with an epilogue that stores the pre-activations
// in fp32 instead of h; the dh pass is the same mainloop with w_down as the
// K-major b (the transpose of the stored (ff, d) matrix, read in place) and
// an epilogue that reads g and u back and applies the activation's
// derivative: the backward twin of pass 1's activation epilogue.  h is
// recomputed from the same fp32 g and u by the same function as the
// forward's pass 1 and rounded to bf16 once, so the h of dw_down = h^T dy
// is the forward's h bit for bit (the forward rounds h before its down
// product).  fp32, and bf16 operands TMA does not take, run both passes on
// an FMA tile kernel (64 x 64 outputs a block, 16-deep K tiles in shared
// memory): TF32 would miss the fp32 tolerance.  The bias gradients are
// column sums, one thread a column, rows added in order.  No atomics: the
// same inputs give the same bits on every run.

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

// The TMA instances: the recompute of pass 1 (two b tiles, or one), and the
// dh pass with w_down read K-major.
using PreGated = hg::GemmCfg<2, 128, 2, false, false, true>;
using PrePlain = hg::GemmCfg<2, 128, 1, false, false, true>;
using DhPass = hg::GemmCfg<2, 128, 1, true, false, true>;

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

template <typename T>
__global__ void colsum_kernel(const T* src, T* out, int m, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float s = 0.0f;
  for (int r = 0; r < m; ++r) s += to_f(src[(size_t)r * n + col]);
  out[col] = from_f<T>(s);
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

// The recompute: pre_g = x w_gate and pre_u = x w_up (GLU: w_gate given), or
// pre_u = x w_up + b_up (plain; b_up may be null), fp32 (m, ff).  x (m, d),
// w_up / w_gate (d, ff), b_up (ff,), contiguous, of dtype 1 (bf16) or 0
// (fp32).  tma 1: the TMA + wgmma mainloop (bf16, every base on 16 bytes, d
// and ff multiples of 8); 0: the FMA tile kernel.  Returns
// cudaGetLastError() (0 = launched) or -1 for arguments it does not take.
int fused_mlp_bwd_pre_launch(const void* x, const void* w_up, const void* w_gate,
                             const void* b_up, float* pre_g, float* pre_u, int m, int d, int ff,
                             int dtype, int tma, void* stream) {
  if (m < 1 || d < 1 || ff < 1 || (w_gate != nullptr && pre_g == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!tma) {
    if (dtype == 1) return tile_pre<bf16>(x, w_up, w_gate, b_up, pre_g, pre_u, m, d, ff, s);
    return tile_pre<float>(x, w_up, w_gate, b_up, pre_g, pre_u, m, d, ff, s);
  }
  if (dtype != 1 || !hg::tma_ok(x, d) || !hg::tma_ok(w_up, ff) ||
      (w_gate != nullptr && !hg::tma_ok(w_gate, ff)))
    return -1;
  hg::GemmParams p{};
  p.epi.mode = hg::kEpiPre;
  p.epi.ldo = ff;
  if (hg::map_a(&p.a, x, m, d, d, 128) != 0) return -1;
  if (w_gate != nullptr) {
    p.epi.out = pre_g;
    p.epi.out2 = pre_u;
    if (hg::map_b(&p.b0, w_gate, ff, d, ff, false, PreGated::BN) != 0 ||
        hg::map_b(&p.b1, w_up, ff, d, ff, false, PreGated::BN) != 0)
      return -1;
    return hg::launch_gemm<PreGated>(p, m, ff, d, (d + hg::kBK - 1) / hg::kBK, s);
  }
  p.epi.out = pre_u;
  p.epi.bias = reinterpret_cast<const bf16*>(b_up);
  if (hg::map_b(&p.b0, w_up, ff, d, ff, false, PrePlain::BN) != 0) return -1;
  p.b1 = p.b0;
  return hg::launch_gemm<PrePlain>(p, m, ff, d, (d + hg::kBK - 1) / hg::kBK, s);
}

// The dh pass: dh = dy w_down^T with the activation's derivative applied in
// the epilogue.  dy (m, dout), w_down (ff, dout) as stored, pre_g (GLU, or
// null) and pre_u fp32 (m, ff); writes dg (GLU only), du and h (m, ff) in
// the operands' type.  tma as for the recompute (dy and w_down the TMA
// operands).  Returns cudaGetLastError() (0 = launched) or -1.
int fused_mlp_bwd_dh_launch(const void* dy, const void* w_down, const float* pre_g,
                            const float* pre_u, void* dg, void* du, void* h, int m, int ff,
                            int dout, int act, int dtype, int tma, void* stream) {
  if (m < 1 || ff < 1 || dout < 1 || pre_u == nullptr || (pre_g != nullptr && dg == nullptr))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!tma) {
    if (dtype == 1) return tile_dh<bf16>(dy, w_down, pre_g, pre_u, dg, du, h, m, ff, dout, act, s);
    return tile_dh<float>(dy, w_down, pre_g, pre_u, dg, du, h, m, ff, dout, act, s);
  }
  if (dtype != 1 || !hg::tma_ok(dy, dout) || !hg::tma_ok(w_down, dout)) return -1;
  hg::GemmParams p{};
  p.epi.mode = hg::kEpiDeriv;
  p.epi.act = act;
  p.epi.ldo = ff;
  p.epi.out = dg;
  p.epi.out2 = du;
  p.epi.out3 = h;
  p.epi.pre_g = pre_g;
  p.epi.pre_u = pre_u;
  if (hg::map_a(&p.a, dy, m, dout, dout, DhPass::BM) != 0) return -1;
  if (hg::map_b(&p.b0, w_down, ff, dout, dout, true, DhPass::BN) != 0) return -1;
  p.b1 = p.b0;
  return hg::launch_gemm<DhPass>(p, m, ff, dout, (dout + hg::kBK - 1) / hg::kBK, s);
}

// out (n,) = the sums of the columns of src (m, n), contiguous, rows added in
// order in fp32; dtype 1 bf16, 0 fp32.  Returns cudaGetLastError() or -1.
int fused_mlp_bwd_colsum_launch(const void* src, void* out, int m, int n, int dtype,
                                void* stream) {
  if (m < 1 || n < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128, blocks = (n + threads - 1) / threads;
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
