// The backward of flash attention for Hopper (sm_90a), from the row
// log-sum-exp the forward wrote (flash_attention.cu, when asked).
//
//   forward   P = softmax(scale Q K^T over live keys), O = P V
//   backward  delta_i = sum_d dO[i, d] O[i, d]
//             P_ij = exp(scale q_i . k_j - lse_i)   (0 where j is not live for i)
//             dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//             dQ = scale dS K,  dK = scale dS^T Q
//
// GQA: query head h reads kv head h / G, and dK, dV of a kv head sum the G
// query heads of its group.  Masks as the forward's at positions 0..S-1:
// causal (j <= i), a window (j > i - window), bidirectional, and Sq != Sk
// without a mask but the index (whisper's cross-attention).  A row with no
// live key has lse = +inf and so P = 0 and no gradient, as its output is 0.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (flash_attention, _flash_kernel :32) has no backward: the reference trains
// through XLA's gradient of chunked_gqa_attention.  The port's model runs
// the hand-written forward on every full-sequence pass (prefill, training),
// which autograd cannot see through, so its gradient is a kernel too
// (kernels/flash_attention/ops.py: an autograd Function).
//
// What bounds it on an H100 SXM (datasheet: 989 TFLOP/s dense bf16, 3.35
// TB/s): at qwen3-14b's training shape (B 8, Hq 40, Hkv 8, S 512, D 128,
// causal) the five products of the causal half are 2.5 times the forward's,
// 54 GFLOP, 0.054 ms on the tensor cores; q, o, dO (Hq heads), k, v (Hkv)
// and the lse in, dq, dk, dv out are 0.202 GB, 0.060 ms.  About balanced;
// this design is far from either (PERF.md).
//
// Route "wgmma" (flash_attention_bwd_wgmma.cu) takes bf16 at
// head dims 64-128, faster at every one measured (PERF.md); this source
// keeps the routes of the rest, bf16 at 16 and 32 ("mma_sync") and fp32
// ("fma").  Their design, simple and right first:
//   * two launches: a Q-major pass computes delta for its rows (and writes
//     it) and dQ; a KV-major pass, after it on the stream, dK and dV.  Each
//     output element is summed in one block, in a fixed order (key tiles in
//     order; for dK and dV the G heads of the group, then the query tiles,
//     in order): no atomics, the same bits on every run.
//   * bf16 (head dims 16 and 32): mma.sync m16n8k16 with fp32
//     accumulators, four warps of 16 rows.  Q, dO, K and V tiles sit in
//     shared memory with rows padded by 16 bytes (conflict-free fragment
//     loads); S and dP stay in registers, and P (for dV) and dS (for dQ,
//     dK) go to the next product straight from the accumulator layout as A
//     fragments in bf16, as the forward's P V does.  dQ pass: 64 query rows
//     against tiles of 64 keys; dKV pass: 64 keys against tiles of 32 query
//     rows (dK and dV, 16 x D each a warp, stay in registers).
//   * fp32: the same two passes on FMA (TF32 would miss the fp32
//     tolerance), tiles of 32 x 32 in shared memory, D a multiple of 8 up to
//     256.
//   * dO is read through its strides: it arrives as the (B, S, Hq, D)
//     storage the forward's output has (the w_o reshape is a view), as do q
//     and dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // four warps
constexpr int kBQ = 64;        // bf16 dQ pass: query rows of a block
constexpr int kBK = 64;        // bf16 dQ pass: keys of a tile; dKV pass: keys of a block
constexpr int kBQ2 = 32;       // bf16 dKV pass: query rows of a tile
constexpr int kFT = 32;        // fp32: rows of every tile
constexpr int kPassDq = 1;     // the passes a launch runs (`passes`)
constexpr int kPassDkv = 2;

struct Args {
  const void* q;        // (B, Hq, Sq, D) at q_sb, q_sh, q_ss
  const void* k;        // (B, Hkv, Sk, D), contiguous
  const void* v;
  const void* o;        // (B, Hq, Sq, D) at o_sb, o_sh, o_ss
  const void* dout;     // (B, Hq, Sq, D) at do_sb, do_sh, do_ss
  const float* lse;     // (B, Hq, Sq), the forward's
  float* delta;         // (B, Hq, Sq), written by the dQ pass
  void* dq;             // (B, Hq, Sq, D) at dq_sb, dq_sh, dq_ss
  void* dk;             // (B, Hkv, Sk, D), contiguous
  void* dv;
  long long q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  int b, hq, hkv, sq, sk, d, g;
  int causal, window;
  float scale, scale_log2;
};

__device__ __forceinline__ bool live(const Args& a, int i, int j) {
  return i < a.sq && j < a.sk && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ long long row_index(const Args& a, int b, int h, int i) {
  return ((long long)b * a.hq + h) * a.sq + i;
}

// The tiles of `span` along the other axis that rows [lo, lo + rows) can
// reach: [first, last) of tiles of `tile`.  Queries i and keys j with j <= i
// (causal) and j > i - window.
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int tile, int& first,
                                          int& last) {
  const int n = (a.sk + tile - 1) / tile;
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  first = 0;
  last = n;
  if (a.causal) last = min(n, q_last / tile + 1);
  if (a.window > 0) first = max(0, (q0 - a.window + 1) / tile);
}

__device__ __forceinline__ void query_tiles(const Args& a, int j0, int keys, int tile, int& first,
                                            int& last) {
  const int n = (a.sq + tile - 1) / tile;
  first = 0;
  last = n;
  if (a.causal) first = j0 / tile;
  if (a.window > 0) last = min(n, (j0 + keys - 1 + a.window - 1) / tile + 1);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// B fragment of a k16 x n8 block stored k-major (rows k, n contiguous).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows r, r + 8 (r = 16 warp + lane / 4) at depth k0 of a
// tile in shared memory, rows of ld elements.
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const bf16* s, int ld, int r, int k0,
                                       int tig) {
  const bf16* p = s + r * ld + k0 + 2 * tig;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// The A fragment (m16 x k16) of columns 16 c .. 16 c + 15 of a 16-row block
// held in the accumulator layout (x[n][e]: row lane / 4 + 8 (e >> 1), column
// 8 n + 2 (lane % 4) + (e & 1)), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_frag(uint32_t (&f)[4], const float (&x)[N][4], int c) {
  f[0] = pack(x[2 * c][0], x[2 * c][1]);
  f[1] = pack(x[2 * c][2], x[2 * c][3]);
  f[2] = pack(x[2 * c + 1][0], x[2 * c + 1][1]);
  f[3] = pack(x[2 * c + 1][2], x[2 * c + 1][3]);
}

template <int D>
struct Mma {
  static constexpr int DP = (D + 15) / 16 * 16;  // D padded to the k16 step
  static constexpr int LD = DP + 8;              // shared-memory row, 16 bytes of padding
  static constexpr int ND = D / 8;               // n8 blocks of a D-wide output
  static constexpr int KD = DP / 16;             // k16 steps over D
  static constexpr int DQ_SMEM = 4 * kBQ * LD * 2 + 2 * kBQ * 4;
  static constexpr int DKV_SMEM = (2 * kBK + 2 * kBQ2) * LD * 2 + 2 * kBQ2 * 4;
};

// Rows [r0, r0 + rows) of an (n, D) bf16 matrix at src (row stride `stride`
// elements, 16-byte aligned rows) into shared memory rows of LD elements;
// zeros past n and in the columns from D to the padded DP.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int r0,
                                          int rows, int n) {
  constexpr int CH = D / 8, CHP = Mma<D>::DP / 8, LD = Mma<D>::LD;
  for (int e = threadIdx.x; e < rows * CHP; e += kThreads) {
    const int r = e / CHP, c = e - r * CHP;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c < CH)
      v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * LD + 8 * c) = v;
  }
}

// dQ pass (and delta): a block owns (b, query head h, 64 query rows).
template <int D>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(Args a) {
  using M = Mma<D>;
  constexpr int LD = M::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kBQ * LD;
  bf16* ks = dos + kBQ * LD;
  bf16* vs = ks + kBK * LD;
  float* lse2_s = reinterpret_cast<float*>(vs + kBK * LD);
  float* dl_s = lse2_s + kBQ;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z, hk = h / a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* og = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long kv0 = ((long long)b * a.hkv + hk) * a.sk * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + kv0;
  const bf16* vg = static_cast<const bf16*>(a.v) + kv0;

  load_rows<D>(qs, qg, a.q_ss, q0, kBQ, a.sq);
  load_rows<D>(dos, dog, a.do_ss, q0, kBQ, a.sq);
  // delta, one warp a row; rows past Sq get lse +inf (P = 0) and delta 0
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int i = q0 + r;
    float s = 0.0f;
    if (i < a.sq)
      for (int dd = lane; dd < D; dd += 32)
        s += to_f(og[i * a.o_ss + dd]) * to_f(dog[i * a.do_ss + dd]);
    s = warp_sum(s);
    if (lane == 0) {
      dl_s[r] = s;
      lse2_s[r] = i < a.sq ? a.lse[row_index(a, b, h, i)] * kLog2e : INFINITY;
      if (i < a.sq) a.delta[row_index(a, b, h, i)] = s;
    }
  }
  __syncthreads();

  const int r_lo = warp * 16 + gid;
  int qi[2];
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + r_lo + 8 * hh;
    l2[hh] = lse2_s[r_lo + 8 * hh];
    dl[hh] = dl_s[r_lo + 8 * hh];
  }
  float dq[M::ND][4];
#pragma unroll
  for (int n = 0; n < M::ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;

  int kt_first, kt_last;
  key_tiles(a, q0, kBK, kt_first, kt_last);
  for (int kt = kt_first; kt < kt_last; ++kt) {
    __syncthreads();  // the last tile's K and V are no longer read
    load_rows<D>(ks, kg, D, kt * kBK, kBK, a.sk);
    load_rows<D>(vs, vg, D, kt * kBK, kBK, a.sk);
    __syncthreads();
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < M::KD; ++kk) {
      uint32_t aq[4], ad[4];
      a_frag(aq, qs, LD, r_lo, 16 * kk, tig);
      a_frag(ad, dos, LD, r_lo, 16 * kk, tig);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const bf16* pk = ks + (8 * n + gid) * LD + 16 * kk + 2 * tig;
        const bf16* pv = vs + (8 * n + gid) * LD + 16 * kk + 2 * tig;
        mma16816(s[n], aq, ld32(pk), ld32(pk + 8));
        mma16816(dp[n], ad, ld32(pv), ld32(pv + 8));
      }
    }
    // s becomes dS = P (dP - delta)
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, j = kt * kBK + 8 * n + 2 * tig + (e & 1);
        const float p = live(a, qi[hh], j) ? exp2f(s[n][e] * a.scale_log2 - l2[hh]) : 0.0f;
        s[n][e] = p * (dp[n][e] - dl[hh]);
      }
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      uint32_t af[4];
      acc_frag(af, s, c);
#pragma unroll
      for (int n = 0; n < M::ND; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, ks + (16 * c + (lane & 15)) * LD + 8 * n);
        mma16816(dq[n], af, b0, b1);
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < M::ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqg + qi[hh] * a.dq_ss + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(dq[n][2 * hh] * a.scale, dq[n][2 * hh + 1] * a.scale);
  }
}

// dKV pass: a block owns (b, kv head, 64 keys) and walks the G query heads of
// the group and their query tiles of 32, in order.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_mma_kernel(Args a) {
  using M = Mma<D>;
  constexpr int LD = M::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBK * LD;
  bf16* qs = vs + kBK * LD;
  bf16* dos = qs + kBQ2 * LD;
  float* lse2_s = reinterpret_cast<float*>(dos + kBQ2 * LD);
  float* dl_s = lse2_s + kBQ2;
  const int j0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const long long kv0 = ((long long)b * a.hkv + hk) * a.sk * D;
  load_rows<D>(ks, static_cast<const bf16*>(a.k) + kv0, D, j0, kBK, a.sk);
  load_rows<D>(vs, static_cast<const bf16*>(a.v) + kv0, D, j0, kBK, a.sk);

  const int r_lo = warp * 16 + gid;  // this thread's keys j0 + r_lo, + 8
  float dk[M::ND][4], dv[M::ND][4];
#pragma unroll
  for (int n = 0; n < M::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  int qt_first, qt_last;
  query_tiles(a, j0, kBK, kBQ2, qt_first, qt_last);
  for (int g = 0; g < a.g; ++g) {
    const int h = hk * a.g + g;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = qt_first; qt < qt_last; ++qt) {
      const int i0 = qt * kBQ2;
      __syncthreads();  // the last tile's Q and dO are no longer read
      load_rows<D>(qs, qg, a.q_ss, i0, kBQ2, a.sq);
      load_rows<D>(dos, dog, a.do_ss, i0, kBQ2, a.sq);
      if (tid < kBQ2) {
        const int i = i0 + tid;
        lse2_s[tid] = i < a.sq ? a.lse[row_index(a, b, h, i)] * kLog2e : INFINITY;
        dl_s[tid] = i < a.sq ? a.delta[row_index(a, b, h, i)] : 0.0f;
      }
      __syncthreads();
      // S^T and dP^T, 16 keys x 32 queries a warp
      float st[kBQ2 / 8][4], dpt[kBQ2 / 8][4];
#pragma unroll
      for (int n = 0; n < kBQ2 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < M::KD; ++kk) {
        uint32_t ak[4], av[4];
        a_frag(ak, ks, LD, r_lo, 16 * kk, tig);
        a_frag(av, vs, LD, r_lo, 16 * kk, tig);
#pragma unroll
        for (int n = 0; n < kBQ2 / 8; ++n) {
          const bf16* pq = qs + (8 * n + gid) * LD + 16 * kk + 2 * tig;
          const bf16* pd = dos + (8 * n + gid) * LD + 16 * kk + 2 * tig;
          mma16816(st[n], ak, ld32(pq), ld32(pq + 8));
          mma16816(dpt[n], av, ld32(pd), ld32(pd + 8));
        }
      }
      // st becomes P^T, dpt dS^T
#pragma unroll
      for (int n = 0; n < kBQ2 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 8 * n + 2 * tig + (e & 1), j = j0 + r_lo + 8 * (e >> 1);
          const float p =
              live(a, i0 + il, j) ? exp2f(st[n][e] * a.scale_log2 - lse2_s[il]) : 0.0f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl_s[il]);
        }
#pragma unroll
      for (int c = 0; c < kBQ2 / 16; ++c) {
        uint32_t ap[4], as[4];
        acc_frag(ap, st, c);
        acc_frag(as, dpt, c);
#pragma unroll
        for (int n = 0; n < M::ND; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, dos + (16 * c + (lane & 15)) * LD + 8 * n);
          mma16816(dv[n], ap, b0, b1);
          ldmatrix_x2_trans(b0, b1, qs + (16 * c + (lane & 15)) * LD + 8 * n);
          mma16816(dk[n], as, b0, b1);
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(a.dk) + kv0;
  bf16* dvg = static_cast<bf16*>(a.dv) + kv0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + r_lo + 8 * hh;
    if (j >= a.sk) continue;
#pragma unroll
    for (int n = 0; n < M::ND; ++n) {
      const long long at = (long long)j * D + 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dkg + at) =
          __floats2bfloat162_rn(dk[n][2 * hh] * a.scale, dk[n][2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + at) =
          __floats2bfloat162_rn(dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA over 32 x 32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kLdS = kFT + 1;  // rows of the score tiles, padded

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int r0, int n, int D) {
  for (int e = threadIdx.x; e < kFT * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[e] = r0 + r < n ? src[(long long)(r0 + r) * stride + c] : 0.0f;
  }
}

__device__ __forceinline__ float dot(const float* x, const float* y, int D) {
  float s = 0.0f;
  for (int c = 0; c < D; ++c) s = fmaf(x[c], y[c], s);
  return s;
}

__global__ void __launch_bounds__(kThreads) dq_fma_kernel(Args a) {
  const int D = a.d;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* dos = qs + kFT * D;
  float* ks = dos + kFT * D;
  float* vs = ks + kFT * D;
  float* acc = vs + kFT * D;
  float* ds = acc + kFT * D;
  float* lse2_s = ds + kFT * kLdS;
  float* dl_s = lse2_s + kFT;
  const int q0 = blockIdx.x * kFT, h = blockIdx.y, b = blockIdx.z, hk = h / a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* og = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long kv0 = ((long long)b * a.hkv + hk) * a.sk * D;
  load_rows_f32(qs, qg, a.q_ss, q0, a.sq, D);
  load_rows_f32(dos, dog, a.do_ss, q0, a.sq, D);
  for (int e = tid; e < kFT * D; e += kThreads) acc[e] = 0.0f;
  for (int r = warp; r < kFT; r += kThreads / 32) {
    const int i = q0 + r;
    float s = 0.0f;
    if (i < a.sq)
      for (int dd = lane; dd < D; dd += 32) s += og[i * a.o_ss + dd] * dog[i * a.do_ss + dd];
    s = warp_sum(s);
    if (lane == 0) {
      dl_s[r] = s;
      lse2_s[r] = i < a.sq ? a.lse[row_index(a, b, h, i)] * kLog2e : INFINITY;
      if (i < a.sq) a.delta[row_index(a, b, h, i)] = s;
    }
  }
  const int n = (a.sk + kFT - 1) / kFT;
  const int q_last = min(q0 + kFT, a.sq) - 1;
  const int kt_last = a.causal ? min(n, q_last / kFT + 1) : n;
  const int kt_first = a.window > 0 ? max(0, (q0 - a.window + 1) / kFT) : 0;
  for (int kt = kt_first; kt < kt_last; ++kt) {
    __syncthreads();
    load_rows_f32(ks, static_cast<const float*>(a.k) + kv0, D, kt * kFT, a.sk, D);
    load_rows_f32(vs, static_cast<const float*>(a.v) + kv0, D, kt * kFT, a.sk, D);
    __syncthreads();
    for (int e = tid; e < kFT * kFT; e += kThreads) {
      const int r = e / kFT, jl = e - r * kFT;
      float v = 0.0f;
      if (live(a, q0 + r, kt * kFT + jl)) {
        const float p = exp2f(dot(qs + r * D, ks + jl * D, D) * a.scale_log2 - lse2_s[r]);
        v = p * (dot(dos + r * D, vs + jl * D, D) - dl_s[r]);
      }
      ds[r * kLdS + jl] = v;
    }
    __syncthreads();
    for (int e = tid; e < kFT * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      float s = acc[e];
      for (int jl = 0; jl < kFT; ++jl) s = fmaf(ds[r * kLdS + jl], ks[jl * D + c], s);
      acc[e] = s;
    }
  }
  __syncthreads();
  float* dqg = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  for (int e = tid; e < kFT * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    if (q0 + r < a.sq) dqg[(q0 + r) * a.dq_ss + c] = acc[e] * a.scale;
  }
}

__global__ void __launch_bounds__(kThreads) dkv_fma_kernel(Args a) {
  const int D = a.d;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + kFT * D;
  float* qs = vs + kFT * D;
  float* dos = qs + kFT * D;
  float* dk = dos + kFT * D;
  float* dv = dk + kFT * D;
  float* ps = dv + kFT * D;
  float* ds = ps + kFT * kLdS;
  float* lse2_s = ds + kFT * kLdS;
  float* dl_s = lse2_s + kFT;
  const int j0 = blockIdx.x * kFT, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long kv0 = ((long long)b * a.hkv + hk) * a.sk * D;
  load_rows_f32(ks, static_cast<const float*>(a.k) + kv0, D, j0, a.sk, D);
  load_rows_f32(vs, static_cast<const float*>(a.v) + kv0, D, j0, a.sk, D);
  for (int e = tid; e < kFT * D; e += kThreads) dk[e] = dv[e] = 0.0f;
  const int n = (a.sq + kFT - 1) / kFT;
  const int qt_first = a.causal ? j0 / kFT : 0;
  const int qt_last = a.window > 0 ? min(n, (j0 + kFT - 1 + a.window - 1) / kFT + 1) : n;
  for (int g = 0; g < a.g; ++g) {
    const int h = hk * a.g + g;
    const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = qt_first; qt < qt_last; ++qt) {
      const int i0 = qt * kFT;
      __syncthreads();
      load_rows_f32(qs, qg, a.q_ss, i0, a.sq, D);
      load_rows_f32(dos, dog, a.do_ss, i0, a.sq, D);
      if (tid < kFT) {
        const int i = i0 + tid;
        lse2_s[tid] = i < a.sq ? a.lse[row_index(a, b, h, i)] * kLog2e : INFINITY;
        dl_s[tid] = i < a.sq ? a.delta[row_index(a, b, h, i)] : 0.0f;
      }
      __syncthreads();
      for (int e = tid; e < kFT * kFT; e += kThreads) {
        const int r = e / kFT, jl = e - r * kFT;
        float p = 0.0f, d = 0.0f;
        if (live(a, i0 + r, j0 + jl)) {
          p = exp2f(dot(qs + r * D, ks + jl * D, D) * a.scale_log2 - lse2_s[r]);
          d = p * (dot(dos + r * D, vs + jl * D, D) - dl_s[r]);
        }
        ps[r * kLdS + jl] = p;
        ds[r * kLdS + jl] = d;
      }
      __syncthreads();
      for (int e = tid; e < kFT * D; e += kThreads) {
        const int jl = e / D, c = e - jl * D;
        float sv = dv[e], sk = dk[e];
        for (int r = 0; r < kFT; ++r) {
          sv = fmaf(ps[r * kLdS + jl], dos[r * D + c], sv);
          sk = fmaf(ds[r * kLdS + jl], qs[r * D + c], sk);
        }
        dv[e] = sv;
        dk[e] = sk;
      }
    }
  }
  __syncthreads();
  float* dkg = static_cast<float*>(a.dk) + kv0;
  float* dvg = static_cast<float*>(a.dv) + kv0;
  for (int e = tid; e < kFT * D; e += kThreads) {
    const int jl = e / D, c = e - jl * D;
    if (j0 + jl < a.sk) {
      dkg[(long long)(j0 + jl) * D + c] = dk[e] * a.scale;
      dvg[(long long)(j0 + jl) * D + c] = dv[e];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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
int launch_mma(const Args& a, int passes, cudaStream_t s) {
  static uint64_t dq_done = 0, dkv_done = 0;
  using M = Mma<D>;
  int err = allow(dq_mma_kernel<D>, M::DQ_SMEM, dq_done);
  if (err == 0) err = allow(dkv_mma_kernel<D>, M::DKV_SMEM, dkv_done);
  if (err != 0) return err;
  if (passes & kPassDq) {
    dq_mma_kernel<D><<<dim3((a.sq + kBQ - 1) / kBQ, a.hq, a.b), kThreads, M::DQ_SMEM, s>>>(a);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (passes & kPassDkv)
    dkv_mma_kernel<D><<<dim3((a.sk + kBK - 1) / kBK, a.hkv, a.b), kThreads, M::DKV_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

int launch_fma(const Args& a, int passes, cudaStream_t s) {
  static uint64_t dq_done = 0, dkv_done = 0;
  const int dq_smem = (5 * kFT * a.d + kFT * kLdS + 2 * kFT) * 4;
  const int dkv_smem = (6 * kFT * a.d + 2 * kFT * kLdS + 2 * kFT) * 4;
  int err = allow(dq_fma_kernel, 6 * kFT * 256 * 4 + 2 * kFT * kLdS * 4 + 2 * kFT * 4, dq_done);
  if (err == 0)
    err = allow(dkv_fma_kernel, 6 * kFT * 256 * 4 + 2 * kFT * kLdS * 4 + 2 * kFT * 4, dkv_done);
  if (err != 0) return err;
  if (passes & kPassDq) {
    dq_fma_kernel<<<dim3((a.sq + kFT - 1) / kFT, a.hq, a.b), kThreads, dq_smem, s>>>(a);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (passes & kPassDkv)
    dkv_fma_kernel<<<dim3((a.sk + kFT - 1) / kFT, a.hkv, a.b), kThreads, dkv_smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward on `stream`, the dQ pass then the dKV pass (those of
// `passes`: 1 the dQ pass, which writes delta, 2 the dKV pass, which reads
// it); returns cudaGetLastError() (0 = launched) or -1 for arguments it does
// not take.
// q, o, dout, dq (B, Hq, Sq, D) at their element strides (the last 1); k, v,
// dk, dv (B, Hkv, Sk, D) contiguous; lse and delta (B, Hq, Sq) fp32
// contiguous, delta written here.  dtype 1: bf16, D 16 or 32 (the other
// head dims are route "wgmma"'s), pointers 16-byte aligned and strides
// multiples of 8 elements; 0: fp32, D a multiple of 8 up to 256.  Sq != Sk only with causal
// 0 and window 0.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int b, int hq, int hkv, int sq, int sk, int d,
                               long long q_sb, long long q_sh, long long q_ss, long long o_sb,
                               long long o_sh, long long o_ss, long long do_sb, long long do_sh,
                               long long do_ss, long long dq_sb, long long dq_sh,
                               long long dq_ss, int causal, int window, float scale, int dtype,
                               int passes, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || d < 8 || d > 256 || d % 8 != 0)
    return -1;
  if (sq != sk && (causal || window > 0)) return -1;
  if (b > 65535 || hq > 65535 || passes < 1 || passes > 3) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss; a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.do_sb = do_sb; a.do_sh = do_sh; a.do_ss = do_ss;
  a.dq_sb = dq_sb; a.dq_sh = dq_sh; a.dq_ss = dq_ss;
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.sk = sk; a.d = d; a.g = hq / hkv;
  a.causal = causal; a.window = window; a.scale = scale; a.scale_log2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fma(a, passes, s);
  if (dtype != 1) return -1;
  switch (d) {
    case 16: return launch_mma<16>(a, passes, s);
    case 32: return launch_mma<32>(a, passes, s);
    default: return -1;
  }
}

// The name of a CUDA error the launch function returned.
const char* flash_attention_bwd_error_name(int err) {
  return err < 0 ? "refused by the launcher" : cudaGetErrorName((cudaError_t)err);
}

}  // extern "C"
