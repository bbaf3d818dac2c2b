// Flash attention for Hopper (sm_90a): prefill and chunked-prefill attention.
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / G, j, :]  over live j)
//                     @ v[b, h / G, :, :]
//
// with key j live for query i when, by positions, k_pos <= q_pos (causal) and
// k_pos > q_pos - window (window > 0).  Positions are either contiguous
// (q_pos = arange(Sq), k_pos = arange(Sk): a prefill with Sq == Sk, or a
// bidirectional cross-attention with any Sq and Sk) or given per row on the
// device, q_pos (B, Sq) and k_pos (B, Sk) (a chunk of a prompt against the
// ring cache, k_pos = the ring's tags; the 2**30 tag of an unwritten slot masks
// itself out under causal).  A query with no live key gives zeros.  q and out
// are read and written through strides of their own (the model hands over q
// and takes out in its (B, S, Hq, D) projection layout); k and v are
// contiguous.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention).  Same function: GQA heads h / G, fp32
// scores and online softmax, l floored at 1e-30, output in q's type.  What it
// adds: per-row positions (the Pallas kernel takes arange(S) only), S not a
// multiple of the tile (rows past S are masked in the kernel, no host
// padding), an fp32 query on a bf16 cache, and zeros for a row with no live
// key (the TPU kernel's -1e30 fill gives the mean of V there).
//
// What bounds it on an H100 (datasheet: 3.35 TB/s, 989 TFLOP/s dense bf16):
// at the lock-step prefill shape (B 8, Hq 40, Hkv 8, S 512, D 128, causal)
// q, k, v and out are about 100 MB, 0.030 ms; the causal products about
// 21.5 GFLOP, 0.022 ms on the tensor cores: about balanced.  A chunk of 32
// tokens against a ring of 2048 is bound by reading the ring's live K and V
// once, 2.6 us.
//
// Design.  The TPU grid (B, Hq, S / bq, S / bk) walks the KV axis in order
// and carries (m, l, acc) in scratch across grid steps; on Hopper the KV axis
// becomes a loop inside the block.  Three routes, chosen by the wrapper:
//   * "wgmma" (bf16 query and cache, head dim 64, 128 or 256): a block owns
//     one (b, kv head) and 64 "rows", a row being a (query position t, query
//     head g of the kv head's group) pair, row = t G + g.  Each K and V tile
//     is read once for all G heads of its kv head, and a tile of rows spans
//     64 / G positions, so the causal and window bounds of its KV loop stay
//     tight.  One producer warp keeps K, V (and the tiles' tags) in flight
//     through a ring of stages: its first lane issues the TMA copies (three
//     dimensional maps over (B Hkv, Sk, D), 128-byte swizzle, zeros past Sk),
//     all its lanes copy the tags (the next tile's loaded while this one
//     waits for its stage), and full[s] completes on the bytes and the 32
//     arrivals.  One consumer warpgroup copies its Q tile into shared memory
//     (cp.async, swizzled as TMA would, issued before the block plans its
//     tiles), computes S = Q K^T by wgmma m64n64k16 from shared memory (K the
//     K-major B operand), masks (only tiles with some key not live for some
//     row: the plan flags them) and runs the online softmax in registers,
//     rounds P to bf16 (as the model's attention rounds P to V's type) and
//     accumulates O += P V by wgmma m64nDk16 with P as the A operand in
//     registers and V the MN-major B operand, then releases the stage on
//     empty[s].  No block barrier inside the loop.
//   * when the blocks of a launch do not fill the card (a chunk at B 1: 8 kv
//     heads x 1-3 row tiles), the live tiles of the KV loop are divided among
//     `splits` blocks of one thread-block cluster.  Each block keeps its
//     (m, l, acc) in its own shared memory; after a cluster barrier each block
//     combines its share of the 64 rows over distributed shared memory, in
//     rank order, floors l and stores (the split-K technique of
//     hopper_gemm.cuh: one launch, no partials in device memory, no atomics,
//     the same bits every run).  The wrapper picks `splits` from the shapes
//     and the card alone.
//   * "mma_sync" (bf16, the other head dims: 16, 32, 72, 80, 96, 112): a
//     block owns (b, q head, 64 query rows); K and V tiles through two
//     cp.async stages, both products on mma.sync m16n8k16 (at D 72 the last
//     k16 step of S = Q K^T takes zeros for the 8 columns past D).
//   * "fma" (fp32 query, fp32 or bf16 cache): a block owns (b, q head, 16
//     query rows); scores, softmax and P.V are FMA loops over tiles in shared
//     memory, since TF32 would miss the fp32 tolerance.
//   * an int8 KV ring (the reference's quantized serving cache, one bf16
//     scale a key and kv head: k_scale / v_scale (B, Hkv, Sk)) is read as it
//     is stored, half the bytes of bf16, on every route: the tiles arrive in
//     int8 ("wgmma": TMA with boxes of 128 one-byte elements; "mma_sync" and
//     "fma": cp.async of 8-byte pieces), the tiles' scales beside them, and
//     before the products the block dequantizes them into the bf16 tiles the
//     route reads (the wgmma descriptors and the fragment loads unchanged),
//     each element (q * scale) rounded to bf16 as the reference's
//     _dequantize_kv.  Nothing widens the ring in device memory.
//   * the KV loop is bounded on every route: contiguous positions give the
//     causal and window range of tiles; with per-row positions every block
//     scans the row's tags (sixteen loads in flight a thread) and lists the
//     tiles that hold a key live for some query of the block, and reads only
//     those.
// Training asks every route for each row's log-sum-exp (Args::lse), which
// the backward (flash_attention_bwd.cu) recomputes P from; without the
// buffer nothing else changes.
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; PERF.md):
// a block's time goes to its prologue, the softmax between the two products
// and, split, the cluster merge, not to the tensor cores; the lock-step
// prefill runs at about half the speed of scaled_dot_product_attention, the
// chunks against the ring ahead of it.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hg::dequant8;
using hg::smem_u32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxListed = 1024;  // rows of up to this many tiles are read live tiles only
constexpr int kPartTile = 1 << 30;  // flag of a listed tile: some key is masked for some row

// route "wgmma": kernels/flash_attention/kernel.py repeats these four
// (tests/test_torch_flash_attention.py reads them from here)
constexpr int kWgRows = 64;       // rows of a block: (query position, head of the group) pairs
constexpr int kWgBK = 64;         // keys of a K or V tile
constexpr int kWgThreads = 160;   // one consumer warpgroup and one producer warp
constexpr int kMaxSplits = 8;     // blocks of a cluster (chip/h100.py MAX_SPLITS)
// route "mma_sync"
constexpr int kMmaThreads = 128;  // four warps of 16 query rows
constexpr int kMmaBQ = 64;
// route "fma"
constexpr int kFmaThreads = 128;
constexpr int kFmaBQ = 16;
constexpr int kFmaBK = 32;

enum : int { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Args {
  const void* q;        // (B, Hq, Sq, D) at strides q_sb, q_sh, q_ss (elements)
  const void* k;        // (B, Hkv, Sk, D), contiguous
  const void* v;
  const bf16* k_scale;  // an int8 cache: (B, Hkv, Sk) scales; else null
  const bf16* v_scale;
  const int* q_pos;     // (B, Sq) or null: contiguous positions
  const int* k_pos;     // (B, Sk), with q_pos
  void* out;            // (B, Hq, Sq, D) in q's type at strides o_sb, o_sh, o_ss
  float* lse;           // (B, Hq, Sq) fp32 or null: each row's log-sum-exp (training)
  long long q_sb, q_sh, q_ss, o_sb, o_sh, o_ss;
  int b, hq, hkv, sq, sk, d, g;
  int qp_stride, kp_stride;  // batch strides of q_pos / k_pos (0: one row for all)
  int causal, window;
  float scale_log2;     // scale * log2(e)
};

// Row (b, h, i)'s natural log-sum-exp of the scaled scores, from its base-2
// running max m and sum l: +inf for a row with no live key, so that the
// backward's exp(s - lse) is 0 there (flash_attention_bwd.cu).  Only where
// the caller asked for it (a.lse not null).
__device__ __forceinline__ void store_lse(const Args& a, int b, int h, int i, float m, float l) {
  if (a.lse == nullptr) return;
  a.lse[((long long)b * a.hq + h) * a.sq + i] =
      m == -INFINITY ? INFINITY : (m + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
}

__device__ __forceinline__ bool live(const Args& a, int kp, int qp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
}

// The KV tiles a block of query positions [q0, q0 + rows) reads, into list_s
// (when `listed`) or as the range [t_lo, t_lo + count).  Contiguous positions:
// the causal and window range.  Per-row positions: the tiles that hold at
// least one key live for some query of the block (qmin / qmax of the block's
// positions), listed in order by one warp, each flagged kPartTile unless
// every key of it is live for every query of the block.  Every thread must
// call this; blockDim.x is a multiple of 32 and bk of 32.
struct TileSet {
  int count, t_lo;
  int q_lo, q_hi;  // the block's least and greatest position
  bool listed;
};

__device__ TileSet plan_tiles(const Args& a, int b, int q0, int rows, int bk, int* list_s,
                              int* scratch_s) {
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int tiles_total = (a.sk + bk - 1) / bk;
  TileSet ts;
  ts.listed = false;
  ts.t_lo = 0;
  ts.count = tiles_total;
  if (a.q_pos == nullptr) {
    const int q_last = min(q0 + rows, a.sq) - 1;
    int hi = tiles_total;
    if (a.causal) hi = min(hi, q_last / bk + 1);
    int lo = 0;
    if (a.window > 0) lo = max(0, q0 - a.window + 1) / bk;
    ts.t_lo = lo;
    ts.count = max(0, hi - lo);
    ts.q_lo = q0;
    ts.q_hi = q_last;
    return ts;
  }
  // the first tags are loaded before anything waits; warp 0 takes qmin /
  // qmax of the block's positions (at most 64 of them); the list's flags
  // are cleared
  const int* qp = a.q_pos + (size_t)b * a.qp_stride;
  const int* kp = a.k_pos + (size_t)b * a.kp_stride;
  const bool listed = tiles_total <= kMaxListed;
  constexpr int kLoads = 16;  // tags in flight a thread
  const int first = tid - lane;  // the warp's first key: a warp's 32 keys lie in one tile
  int p[kLoads];
  if (listed) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = first + u * nthreads + lane;
      p[u] = j < a.sk ? __ldg(kp + j) : INT_MAX;
    }
    for (int i = tid; i < tiles_total; i += nthreads) list_s[i] = (i + 1) * bk > a.sk ? 2 : 0;
  }
  if (tid < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < rows && q0 + r < a.sq; r += 32) {
      const int v = __ldg(qp + q0 + r);
      lo = min(lo, v);
      hi = max(hi, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      scratch_s[0] = lo;
      scratch_s[1] = hi;
    }
  }
  __syncthreads();
  const int qmin = scratch_s[0], qmax = scratch_s[1];
  ts.q_lo = qmin;
  ts.q_hi = qmax;
  if (!listed) return ts;  // a longer ring: every tile, every one masked
  ts.listed = true;
  // per tile: bit 0 some key live for some query, bit 1 some key not live
  // for every query
  for (int j0 = first; j0 < a.sk; j0 += kLoads * nthreads) {
    if (j0 != first) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = j0 + u * nthreads + lane;
        p[u] = j < a.sk ? __ldg(kp + j) : INT_MAX;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int jw = j0 + u * nthreads;  // the warp's first key
      const bool inside = jw + lane < a.sk;
      const bool any =
          inside && (!a.causal || p[u] <= qmax) && (a.window <= 0 || p[u] > qmin - a.window);
      const bool all =
          (!a.causal || p[u] <= qmin) && (a.window <= 0 || p[u] > qmax - a.window);
      const unsigned some = __ballot_sync(0xffffffffu, any);
      const unsigned part = __ballot_sync(0xffffffffu, inside && !all);
      if (lane == 0 && jw < a.sk) {
        if (some) atomicOr(&list_s[jw / bk], 1);
        if (part) atomicOr(&list_s[jw / bk], 2);
      }
    }
  }
  __syncthreads();
  if (tid < 32) {  // compact in place: entry n <= i is written after i is read
    int n = 0;
    for (int base = 0; base < tiles_total; base += 32) {
      const int i = base + lane;
      const int f = i < tiles_total ? list_s[i] : 0;
      const bool lv = (f & 1) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, lv);
      __syncwarp();
      if (lv) list_s[n + __popc(m & ((1u << lane) - 1))] = i | ((f & 2) ? kPartTile : 0);
      n += __popc(m);
    }
    if (lane == 0) scratch_s[2] = n;
  }
  __syncthreads();
  ts.count = scratch_s[2];
  return ts;
}

__device__ __forceinline__ int tile_index(const TileSet& ts, const int* list_s, int k) {
  return ts.listed ? list_s[k] & (kPartTile - 1) : ts.t_lo + k;
}

// Whether every key of the k-th tile is live for every query of the block,
// so that the tile needs no mask.
__device__ __forceinline__ bool tile_full(const Args& a, const TileSet& ts, const int* list_s,
                                          int k, int bk) {
  if (ts.listed) return (list_s[k] & kPartTile) == 0;
  if (a.q_pos != nullptr) return false;
  const int j0 = (ts.t_lo + k) * bk;
  return j0 + bk <= a.sk && (!a.causal || j0 + bk - 1 <= ts.q_lo) &&
         (a.window <= 0 || j0 > ts.q_hi - a.window);
}

// Starts the copy of rows [r0, r0 + rows) of an (n, D) matrix of T with a row
// stride of src_ld elements into shared memory rows of ld elements; rows past
// n are zero-filled without a read.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, long long src_ld, int r0,
                                          int rows, int n, int d) {
  const int cpr = d * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, ch = e % cpr;
    const bool inside = r0 + r < n;
    const T* s = inside ? src + (long long)(r0 + r) * src_ld + ch * (16 / sizeof(T)) : src;
    __pipeline_memcpy_async(dst + (size_t)r * ld + ch * (16 / sizeof(T)), s, 16, inside ? 0 : 16);
  }
}

// Starts the copy of rows [r0, r0 + rows) of an (n, D) int8 matrix into
// shared memory rows of D bytes, 8 bytes at a time (D % 8 == 0); rows past n
// are zero-filled without a read.
__device__ __forceinline__ void copy_rows8(int8_t* dst, const int8_t* src, int r0, int rows,
                                           int n, int d) {
  const int cpr = d / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, ch = e % cpr;
    const bool inside = r0 + r < n;
    const int8_t* s = inside ? src + (long long)(r0 + r) * d + ch * 8 : src;
    __pipeline_memcpy_async(dst + (size_t)r * d + ch * 8, s, 8, inside ? 0 : 8);
  }
}

// Loads the scales of keys [j0, j0 + n) of K and V into ks_dst and vs_dst
// (fp32), zeros past Sk.
__device__ __forceinline__ void load_scales(float* ks_dst, float* vs_dst, const bf16* ks,
                                            const bf16* vs, int j0, int n, int sk) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const bool inside = j0 + e < sk;
    ks_dst[e] = inside ? __bfloat162float(ks[j0 + e]) : 0.0f;
    vs_dst[e] = inside ? __bfloat162float(vs[j0 + e]) : 0.0f;
  }
}

// Dequantizes int8 K and V tiles of `rows` rows of D bytes (src, K then V,
// each rows x D) with their scales (scales, K's then V's) into bf16 tiles of
// rows of ld elements (dst_k, dst_v), eight elements a thread at a time.
__device__ __forceinline__ void dequant_rows(bf16* dst_k, bf16* dst_v, int ld, const int8_t* src,
                                             const float* scales, int rows, int d) {
  const int per_row = d / 8;
  for (int e = threadIdx.x; e < 2 * rows * per_row; e += blockDim.x) {
    const int which = e / (rows * per_row), r = (e / per_row) % rows, h = e % per_row;
    const uint2 raw =
        *reinterpret_cast<const uint2*>(src + ((size_t)which * rows + r) * d + 8 * h);
    *reinterpret_cast<uint4*>((which ? dst_v : dst_k) + (size_t)r * ld + 8 * h) =
        dequant8(raw.x, raw.y, scales[which * rows + r]);
  }
}

// Starts the copy of the tags of keys [j0, j0 + n) (past Sk: anything, those
// keys are masked by index).
__device__ __forceinline__ void copy_tags(int* dst, const int* kp, int j0, int n, int sk) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const bool inside = j0 + e < sk;
    __pipeline_memcpy_async(dst + e, kp + (inside ? j0 + e : 0), 4, inside ? 0 : 4);
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// The online-softmax step of one tile for the two rows a thread holds, over
// scores in the accumulator layout of an m16n8 / m64nN product: s[4 n + e]
// is row gid + 8 (e >> 1) of the warp's 16, key 8 n + 2 tig + (e & 1) of the
// tile.  A tile that is not `full` is masked first (keys not live for a row,
// by index j0 + ... and by position from tags or the index).  Scales to base
// 2, turns s into probabilities, updates m_run / l_run (l_run: this thread's
// share of the row sum) and returns the factor alpha by which the output
// rows are rescaled.
template <int BK>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[BK / 2], int j0,
                                             bool full, const int* tags, const int (&qpos)[2],
                                             int tig, float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (full) {  // every key live for every row: no mask
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] *= a.scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * tig + (e & 1);
        const int j = j0 + jl;
        const int hh = e >> 1;
        const int kpos = tags == nullptr ? j : tags[jl];
        const bool ok = j < a.sk && live(a, kpos, qpos[hh]);
        s[4 * n + e] = ok ? s[4 * n + e] * a.scale_log2 : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[4 * n + e]);
      }
    }
  }
  float m_use[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_run[hh], mx[hh]);
    // nothing live yet: exp2(-inf - 0) = 0 keeps p, l and o at zero
    m_use[hh] = m_new == -INFINITY ? 0.0f : m_new;
    alpha[hh] = exp2f(m_run[hh] - m_use[hh]);
    m_run[hh] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * n + e] - m_use[e >> 1]);
      s[4 * n + e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
}

// ---------------------------------------------------------------------------
// route "wgmma": bf16, GQA rows packed, TMA ring, wgmma, split over a cluster
// ---------------------------------------------------------------------------

// d (64 x N, fp32, the accumulator layout of wgmma) += A (64 x 16 bf16, four
// registers a thread in the A layout of mma.m16n8k16, each warp its 16 rows)
// B (16 x N bf16 in shared memory by descriptor, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_m64n64(d, a, desc_b);
  else if constexpr (D == 128) wgmma_rs_m64n128(d, a, desc_b);
  else wgmma_rs_m64n256(d, a, desc_b);
}

// Shared memory of a block: the ring (STAGES x (K tile, V tile), each tile
// D / 64 column blocks of kWgBK rows x 128 bytes, swizzled), the Q tile (the
// same layout, kWgRows rows), the tiles' tags, the tile list, the combine's
// coefficients, scratch, the mbarriers.  After the loop the ring holds a
// split's (acc, m, l) for the combine.
// An int8 ring (Q8): the stages hold the tiles as they arrive, in boxes of 128
// one-byte elements (a row of 64 padded to 128), then come the bf16 K and V
// tiles the products read, dequantized from the stage in hand; the scales sit
// beside the tags.
template <int D, bool Q8 = false> struct WgTile {
  static constexpr int BLOCKS = D / 64;             // 128-byte column blocks of a bf16 row
  static constexpr int KV_BYTES = kWgBK * D * 2;    // one bf16 K or V tile
  static constexpr int BLOCKS8 = D > 128 ? D / 128 : 1;  // of an int8 row
  static constexpr int IN_BYTES = Q8 ? kWgBK * 128 * BLOCKS8 : KV_BYTES;  // a tile as it arrives
  static constexpr int STAGE_BYTES = 2 * IN_BYTES;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = D == 256 ? 1 : 2;  // blocks an SM holds
  static constexpr int RING = STAGES * STAGE_BYTES + (Q8 ? 2 * KV_BYTES : 0);
  static constexpr int Q_BYTES = kWgRows * D * 2;
  static constexpr int SMEM = 1024 + RING + Q_BYTES + STAGES * kWgBK * 4 * (Q8 ? 3 : 1) +
                              kMaxListed * 4 + kWgRows * (kMaxSplits + 1) * 4 + 16 +
                              2 * STAGES * 8;
  static_assert(D == 64 || D == 128 || D == 256, "head dims of the wgmma route");
  static_assert(kWgRows * D * 4 + kWgRows * 8 <= RING, "a split's (acc, m, l) fit the ring");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM holds");
};

struct WgParams {
  CUtensorMap k_map, v_map;  // (B Hkv, Sk, D), boxes of 128 bytes x kWgBK x 1
  Args a;
  int splits;                // blocks of a cluster, each a share of the live tiles
};

template <int D, bool Q8 = false>
__global__ void __launch_bounds__(kWgThreads, WgTile<D>::MIN_BLOCKS)
    flash_attention_wgmma_kernel(const __grid_constant__ WgParams p) {
  using W = WgTile<D, Q8>;
  const Args& a = p.a;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must start on 1024 bytes
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dq_tiles = ring + W::STAGES * W::STAGE_BYTES;  // Q8: the bf16 K, V tiles
  unsigned char* q_s = ring + W::RING;
  int* tags_s = reinterpret_cast<int*>(q_s + W::Q_BYTES);
  // Q8: stage s's K scales at 2 s kWgBK, its V scales after them
  float* sc_s = reinterpret_cast<float*>(tags_s + W::STAGES * kWgBK);
  int* list_s = reinterpret_cast<int*>(sc_s + (Q8 ? 2 * W::STAGES * kWgBK : 0));
  float* coef_s = reinterpret_cast<float*>(list_s + kMaxListed);
  int* scratch_s = reinterpret_cast<int*>(coef_s + kWgRows * (kMaxSplits + 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch_s + 4);
  uint64_t* empty = full + W::STAGES;

  const int split = blockIdx.x;  // rank in the cluster
  const int bh = blockIdx.z;
  const int b = bh / a.hkv, hk = bh % a.hkv, G = a.g;
  const int r0 = blockIdx.y * kWgRows;
  const int rows_total = a.sq * G;
  const int t_first = r0 / G;
  const int t_last = min((r0 + kWgRows - 1) / G, a.sq - 1);
  const int* kp = a.k_pos != nullptr ? a.k_pos + (size_t)b * a.kp_stride : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < W::STAGES; ++s) {
      hg::mbar_init(&full[s], 33);  // the producer's expect_tx and its 32 lanes' tags
      hg::mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < 4) {
    // the consumers start copying the Q tile into shared memory, swizzled as
    // TMA would (16-byte piece c of row r at c ^ (r % 8)); rows past the end
    // are zeros
    constexpr int CPR = D / 8;  // 16-byte pieces of a row
    for (int e = tid; e < kWgRows * CPR; e += 128) {
      const int r = e / CPR, ch = e % CPR;
      const int row = r0 + r;
      const bool inside = row < rows_total;
      const int tq = row / G, g = row - tq * G;
      const bf16* src = reinterpret_cast<const bf16*>(a.q);
      if (inside)
        src += b * a.q_sb + (long long)(hk * G + g) * a.q_sh + (long long)tq * a.q_ss + ch * 8;
      __pipeline_memcpy_async(
          q_s + (ch >> 3) * (kWgRows * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4), src, 16,
          inside ? 0 : 16);
    }
    __pipeline_commit();
  }
  const TileSet ts = plan_tiles(a, b, t_first, t_last - t_first + 1, kWgBK, list_s, scratch_s);
  __syncthreads();
  // this split's share of the live tiles (none at all for some splits)
  const int per = (ts.count + p.splits - 1) / p.splits;
  const int k_begin = min(split * per, ts.count);
  const int nk = min(k_begin + per, ts.count) - k_begin;

  if (warp == 4) {
    // producer: lane 0 issues the copies of K and V, every lane copies tags
    // (and an int8 ring's scales), those of the next tile loaded while this
    // one waits for its stage
    int nxt[2] = {0, 0};
    float nsc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // Q8: the next tile's K, V scales
    const bool side = kp != nullptr || Q8;  // something besides the tiles to copy
    auto load_tags = [&](int i) {
      const int j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + lane + 32 * u;
        if (kp != nullptr) nxt[u] = j < a.sk ? __ldg(kp + j) : 0;
        if constexpr (Q8) {
          const size_t si = (size_t)bh * a.sk + j;
          nsc[0][u] = j < a.sk ? __bfloat162float(a.k_scale[si]) : 0.0f;
          nsc[1][u] = j < a.sk ? __bfloat162float(a.v_scale[si]) : 0.0f;
        }
      }
    };
    if (side && nk > 0) load_tags(0);
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % W::STAGES;
      const int cur[2] = {nxt[0], nxt[1]};
      const float csc[2][2] = {{nsc[0][0], nsc[0][1]}, {nsc[1][0], nsc[1][1]}};
      if (side && i + 1 < nk) load_tags(i + 1);
      hg::mbar_wait(&empty[s], ((i / W::STAGES) & 1) ^ 1);
      const int j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
      if (lane == 0) {
        unsigned char* st = ring + s * W::STAGE_BYTES;
        hg::mbar_expect_tx(&full[s], W::STAGE_BYTES);
        if constexpr (Q8) {
#pragma unroll
          for (int c = 0; c < W::BLOCKS8; ++c) {
            hg::tma_load_3d(st + c * kWgBK * 128, &p.k_map, &full[s], c * 128, j0, bh);
            hg::tma_load_3d(st + W::IN_BYTES + c * kWgBK * 128, &p.v_map, &full[s], c * 128, j0,
                            bh);
          }
        } else {
#pragma unroll
          for (int c = 0; c < W::BLOCKS; ++c) {
            hg::tma_load_3d(st + c * kWgBK * 128, &p.k_map, &full[s], c * 64, j0, bh);
            hg::tma_load_3d(st + W::KV_BYTES + c * kWgBK * 128, &p.v_map, &full[s], c * 64, j0,
                            bh);
          }
        }
      }
      if (kp != nullptr) {
        tags_s[s * kWgBK + lane] = cur[0];
        tags_s[s * kWgBK + lane + 32] = cur[1];
      }
      if constexpr (Q8) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          sc_s[2 * s * kWgBK + lane + 32 * u] = csc[0][u];
          sc_s[(2 * s + 1) * kWgBK + lane + 32 * u] = csc[1][u];
        }
      }
      hg::mbar_arrive(&full[s]);
    }
  } else {
    // consumers: the Q tile is on its way since the start
    __pipeline_wait_prior(0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    // this thread's two rows: 16 warp + gid and + 8 of the block's 64
    const int gid = lane >> 2, tig = lane & 3;
    int qpos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + warp * 16 + gid + 8 * hh;
      const int tq = row / G;
      qpos[hh] = row >= rows_total ? INT_MIN / 2
                 : a.q_pos == nullptr ? tq
                                      : a.q_pos[(size_t)b * a.qp_stride + tq];
    }
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};
    const uint32_t q_base = smem_u32(q_s);

#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % W::STAGES;
      hg::mbar_wait(&full[s], (i / W::STAGES) & 1);
      uint32_t k_base = smem_u32(ring + s * W::STAGE_BYTES);
      uint32_t v_base = k_base + W::KV_BYTES;
      if constexpr (Q8) {
        // the stage's int8 K and V into the bf16 tiles the products read,
        // swizzled as TMA writes a bf16 tile, once every warp's products of
        // the last tile are done with them
        if (i > 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
        const unsigned char* in = ring + s * W::STAGE_BYTES;
        const float* scl = sc_s + 2 * s * kWgBK;  // K's, then V's
        constexpr int P8 = D / 16;                // 16-byte pieces of an int8 row
#pragma unroll 2
        for (int u = tid; u < 2 * kWgBK * P8; u += 128) {
          const int which = u / (kWgBK * P8), r = (u / P8) % kWgBK, c = u % P8;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              in + which * W::IN_BYTES + (c >> 3) * (kWgBK * 128) + r * 128 +
              (((c & 7) ^ (r & 7)) << 4));
          const float sc = scl[which * kWgBK + r];
          unsigned char* out = dq_tiles + which * W::KV_BYTES + r * 128;
          const int c0 = 2 * c, c1 = 2 * c + 1;  // its two bf16 pieces
          *reinterpret_cast<uint4*>(out + (c0 >> 3) * (kWgBK * 128) + (((c0 & 7) ^ (r & 7)) << 4)) =
              dequant8(raw.x, raw.y, sc);
          *reinterpret_cast<uint4*>(out + (c1 >> 3) * (kWgBK * 128) + (((c1 & 7) ^ (r & 7)) << 4)) =
              dequant8(raw.z, raw.w, sc);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        k_base = smem_u32(dq_tiles);
        v_base = k_base + W::KV_BYTES;
      }

      // S = Q K^T: 64 rows x kWgBK keys
      float sc[kWgBK / 2];
#pragma unroll
      for (int e = 0; e < kWgBK / 2; ++e) sc[e] = 0.0f;
      hg::fence_acc(sc);
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq =
            hg::desc_sw128(q_base + (kk >> 2) * (kWgRows * 128) + (kk & 3) * 32, 16, 1024);
        const uint64_t dk =
            hg::desc_sw128(k_base + (kk >> 2) * (kWgBK * 128) + (kk & 3) * 32, 16, 1024);
        hg::wgmma_m64n64<0>(sc, dq, dk);
      }
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_acc(sc);

      const int j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
      const bool full = tile_full(a, ts, list_s, k_begin + i, kWgBK);
      float alpha[2];
      softmax_tile<kWgBK>(a, sc, j0, full, kp != nullptr ? tags_s + s * kWgBK : nullptr, qpos,
                          tig, m_run, l_run, alpha);
      if (alpha[0] != 1.0f || alpha[1] != 1.0f) {  // a row's max moved
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
      }
      // P in bf16 as the A operand: keys 16 j .. 16 j + 15 are score blocks 2 j, 2 j + 1
      uint32_t pf[kWgBK / 16][4];
#pragma unroll
      for (int j = 0; j < kWgBK / 16; ++j) {
        pf[j][0] = pack2f(sc[8 * j], sc[8 * j + 1]);
        pf[j][1] = pack2f(sc[8 * j + 2], sc[8 * j + 3]);
        pf[j][2] = pack2f(sc[8 * j + 4], sc[8 * j + 5]);
        pf[j][3] = pack2f(sc[8 * j + 6], sc[8 * j + 7]);
      }
      // O += P V: V's 16 keys of step j start 16 rows (2048 bytes) on, its
      // 64-column blocks kWgBK rows apart
      hg::fence_acc(o);
      hg::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kWgBK / 16; ++j)
        wgmma_rs<D>(o, pf[j], hg::desc_sw128(v_base + j * 16 * 128, kWgBK * 128, 1024));
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_acc(o);
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    float l_row[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[hh] = l;
    }
    if (p.splits == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + warp * 16 + gid + 8 * hh;
        if (row < rows_total) {
          const int tq = row / G, g = row - tq * G;
          if (tig == 0) store_lse(a, b, hk * G + g, tq, m_run[hh], l_row[hh]);
          const float inv = 1.0f / fmaxf(l_row[hh], 1e-30f);
          bf16* dst = reinterpret_cast<bf16*>(a.out) + b * a.o_sb +
                      (long long)(hk * G + g) * a.o_sh + (long long)tq * a.o_ss + 2 * tig;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
                __floats2bfloat162_rn(o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
        }
      }
    } else {
      // a split: (acc, m, l) of the 64 rows into this block's ring, which
      // every consumer warp has finished reading
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      float* red = reinterpret_cast<float*>(ring);
      float* ml = red + kWgRows * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + gid + 8 * hh;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<float2*>(red + r * D + 8 * c + 2 * tig) =
              make_float2(o[4 * c + 2 * hh], o[4 * c + 2 * hh + 1]);
        if (tig == 0) {
          ml[2 * r] = m_run[hh];
          ml[2 * r + 1] = l_row[hh];
        }
      }
    }
  }

  if (p.splits > 1) {
    hg::cluster_sync();  // every split's (acc, m, l) is in its block's shared memory
    const float* red = reinterpret_cast<const float*>(ring);
    const float* ml = red + kWgRows * D;
    const int splits = p.splits;
    const int rpb = (kWgRows + splits - 1) / splits;
    const int rb = min(split * rpb, kWgRows), nr = min(kWgRows, rb + rpb) - rb;
    // this block's rows: the weight of each split and 1 / l, the (m, l) of
    // every split loaded at once
    float* wq = coef_s;                   // [nr][splits]
    float* inv = coef_s + kWgRows * kMaxSplits / 2 + kMaxSplits;  // [nr]
    if (tid < nr) {
      const int r = rb + tid;
      float2 v[kMaxSplits];
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        if (q < splits) v[q] = *reinterpret_cast<const float2*>(hg::cluster_ptr(ml + 2 * r, q, true));
      float mmax = -INFINITY;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        if (q < splits) mmax = fmaxf(mmax, v[q].x);
      float l = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q) {
        if (q < splits) {
          const float w = v[q].x == -INFINITY ? 0.0f : exp2f(v[q].x - mmax);
          wq[tid * splits + q] = w;
          l += w * v[q].y;
        }
      }
      inv[tid] = 1.0f / fmaxf(l, 1e-30f);
      if (r0 + r < rows_total) {
        const int tq = (r0 + r) / G;
        store_lse(a, b, hk * G + (r0 + r - tq * G), tq, mmax, l);
      }
    }
    __syncthreads();
    // four columns a thread: the splits' sums in rank order
    for (int e = tid; e < nr * (D / 4); e += kWgThreads) {
      const int rl = e / (D / 4), col = 4 * (e % (D / 4));
      const int r = rb + rl, row = r0 + r;
      if (row >= rows_total) continue;
      float4 part[kMaxSplits];
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q)
        if (q < splits)
          part[q] = *reinterpret_cast<const float4*>(hg::cluster_ptr(red + r * D + col, q, true));
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q) {
        if (q < splits) {
          const float w = wq[rl * splits + q];
          acc.x += w * part[q].x;
          acc.y += w * part[q].y;
          acc.z += w * part[q].z;
          acc.w += w * part[q].w;
        }
      }
      const float iv = inv[rl];
      const int tq = row / G, g = row - tq * G;
      bf16* dst = reinterpret_cast<bf16*>(a.out) + b * a.o_sb + (long long)(hk * G + g) * a.o_sh +
                  (long long)tq * a.o_ss + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x * iv, acc.y * iv);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc.z * iv, acc.w * iv);
    }
    hg::cluster_sync();  // no block leaves while another reads its shared memory
  }
}

// ---------------------------------------------------------------------------
// route "mma_sync": bf16, one query head a block, mma.sync m16n8k16
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

template <int D, bool Q8 = false> struct MmaTile {
  static_assert(D % 8 == 0, "head dims of route mma_sync are multiples of 8");
  static constexpr int BK = D > 128 ? 32 : 64;
  // a row of an odd number of 16-byte pieces, so that the 32-bit fragment
  // loads of eight rows fall on distinct banks: D + 8 elements, or D itself
  // when D / 8 is odd (72)
  static constexpr int LD = (D / 8) % 2 ? D : D + 8;
  static constexpr size_t kTileBytes = (size_t)BK * LD * sizeof(bf16);
  // q tile, two stages of K and V, two stages of tags, the tile list, scratch;
  // an int8 ring (Q8): two stages of its K and V tiles as they arrive (BK x D
  // bytes each) and of their scales, dequantized into the bf16 stage
  static constexpr size_t kSmem = (size_t)kMmaBQ * LD * sizeof(bf16) + 4 * kTileBytes +
                                  2 * BK * sizeof(int) + kMaxListed * sizeof(int) + 16 +
                                  (Q8 ? 4 * (size_t)BK * D + 4 * BK * sizeof(float) : 0);
};

template <int D, bool Q8 = false>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(Args a) {
  using Tile = MmaTile<D, Q8>;
  constexpr int BK = Tile::BK, LD = Tile::LD;
  constexpr int NT = BK / 8;   // score fragments (n8) a tile
  constexpr int ND = D / 8;          // output fragments (n8)
  constexpr int KD = (D + 15) / 16;  // k16 steps of the score product
  // at D 72 the last step's upper 8 columns lie past D: zeros, not loads
  constexpr bool kHalfStep = D % 16 != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kMmaBQ * LD;  // stage s: K at 2 s, V at 2 s + 1
  int* tags_s = reinterpret_cast<int*>(kv_s + 4 * BK * LD);
  int* list_s = tags_s + 2 * BK;
  int* scratch_s = list_s + kMaxListed;
  // Q8: stage st's int8 K and V at 2 st and 2 st + 1 (BK x D bytes each), and
  // their scales at 2 st BK and (2 st + 1) BK
  int8_t* kv8_s = reinterpret_cast<int8_t*>(scratch_s + 4);
  float* sc_s = reinterpret_cast<float*>(kv8_s + (Q8 ? 4 * BK * D : 0));

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kMmaBQ;
  const int hk = h / a.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // row group, thread in group

  const bf16* qg = reinterpret_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const size_t kv_off = (((size_t)b * a.hkv + hk) * a.sk) * D;
  const bf16* kg = reinterpret_cast<const bf16*>(a.k) + kv_off;
  const bf16* vg = reinterpret_cast<const bf16*>(a.v) + kv_off;
  const int* kp = a.k_pos != nullptr ? a.k_pos + (size_t)b * a.kp_stride : nullptr;
  const size_t sc_off = ((size_t)b * a.hkv + hk) * a.sk;  // Q8: the row's scales

  const TileSet ts = plan_tiles(a, b, q0, kMmaBQ, BK, list_s, scratch_s);

  copy_rows(q_s, LD, qg, a.q_ss, q0, kMmaBQ, a.sq, D);
  __pipeline_commit();
  auto load_tile = [&](int k, int st) {
    if (k < ts.count) {
      const int j0 = tile_index(ts, list_s, k) * BK;
      if constexpr (Q8) {
        copy_rows8(kv8_s + (2 * st) * BK * D, reinterpret_cast<const int8_t*>(a.k) + kv_off, j0,
                   BK, a.sk, D);
        copy_rows8(kv8_s + (2 * st + 1) * BK * D, reinterpret_cast<const int8_t*>(a.v) + kv_off,
                   j0, BK, a.sk, D);
        load_scales(sc_s + 2 * st * BK, sc_s + (2 * st + 1) * BK, a.k_scale + sc_off,
                    a.v_scale + sc_off, j0, BK, a.sk);
      } else {
        copy_rows(kv_s + (2 * st) * BK * LD, LD, kg, D, j0, BK, a.sk, D);
        copy_rows(kv_s + (2 * st + 1) * BK * LD, LD, vg, D, j0, BK, a.sk, D);
      }
      if (kp != nullptr) copy_tags(tags_s + st * BK, kp, j0, BK, a.sk);
    }
    __pipeline_commit();
  };
  load_tile(0, 0);

  // this thread's two query rows: r = 16 warp + gid and r + 8
  const int r_lo = warp * 16 + gid;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + r_lo + 8 * hh;
    qpos[hh] = a.q_pos == nullptr ? i
                                  : (i < a.sq ? a.q_pos[(size_t)b * a.qp_stride + i] : INT_MIN / 2);
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  for (int k = 0; k < ts.count; ++k) {
    const int st = k & 1;
    load_tile(k + 1, st ^ 1);  // that stage was last read in tile k - 1
    __pipeline_wait_prior(1);
    __syncthreads();
    if constexpr (Q8) {  // the stage's int8 tiles into its bf16 ones
      dequant_rows(kv_s + (2 * st) * BK * LD, kv_s + (2 * st + 1) * BK * LD, LD,
                   kv8_s + (2 * st) * BK * D, sc_s + 2 * st * BK, BK, D);
      __syncthreads();
    }
    const bf16* ks = kv_s + (2 * st) * BK * LD;
    const bf16* vs = kv_s + (2 * st + 1) * BK * LD;
    const int j0 = tile_index(ts, list_s, k) * BK;

    // scores S = Q K^T for the warp's 16 rows
    float s[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) s[e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const bool half = kHalfStep && kk == KD - 1;
      uint32_t af[4];
      const bf16* qr = q_s + (warp * 16 + gid) * LD + kk * 16 + 2 * tig;
      af[0] = ld32(qr);
      af[1] = ld32(qr + 8 * LD);
      af[2] = half ? 0u : ld32(qr + 8);
      af[3] = half ? 0u : ld32(qr + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = ks + (n * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma16816(s + 4 * n, af, ld32(kr), half ? 0u : ld32(kr + 8));
      }
    }

    float alpha[2];
    softmax_tile<BK>(a, s, j0, tile_full(a, ts, list_s, k, BK),
                     kp != nullptr ? tags_s + st * BK : nullptr, qpos, tig, m_run, l_run, alpha);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V: the score fragments of keys 16 j .. 16 j + 15 are the A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pf[4];
      pf[0] = pack2f(s[8 * j], s[8 * j + 1]);
      pf[1] = pack2f(s[8 * j + 2], s[8 * j + 3]);
      pf[2] = pack2f(s[8 * j + 4], s[8 * j + 5]);
      pf[3] = pack2f(s[8 * j + 6], s[8 * j + 7]);
      const bf16* v0 = vs + (j * 16 + 2 * tig) * LD + gid;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vp = v0 + n * 8;
        mma16816(o[n], pf, pack2(vp[0], vp[LD]), pack2(vp[8 * LD], vp[9 * LD]));
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  __pipeline_wait_prior(0);

  // finish: l over the row's four threads, floored; write bf16 pairs
  bf16* og = reinterpret_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int i = q0 + r_lo + 8 * hh;
    if (i < a.sq && tig == 0) store_lse(a, b, h, i, m_run[hh], l);
    if (i < a.sq) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(og + i * a.o_ss + n * 8 + 2 * tig) = pr;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route "fma": fp32 query, FMA loops (cache fp32 or bf16)
// ---------------------------------------------------------------------------

__host__ __device__ inline int fma_row_bytes(int d, int elem) {
  int rb = d * elem;                 // a multiple of 16 (d % 8 == 0)
  if ((rb / 16) % 2 == 0) rb += 16;  // odd multiple of 16: no bank conflicts
  return rb;
}

// q (BQ x D fp32), o (BQ x D fp32), scores (BQ x BK), m, l, alpha (BQ each),
// tags (BK), the tile list, scratch, then the K and V tiles
__host__ __device__ inline size_t fma_head_bytes(int d) {
  const size_t n = sizeof(float) * (2 * (size_t)kFmaBQ * d + (size_t)kFmaBQ * kFmaBK +
                                    3 * kFmaBQ + kFmaBK + kMaxListed + 4);
  return (n + 15) / 16 * 16;
}

// an int8 ring (q8): the tiles are bf16, and its int8 K and V tiles as they
// arrive (kFmaBK x D bytes each) and their scales follow them
__host__ __device__ inline size_t fma_smem_bytes(int d, int elem, bool q8) {
  return fma_head_bytes(d) + 2 * (size_t)kFmaBK * fma_row_bytes(d, elem) +
         (q8 ? 2 * (size_t)kFmaBK * d + 2 * kFmaBK * sizeof(float) : 0);
}

// the products of the 16 bytes of k at kp with q (fp32, shared memory)
__device__ __forceinline__ float dot16(const float* kp, const float* qp) {
  const float4 k = *reinterpret_cast<const float4*>(kp);
  const float4 q = *reinterpret_cast<const float4*>(qp);
  return fmaf(q.x, k.x, fmaf(q.y, k.y, fmaf(q.z, k.z, q.w * k.w)));
}
__device__ __forceinline__ float dot16(const bf16* kp, const float* qp) {
  const uint4 raw = *reinterpret_cast<const uint4*>(kp);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(qp);
  const float4 qb = *reinterpret_cast<const float4*>(qp + 4);
  float2 k0 = __bfloat1622float2(k2[0]), k1 = __bfloat1622float2(k2[1]);
  float2 k2f = __bfloat1622float2(k2[2]), k3 = __bfloat1622float2(k2[3]);
  float s = qa.x * k0.x;
  s = fmaf(qa.y, k0.y, s);
  s = fmaf(qa.z, k1.x, s);
  s = fmaf(qa.w, k1.y, s);
  s = fmaf(qb.x, k2f.x, s);
  s = fmaf(qb.y, k2f.y, s);
  s = fmaf(qb.z, k3.x, s);
  return fmaf(qb.w, k3.y, s);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TKV: the type of the tiles the loops read; Q8: an int8 ring, dequantized
// into bf16 tiles (TKV bf16)
template <typename TKV, bool Q8 = false>
__global__ void __launch_bounds__(kFmaThreads) flash_attention_fma_kernel(Args a) {
  static_assert(!Q8 || sizeof(TKV) == 2, "an int8 ring is read from bf16 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.d, BK = kFmaBK, BQ = kFmaBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* q_s = reinterpret_cast<float*>(smem);
  float* o_s = q_s + BQ * D;
  float* s_s = o_s + BQ * D;
  float* m_s = s_s + BQ * BK;
  float* l_s = m_s + BQ;
  float* al_s = l_s + BQ;
  int* tags_s = reinterpret_cast<int*>(al_s + BQ);
  int* list_s = tags_s + BK;
  int* scratch_s = list_s + kMaxListed;
  const int rb = fma_row_bytes(D, (int)sizeof(TKV));
  const int ld = rb / (int)sizeof(TKV);
  TKV* k_s = reinterpret_cast<TKV*>(smem + fma_head_bytes(D));
  TKV* v_s = reinterpret_cast<TKV*>(smem + fma_head_bytes(D) + (size_t)BK * rb);
  int8_t* kv8_s = reinterpret_cast<int8_t*>(smem + fma_head_bytes(D) + 2 * (size_t)BK * rb);
  float* sc_s = reinterpret_cast<float*>(kv8_s + 2 * BK * D);  // Q8: K's scales, V's

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / a.g;
  const float* qg = reinterpret_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const size_t kv_off = (((size_t)b * a.hkv + hk) * a.sk) * D;
  const TKV* kg = reinterpret_cast<const TKV*>(a.k) + kv_off;
  const TKV* vg = reinterpret_cast<const TKV*>(a.v) + kv_off;
  const int* kp = a.k_pos != nullptr ? a.k_pos + (size_t)b * a.kp_stride : nullptr;
  const size_t sc_off = ((size_t)b * a.hkv + hk) * a.sk;  // Q8: the row's scales

  const TileSet ts = plan_tiles(a, b, q0, BQ, BK, list_s, scratch_s);

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, dd = i % D;
    q_s[i] = q0 + r < a.sq ? qg[(q0 + r) * a.q_ss + dd] * a.scale_log2 : 0.0f;
    o_s[i] = 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const int vec = 16 / (int)sizeof(TKV);

  for (int k = 0; k < ts.count; ++k) {
    const int j0 = tile_index(ts, list_s, k) * BK;
    if constexpr (Q8) {
      copy_rows8(kv8_s, reinterpret_cast<const int8_t*>(a.k) + kv_off, j0, BK, a.sk, D);
      copy_rows8(kv8_s + BK * D, reinterpret_cast<const int8_t*>(a.v) + kv_off, j0, BK, a.sk, D);
      load_scales(sc_s, sc_s + BK, a.k_scale + sc_off, a.v_scale + sc_off, j0, BK, a.sk);
    } else {
      copy_rows(k_s, ld, kg, D, j0, BK, a.sk, D);
      copy_rows(v_s, ld, vg, D, j0, BK, a.sk, D);
    }
    if (kp != nullptr) copy_tags(tags_s, kp, j0, BK, a.sk);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if constexpr (Q8) {  // the int8 tiles into the bf16 ones
      dequant_rows(k_s, v_s, ld, kv8_s, sc_s, BK, D);
      __syncthreads();
    }

    // scores; a masked key (or one past Sk, or a query row past Sq) is -inf
    for (int p = tid; p < BQ * BK; p += kFmaThreads) {
      const int r = p / BK, jl = p % BK;
      const int i = q0 + r, j = j0 + jl;
      float s = -INFINITY;
      if (i < a.sq && j < a.sk) {
        const int qp = a.q_pos == nullptr ? i : a.q_pos[(size_t)b * a.qp_stride + i];
        const int kpos = kp == nullptr ? j : tags_s[jl];
        if (live(a, kpos, qp)) {
          const TKV* kr = k_s + jl * ld;
          const float* qr = q_s + r * D;
          float acc = 0.0f;
          for (int dd = 0; dd < D; dd += vec) acc += dot16(kr + dd, qr + dd);
          s = acc;
        }
      }
      s_s[p] = s;
    }
    __syncthreads();

    // online softmax, one warp a row: scores become probabilities
    for (int r = warp; r < BQ; r += kFmaThreads / 32) {
      float* row = s_s + r * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[r], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float pj = exp2f(row[j] - m_use);
        row[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_s[r] - m_use);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * D; i += kFmaThreads) {
      const int r = i / D, dd = i % D;
      const float* pr = s_s + r * BK;
      float acc = o_s[i] * al_s[r];
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], to_f32(v_s[j * ld + dd]), acc);
      o_s[i] = acc;
    }
    __syncthreads();  // the tiles and scores are free for the next tile
  }
  __syncthreads();  // l_s, even when no tile was read

  float* og = reinterpret_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int r = tid; r < BQ; r += kFmaThreads)
    if (q0 + r < a.sq) store_lse(a, b, h, q0 + r, m_s[r], l_s[r]);
  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, dd = i % D;
    if (q0 + r < a.sq) og[(q0 + r) * a.o_ss + dd] = o_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// host side
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

template <int D, bool Q8 = false>
int launch_wgmma(const Args& a, int splits, cudaStream_t stream) {
  using W = WgTile<D, Q8>;
  WgParams p;
  const long long bh = (long long)a.b * a.hkv;
  const int elem = Q8 ? 1 : 2;
  if (hg::tensor_map_3d(&p.k_map, a.k, elem, D, a.sk, bh, kWgBK) != 0 ||
      hg::tensor_map_3d(&p.v_map, a.v, elem, D, a.sk, bh, kWgBK) != 0)
    return -1;
  p.a = a;
  p.splits = splits;
  const long long row_tiles = ((long long)a.sq * a.g + kWgRows - 1) / kWgRows;
  if (row_tiles > 65535 || bh > 65535) return -1;
  const dim3 grid(splits, (unsigned)row_tiles, (unsigned)bh);
  if (splits == 1) {
    flash_attention_wgmma_kernel<D, Q8><<<grid, kWgThreads, W::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = W::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_attention_wgmma_kernel<D, Q8>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int D, bool Q8 = false>
int launch_mma(const Args& a, cudaStream_t stream) {
  dim3 grid((a.sq + kMmaBQ - 1) / kMmaBQ, a.hq, a.b);
  flash_attention_mma_kernel<D, Q8><<<grid, kMmaThreads, MmaTile<D, Q8>::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV, bool Q8 = false>
int launch_fma(const Args& a, cudaStream_t stream) {
  dim3 grid((a.sq + kFmaBQ - 1) / kFmaBQ, a.hq, a.b);
  flash_attention_fma_kernel<TKV, Q8>
      <<<grid, kFmaThreads, fma_smem_bytes(a.d, (int)sizeof(TKV), Q8), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sets every kernel's dynamic shared-memory limit on the current device to
// what a block may opt in to, so that launches need not set it.  Call once a
// device before launching.  Returns 0 or a CUDA error.
int flash_attention_prepare(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<64>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<128>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<256>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<16>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<32>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<72>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<80>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<96>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<112>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<float>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<bf16>, optin);
  // the int8 ring's instances
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<64, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<128, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<256, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<16, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<32, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<72, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<80, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<96, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<112, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<bf16, true>, optin);
  return (int)err;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched) or -1 for
// arguments it does not take.  q (B, Hq, Sq, D) at element strides q_sb,
// q_sh, q_ss, out the same shape in q's type at o_sb, o_sh, o_ss; k, v
// (B, Hkv, Sk, D) contiguous, fp32 (kv_dtype 0), bf16 (1) or int8 (2); an
// int8 cache with its scales k_scale, v_scale (B, Hkv, Sk) bf16, any other
// with null ones.  Routes: 2 "wgmma" (bf16 q, a bf16 or int8 cache, D 64, 128
// or 256, `splits` blocks of a cluster, 1 to 8), 1 "mma_sync" (bf16 q, a bf16
// or int8 cache, D one of 16, 32, 72, 80, 96, 112), 0 "fma" (fp32 q (q_dtype
// 0) with any cache, D a multiple of 8 up to 256).  q_pos null:
// contiguous positions (Sq == Sk), or with causal 0 and window 0 any Sq
// against any Sk (a cross-attention: keys past Sk and rows past Sq are masked
// by index, which is all the mask there is); else q_pos (B, Sq) and k_pos (B, Sk) int32
// with batch strides qp_stride / kp_stride.  Pointers 16-byte aligned; on the
// bf16 routes q's strides are multiples of 8 elements.  lse: null, or (B, Hq,
// Sq) fp32 contiguous, where every route writes each row's log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const int* q_pos, const int* k_pos, void* out,
                           float* lse, int b, int hq, int hkv, int sq, int sk,
                           int d, long long q_sb, long long q_sh, long long q_ss, long long o_sb,
                           long long o_sh, long long o_ss, int qp_stride, int kp_stride,
                           int causal, int window, float scale, int q_dtype, int kv_dtype,
                           int route, int splits, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || d < 8 || d > 256 || d % 8 != 0)
    return -1;
  if (q_pos == nullptr && sq != sk && (causal || window > 0)) return -1;
  if ((q_pos == nullptr) != (k_pos == nullptr)) return -1;
  if (kv_dtype < 0 || kv_dtype > 2) return -1;
  const bool q8 = kv_dtype == 2;
  if (q8 != (k_scale != nullptr && v_scale != nullptr)) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.q_pos = q_pos; a.k_pos = k_pos; a.out = out; a.lse = lse;
  a.k_scale = static_cast<const bf16*>(k_scale);
  a.v_scale = static_cast<const bf16*>(v_scale);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss; a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.sk = sk; a.d = d; a.g = hq / hkv;
  a.qp_stride = qp_stride; a.kp_stride = kp_stride;
  a.causal = causal; a.window = window; a.scale_log2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteWgmma) {
    if (q_dtype != 1 || kv_dtype == 0 || splits < 1 || splits > kMaxSplits) return -1;
    if (q8) {
      switch (d) {
        case 64: return launch_wgmma<64, true>(a, splits, s);
        case 128: return launch_wgmma<128, true>(a, splits, s);
        case 256: return launch_wgmma<256, true>(a, splits, s);
        default: return -1;
      }
    }
    switch (d) {
      case 64: return launch_wgmma<64>(a, splits, s);
      case 128: return launch_wgmma<128>(a, splits, s);
      case 256: return launch_wgmma<256>(a, splits, s);
      default: return -1;
    }
  }
  if (route == kRouteMma) {
    if (q_dtype != 1 || kv_dtype == 0) return -1;
    if (q8) {
      switch (d) {
        case 16: return launch_mma<16, true>(a, s);
        case 32: return launch_mma<32, true>(a, s);
        case 72: return launch_mma<72, true>(a, s);
        case 80: return launch_mma<80, true>(a, s);
        case 96: return launch_mma<96, true>(a, s);
        case 112: return launch_mma<112, true>(a, s);
        default: return -1;
      }
    }
    switch (d) {
      case 16: return launch_mma<16>(a, s);
      case 32: return launch_mma<32>(a, s);
      case 72: return launch_mma<72>(a, s);
      case 80: return launch_mma<80>(a, s);
      case 96: return launch_mma<96>(a, s);
      case 112: return launch_mma<112>(a, s);
      default: return -1;
    }
  }
  if (route != kRouteFma || q_dtype != 0) return -1;
  if (q8) return launch_fma<bf16, true>(a, s);
  return kv_dtype == 1 ? launch_fma<bf16>(a, s) : launch_fma<float>(a, s);
}

}  // extern "C"
