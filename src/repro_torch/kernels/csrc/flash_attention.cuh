// What the routes of flash attention share (flash_attention.cu: routes
// "mma_sync" and "fma"; flash_attention_wgmma.cu: route "wgmma"): the
// arguments, the constants the Python plans repeat, the plan of a block's KV
// tiles, the copies into shared memory and the online-softmax step.  Two
// sources, two libraries, so that their nvcc processes run side by side; what
// the kernels compute and how each route is cut is said in flash_attention.cu.
//
// Everything here has internal linkage: each library includes its own copy.

#pragma once

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


template <typename K>
cudaError_t allow_smem(K kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  return err;
}

// Fills `a` from flash_attention_launch's arguments (flash_attention.cu says
// what they are); false for a combination no route takes.
inline bool make_args(Args* a, const void* q, const void* k, const void* v, const void* k_scale,
                      const void* v_scale, const int* q_pos, const int* k_pos, void* out,
                      float* lse, int b, int hq, int hkv, int sq, int sk, int d, long long q_sb,
                      long long q_sh, long long q_ss, long long o_sb, long long o_sh,
                      long long o_ss, int qp_stride, int kp_stride, int causal, int window,
                      float scale, int kv_dtype) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || d < 8 || d > 256 || d % 8 != 0)
    return false;
  if (q_pos == nullptr && sq != sk && (causal || window > 0)) return false;
  if ((q_pos == nullptr) != (k_pos == nullptr)) return false;
  if (kv_dtype < 0 || kv_dtype > 2) return false;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) return false;
  a->q = q; a->k = k; a->v = v; a->q_pos = q_pos; a->k_pos = k_pos; a->out = out; a->lse = lse;
  a->k_scale = static_cast<const bf16*>(k_scale);
  a->v_scale = static_cast<const bf16*>(v_scale);
  a->q_sb = q_sb; a->q_sh = q_sh; a->q_ss = q_ss; a->o_sb = o_sb; a->o_sh = o_sh; a->o_ss = o_ss;
  a->b = b; a->hq = hq; a->hkv = hkv; a->sq = sq; a->sk = sk; a->d = d; a->g = hq / hkv;
  a->qp_stride = qp_stride; a->kp_stride = kp_stride;
  a->causal = causal; a->window = window; a->scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace
