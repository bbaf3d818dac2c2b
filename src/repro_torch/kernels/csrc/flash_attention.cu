// Flash attention for Hopper (sm_90a): prefill and chunked-prefill attention.
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / G, j, :]  over live j)
//                     @ v[b, h / G, :, :]
//
// with key j live for query i when, by positions, k_pos <= q_pos (causal) and
// k_pos > q_pos - window (window > 0).  Positions are either contiguous
// (q_pos = k_pos = arange(S), Sq == Sk: a prefill) or given per row on the
// device, q_pos (B, Sq) and k_pos (B, Sk) (a chunk of a prompt against the
// ring cache, k_pos = the ring's tags; the 2**30 tag of an unwritten slot masks
// itself out under causal).  A query with no live key gives zeros.
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
// tokens against a ring of 2048 is bound by reading the ring's live K and V.
//
// Design.  The TPU grid (B, Hq, S / bq, S / bk) walks the KV axis in order
// and carries (m, l, acc) in scratch across grid steps; on Hopper the KV axis
// becomes a loop inside the block:
//   * bf16 (q and cache): a block owns (b, q head, 64 query rows), four warps
//     of 16 rows.  K and V tiles go through two cp.async stages in shared
//     memory (rows padded to an odd multiple of 16 bytes), the next tile in
//     flight while this one is used.  Both products run on the tensor cores
//     through mma.sync m16n8k16 (bf16 in, fp32 accumulate); the score
//     fragment becomes the P operand in registers, rounded to bf16 as the
//     model's own attention rounds P to V's type.  m, l and the output
//     accumulator stay in fp32 registers; the softmax is in base 2 with
//     log2(e) folded into the scale.
//   * fp32 query (fp32 or bf16 cache): a block owns (b, q head, 16 query
//     rows); scores, softmax and P.V are FMA loops over tiles in shared
//     memory, since TF32 would miss the fp32 tolerance.
//   * the KV loop is bounded: contiguous positions give the causal and window
//     range of tiles; with per-row positions every block scans the row's tags
//     and lists the tiles that hold a key live for some query of the block,
//     and reads only those (a chunk early in a ring of 2048 reads a few
//     tiles, not 32).
// wgmma, TMA and warp specialisation are left for later.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxListed = 1024;  // rows of up to this many tiles are read live tiles only

// the tensor-core kernel (bf16)
constexpr int kMmaThreads = 128;  // four warps of 16 query rows
constexpr int kMmaBQ = 64;
// the FMA kernel (fp32 query)
constexpr int kFmaThreads = 128;
constexpr int kFmaBQ = 16;
constexpr int kFmaBK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Args {
  const void* q;        // (B, Hq, Sq, D)
  const void* k;        // (B, Hkv, Sk, D)
  const void* v;
  const int* q_pos;     // (B, Sq) or null: contiguous positions
  const int* k_pos;     // (B, Sk), with q_pos
  void* out;            // (B, Hq, Sq, D), q's type
  int b, hq, hkv, sq, sk, d, g;
  int qp_stride, kp_stride;  // batch strides of q_pos / k_pos (0: one row for all)
  int causal, window;
  float scale_log2;     // scale * log2(e)
};

__device__ __forceinline__ bool live(const Args& a, int kp, int qp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
}

// The KV tiles a block of query rows [q0, q0 + rows) reads, into list_s (when
// `listed`) or as the range [t_lo, t_lo + count).  Contiguous positions: the
// causal and window range.  Per-row positions: the tiles that hold at least
// one key live for some query of the block (qmin / qmax of the block's
// positions), listed in order by one warp; every thread must call this.
struct TileSet {
  int count, t_lo;
  bool listed;
};

__device__ TileSet plan_tiles(const Args& a, int b, int q0, int rows, int bk, int* list_s,
                              int* scratch_s) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
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
    return ts;
  }
  // qmin / qmax of the block's positions
  const int* qp = a.q_pos + (size_t)b * a.qp_stride;
  if (tid == 0) {
    scratch_s[0] = INT_MAX;
    scratch_s[1] = INT_MIN;
  }
  __syncthreads();
  for (int r = tid; r < rows && q0 + r < a.sq; r += nthreads) {
    atomicMin(&scratch_s[0], qp[q0 + r]);
    atomicMax(&scratch_s[1], qp[q0 + r]);
  }
  __syncthreads();
  const int qmin = scratch_s[0], qmax = scratch_s[1];
  if (tiles_total > kMaxListed) return ts;  // a longer ring: every tile
  ts.listed = true;
  const int* kp = a.k_pos + (size_t)b * a.kp_stride;
  for (int i = tid; i < tiles_total; i += nthreads) list_s[i] = 0;
  __syncthreads();
  for (int j = tid; j < a.sk; j += nthreads) {
    const int p = kp[j];
    const bool any = (!a.causal || p <= qmax) && (a.window <= 0 || p > qmin - a.window);
    if (any) list_s[j / bk] = 1;
  }
  __syncthreads();
  if (tid < 32) {  // compact in place: entry n <= i is written after i is read
    const int lane = tid;
    int n = 0;
    for (int base = 0; base < tiles_total; base += 32) {
      const int i = base + lane;
      const bool lv = i < tiles_total && list_s[i] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, lv);
      __syncwarp();
      if (lv) list_s[n + __popc(m & ((1u << lane) - 1))] = i;
      n += __popc(m);
    }
    if (lane == 0) scratch_s[2] = n;
  }
  __syncthreads();
  ts.count = scratch_s[2];
  return ts;
}

__device__ __forceinline__ int tile_index(const TileSet& ts, const int* list_s, int k) {
  return ts.listed ? list_s[k] : ts.t_lo + k;
}

// Starts the copy of rows [r0, r0 + rows) of a (n, D) matrix of T into shared
// memory rows of ld elements; rows past n are zero-filled without a read.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int r0, int rows, int n,
                                          int d) {
  const int cpr = d * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, ch = e % cpr;
    const bool inside = r0 + r < n;
    const T* s = inside ? src + (size_t)(r0 + r) * d + ch * (16 / sizeof(T)) : src;
    __pipeline_memcpy_async(dst + (size_t)r * ld + ch * (16 / sizeof(T)), s, 16, inside ? 0 : 16);
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

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

template <int D> struct MmaTile {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int LD = D + 8;  // row of 2 D + 16 bytes: an odd multiple of 16
  static constexpr size_t kTileBytes = (size_t)BK * LD * sizeof(bf16);
  // q tile, two stages of K and V, two stages of tags, the tile list, scratch
  static constexpr size_t kSmem = (size_t)kMmaBQ * LD * sizeof(bf16) + 4 * kTileBytes +
                                  2 * BK * sizeof(int) + kMaxListed * sizeof(int) + 16;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(Args a) {
  using Tile = MmaTile<D>;
  constexpr int BK = Tile::BK, LD = Tile::LD;
  constexpr int NT = BK / 8;   // score fragments (n8) a tile
  constexpr int ND = D / 8;    // output fragments (n8)
  constexpr int KD = D / 16;   // k16 steps of the score product
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kMmaBQ * LD;  // stage s: K at 2 s, V at 2 s + 1
  int* tags_s = reinterpret_cast<int*>(kv_s + 4 * BK * LD);
  int* list_s = tags_s + 2 * BK;
  int* scratch_s = list_s + kMaxListed;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kMmaBQ;
  const int hk = h / a.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // row group, thread in group

  const bf16* qg = reinterpret_cast<const bf16*>(a.q) + (((size_t)b * a.hq + h) * a.sq) * D;
  const size_t kv_off = (((size_t)b * a.hkv + hk) * a.sk) * D;
  const bf16* kg = reinterpret_cast<const bf16*>(a.k) + kv_off;
  const bf16* vg = reinterpret_cast<const bf16*>(a.v) + kv_off;
  const int* kp = a.k_pos != nullptr ? a.k_pos + (size_t)b * a.kp_stride : nullptr;

  const TileSet ts = plan_tiles(a, b, q0, kMmaBQ, BK, list_s, scratch_s);

  copy_rows(q_s, LD, qg, q0, kMmaBQ, a.sq, D);
  __pipeline_commit();
  auto load_tile = [&](int k, int st) {
    if (k < ts.count) {
      const int j0 = tile_index(ts, list_s, k) * BK;
      copy_rows(kv_s + (2 * st) * BK * LD, LD, kg, j0, BK, a.sk, D);
      copy_rows(kv_s + (2 * st + 1) * BK * LD, LD, vg, j0, BK, a.sk, D);
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
    const bf16* ks = kv_s + (2 * st) * BK * LD;
    const bf16* vs = kv_s + (2 * st + 1) * BK * LD;
    const int j0 = tile_index(ts, list_s, k) * BK;

    // scores S = Q K^T for the warp's 16 rows
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t af[4];
      const bf16* qr = q_s + (warp * 16 + gid) * LD + kk * 16 + 2 * tig;
      af[0] = ld32(qr);
      af[1] = ld32(qr + 8 * LD);
      af[2] = ld32(qr + 8);
      af[3] = ld32(qr + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = ks + (n * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma16816(s[n], af, ld32(kr), ld32(kr + 8));
      }
    }

    // mask, scale, online softmax (base 2); a row's four threads share it
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * tig + (e & 1);
        const int j = j0 + jl;
        const int hh = e >> 1;
        const int kpos = kp == nullptr ? j : tags_s[st * BK + jl];
        const bool ok = j < a.sk && live(a, kpos, qpos[hh]);
        s[n][e] = ok ? s[n][e] * a.scale_log2 : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[n][e]);
      }
    }
    float alpha[2], m_use[2];
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
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_use[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
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
      pf[0] = pack2f(s[2 * j][0], s[2 * j][1]);
      pf[1] = pack2f(s[2 * j][2], s[2 * j][3]);
      pf[2] = pack2f(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[3] = pack2f(s[2 * j + 1][2], s[2 * j + 1][3]);
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
  bf16* og = reinterpret_cast<bf16*>(a.out) + (((size_t)b * a.hq + h) * a.sq) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int i = q0 + r_lo + 8 * hh;
    if (i < a.sq) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)i * D + n * 8 + 2 * tig) = pr;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 query: FMA loops (cache fp32 or bf16)
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

__host__ __device__ inline size_t fma_smem_bytes(int d, int elem) {
  return fma_head_bytes(d) + 2 * (size_t)kFmaBK * fma_row_bytes(d, elem);
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

template <typename TKV>
__global__ void __launch_bounds__(kFmaThreads) flash_attention_fma_kernel(Args a) {
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

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / a.g;
  const float* qg = reinterpret_cast<const float*>(a.q) + (((size_t)b * a.hq + h) * a.sq) * D;
  const size_t kv_off = (((size_t)b * a.hkv + hk) * a.sk) * D;
  const TKV* kg = reinterpret_cast<const TKV*>(a.k) + kv_off;
  const TKV* vg = reinterpret_cast<const TKV*>(a.v) + kv_off;
  const int* kp = a.k_pos != nullptr ? a.k_pos + (size_t)b * a.kp_stride : nullptr;

  const TileSet ts = plan_tiles(a, b, q0, BQ, BK, list_s, scratch_s);

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D;
    q_s[i] = q0 + r < a.sq ? qg[(size_t)q0 * D + i] * a.scale_log2 : 0.0f;
    o_s[i] = 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const int vec = 16 / (int)sizeof(TKV);

  for (int k = 0; k < ts.count; ++k) {
    const int j0 = tile_index(ts, list_s, k) * BK;
    copy_rows(k_s, ld, kg, j0, BK, a.sk, D);
    copy_rows(v_s, ld, vg, j0, BK, a.sk, D);
    if (kp != nullptr) copy_tags(tags_s, kp, j0, BK, a.sk);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

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

  float* og = reinterpret_cast<float*>(a.out) + (((size_t)b * a.hq + h) * a.sq) * D;
  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D;
    if (q0 + r < a.sq) og[(size_t)q0 * D + i] = o_s[i] / fmaxf(l_s[r], 1e-30f);
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

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  dim3 grid((a.sq + kMmaBQ - 1) / kMmaBQ, a.hq, a.b);
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, MmaTile<D>::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_fma(const Args& a, cudaStream_t stream) {
  dim3 grid((a.sq + kFmaBQ - 1) / kFmaBQ, a.hq, a.b);
  flash_attention_fma_kernel<TKV>
      <<<grid, kFmaThreads, fma_smem_bytes(a.d, (int)sizeof(TKV)), stream>>>(a);
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
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<16>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<32>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<64>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<80>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<96>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<128>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<256>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<float>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<bf16>, optin);
  return (int)err;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched) or -1 for
// arguments it does not take.  q (B, Hq, Sq, D) and out in q's type: bf16
// (q_dtype 1) with a bf16 cache, D one of 16, 32, 64, 80, 96, 128, 256; or
// fp32 (q_dtype 0) with an fp32 (kv_dtype 0) or bf16 (1) cache, D a multiple
// of 8 up to 256.  k, v (B, Hkv, Sk, D).  q_pos null: contiguous positions
// (Sq == Sk); else q_pos (B, Sq) and k_pos (B, Sk) int32 with batch strides
// qp_stride / kp_stride.  All tensors contiguous, 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v, const int* q_pos,
                           const int* k_pos, void* out, int b, int hq, int hkv, int sq, int sk,
                           int d, int qp_stride, int kp_stride, int causal, int window,
                           float scale, int q_dtype, int kv_dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || d < 8 || d > 256 || d % 8 != 0)
    return -1;
  if (q_pos == nullptr && sq != sk) return -1;
  if ((q_pos == nullptr) != (k_pos == nullptr)) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.q_pos = q_pos; a.k_pos = k_pos; a.out = out;
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.sk = sk; a.d = d; a.g = hq / hkv;
  a.qp_stride = qp_stride; a.kp_stride = kp_stride;
  a.causal = causal; a.window = window; a.scale_log2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1) {
    if (kv_dtype != 1) return -1;
    switch (d) {
      case 16: return launch_mma<16>(a, s);
      case 32: return launch_mma<32>(a, s);
      case 64: return launch_mma<64>(a, s);
      case 80: return launch_mma<80>(a, s);
      case 96: return launch_mma<96>(a, s);
      case 128: return launch_mma<128>(a, s);
      case 256: return launch_mma<256>(a, s);
      default: return -1;
    }
  }
  return kv_dtype == 1 ? launch_fma<bf16>(a, s) : launch_fma<float>(a, s);
}

}  // extern "C"
