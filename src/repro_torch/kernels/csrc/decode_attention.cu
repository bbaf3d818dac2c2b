// Decode attention for Hopper (sm_90a): one query token a row against that
// row's ring KV cache.
//
//   out[b, hq, :] = softmax_c(scale * q[b, hq, :] . k[b, hq / G, c, :]  over live c)
//                   @ v[b, hq / G, :, :]
//
// with slot c of row b live when slot_pos[b, c] <= q_pos[b] and, with a
// window, slot_pos[b, c] > q_pos[b] - window.  slot_pos is (C,) or (B, C),
// q_pos one position for all rows or one a row.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention).  Same function: GQA heads hq / G, fp32
// scores, fp32 softmax and P.V, l floored at 1e-30, output in q's type, caches
// fp32 or bf16, scale d**-0.5 unless given.  One difference, on purpose: a
// masked slot adds exactly 0 (the TPU kernel fills masked scores with -1e30,
// so a row with no live slot returns the mean of V); a row with no live slot
// gives zeros here, as decode_attention_ref and the model's gqa_attention do.
//
// What bounds it on an H100 (datasheet: 3.35 TB/s): the cache.  One slot's K
// and V are 4 D bytes in bf16 and take 4 G D operations, G operations a byte
// (5 at G 5), far below the card's balance point of about 295, so reading K
// and V once is the whole cost.  At the serving shapes (bf16, D 128, G 5),
// reading every slot: lock-step B 8, Hkv 8, C 1024 is 33.55 MB, 10.0 us;
// slot-batched 8 slots, C 2048 is 67.1 MB, 20.0 us; reading the live slots
// only, as the kernel does, less (chip_smoke.py prints both bounds).
//
// Design.  The TPU grid (B, Hkv, C / bk) carries (m, l, acc) across the
// sequential steps of C; at B * Hkv = 64 that would fill under half of the
// 132 SMs.  Here the cache axis is split ("flash-decoding"):
//   * a block owns (split of C, kv head, batch row, chunk of up to 16 of the G
//     query rows).  It keeps its query rows in shared memory (fp32, scaled),
//     streams BK-slot tiles of K and V into shared memory through a ring of
//     two cp.async stages (the next tile travels while this one is used), and
//     keeps the online-softmax carry (m, l) in shared memory and acc in fp32
//     registers, two head elements a thread.
//   * it writes its (m, l, acc) to fp32 scratch; a second small kernel
//     combines the splits by log-sum-exp in a fixed order, so the result is
//     the same every run, floors l and casts.  A split with no live slot has
//     m = -inf and weighs exactly 0 in the combine.
//   * the wrapper picks the splits so that the blocks fill the SMs in one
//     wave, as many to an SM as fit (occupancy asked of the runtime).
//   * G <= 16 rows against D <= 256 is FMA work beside the memory stream: no
//     tensor cores.  Score products read K in 16-byte pieces, and a row of a
//     tile in shared memory is an odd multiple of 16 bytes long, so that the
//     eight threads of a quarter warp meet eight distinct groups of banks.
//   * the tiles that hold no live slot are not read at all: every block of a
//     row scans the row's tags (4 bytes a slot), lists the tiles with a live
//     slot, and takes its split's share of that list.  A decode step at
//     position p of a ring of C reads about min(p, C) slots, not C.
// TMA and warp specialisation are left for later.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxGroup = 16;    // query rows one block holds
constexpr int kMaxSplits = 128;  // the combine keeps one weight a split in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxListed = 1024;  // rings of up to this many tiles are read live tiles only

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// adds the products of the 16 bytes of k at kp with q (fp32, in shared
// memory) into two sums, so that two chains of FMAs run side by side
__device__ __forceinline__ void dot16(const float* kp, const float* qp, float& a0, float& a1) {
  const float4 k = *reinterpret_cast<const float4*>(kp);
  const float4 q = *reinterpret_cast<const float4*>(qp);
  a0 = fmaf(q.x, k.x, a0);
  a1 = fmaf(q.y, k.y, a1);
  a0 = fmaf(q.z, k.z, a0);
  a1 = fmaf(q.w, k.w, a1);
}
__device__ __forceinline__ void dot16(const bf16* kp, const float* qp, float& a0, float& a1) {
  const uint4 raw = *reinterpret_cast<const uint4*>(kp);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(qp);
  const float4 qb = *reinterpret_cast<const float4*>(qp + 4);
  float2 k;
  k = __bfloat1622float2(k2[0]);
  a0 = fmaf(qa.x, k.x, a0);
  a1 = fmaf(qa.y, k.y, a1);
  k = __bfloat1622float2(k2[1]);
  a0 = fmaf(qa.z, k.x, a0);
  a1 = fmaf(qa.w, k.y, a1);
  k = __bfloat1622float2(k2[2]);
  a0 = fmaf(qb.x, k.x, a0);
  a1 = fmaf(qb.y, k.y, a1);
  k = __bfloat1622float2(k2[3]);
  a0 = fmaf(qb.z, k.x, a0);
  a1 = fmaf(qb.w, k.y, a1);
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

struct Args {
  const void* q;          // (B, Hq, D), fp32 or bf16 (q_bf16)
  const void* k;          // (B, Hkv, C, D), T
  const void* v;
  const int* slot_pos;    // (C,) or (B, C)
  const int* q_pos;       // (B,) or one value (qp_stride 0); null: q_pos_value
  float* part_acc;        // (splits, B, Hq, D)
  float* part_ml;         // (splits, B, Hq, 2): running max and sum
  int b, hq, hkv, c, d, g;
  int sp_stride, qp_stride, q_pos_value;
  int window;
  float scale;
  int q_bf16;
  int bk, tiles_per_split, row_bytes;
};

// Shared memory: q rows (fp32, MAXG x D), scores (MAXG x BK), m, l and the
// tile's rescale (MAXG each), two stages of the tile's tags (BK each), the
// list of live tiles (kMaxListed), then two stages of K and V tiles (BK rows
// of row_bytes each).  After the loop the stages hold the partial sums of the
// thread groups that split BK.
__host__ __device__ inline size_t head_bytes(int maxg, int d, int bk) {
  const size_t n = sizeof(float) * ((size_t)maxg * d + (size_t)maxg * bk + 3 * (size_t)maxg +
                                    2 * (size_t)bk + kMaxListed);
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int row_bytes_for(int d, int elem) {
  int rb = d * elem;                   // a multiple of 16 (d % 8 == 0)
  if ((rb / 16) % 2 == 0) rb += 16;    // odd multiple of 16: no bank conflicts
  return rb;
}

__host__ __device__ inline size_t smem_bytes(int maxg, int d, int bk, int elem) {
  const size_t tiles = 4 * (size_t)bk * row_bytes_for(d, elem);
  const size_t red = sizeof(float) * (size_t)(2 * kThreads) * maxg;  // JG * D <= 2 * kThreads
  return head_bytes(maxg, d, bk) + (tiles > red ? tiles : red);
}

template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads, 2) decode_attention_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int D = a.d, BK = a.bk;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int gchunks = (a.g + kMaxGroup - 1) / kMaxGroup;
  const int b = blockIdx.z / gchunks;
  const int g0 = (blockIdx.z % gchunks) * kMaxGroup;
  const int gn = min(MAXG, a.g - g0);  // query rows of this block
  const int ldk = a.row_bytes / (int)sizeof(T);

  float* q_s = reinterpret_cast<float*>(smem);
  float* s_s = q_s + MAXG * D;
  float* m_s = s_s + MAXG * BK;
  float* l_s = m_s + MAXG;
  float* al_s = l_s + MAXG;
  int* sp_s = reinterpret_cast<int*>(al_s + MAXG);  // two stages of BK tags
  int* list_s = sp_s + 2 * BK;                       // live tiles of the row
  __shared__ int nlive_s;
  unsigned char* tiles = smem + head_bytes(MAXG, D, BK);
  const size_t stage_bytes = 2 * (size_t)BK * a.row_bytes;

  const int qp = a.q_pos != nullptr ? a.q_pos[(size_t)b * a.qp_stride] : a.q_pos_value;
  const int* sp = a.slot_pos + (size_t)b * a.sp_stride;
  const int tiles_total = (a.c + BK - 1) / BK;
  auto live = [&](int spos) {
    return spos <= qp && (a.window == 0 || spos > qp - a.window);
  };
  const int warp = tid >> 5, lane = tid & 31;

  // The tiles this block reads.  A ring of up to kMaxListed tiles: the row's
  // tiles that hold a live slot are listed (every block of the row scans the
  // tags, 4 bytes a slot) and the splits share them out evenly, so a block
  // reads no tile that is wholly masked.  A longer ring: the split's own
  // range of tiles.
  const bool listed = tiles_total <= kMaxListed;
  int k_end, t0 = 0;
  if (listed) {
    for (int i = tid; i < tiles_total; i += kThreads) list_s[i] = 0;
    __syncthreads();
    for (int c = tid; c < a.c; c += kThreads)
      if (live(sp[c])) list_s[c / BK] = 1;
    __syncthreads();
    if (warp == 0) {  // compact in place: entry n <= i is written after i is read
      int n = 0;
      for (int base = 0; base < tiles_total; base += 32) {
        const int i = base + lane;
        const bool lv = i < tiles_total && list_s[i] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, lv);
        __syncwarp();
        if (lv) list_s[n + __popc(m & ((1u << lane) - 1))] = i;
        n += __popc(m);
      }
      if (lane == 0) nlive_s = n;
    }
    __syncthreads();
    const int per = (nlive_s + gridDim.x - 1) / gridDim.x;
    t0 = min(split * per, nlive_s);
    k_end = min(t0 + per, nlive_s) - t0;
  } else {
    t0 = min(split * a.tiles_per_split, tiles_total);
    k_end = min(t0 + a.tiles_per_split, tiles_total) - t0;
  }
  // the k-th tile this block reads
  auto tile_at = [&](int k) { return listed ? list_s[t0 + k] : t0 + k; };
  const size_t kv_base = ((size_t)b * a.hkv + h) * a.c * D;
  const T* kg = reinterpret_cast<const T*>(a.k) + kv_base;
  const T* vg = reinterpret_cast<const T*>(a.v) + kv_base;
  const int cpr = D * (int)sizeof(T) / 16;  // 16-byte pieces of a row

  auto load_tile = [&](int k, int st) {
    if (k < k_end) {
      const int c0 = tile_at(k) * BK;
      unsigned char* kd = tiles + st * stage_bytes;
      unsigned char* vd = kd + (size_t)BK * a.row_bytes;
      for (int e = tid; e < BK; e += kThreads) {
        const bool inside = c0 + e < a.c;
        __pipeline_memcpy_async(sp_s + st * BK + e, sp + (inside ? c0 + e : 0), 4,
                                inside ? 0 : 4);
      }
      for (int e = tid; e < BK * cpr; e += kThreads) {
        const int r = e / cpr, ch = e % cpr;
        const bool inside = c0 + r < a.c;
        const size_t off = inside ? (size_t)(c0 + r) * D + ch * (16 / sizeof(T)) : 0;
        // outside the ring nothing is read: the 16 bytes are zero-filled
        __pipeline_memcpy_async(kd + r * a.row_bytes + ch * 16, kg + off, 16, inside ? 0 : 16);
        __pipeline_memcpy_async(vd + r * a.row_bytes + ch * 16, vg + off, 16, inside ? 0 : 16);
      }
    }
    __pipeline_commit();
  };

  load_tile(0, 0);

  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    const size_t qi = ((size_t)b * a.hq + (size_t)h * a.g + g0 + g) * D + dd;
    const float qv = a.q_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(a.q)[qi])
                              : reinterpret_cast<const float*>(a.q)[qi];
    q_s[g * D + dd] = qv * a.scale * kLog2e;  // scores in the base-2 domain
  }
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  // P.V: thread (jg, dp) owns head elements 2 dp, 2 dp + 1 of every query
  // row, over the slots jg, jg + JG, ... of a tile
  const int DP = D / 2;
  const int JG = kThreads / DP;
  const int dp = tid % DP, jg = tid / DP;
  const bool pv_on = jg < JG;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.0f;

  const int vec = 16 / (int)sizeof(T);
  for (int k = 0; k < k_end; ++k) {
    const int st = k & 1;
    // the other stage was last read in tile k - 1, which ended with a barrier
    load_tile(k + 1, st ^ 1);
    __pipeline_wait_prior(1);
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(tiles + st * stage_bytes);
    const T* vs = reinterpret_cast<const T*>(tiles + st * stage_bytes + (size_t)BK * a.row_bytes);
    const int c0 = tile_at(k) * BK;
    const int* tags = sp_s + st * BK;

    // scores; a masked slot (or one past the ring) is -inf
    for (int p = tid; p < gn * BK; p += kThreads) {
      const int g = p / BK, j = p % BK;
      const int cc = c0 + j;
      float s = -INFINITY;
      if (cc < a.c) {
        const int spos = tags[j];
        if (live(spos)) {
          const T* kr = ks + j * ldk;
          const float* qr = q_s + g * D;
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
          for (int dd = 0; dd < D; dd += vec) dot16(kr + dd, qr + dd, a0, a1);
          s = a0 + a1;
        }
      }
      s_s[g * BK + j] = s;
    }
    __syncthreads();

    // online softmax, one warp a query row: scores become probabilities
    for (int g = warp; g < gn; g += kThreads / 32) {
      float* row = s_s + g * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float pj = row[j] == -INFINITY ? 0.0f : exp2f(row[j] - m_new);
        row[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        // nothing live yet: keep the (zero) carry as it is
        const float alpha = m_new == -INFINITY ? 1.0f : exp2f(m_old - m_new);
        al_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (pv_on) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < gn) {
          acc[g][0] *= al_s[g];
          acc[g][1] *= al_s[g];
        }
      }
#pragma unroll 4
      for (int j = jg; j < BK; j += JG) {
        const float2 v2 = load2(vs + j * ldk + 2 * dp);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < gn) {
            const float pj = s_s[g * BK + j];
            acc[g][0] = fmaf(pj, v2.x, acc[g][0]);
            acc[g][1] = fmaf(pj, v2.y, acc[g][1]);
          }
        }
      }
    }
    __syncthreads();  // the stage and the scores are free for the next tile
  }

  // sum the thread groups' partials (in a fixed order) and write the split's
  // (m, l, acc); the stages are free now
  float* red = reinterpret_cast<float*>(tiles);
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < gn) {
        red[(jg * MAXG + g) * D + 2 * dp] = acc[g][0];
        red[(jg * MAXG + g) * D + 2 * dp + 1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float s = 0.0f;
    for (int r = 0; r < JG; ++r) s += red[(r * MAXG + g) * D + dd];
    const size_t row = ((size_t)split * a.b + b) * a.hq + (size_t)h * a.g + g0 + g;
    a.part_acc[row * D + dd] = s;
    if (dd == 0) {
      a.part_ml[row * 2] = m_s[g];
      a.part_ml[row * 2 + 1] = l_s[g];
    }
  }
}

// out[row, :] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = 2^(m_s - M),
// summed over the splits in order; a split with m_s = -inf weighs 0.
template <typename TO>
__global__ void decode_attention_combine_kernel(const float* __restrict__ part_acc,
                                                const float* __restrict__ part_ml,
                                                TO* __restrict__ out, int rows, int d,
                                                int splits) {
  __shared__ float w[kMaxSplits];
  const int row = blockIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[((size_t)s * rows + row) * 2]);
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    const float m = part_ml[((size_t)s * rows + row) * 2];
    w[s] = m == -INFINITY ? 0.0f : exp2f(m - mx);
  }
  __syncthreads();
  float l = 0.0f;
  for (int s = 0; s < splits; ++s) l += w[s] * part_ml[((size_t)s * rows + row) * 2 + 1];
  l = fmaxf(l, 1e-30f);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float o = 0.0f;
    for (int s = 0; s < splits; ++s) o += w[s] * part_acc[((size_t)s * rows + row) * d + dd];
    out[(size_t)row * d + dd] = from_f32<TO>(o / l);
  }
}

int maxg_for(int g) {
  const int c = g < kMaxGroup ? g : kMaxGroup;
  return c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : c <= 8 ? 8 : 16;
}

// Sets the split kernel's shared-memory attributes on the current device: the
// dynamic shared memory it may ask for, as much as a block may opt in to (so
// that one setting serves every head dim and tile depth, and launches need
// not set it again), and the largest carveout, so that as many blocks as fit
// share an SM.  Then gives how many blocks of the (d, bk) tiling an SM holds.
template <typename T, int MAXG>
int prepare(int d, int bk, int* blocks_per_sm) {
  auto kernel = decode_attention_split_kernel<T, MAXG>;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem_bytes(MAXG, d, bk, (int)sizeof(T)));
  return (int)err;
}

template <typename T>
int prepare_t(int g, int d, int bk, int* blocks_per_sm) {
  switch (maxg_for(g)) {
    case 1: return prepare<T, 1>(d, bk, blocks_per_sm);
    case 2: return prepare<T, 2>(d, bk, blocks_per_sm);
    case 4: return prepare<T, 4>(d, bk, blocks_per_sm);
    case 8: return prepare<T, 8>(d, bk, blocks_per_sm);
    default: return prepare<T, 16>(d, bk, blocks_per_sm);
  }
}

template <typename T, int MAXG>
int launch_split(const Args& a, int splits, cudaStream_t stream) {
  const int gchunks = (a.g + kMaxGroup - 1) / kMaxGroup;
  dim3 grid(splits, a.hkv, a.b * gchunks);
  decode_attention_split_kernel<T, MAXG>
      <<<grid, kThreads, smem_bytes(MAXG, a.d, a.bk, (int)sizeof(T)), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_t(const Args& a, int splits, cudaStream_t stream) {
  switch (maxg_for(a.g)) {
    case 1: return launch_split<T, 1>(a, splits, stream);
    case 2: return launch_split<T, 2>(a, splits, stream);
    case 4: return launch_split<T, 4>(a, splits, stream);
    case 8: return launch_split<T, 8>(a, splits, stream);
    default: return launch_split<T, 16>(a, splits, stream);
  }
}

}  // namespace

extern "C" {

// Tile depth BK for (kv dtype 0 fp32 / 1 bf16, head dim d, group size g): the
// deepest of 64, 32, 16 whose shared memory lets two blocks share an SM, else
// 16; and how many blocks of that tiling an SM holds at once (occupancy on
// the current device), from which the wrapper sizes the splits.  It also sets
// the kernel's shared-memory attributes on the current device, which
// decode_attention_launch needs: call it once for each device, cache type and
// group size before launching.  Returns 0, a CUDA error, or -1 if d is not a
// multiple of 8 in (0, 256].
int decode_attention_tile(int kv_dtype, int d, int g, int* bk, int* blocks_per_sm) {
  if (d <= 0 || d > 256 || d % 8 != 0 || g < 1) return -1;
  const int elem = kv_dtype == 1 ? 2 : 4;
  const int maxg = maxg_for(g);
  *bk = 16;
  for (int cand = 64; cand >= 16; cand /= 2) {
    if (smem_bytes(maxg, d, cand, elem) <= 113 * 1024) {
      *bk = cand;
      break;
    }
  }
  return kv_dtype == 1 ? prepare_t<bf16>(g, d, *bk, blocks_per_sm)
                       : prepare_t<float>(g, d, *bk, blocks_per_sm);
}

// Launches the split kernel and the combine on `stream`; returns
// cudaGetLastError() (0 = launched), or -1 for arguments it does not take.
// part_acc holds splits * b * hq * d floats, part_ml splits * b * hq * 2.
// slot_pos is (C,) (sp_stride 0) or (B, C) (sp_stride c); q_pos is null (one
// position q_pos_value), or (B,) (qp_stride 1), or one value (qp_stride 0).
// q and out are fp32 (q_dtype 0) or bf16 (1), the caches fp32 or bf16
// (kv_dtype).  All tensors are contiguous.
int decode_attention_launch(const void* q, const void* k, const void* v, const int* slot_pos,
                            const int* q_pos, void* part_acc, void* part_ml, void* out, int b,
                            int hq, int hkv, int c, int d, int sp_stride, int qp_stride,
                            int q_pos_value, int window, float scale, int q_dtype,
                            int kv_dtype, int bk, int tiles_per_split, int splits,
                            void* stream) {
  if (hkv < 1 || hq % hkv != 0 || d <= 0 || d > 256 || d % 8 != 0 || splits < 1 ||
      splits > kMaxSplits || b < 1 || c < 1 || bk < 16 || bk % 16 != 0)
    return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.slot_pos = slot_pos; a.q_pos = q_pos;
  a.part_acc = (float*)part_acc; a.part_ml = (float*)part_ml;
  a.b = b; a.hq = hq; a.hkv = hkv; a.c = c; a.d = d; a.g = hq / hkv;
  a.sp_stride = sp_stride; a.qp_stride = qp_stride; a.q_pos_value = q_pos_value;
  a.window = window; a.scale = scale; a.q_bf16 = q_dtype == 1;
  a.bk = bk; a.tiles_per_split = tiles_per_split;
  a.row_bytes = row_bytes_for(d, kv_dtype == 1 ? 2 : 4);
  cudaStream_t s = (cudaStream_t)stream;
  int err = kv_dtype == 1 ? launch_split_t<bf16>(a, splits, s) : launch_split_t<float>(a, splits, s);
  if (err != 0) return err;
  const int rows = b * hq;
  const int threads = d < 128 ? d : 128;
  if (q_dtype == 1)
    decode_attention_combine_kernel<bf16><<<rows, threads, 0, s>>>(
        (const float*)part_acc, (const float*)part_ml, (bf16*)out, rows, d, splits);
  else
    decode_attention_combine_kernel<float><<<rows, threads, 0, s>>>(
        (const float*)part_acc, (const float*)part_ml, (float*)out, rows, d, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
