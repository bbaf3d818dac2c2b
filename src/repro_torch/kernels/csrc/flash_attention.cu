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
// becomes a loop inside the block.  Three routes, chosen by the wrapper; the
// "wgmma" instances are compiled from flash_attention_wgmma.cu (a library of
// their own, so that the two nvcc processes run side by side), what all
// routes share is in flash_attention.cuh:
//   * "wgmma" (bf16 query, a bf16 cache at head dim 64, 72, 80, 96, 112, 128
//     or 256, an int8 one at the same but 72): a block owns
//     one (b, kv head) and 64 "rows", a row being a (query position t, query
//     head g of the kv head's group) pair, row = t G + g.  Each K and V tile
//     is read once for all G heads of its kv head, and a tile of rows spans
//     64 / G positions, so the causal and window bounds of its KV loop stay
//     tight.  One producer warp keeps K, V (and the tiles' tags) in flight
//     through a ring of stages: its first lane issues the TMA copies (three
//     dimensional maps over (B Hkv, Sk, D), 128-byte swizzle, zeros past Sk
//     and past D), all its lanes copy the tags (the next tile's loaded while
//     this one waits for its stage), and full[s] completes on the bytes and
//     the 32 arrivals.  One consumer warpgroup copies its Q tile into shared
//     memory (cp.async, swizzled as TMA would, zeros past D, issued before
//     the block plans its tiles), computes S = Q K^T by wgmma m64n64k16 from
//     shared memory (K the K-major B operand), masks (only tiles with some
//     key not live for some row: the plan flags them) and runs the online
//     softmax in registers, rounds P to bf16 (as the model's attention rounds
//     P to V's type) and accumulates O += P V by wgmma with P as the A
//     operand in registers and V the MN-major B operand, then releases the
//     stage on empty[s].  No block barrier inside the loop.  Head dims 72-112
//     take the shared-memory layout of 128 (flash_attention_wgmma.cu says
//     how).
//   * when the blocks of a launch do not fill the card (a chunk at B 1: 8 kv
//     heads x 1-3 row tiles), the live tiles of the KV loop are divided among
//     `splits` blocks of one thread-block cluster.  Each block keeps its
//     (m, l, acc) in its own shared memory; after a cluster barrier each block
//     combines its share of the 64 rows over distributed shared memory, in
//     rank order, floors l and stores (the split-K technique of
//     hopper_gemm.cuh: one launch, no partials in device memory, no atomics,
//     the same bits every run).  The wrapper picks `splits` from the shapes
//     and the card alone.
//   * "mma_sync" (bf16 at head dims 16, 32, 72, 80, 96, 112; the planned
//     route at 16 and 32 and for an int8 ring at 72, reachable at the others
//     by route="mma_sync"): a block owns (b, q head, 64 query rows); K and V
//     tiles through two cp.async stages, both products on mma.sync m16n8k16
//     (at D 72 the last k16 step of S = Q K^T takes zeros for the 8 columns
//     past D).
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
//     _dequantize_kv (hg::dequant8: a byte permute and a subtraction, no
//     integer conversion).
//     Nothing widens the ring in device memory.  On "wgmma" a tile's scales
//     come by two bulk copies beside its TMA boxes, and the conversion runs
//     beside the products: one bf16 K tile and one bf16 V tile, V of tile i
//     converted while S_i = Q K_i^T runs and K of tile i + 1 while O +=
//     P_i V_i runs (flash_attention_wgmma.cu).
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
// chunks against the ring ahead of it.  Until head dims 72-112 took route
// "wgmma", mma_sync's block a query head read each K/V tile G times over
// (8 at kimi-k2's 64/8 heads of 112: its prefill 4.15x the library).

#include "flash_attention.cuh"

namespace {

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
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<16>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<32>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<72>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<80>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<96>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_mma_kernel<112>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<float>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_fma_kernel<bf16>, optin);
  // the int8 ring's instances
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
// with null ones.  Routes: 1 "mma_sync" (bf16 q, a bf16 or int8 cache, D
// one of 16, 32, 72, 80, 96, 112), 0 "fma" (fp32 q (q_dtype
// 0) with any cache, D a multiple of 8 up to 256).  q_pos null:
// contiguous positions (Sq == Sk), or with causal 0 and window 0 any Sq
// against any Sk (a cross-attention: keys past Sk and rows past Sq are masked
// by index, which is all the mask there is); else q_pos (B, Sq) and k_pos (B, Sk) int32
// with batch strides qp_stride / kp_stride.  Pointers 16-byte aligned; on the
// bf16 routes q's strides are multiples of 8 elements.  lse: null, or (B, Hq,
// Sq) fp32 contiguous, where every route writes each row's log-sum-exp.
// `splits` 1 (route "wgmma", 2, is flash_attention_wgmma_launch, in
// flash_attention_wgmma.cu).
int flash_attention_launch(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const int* q_pos, const int* k_pos, void* out,
                           float* lse, int b, int hq, int hkv, int sq, int sk,
                           int d, long long q_sb, long long q_sh, long long q_ss, long long o_sb,
                           long long o_sh, long long o_ss, int qp_stride, int kp_stride,
                           int causal, int window, float scale, int q_dtype, int kv_dtype,
                           int route, int splits, void* stream) {
  Args a;
  if (splits != 1 ||
      !make_args(&a, q, k, v, k_scale, v_scale, q_pos, k_pos, out, lse, b, hq, hkv, sq, sk, d,
                 q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, qp_stride, kp_stride, causal, window, scale,
                 kv_dtype))
    return -1;
  const bool q8 = kv_dtype == 2;
  cudaStream_t s = (cudaStream_t)stream;
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
