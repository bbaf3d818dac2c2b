// Flash attention for Hopper (sm_90a), route "wgmma": bf16 query with a bf16
// or int8 cache, head dims 64, 72, 80, 96, 112, 128 and 256.  What the kernel
// computes, and the other routes, are in flash_attention.cu; this source
// holds the "wgmma" instances only, so that its nvcc runs beside that one's.
//
// A block owns one (b, kv head) and 64 "rows", a row being a (query position
// t, query head g of the kv head's group) pair, row = t G + g: each K and V
// tile is read once for all G heads of its kv head.  One producer warp keeps
// K and V (and the tiles' tags) in flight through a ring of stages by TMA;
// one consumer warpgroup computes S = Q K^T by wgmma from shared memory, runs
// the online softmax in registers and accumulates O += P V by wgmma with P in
// registers; when the blocks do not fill the card the live tiles are divided
// among the blocks of a cluster and merged over distributed shared memory in
// rank order (flash_attention.cu says more).
//
// Head dims 72, 80, 96 and 112 (dit-xl's 72, kimi-k2's 112) use the shared
// memory layout of 128: a K or V tile is two 64-column blocks of 128-byte
// swizzled rows, as at 128, and the tensor maps over (B Hkv, Sk, D) give the
// boxes of 64 columns whose columns past D arrive as zeros (TMA's
// out-of-bounds fill; D x 2 bytes is a whole 16 bytes at each, so the bf16
// maps are legal).  The consumers' copy of the Q tile writes zeros into the
// columns past D (never stale bytes: garbage times a zero key could be NaN).
// S = Q K^T runs ceil(D / 16) k16 steps; O += P V runs at wgmma n = D
// (m64n72k16 ... m64n112k16), chosen by measurement: against n = 128 with
// the padded columns dropped it was as fast or up to 1.6 % faster at 7 of
// dit-xl's and kimi-k2's 8 shapes (chip_smoke.py, NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md), and n = 128 was removed.  Only D columns are stored,
// combined or rescaled.  An int8 ring at these
// dims: rows of 80, 96 or 112 bytes are a whole 16 bytes and TMA takes them
// (boxes of 128 bytes, zeros past D); at 72 bytes it cannot, and the wrapper
// keeps an int8 ring at D 72 on route "mma_sync".
//
// An int8 ring (the Q8 instances).  The products see what the reference's
// _dequantize_kv gives, bf16(q x scale) in fp32, so the int8 tiles are
// converted into bf16 tiles in shared memory before the products read them
// (the scales are not folded into the scores or into P: that would change
// the values the products see).  What held the route back was the
// conversion in series with the products (both tiles converted between two
// barriers, the tensor cores idle meanwhile), its integer conversions (I2F
// at an eighth of the FP32 rate) and the scales loaded by the producer's
// lanes one at a time.  So:
//   * one bf16 K tile and one bf16 V tile: V_i converted while S_i = Q K_i^T
//     is in flight, K_{i+1} while O += P_i V_i is, each conversion ended by
//     fence.proxy.async and the warpgroup's barrier before the product that
//     reads it (two barriers a tile, as before);
//   * the conversion by a byte permute and a subtraction (hg::dequant8, the
//     same bits), a batch of a thread's int8 pieces and scales loaded before
//     any is converted (a store into the bf16 tile could alias a later load,
//     and the compiler keeps them in order: loaded one at a time, the
//     loads' latencies added up);
//   * a tile's 64 K and 64 V scales by two bulk copies that complete on the
//     stage's full barrier beside the TMA boxes (the lanes copy them where
//     the ring's rows do not start on 16 bytes, and for a last part tile);
//   * a stage released once its V is converted (or, where the softmax masks
//     by its tags, once it has read them), so that the ring runs ahead; S
//     started at scale-d 0 rather than by zeroing the scores.
// What bounds it now (clock64 phases of a probe of the loop, PERF.md): a
// tile's conversion takes longer than the product it hides behind, on one
// warp an SMSP, and the softmax between the products as over bf16.
// The bf16 instances run the code they ran before: every int8 change is an
// `if constexpr (Q8)` branch.
//
// Registers: the output tile is D / 2 fp32 a thread (56 at D 112, 64 at 128),
// the scores 32; chip_smoke.py prints ptxas's counts and spills for every
// instance ([build]).

#include "flash_attention.cuh"
#include "wgmma_rs.cuh"

namespace {

// The shared-memory layout's head dim: 64, 128 (for every D from 72 to 128)
// or 256.
constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// Shared memory of a block: the ring (STAGES x (K tile, V tile), each tile
// DP / 64 column blocks of kWgBK rows x 128 bytes, swizzled), the Q tile (the
// same layout, kWgRows rows), the tiles' tags, the tile list, the combine's
// coefficients, scratch, the mbarriers.  After the loop the ring holds a
// split's (acc, m, l) for the combine.
// An int8 ring (Q8): the stages hold the tiles as they arrive, in boxes of 128
// one-byte elements (a row of 64 padded to 128), then come the one bf16 K
// tile and the one bf16 V tile the products read, each dequantized from its
// stage while the product of the other runs; the stages' scales (bf16, as
// stored) sit beside the tags.
template <int D, bool Q8 = false> struct WgTile {
  static constexpr int DP = padded_dim(D);          // the layout's head dim
  static constexpr int BLOCKS = DP / 64;            // 128-byte column blocks of a bf16 row
  static constexpr int KV_BYTES = kWgBK * DP * 2;   // one bf16 K or V tile
  static constexpr int BLOCKS8 = DP > 128 ? DP / 128 : 1;  // of an int8 row
  static constexpr int IN_BYTES = Q8 ? kWgBK * 128 * BLOCKS8 : KV_BYTES;  // a tile as it arrives
  static constexpr int STAGE_BYTES = 2 * IN_BYTES;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = D == 256 ? 1 : 2;  // blocks an SM holds
  static constexpr int RING = STAGES * STAGE_BYTES + (Q8 ? 2 * KV_BYTES : 0);
  static constexpr int Q_BYTES = kWgRows * DP * 2;
  static constexpr int SMEM = 1024 + RING + Q_BYTES + STAGES * kWgBK * 4 * (Q8 ? 2 : 1) +
                              kMaxListed * 4 + kWgRows * (kMaxSplits + 1) * 4 + 16 +
                              2 * STAGES * 8;
  static_assert(D == 64 || D == 72 || D == 80 || D == 96 || D == 112 || D == 128 || D == 256,
                "head dims of the wgmma route");
  static_assert(!Q8 || D % 16 == 0, "an int8 row TMA takes is a whole 16 bytes");
  static_assert(kWgRows * D * 4 + kWgRows * 8 <= RING, "a split's (acc, m, l) fit the ring");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM holds");
};

struct WgParams {
  CUtensorMap k_map, v_map;  // (B Hkv, Sk, D), boxes of 128 bytes x kWgBK x 1
  Args a;
  int splits;                // blocks of a cluster, each a share of the live tiles
  int bulk_scales;           // Q8: a whole tile's scales by bulk copies (rows on 16 bytes)
};

template <int D, bool Q8 = false>
__global__ void __launch_bounds__(kWgThreads, WgTile<D>::MIN_BLOCKS)
    flash_attention_wgmma_kernel(const __grid_constant__ WgParams p) {
  using W = WgTile<D, Q8>;
  constexpr int DP = W::DP;
  const Args& a = p.a;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must start on 1024 bytes
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dq_tiles = ring + W::STAGES * W::STAGE_BYTES;  // Q8: the bf16 K, V tiles
  unsigned char* q_s = ring + W::RING;
  int* tags_s = reinterpret_cast<int*>(q_s + W::Q_BYTES);
  // Q8: stage s's K scales at 2 s kWgBK, its V scales after them, each 128
  // bytes on 16
  bf16* sc16 = reinterpret_cast<bf16*>(tags_s + W::STAGES * kWgBK);
  int* list_s = reinterpret_cast<int*>(sc16 + (Q8 ? 2 * W::STAGES * kWgBK : 0));
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
    // and the columns past D are zeros
    constexpr int CPR = DP / 8;  // 16-byte pieces of a row of the layout
    for (int e = tid; e < kWgRows * CPR; e += 128) {
      const int r = e / CPR, ch = e % CPR;
      const int row = r0 + r;
      const bool inside = row < rows_total && ch < D / 8;
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
    // producer: lane 0 issues the copies of K and V, every lane copies tags,
    // those of the next tile loaded while this one waits for its stage.  An
    // int8 ring's scales: a whole tile's by two bulk copies beside K and V
    // (bulk_tile), else (a ring whose rows do not start on 16 bytes, its
    // last part tile) by the lanes as the tags, zeros past Sk
    int nxt[2] = {0, 0};
    bf16 nsc[2][2];  // Q8, a tile the lanes copy: its K, V scales
    const bool side = kp != nullptr || Q8;  // something besides the tiles to copy
    auto bulk_tile = [&](int j0) { return p.bulk_scales != 0 && j0 + kWgBK <= a.sk; };
    auto load_tags = [&](int i) {
      const int j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + lane + 32 * u;
        if (kp != nullptr) nxt[u] = j < a.sk ? __ldg(kp + j) : 0;
        if constexpr (Q8) {
          if (!bulk_tile(j0)) {
            const size_t si = (size_t)bh * a.sk + j;
            nsc[0][u] = j < a.sk ? a.k_scale[si] : __float2bfloat16(0.0f);
            nsc[1][u] = j < a.sk ? a.v_scale[si] : __float2bfloat16(0.0f);
          }
        }
      }
    };
    if (side && nk > 0) load_tags(0);
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % W::STAGES;
      const int cur[2] = {nxt[0], nxt[1]};
      const bf16 csc[2][2] = {{nsc[0][0], nsc[0][1]}, {nsc[1][0], nsc[1][1]}};
      if (side && i + 1 < nk) load_tags(i + 1);
      hg::mbar_wait(&empty[s], ((i / W::STAGES) & 1) ^ 1);
      const int j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
      const bool bulk = Q8 && bulk_tile(j0);
      if (lane == 0) {
        unsigned char* st = ring + s * W::STAGE_BYTES;
        hg::mbar_expect_tx(&full[s], W::STAGE_BYTES + (bulk ? 4 * kWgBK : 0));
        if constexpr (Q8) {
#pragma unroll
          for (int c = 0; c < W::BLOCKS8; ++c) {
            hg::tma_load_3d(st + c * kWgBK * 128, &p.k_map, &full[s], c * 128, j0, bh);
            hg::tma_load_3d(st + W::IN_BYTES + c * kWgBK * 128, &p.v_map, &full[s], c * 128, j0,
                            bh);
          }
          if (bulk) {
            const size_t si = (size_t)bh * a.sk + j0;
            hg::bulk_copy(sc16 + 2 * s * kWgBK, a.k_scale + si, 2 * kWgBK, &full[s]);
            hg::bulk_copy(sc16 + (2 * s + 1) * kWgBK, a.v_scale + si, 2 * kWgBK, &full[s]);
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
        if (!bulk) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            sc16[2 * s * kWgBK + lane + 32 * u] = csc[0][u];
            sc16[(2 * s + 1) * kWgBK + lane + 32 * u] = csc[1][u];
          }
          // the lanes' stores before a later bulk copy into the stage
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      }
      hg::mbar_arrive(&full[s]);
    }
  } else {
    // consumers: the Q tile is on its way since the start; `sync` is the
    // consumers' barrier
    auto sync = [&] { asm volatile("bar.sync 1, 128;\n" ::: "memory"); };
    __pipeline_wait_prior(0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    sync();

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
    // the int8 instances add (warp / 4) 64 x 128 bytes, zero for every
    // consumer warp, as ptxas then fits D 128's in 168 registers (the
    // constant form spilled 8-16 bytes there)
    const uint32_t q_base = smem_u32(q_s) + (Q8 ? (warp >> 2) * (64 * 128) : 0);
    // Q8: the int8 K (which 0) or V (1) of stage st dequantized into its
    // bf16 tile, swizzled as TMA writes one, 16 bytes of a row a thread at
    // a time: the D / 16 pieces a row of the products read (S runs D / 16
    // k16 steps, O += P V is n = D wide; the columns past D are never read)
    auto convert = [&](int which, int st) {
      constexpr int P8 = D / 16;
      constexpr int N = (kWgBK * P8 + 127) / 128;  // pieces a thread
      const unsigned char* in = ring + st * W::STAGE_BYTES + which * W::IN_BYTES;
      const bf16* scl = sc16 + (2 * st + which) * kWgBK;
      unsigned char* out = dq_tiles + which * W::KV_BYTES;
      // a batch of pieces' bytes and scales before any is converted (a
      // store into the bf16 tile could alias a later load: the compiler
      // keeps them in order): up to four, one at D 256 (its registers: its
      // output tile is 128 a thread)
      constexpr int CH = D > 128 ? 1 : N < 4 ? N : 4;
      static_assert(N % CH == 0, "whole batches of pieces");
#pragma unroll
      for (int i0 = 0; i0 < N; i0 += CH) {
        uint4 raw[CH];
        float scale[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int u = tid + 128 * (i0 + j);
          if (kWgBK * P8 % 128 == 0 || u < kWgBK * P8) {
            const int r = u / P8, c = u % P8;
            raw[j] = *reinterpret_cast<const uint4*>(
                in + (c >> 3) * (kWgBK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
            scale[j] = __bfloat162float(scl[r]);
          }
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int u = tid + 128 * (i0 + j);
          if (kWgBK * P8 % 128 == 0 || u < kWgBK * P8) {
            const int r = u / P8, c = u % P8;
            unsigned char* row = out + r * 128;
            const int c0 = 2 * c, c1 = 2 * c + 1;  // its two bf16 pieces
            *reinterpret_cast<uint4*>(row + (c0 >> 3) * (kWgBK * 128) +
                                      (((c0 & 7) ^ (r & 7)) << 4)) =
                hg::dequant8(raw[j].x, raw[j].y, scale[j]);
            *reinterpret_cast<uint4*>(row + (c1 >> 3) * (kWgBK * 128) +
                                      (((c1 & 7) ^ (r & 7)) << 4)) =
                hg::dequant8(raw[j].z, raw[j].w, scale[j]);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    };
    if constexpr (Q8) {
      if (nk > 0) {  // the first tile's K
        hg::mbar_wait(&full[0], 0);
        convert(0, 0);
        sync();
      }
    }

#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % W::STAGES;
      uint32_t k_base;
      if constexpr (Q8) {
        k_base = smem_u32(dq_tiles);
      } else {
        hg::mbar_wait(&full[s], (i / W::STAGES) & 1);
        k_base = smem_u32(ring + s * W::STAGE_BYTES);
      }
      const uint32_t v_base = k_base + W::KV_BYTES;
      // the tile's first key and whether every key of it is live for every
      // row (no mask); Q8 reads them before S, for the stage's release
      int j0 = 0;
      bool all_live = false;
      if constexpr (Q8) {
        j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
        all_live = tile_full(a, ts, list_s, k_begin + i, kWgBK);
      }

      // S = Q K^T: 64 rows x kWgBK keys (Q8: the first k16 step at scale-d
      // 0 in place of zeroing the scores)
      float sc[kWgBK / 2];
      if constexpr (!Q8) {
#pragma unroll
        for (int e = 0; e < kWgBK / 2; ++e) sc[e] = 0.0f;
      }
      hg::fence_acc(sc);
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk) {
        const uint64_t dq =
            hg::desc_sw128(q_base + (kk >> 2) * (kWgRows * 128) + (kk & 3) * 32, 16, 1024);
        const uint64_t dk =
            hg::desc_sw128(k_base + (kk >> 2) * (kWgBK * 128) + (kk & 3) * 32, 16, 1024);
        hg::wgmma_m64n64<0>(sc, dq, dk, Q8 && kk == 0 ? 0 : 1);
      }
      hg::wgmma_commit();
      // Q8: V of this tile into the V tile while S runs (every warp's O +=
      // P V of the last tile is done with it: the barrier that ended it);
      // then this warp is done with stage s (its int8 K and V, scales)
      // unless the softmax reads its tags (a tile with keys not live)
      if constexpr (Q8) {
        convert(1, s);
        if (all_live) {
          __syncwarp();
          if (lane == 0) hg::mbar_arrive(&empty[s]);
        }
      }
      hg::wgmma_wait<0>();
      hg::fence_acc(sc);

      if constexpr (!Q8) {
        j0 = tile_index(ts, list_s, k_begin + i) * kWgBK;
        all_live = tile_full(a, ts, list_s, k_begin + i, kWgBK);
      }
      float alpha[2];
      softmax_tile<kWgBK>(a, sc, j0, all_live, kp != nullptr ? tags_s + s * kWgBK : nullptr, qpos,
                          tig, m_run, l_run, alpha);
      if constexpr (Q8) {
        // the tags read; the V tile is whole for every warp, and every
        // warp's S is done with the K tile
        if (!all_live) {
          __syncwarp();
          if (lane == 0) hg::mbar_arrive(&empty[s]);
        }
        sync();
      }
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
      for (int j = 0; j < kWgBK / 16; ++j) {
        const uint64_t dv = hg::desc_sw128(v_base + j * 16 * 128, kWgBK * 128, 1024);
        wgmma_pv<D>(o, pf[j], dv);
      }
      hg::wgmma_commit();
      if constexpr (Q8) {
        // K of the next tile into the K tile while O += P V runs; then that
        // tile is whole for every warp, and every warp's O += P V is done
        // with the V tile
        if (i + 1 < nk) {
          const int s1 = (i + 1) % W::STAGES;
          hg::mbar_wait(&full[s1], ((i + 1) / W::STAGES) & 1);
          convert(0, s1);
        }
        hg::wgmma_wait<0>();
        hg::fence_acc(o);
        sync();
      } else {
        hg::wgmma_wait<0>();
        hg::fence_acc(o);
        __syncwarp();
        if (lane == 0) hg::mbar_arrive(&empty[s]);  // this warp is done with stage s
      }
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
      sync();
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
  // a tile's scales (64 bf16 of each) by bulk copies: their rows start on
  // 16 bytes (Sk a multiple of 8)
  p.bulk_scales = Q8 && a.sk % 8 == 0 && reinterpret_cast<uintptr_t>(a.k_scale) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v_scale) % 16 == 0;
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

}  // namespace

extern "C" {

// Sets every instance's dynamic shared-memory limit on the current device to
// what a block may opt in to, so that launches need not set it.  Call once a
// device before launching.  Returns 0 or a CUDA error.
int flash_attention_wgmma_prepare(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<64>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<72>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<80>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<96>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<112>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<128>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<256>, optin);
  // the int8 ring's instances (D 72: its 72-byte rows are no TMA stride)
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<64, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<80, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<96, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<112, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<128, true>, optin);
  if (err == cudaSuccess) err = allow_smem(flash_attention_wgmma_kernel<256, true>, optin);
  return (int)err;
}

// Route "wgmma" of flash_attention_launch (flash_attention.cu), the same
// arguments and returns: bf16 q with a bf16 cache at head dim 64, 72, 80,
// 96, 112, 128 or 256, or with an int8 cache at the same but 72; `splits`
// blocks of a cluster, 1 to 8.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const int* q_pos,
                                 const int* k_pos, void* out, float* lse, int b, int hq, int hkv,
                                 int sq, int sk, int d, long long q_sb, long long q_sh,
                                 long long q_ss, long long o_sb, long long o_sh, long long o_ss,
                                 int qp_stride, int kp_stride, int causal, int window,
                                 float scale, int q_dtype, int kv_dtype, int splits,
                                 void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, k_scale, v_scale, q_pos, k_pos, out, lse, b, hq, hkv, sq, sk, d,
                 q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, qp_stride, kp_stride, causal, window, scale,
                 kv_dtype))
    return -1;
  if (q_dtype != 1 || kv_dtype == 0 || splits < 1 || splits > kMaxSplits) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 2) {
    switch (d) {
      case 64: return launch_wgmma<64, true>(a, splits, s);
      case 80: return launch_wgmma<80, true>(a, splits, s);
      case 96: return launch_wgmma<96, true>(a, splits, s);
      case 112: return launch_wgmma<112, true>(a, splits, s);
      case 128: return launch_wgmma<128, true>(a, splits, s);
      case 256: return launch_wgmma<256, true>(a, splits, s);
      default: return -1;
    }
  }
  switch (d) {
    case 64: return launch_wgmma<64>(a, splits, s);
    case 72: return launch_wgmma<72>(a, splits, s);
    case 80: return launch_wgmma<80>(a, splits, s);
    case 96: return launch_wgmma<96>(a, splits, s);
    case 112: return launch_wgmma<112>(a, splits, s);
    case 128: return launch_wgmma<128>(a, splits, s);
    case 256: return launch_wgmma<256>(a, splits, s);
    default: return -1;
  }
}

}  // extern "C"
