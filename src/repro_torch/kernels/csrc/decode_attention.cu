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
// 132 SMs.  Here the cache axis is split ("flash-decoding"), in one launch:
//   * a block owns (split, kv head, batch row, chunk of up to 8 of the G query
//     rows); the `splits` blocks of one (kv head, row, chunk) run as one
//     thread-block cluster.  Every block of a row scans the row's tags (4
//     bytes a slot, sixteen loads in flight a thread), lists the tiles that
//     hold a live slot, and takes its split's share of that list: a decode
//     step at position p of a ring of C reads about min(p, C) slots, not C,
//     and no tile that is wholly masked.
//   * one producer warp keeps the bytes in flight: its first lane issues TMA
//     copies of the K and V tiles (three dimensional maps over (B Hkv, C, D),
//     128-byte swizzle) into a ring of stages, all its lanes copy the tiles'
//     tags (those of the next tile loaded while this one waits for its
//     stage), and full[s] completes on the bytes and the 32 arrivals.  Eight
//     consumer warps keep their own (m, l, acc) carries: no block-wide
//     barrier inside the KV loop, a warp releases a stage on empty[s] when it
//     is done with it.
//   * route "mma" (bf16 query and cache, D 16-256 in steps the products
//     take, 72 and 112 among them): the tiles hold 64 slots, two groups of four warps take
//     alternate tiles (an even number of stages, half each, so a group waits
//     for its stages' phases in order), each warp 16 slots.  S^T = K Q^T and
//     O^T += V^T P^T run on mma.sync m16n8k16 with the (up to 8) query rows
//     as the 8 columns, so a group of 5 wastes 3 columns, not 11 rows: K is
//     the A operand as stored (ldmatrix), V^T the A operand transposed on
//     the way in (ldmatrix.trans), Q^T the B operand in registers, P^T
//     (rounded to bf16, as the flash kernel's P) the B operand by an 8 x 8
//     transpose of the score fragments (movmatrix).  Measured at G 5 and G 8
//     against the FMA loops (chip_smoke.py), it wins at both.
//   * route "fma" (an fp32 query or cache, other head dims): each warp owns
//     bk / 8 slots of every tile; a slot's score is split over 32 / (slots a
//     warp) lanes, each reading 16-byte pieces of the slot's K row (the
//     swizzle puts the rows of eight lanes on eight bank groups) against the
//     query rows in shared memory (fp32, scaled into base 2); shuffles add
//     the pieces and give the warp's max and sum; each lane then owns two
//     head elements (and two more every 64) of every query row for P.V.
//   * after the loop the eight warps' carries are merged into the block's, in
//     warp order; one block a row writes the output.  A cluster's blocks
//     then merge their carries over distributed shared memory, in rank
//     order, each block its share of the outputs, l floored and cast.  No
//     partials in device memory, no atomics: the same inputs give the same
//     bits on every run.
//   * the wrapper plans tile depth and stages (kernel.py) and the splits:
//     enough to give every SM a block, at most 8 (the portable cluster
//     size); a second block on an SM, or a larger cluster, cost more in
//     prologue and merge than they saved (PERF.md).
//   * an int8 ring (the reference's quantized serving cache: one bf16 scale a
//     slot and kv head, k_scale / v_scale (B, Hkv, C)) is read as it is
//     stored, half the bytes of bf16: the tiles arrive in int8 (TMA with
//     boxes of 128 one-byte elements; at a head dim whose rows TMA cannot
//     stride, D % 16 != 0, the producer's lanes copy them), the producer's
//     lanes copy the tiles' scales beside their tags, and each element is
//     dequantized as the reference does, (q * scale) rounded to bf16, before
//     it enters a product.  Route "mma": the products' fragments are built
//     in registers from the int8 tile itself, never through shared memory
//     again: the head dim is read permuted (k_perm, v_perm below), so that
//     a lane's elements of K for every k16 step are one run of its slot
//     row (16-byte loads at D 128) and its elements of V^T for every m
//     tile one run of each of its four slots' rows; Q's B fragments follow
//     K's permutation, loaded once a block, and the carry is written back
//     to the dims it stands for.  Each int8 becomes its exact fp32 value by
//     a byte permute and a subtraction (hopper_gemm.cuh, i8f), not an
//     integer conversion, and (q * scale) is rounded to bf16, as the
//     reference dequantizes: the operands' bits are those of its
//     dequantized ring.  No per-warp copy
//     of the slots in bf16 crosses shared memory, and the ring keeps all
//     of it for stages.  A tile's scales come by bulk copies beside K and
//     V, not by the producer's lanes.  At the reference's decode_32k shape
//     (B 8, Hkv 8, D 128, C 32768) this route takes 0.260 ms, against
//     0.163 to read the int8 ring once and the bf16 route's 0.364
//     (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).  Route "fma": in registers, as the pieces are
//     read.  Nothing widens the ring in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hg::bulk_copy;
using hg::deq;
using hg::deq_pair8;
using hg::i8f;
using hg::smem_u32;

// kernels/decode_attention/kernel.py repeats these, smem_bytes and maxg_for,
// and plans the tile depth (16, 32 or 64 slots) and the stages
// (tests/test_torch_decode_attention.py reads them from here)
constexpr int kWarps = 8;          // consumer warps; one producer warp beside them
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kMaxGroup = 8;       // query rows one block holds
constexpr int kMaxSplits = 8;      // blocks of a cluster (chip/h100.py MAX_SPLITS)
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;  // route "mma" takes an even count, "fma" 3 or 4
constexpr int kMaxListed = 1024;   // rings of up to this many tiles are read live tiles only
constexpr float kLog2e = 1.4426950408889634f;
// combine scratch a query row: the weight of each warp's carry, of each
// rank's, 1 / l, pad
constexpr int kCoef = kWarps + kMaxSplits + 2;

struct Params {
  CUtensorMap k_map, v_map;  // (B Hkv, C, D) of T, boxes of 128 bytes x bk x 1
  const void* k;             // the caches (B, Hkv, C, D), for the lanes' copies
  const void* v;
  const bf16* k_scale;       // int8 ring: (B, Hkv, C) scales; else null
  const bf16* v_scale;
  int lane_copy;             // int8 ring at D % 16 != 0: the producer's lanes copy the tiles
  int bulk_scales;           // int8 ring, route "mma": whole tiles' scales by bulk copies
  const void* q;             // (B, Hq, D), fp32 or bf16 (q_bf16)
  const int* slot_pos;       // (C,) or (B, C)
  const int* q_pos;          // (B,) or one value (qp_stride 0); null: q_pos_value
  void* out;                 // (B, Hq, D) in q's type
  int b, hq, hkv, c, d, g;
  int sp_stride, qp_stride, q_pos_value;
  int window;
  float scale;
  int q_bf16;
  int bk, stages;            // slots of a tile, stages of the ring
  int tiles_per_split;       // a ring of more than kMaxListed tiles: each split's range
  int splits;                // blocks of a cluster
};

// bytes of a row of a K or V tile in shared memory: 128-byte blocks
__host__ __device__ inline int row_bytes_for(int d, int elem) { return (d * elem + 127) / 128 * 128; }

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// (acc, m, l) of every warp and of the block, kept in the ring after the loop
__host__ __device__ inline size_t partial_bytes(int maxg, int d) {
  return sizeof(float) * (size_t)(kWarps + 1) * maxg * (d + 2);
}

// The region at the start of shared memory: the ring (stages x (K tile, V
// tile), each tile row_bytes / 128 column blocks of bk rows x 128 bytes);
// after the loop the carries, whichever is larger.
__host__ __device__ inline size_t region_bytes(int maxg, int d, int bk, int stages, int elem) {
  const size_t ring = (size_t)stages * 2 * bk * row_bytes_for(d, elem);
  const size_t partial = partial_bytes(maxg, d);
  return ring > partial ? ring : partial;
}

// Shared memory: the region, the query rows (fp32, maxg x D), the warps'
// probabilities (kWarps x bk / kWarps slots x pad4(maxg)), the tiles' tags,
// an int8 ring's scales (of K and V, a stage's tile each), the tile list, the
// combine coefficients, scratch, the mbarriers.
__host__ __device__ inline size_t smem_bytes(int maxg, int d, int bk, int stages, int elem) {
  const size_t rest = sizeof(float) * ((size_t)maxg * d + (size_t)bk * pad4(maxg) +
                                       (size_t)stages * bk * (elem == 1 ? 3 : 1) + kMaxListed +
                                       (size_t)maxg * kCoef + 4) +
                      2 * (size_t)stages * sizeof(uint64_t);
  return 1024 + region_bytes(maxg, d, bk, stages, elem) + rest;
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving the
// rows of matrix i; `trans` transposes each.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t out;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(out) : "r"(v));
  return out;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 4-byte word at byte `off` of row `row` of a swizzled tile of bk rows.
__device__ __forceinline__ uint32_t ld_word(const unsigned char* tile, int bk, int row, int off) {
  return *reinterpret_cast<const uint32_t*>(tile + (off >> 7) * (bk * 128) + row * 128 +
                                            ((((off & 127) >> 4) ^ (row & 7)) << 4) + (off & 15));
}

// Route "mma" over an int8 ring reads the head dim permuted, so that a
// lane's operand elements lie side by side in a slot's row and its
// fragments are built in registers from one load of them
// (kernels/decode_attention/kernel.py k_perm and v_perm repeat both; KS
// k16 steps over D):
//   K, the A operand of S^T = K Q^T: lane (gid, tig)'s elements 2 tig,
//     2 tig + 1, 2 tig + 8, 2 tig + 9 of k16 step kk are dims 4 KS tig +
//     4 kk + 0..3, so its 4 KS bytes of a slot row are one run; Q's B
//     fragments (the same dims) are loaded once a block.  A common
//     permutation of D leaves the contraction unchanged.
//   V^T, the A operand of O^T += V^T P^T: O^T's rows gid and gid + 8 of m
//     tile mt are dims 2 KS gid + 2 mt and + 1, so a lane's 2 KS dims over
//     every m tile are one run of its four slots' rows; the carry is
//     written back to the dims they stand for.
template <int KS>
__device__ __forceinline__ int k_perm(int tig, int kk, int j) {
  return 4 * KS * tig + 4 * kk + j;
}
template <int KS>
__device__ __forceinline__ int v_perm(int gid, int mt, int h) {
  return 2 * KS * gid + 2 * mt + h;
}

// The offset of 16-byte piece c of row `row` in a K or V tile of bk rows
// (128-byte column blocks, swizzled as TMA writes them), and its address.
__device__ __forceinline__ int piece_off(int bk, int row, int c) {
  return (c >> 3) * (bk * 128) + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}
__device__ __forceinline__ const unsigned char* piece(const unsigned char* tile, int bk, int row,
                                                      int c) {
  return tile + piece_off(bk, row, c);
}

// An int8 ring whose rows TMA cannot stride (D % 16 != 0): the producer's 32
// lanes copy `rows` rows of D bytes from src into a tile of bk rows, 8 bytes
// at a time, swizzled as TMA would write them.  The bytes past D of a row are
// left as they are: what they dequantize to is finite and meets zeros of the
// query or lands in outputs past D, never stored.
__device__ __forceinline__ void copy_rows_by_lanes(unsigned char* tile, const int8_t* src,
                                                   int rows, int d, int bk, int lane) {
  const int per_row = d / 8;
#pragma unroll 4
  for (int e = lane; e < rows * per_row; e += 32) {
    const int r = e / per_row, h = e % per_row;
    const uint2 v = *reinterpret_cast<const uint2*>(src + (size_t)r * d + 8 * h);
    *reinterpret_cast<uint2*>(tile + piece_off(bk, r, h >> 1) + (h & 1) * 8) = v;
  }
}

// S^T += K Q^T over an int8 ring, route "mma": this warp's 16 slots (rows
// r0 = slot0 + gid and r0 + 8 of the tile, their scales s0 and s1) against
// Q's B fragments qf, loaded under k_perm.  The lane's 4 KS bytes of each
// of its two rows are one run: 16-byte loads where the run is whole
// 16-byte pieces (D 64, 128, 256), else a word a k16 step.
template <int KS>
__device__ __forceinline__ void k8_scores(float (&sc)[4], const unsigned char* kt, int bk, int r0,
                                          int tig, float s0, float s1,
                                          const uint32_t (&qf)[KS][2]) {
  constexpr int RUN = 4 * KS;
#pragma unroll
  for (int kc = 0; kc < KS; kc += 4) {
    uint32_t w0[4], w1[4];
    if constexpr (RUN % 16 == 0) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(piece(kt, bk, r0, (RUN * tig + 4 * kc) >> 4));
      const uint4 x1 =
          *reinterpret_cast<const uint4*>(piece(kt, bk, r0 + 8, (RUN * tig + 4 * kc) >> 4));
      w0[0] = x0.x; w0[1] = x0.y; w0[2] = x0.z; w0[3] = x0.w;
      w1[0] = x1.x; w1[1] = x1.y; w1[2] = x1.z; w1[3] = x1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kc + j < KS) {
          w0[j] = ld_word(kt, bk, r0, k_perm<KS>(tig, kc + j, 0));
          w1[j] = ld_word(kt, bk, r0 + 8, k_perm<KS>(tig, kc + j, 0));
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kc + j < KS) {
        // elements 2 tig, 2 tig + 1 (bytes 0, 1) and 2 tig + 8, 2 tig + 9
        // (bytes 2, 3) of rows gid (a0, a2) and gid + 8 (a1, a3)
        const uint32_t x0 = w0[j] ^ 0x80808080u, x1 = w1[j] ^ 0x80808080u;
        const uint32_t a[4] = {deq_pair8(i8f(x0, 0), s0, i8f(x0, 1), s0),
                               deq_pair8(i8f(x1, 0), s1, i8f(x1, 1), s1),
                               deq_pair8(i8f(x0, 2), s0, i8f(x0, 3), s0),
                               deq_pair8(i8f(x1, 2), s1, i8f(x1, 3), s1)};
        mma16816(sc, a, qf[kc + j][0], qf[kc + j][1]);
      }
  }
}

// O^T += V^T P^T over an int8 ring, route "mma": lane (gid, tig)'s slots
// 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the warp's 16 (scales vs), its
// 2 KS dims v_perm(gid, mt, 0..1) over every m tile one run of each of the
// four rows, read eight m tiles (16 bytes a row) at a time in the widest
// loads the run's length allows; the bf16 slot pairs of a fragment are
// built from the two rows' bytes.
template <int KS>
__device__ __forceinline__ void v8_products(float (&o)[KS][4], const unsigned char* vt, int bk,
                                            int slot0, int gid, int tig, const float (&vs)[4],
                                            uint32_t pb0, uint32_t pb1) {
  constexpr int RUN = 2 * KS;
  constexpr int W = RUN % 16 == 0 ? 16 : RUN % 8 == 0 ? 8 : RUN % 4 == 0 ? 4 : 2;
  const int rows[4] = {slot0 + 2 * tig, slot0 + 2 * tig + 1, slot0 + 2 * tig + 8,
                       slot0 + 2 * tig + 9};
#pragma unroll
  for (int mc = 0; mc < KS; mc += 8) {
    const int off = v_perm<KS>(gid, mc, 0);  // the chunk's first byte in each row
    uint32_t w[4][4];                        // row x word: two m tiles a word
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned char* src = piece(vt, bk, rows[r], off >> 4) + (off & 15);
      if constexpr (W == 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        w[r][0] = x.x; w[r][1] = x.y; w[r][2] = x.z; w[r][3] = x.w;
      } else if constexpr (W == 8) {
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        w[r][0] = x.x; w[r][1] = x.y;
      } else if constexpr (W == 4) {
#pragma unroll
        for (int j = 0; j < RUN / 4; ++j) w[r][j] = ld_word(vt, bk, rows[r], off + 4 * j);
      } else {
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const uint32_t h = *reinterpret_cast<const uint16_t*>(
              piece(vt, bk, rows[r], (off + 2 * j) >> 4) + ((off + 2 * j) & 15));
          w[r][j / 2] = j % 2 ? w[r][j / 2] | h << 16 : h;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (mc + j < KS) {
        // dims gid (byte lo) and gid + 8 (byte lo + 1) of m tile mc + j
        const int lo = 2 * (j % 2);
        const uint32_t x0 = w[0][j / 2] ^ 0x80808080u, x1 = w[1][j / 2] ^ 0x80808080u;
        const uint32_t x2 = w[2][j / 2] ^ 0x80808080u, x3 = w[3][j / 2] ^ 0x80808080u;
        const uint32_t a[4] = {deq_pair8(i8f(x0, lo), vs[0], i8f(x1, lo), vs[1]),
                               deq_pair8(i8f(x0, lo + 1), vs[0], i8f(x1, lo + 1), vs[1]),
                               deq_pair8(i8f(x2, lo), vs[2], i8f(x3, lo), vs[3]),
                               deq_pair8(i8f(x2, lo + 1), vs[2], i8f(x3, lo + 1), vs[3])};
        mma16816(o[mc + j], a, pb0, pb1);
      }
  }
}

// T: the ring's type (float, bf16, or int8 with its scales).  NP: element
// pairs of every query row a lane owns for P.V on the FMA route, 64 elements
// apart (D <= 64 NP).  DM > 0: route "mma" at head dim DM, a
// multiple of 8: at an odd multiple (72) the last k16 step of S^T = K Q^T
// reads 8 columns past D, which the TMA copy of the tile zero-fills (its box
// is 128 bytes wide, the tensor D) and whose query entries are zeros; O^T's
// last 8 rows are then zeros and are not stored.
template <typename T, int MAXG, int NP, int DM>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const __grid_constant__ Params p) {
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  constexpr bool Q8 = sizeof(T) == 1;     // an int8 ring with its scales
  constexpr int PST = (MAXG + 3) / 4 * 4;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int D = p.d, BK = p.bk, S = p.stages;
  const int tile_bytes = BK * row_bytes_for(D, (int)sizeof(T));  // a K or a V tile
  const int nblk = row_bytes_for(D, (int)sizeof(T)) / 128;
  float* q_s = reinterpret_cast<float*>(ring + region_bytes(MAXG, D, BK, S, (int)sizeof(T)));
  float* p_s = q_s + MAXG * D;
  int* tags_s = reinterpret_cast<int*>(p_s + BK * PST);
  // an int8 ring's scales: stage s's of K at 2 s BK, of V at (2 s + 1) BK;
  // route "mma" keeps them in bf16 (sc16, the first half of the area), as
  // bulk copies bring them
  constexpr bool MMA8 = Q8 && DM > 0;
  float* sc_s = reinterpret_cast<float*>(tags_s + S * BK);
  bf16* sc16 = reinterpret_cast<bf16*>(sc_s);
  int* list_s = reinterpret_cast<int*>(sc_s + (Q8 ? 2 * S * BK : 0));
  float* coef_s = reinterpret_cast<float*>(list_s + kMaxListed);
  int* scratch_s = reinterpret_cast<int*>(coef_s + MAXG * kCoef);
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch_s + 4);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;  // rank in the cluster
  const int h = blockIdx.y;
  const int gchunks = (p.g + kMaxGroup - 1) / kMaxGroup;
  const int b = blockIdx.z / gchunks;
  const int g0 = (blockIdx.z % gchunks) * kMaxGroup;
  const int gn = min(MAXG, p.g - g0);  // query rows of this block
  const int bh = b * p.hkv + h;
  const bool cluster = p.splits > 1;

  const int qp = p.q_pos != nullptr ? p.q_pos[(size_t)b * p.qp_stride] : p.q_pos_value;
  const int* sp = p.slot_pos + (size_t)b * p.sp_stride;
  const int tiles_total = (p.c + BK - 1) / BK;
  auto live = [&](int spos) {
    return spos <= qp && (p.window == 0 || spos > qp - p.window);
  };

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      hg::mbar_init(&full[s], 33);      // the producer's expect_tx and its 32 lanes' tags
      // one arrival a consumer warp (route "mma": the four warps of a tile)
      hg::mbar_init(&empty[s], DM > 0 ? kWarps / 2 : kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The tiles this block reads.  A ring of up to kMaxListed tiles: the row's
  // tiles that hold a live slot are listed (every block of the row scans the
  // tags) and the splits share them out evenly.  A longer ring: the split's
  // own range of tiles.  The first tags and the query rows are loaded before
  // anything waits.
  const bool listed = tiles_total <= kMaxListed;
  constexpr int kLoads = 16;                                // tags in flight a thread
  constexpr int kQLoads = (MAXG * 256 + kThreads - 1) / kThreads;  // query elements a thread
  int tag[kLoads];
  if (listed) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = tid + u * kThreads;
      tag[u] = c < p.c ? __ldg(sp + c) : INT_MAX;
    }
  }
  float qv[kQLoads];
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = tid + u * kThreads, g = i / D;
    qv[u] = 0.0f;
    if (i < MAXG * D && g < gn) {
      const size_t qi = ((size_t)b * p.hq + (size_t)h * p.g + g0 + g) * D + i % D;
      qv[u] = p.q_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p.q)[qi])
                       : reinterpret_cast<const float*>(p.q)[qi];
    }
  }
  if (listed)
    for (int i = tid; i < tiles_total; i += kThreads) list_s[i] = 0;
  __syncthreads();
  // the query rows, fp32 and scaled into base 2; rows past gn are zeros
#pragma unroll
  for (int u = 0; u < kQLoads; ++u)
    if (tid + u * kThreads < MAXG * D) q_s[tid + u * kThreads] = qv[u] * p.scale * kLog2e;
  int nk, k_begin = 0;
  if (listed) {
    for (int c0 = 0; c0 < p.c; c0 += kLoads * kThreads) {
      if (c0 != 0) {
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int c = c0 + tid + u * kThreads;
          tag[u] = c < p.c ? __ldg(sp + c) : INT_MAX;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (live(tag[u])) list_s[(c0 + tid + u * kThreads) / BK] = 1;
    }
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
      if (lane == 0) scratch_s[0] = n;
    }
    __syncthreads();
    const int nlive = scratch_s[0];
    const int per = (nlive + p.splits - 1) / p.splits;
    k_begin = min(split * per, nlive);
    nk = min(k_begin + per, nlive) - k_begin;
  } else {
    k_begin = min(split * p.tiles_per_split, tiles_total);
    nk = min(k_begin + p.tiles_per_split, tiles_total) - k_begin;
    __syncthreads();
  }
  // the i-th tile this block reads
  auto tile_at = [&](int i) { return listed ? list_s[k_begin + i] : k_begin + i; };

  if (warp == kWarps) {
    // producer: lane 0 issues the copies of K and V, every lane copies tags
    // (and an int8 ring's scales), those of the next tile loaded while this
    // one waits for its stage.  Route "mma" over an int8 ring: a whole
    // tile's scales come by two bulk copies beside K and V (bulk_scales),
    // kept in bf16: the lanes' loads of them held the kernel back, however
    // far ahead they were issued (measured by variants without them).
    int nxt[2] = {0, 0};
    float nsc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // the next tile's K and V scales
    auto bulk_tile = [&](int c0) { return MMA8 && p.bulk_scales && c0 + BK <= p.c; };
    auto load_tags = [&](int i) {
      const int c0 = tile_at(i) * BK;
      const bool bulk = bulk_tile(c0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        const bool in = e < BK && c0 + e < p.c;
        nxt[u] = in ? __ldg(sp + c0 + e) : INT_MAX;
        if (Q8 && !bulk) {
          const size_t si = (size_t)bh * p.c + c0 + e;
          nsc[0][u] = in ? __bfloat162float(p.k_scale[si]) : 0.0f;
          nsc[1][u] = in ? __bfloat162float(p.v_scale[si]) : 0.0f;
        }
      }
    };
    if (nk > 0) load_tags(0);
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      const int cur[2] = {nxt[0], nxt[1]};
      const float csc[2][2] = {{nsc[0][0], nsc[0][1]}, {nsc[1][0], nsc[1][1]}};
      if (i + 1 < nk) load_tags(i + 1);
      hg::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
      const int c0 = tile_at(i) * BK;
      const bool bulk = bulk_tile(c0);
      unsigned char* kd = ring + (size_t)s * 2 * tile_bytes;
      if (Q8 && p.lane_copy) {
        const size_t row0 = ((size_t)bh * p.c + c0) * D;
        const int rows = min(BK, p.c - c0);
        copy_rows_by_lanes(kd, static_cast<const int8_t*>(p.k) + row0, rows, D, BK, lane);
        copy_rows_by_lanes(kd + tile_bytes, static_cast<const int8_t*>(p.v) + row0, rows, D, BK,
                           lane);
        if (lane == 0) hg::mbar_arrive(&full[s]);  // in place of the bytes' arrival
      } else if (lane == 0) {
        hg::mbar_expect_tx(&full[s], 2 * tile_bytes + (bulk ? 4 * BK : 0));
        for (int blk = 0; blk < nblk; ++blk) {
          const int e0 = blk * (128 / (int)sizeof(T));
          hg::tma_load_3d(kd + blk * BK * 128, &p.k_map, &full[s], e0, c0, bh);
          hg::tma_load_3d(kd + tile_bytes + blk * BK * 128, &p.v_map, &full[s], e0, c0, bh);
        }
        if (bulk) {
          const size_t si = (size_t)bh * p.c + c0;
          bulk_copy(sc16 + 2 * s * BK, p.k_scale + si, 2 * BK, &full[s]);
          bulk_copy(sc16 + (2 * s + 1) * BK, p.v_scale + si, 2 * BK, &full[s]);
        }
      }
      // a slot past the ring has a tag that is never live
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        if (e < BK) {
          tags_s[s * BK + e] = cur[u];
          if constexpr (MMA8) {
            if (!bulk) {
              sc16[2 * s * BK + e] = __float2bfloat16(csc[0][u]);
              sc16[(2 * s + 1) * BK + e] = __float2bfloat16(csc[1][u]);
            }
          } else if constexpr (Q8) {
            sc_s[2 * s * BK + e] = csc[0][u];
            sc_s[(2 * s + 1) * BK + e] = csc[1][u];
          }
        }
      }
      // the lanes' stores of scales before a later bulk copy of the stage's
      if (MMA8 && !bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      hg::mbar_arrive(&full[s]);
    }
  } else if constexpr (DM > 0) {
    // route "mma" (bf16, D = DM): warps 4 t .. 4 t + 3 take the tiles
    // i = t mod 2, each its 16 slots; with an even number of stages a stage
    // always serves the same four warps, so that they wait for its phases in
    // order.  S^T = K Q^T and O^T += V^T P^T on
    // mma.sync m16n8k16 with the query rows as the 8 columns: K is the A
    // operand as stored (ldmatrix), V^T the A operand transposed on the way
    // in (ldmatrix.trans), Q^T the B operand in registers, and P^T (rounded
    // to bf16) the B operand by an 8 x 8 transpose of the score fragments
    // (movmatrix).  Rows past gn are zeros and are never stored.  Over an
    // int8 ring K and V^T come from registers (k8_scores, v8_products).
    static_assert(DM % 8 == 0, "head dims of route mma are multiples of 8");
    constexpr int KS = (DM + 15) / 16;  // k16 steps over D, and m16 tiles of O^T
    const int gid = lane >> 2, tig = lane & 3;
    const int wg = warp >> 2, slot0 = (warp & 3) * 16;
    uint32_t qf[KS][2];
    const bf16* qrow = reinterpret_cast<const bf16*>(p.q) +
                       ((size_t)b * p.hq + (size_t)h * p.g + g0 + gid) * DM;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (Q8) {  // the dims k8_scores reads K at: k_perm
        const int d0 = k_perm<KS>(tig, kk, 0);
        qf[kk][0] = gid < gn && d0 < DM ? *reinterpret_cast<const uint32_t*>(qrow + d0) : 0u;
        qf[kk][1] = gid < gn && d0 + 2 < DM ? *reinterpret_cast<const uint32_t*>(qrow + d0 + 2)
                                            : 0u;
      } else {
        qf[kk][0] = gid < gn ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * tig) : 0u;
        qf[kk][1] = gid < gn && 16 * kk + 8 < DM
                        ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8 + 2 * tig)
                        : 0u;
      }
    }
    const float scale = p.scale * kLog2e;
    float m_run[2] = {-INFINITY, -INFINITY};  // query rows 2 tig, 2 tig + 1
    float l_run[2] = {0.0f, 0.0f};
    float o[KS][4];  // O^T: dims 16 mt + gid (+ 8), rows 2 tig (+ 1)
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.0f;
    // this lane's ldmatrix rows: matrix lane / 8, row lane % 8 of it
    const int mi = lane >> 3, mr = lane & 7;

#pragma unroll 1
    for (int it = wg; it < nk; it += 2) {
      const int s = it % S;
      hg::mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* kt = ring + (size_t)s * 2 * tile_bytes;
      const unsigned char* vt = kt + tile_bytes;
      const int c0 = tile_at(it) * BK;
      // S^T (16 slots x 8 rows): c0, c1 slot gid, c2, c3 slot gid + 8; over
      // an int8 ring the fragments are built in registers from the tile's
      // bytes (k8_scores), else read by ldmatrix
      float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (Q8) {
        const bf16* ksc = sc16 + 2 * s * BK + slot0;
        k8_scores<KS>(sc, kt, BK, slot0 + gid, tig, __bfloat162float(ksc[gid]),
                      __bfloat162float(ksc[gid + 8]), qf);
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4];
          ldmatrix_x4<false>(a, piece(kt, BK, slot0 + (mi & 1) * 8 + mr, 2 * kk + (mi >> 1)));
          mma16816(sc, a, qf[kk][0], qf[kk][1]);
        }
      }
      const int* tg = tags_s + s * BK + slot0;
      const bool ok0 = c0 + slot0 + gid < p.c && live(tg[gid]);
      const bool ok1 = c0 + slot0 + gid + 8 < p.c && live(tg[gid + 8]);
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s0 = ok0 ? sc[e] * scale : -INFINITY;
        const float s1 = ok1 ? sc[2 + e] * scale : -INFINITY;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[e], mx);
        const float p0 = s0 == -INFINITY ? 0.0f : exp2f(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.0f : exp2f(s1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        // nothing live yet: keep the (zero) carry as it is
        alpha[e] = m_new == -INFINITY ? 1.0f : exp2f(m_run[e] - m_new);
        l_run[e] = l_run[e] * alpha[e] + sum;
        m_run[e] = m_new;
        sc[e] = p0;
        sc[2 + e] = p1;
      }
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
      }
      // P^T as the B operand: (row gid, slots 2 tig, 2 tig + 1) and + 8
      const uint32_t pb0 = transpose8x8(pack_bf16(sc[0], sc[1]));
      const uint32_t pb1 = transpose8x8(pack_bf16(sc[2], sc[3]));
      if constexpr (Q8) {
        const bf16* vsc = sc16 + (2 * s + 1) * BK + slot0 + 2 * tig;
        const float vs[4] = {__bfloat162float(vsc[0]), __bfloat162float(vsc[1]),
                             __bfloat162float(vsc[8]), __bfloat162float(vsc[9])};
        v8_products<KS>(o, vt, BK, slot0, gid, tig, vs, pb0, pb1);
      } else {
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          uint32_t a[4];  // V^T: dims 16 mt .. + 15 x the warp's 16 slots
          ldmatrix_x4<true>(a, piece(vt, BK, slot0 + (mi >> 1) * 8 + mr, 2 * mt + (mi & 1)));
          mma16816(o[mt], a, pb0, pb1);
        }
      }
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the warp's carry into the ring, once every warp is done with it
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
    float* pml = reinterpret_cast<float*>(ring);  // [kWarps][MAXG][2]
    float* pacc = pml + kWarps * MAXG * 2;        // [kWarps][MAXG][D]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * tig + e;
      if (r < MAXG) {
        if (gid == 0) {
          pml[(warp * MAXG + r) * 2] = m_run[e];
          pml[(warp * MAXG + r) * 2 + 1] = l_run[e];
        }
        if constexpr (Q8) {  // O^T's rows stand for the dims v_perm gives
#pragma unroll
          for (int mt = 0; mt < KS; ++mt) {
            const int dd = v_perm<KS>(gid, mt, 0);
            if (dd < DM)
              *reinterpret_cast<float2*>(pacc + (warp * MAXG + r) * DM + dd) =
                  make_float2(o[mt][e], o[mt][2 + e]);
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < KS; ++mt) {
            pacc[(warp * MAXG + r) * DM + 16 * mt + gid] = o[mt][e];
            if (16 * mt + 8 < DM) pacc[(warp * MAXG + r) * DM + 16 * mt + gid + 8] = o[mt][2 + e];
          }
        }
      }
    }
  } else {
    // consumer warp: slots [warp spw, warp spw + spw) of every tile; lane
    // (part, j) reads the 16-byte pieces part, part + parts, ... of slot j
    const int spw = BK / kWarps;      // 16, 8 or 4
    const int parts = 32 / spw;
    const int j = lane % spw, part = lane / spw;
    const int slot = warp * spw + j;
    const int nch = (D * (int)sizeof(T) + 15) / 16;  // an int8 row at D % 16: a half piece
    float m_run[MAXG], l_run[MAXG], acc[MAXG][NP][2];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      m_run[g] = -INFINITY;
      l_run[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[g][i][0] = acc[g][i][1] = 0.0f;
    }
    float* pw = p_s + warp * spw * PST;  // this warp's probabilities, a slot a row

#pragma unroll 1
    for (int it = 0; it < nk; ++it) {
      const int s = it % S;
      hg::mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* kt = ring + (size_t)s * 2 * tile_bytes;
      const unsigned char* vt = kt + tile_bytes;
      const int c0 = tile_at(it) * BK;

      // scores of slot `slot` against every query row (entries past MAXG stay 0)
      float sc[PST];
#pragma unroll
      for (int g = 0; g < PST; ++g) sc[g] = 0.0f;
      for (int ch = part; ch < nch; ch += parts) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kt + (ch >> 3) * (BK * 128) + slot * 128 + (((ch & 7) ^ (slot & 7)) << 4));
        float kf[E];
        if constexpr (Q8) {
          const float ks = sc_s[2 * s * BK + slot];
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int x = 0; x < 16; ++x) kf[x] = deq(w[x >> 2], x & 3, ks);
        } else if constexpr (sizeof(T) == 2) {
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 f = __bfloat1622float2(k2[x]);
            kf[2 * x] = f.x;
            kf[2 * x + 1] = f.y;
          }
        } else {
          kf[0] = __uint_as_float(raw.x);
          kf[1] = __uint_as_float(raw.y);
          kf[2] = __uint_as_float(raw.z);
          kf[3] = __uint_as_float(raw.w);
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float* qr = q_s + g * D + ch * E;
          float a = sc[g];
#pragma unroll
          for (int x = 0; x < E; x += 4) {
            if (Q8 && ch * E + x >= D) break;  // past D: the query row ends
            const float4 q4 = *reinterpret_cast<const float4*>(qr + x);
            a = fmaf(q4.x, kf[x], a);
            a = fmaf(q4.y, kf[x + 1], a);
            a = fmaf(q4.z, kf[x + 2], a);
            a = fmaf(q4.w, kf[x + 3], a);
          }
          sc[g] = a;
        }
      }
      const bool ok = live(tags_s[s * BK + slot]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        for (int o = spw; o < 32; o <<= 1) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
        if (!ok) sc[g] = -INFINITY;
      }

      // online softmax over the warp's slots: lanes of one slot hold the same
      // scores, so shuffles over the lanes of one part give the warp's max and sum
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float mx = sc[g];
        for (int o = 1; o < spw; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[g], mx);
        const float pj = sc[g] == -INFINITY ? 0.0f : exp2f(sc[g] - m_new);
        float sum = pj;
        for (int o = 1; o < spw; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        // nothing live yet: keep the (zero) carry as it is
        const float alpha = m_new == -INFINITY ? 1.0f : exp2f(m_run[g] - m_new);
        l_run[g] = l_run[g] * alpha + sum;
        m_run[g] = m_new;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[g][i][0] *= alpha;
          acc[g][i][1] *= alpha;
        }
        sc[g] = pj;
      }
      if (part == 0) {
#pragma unroll
        for (int g = 0; g < PST; g += 4)
          *reinterpret_cast<float4*>(pw + j * PST + g) =
              make_float4(sc[g], sc[g + 1], sc[g + 2], sc[g + 3]);
      }
      __syncwarp();

      // P.V: lane owns element pairs 2 lane + 64 i of every query row
      for (int jj = 0; jj < spw; ++jj) {
        const int row = warp * spw + jj;
        float pr[PST];
#pragma unroll
        for (int g = 0; g < PST; g += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(pw + jj * PST + g);
          pr[g] = v4.x;
          pr[g + 1] = v4.y;
          pr[g + 2] = v4.z;
          pr[g + 3] = v4.w;
        }
        const float vs = Q8 ? sc_s[(2 * s + 1) * BK + row] : 0.0f;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int e = 2 * lane + 64 * i;
          if (e < D) {
            const int byte = e * (int)sizeof(T);
            const unsigned char* vp = vt + (byte >> 7) * (BK * 128) + row * 128 +
                                      ((((byte & 127) >> 4) ^ (row & 7)) << 4) + (byte & 15);
            float2 v2;
            if constexpr (Q8) {
              const uint32_t two = *reinterpret_cast<const uint16_t*>(vp);
              v2 = make_float2(deq(two, 0, vs), deq(two, 1, vs));
            } else if constexpr (sizeof(T) == 2)
              v2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp));
            else
              v2 = *reinterpret_cast<const float2*>(vp);
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              acc[g][i][0] = fmaf(pr[g], v2.x, acc[g][i][0]);
              acc[g][i][1] = fmaf(pr[g], v2.y, acc[g][i][1]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the warp's carry into the ring, once every warp is done with it
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
    float* pml = reinterpret_cast<float*>(ring);  // [kWarps][MAXG][2]
    float* pacc = pml + kWarps * MAXG * 2;        // [kWarps][MAXG][D]
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        pml[(warp * MAXG + g) * 2] = m_run[g];
        pml[(warp * MAXG + g) * 2 + 1] = l_run[g];
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int e = 2 * lane + 64 * i;
      if (e < D) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          *reinterpret_cast<float2*>(pacc + (warp * MAXG + g) * D + e) =
              make_float2(acc[g][i][0], acc[g][i][1]);
      }
    }
  }
  __syncthreads();

  // The block's carry: the warps' merged in warp order (weights 2^(m - M),
  // then the sums).  One block a row: that is the output.  A cluster: each
  // block's carry stays in its ring, and after a cluster barrier every block
  // merges its share of the outputs over the ranks, in rank order.
  const float* pml = reinterpret_cast<const float*>(ring);
  const float* pacc = pml + kWarps * MAXG * 2;
  float* bml = reinterpret_cast<float*>(ring) + kWarps * MAXG * (D + 2);  // [MAXG][2]
  float* bacc = bml + MAXG * 2;                                           // [MAXG][D]
  const int splits = p.splits;
  if (tid < gn) {
    const int g = tid;
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, pml[(w * MAXG + g) * 2]);
    float lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float m = pml[(w * MAXG + g) * 2];
      const float x = m == -INFINITY ? 0.0f : exp2f(m - mmax);
      coef_s[g * kCoef + w] = x;
      lsum += x * pml[(w * MAXG + g) * 2 + 1];
    }
    bml[2 * g] = mmax;
    bml[2 * g + 1] = lsum;
    coef_s[g * kCoef + kWarps + kMaxSplits] = 1.0f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < gn * D / 2; e += kThreads) {
    const int g = 2 * e / D, dd = 2 * e % D;
    const float* cf = coef_s + g * kCoef;
    float2 o = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(pacc + (w * MAXG + g) * D + dd);
      o.x += cf[w] * v.x;
      o.y += cf[w] * v.y;
    }
    if (cluster) {
      *reinterpret_cast<float2*>(bacc + g * D + dd) = o;
    } else {
      const float iv = cf[kWarps + kMaxSplits];
      const size_t oi = ((size_t)b * p.hq + (size_t)h * p.g + g0 + g) * D + dd;
      if (p.q_bf16)
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(p.out) + oi) =
            __floats2bfloat162_rn(o.x * iv, o.y * iv);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + oi) =
            make_float2(o.x * iv, o.y * iv);
    }
  }
  if (!cluster) return;

  hg::cluster_sync();  // every block's carry is in its shared memory
  // every row's weight of each rank and 1 / l, the ranks' (m, l) loaded at once
  if (tid < gn) {
    const int g = tid;
    float2 v[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits)
        v[q] = *reinterpret_cast<const float2*>(hg::cluster_ptr(bml + 2 * g, q, true));
    float mmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) mmax = fmaxf(mmax, v[q].x);
    float lsum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) {
        const float x = v[q].x == -INFINITY ? 0.0f : exp2f(v[q].x - mmax);
        coef_s[g * kCoef + kWarps + q] = x;
        lsum += x * v[q].y;
      }
    coef_s[g * kCoef + kWarps + kMaxSplits] = 1.0f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // this block's share of the gn x D outputs, two a thread
  const int pairs = gn * D / 2;
  const int share = (pairs + splits - 1) / splits;
  const int e_end = min(pairs, (split + 1) * share);
  for (int e = split * share + tid; e < e_end; e += kThreads) {
    const int g = 2 * e / D, dd = 2 * e % D;
    const float* cf = coef_s + g * kCoef + kWarps;
    float2 v[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits)
        v[q] = *reinterpret_cast<const float2*>(hg::cluster_ptr(bacc + g * D + dd, q, true));
    float2 o = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) {
        o.x += cf[q] * v[q].x;
        o.y += cf[q] * v[q].y;
      }
    const float iv = cf[kMaxSplits];
    const size_t oi = ((size_t)b * p.hq + (size_t)h * p.g + g0 + g) * D + dd;
    if (p.q_bf16)
      *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(p.out) + oi) =
          __floats2bfloat162_rn(o.x * iv, o.y * iv);
    else
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + oi) =
          make_float2(o.x * iv, o.y * iv);
  }
  hg::cluster_sync();  // no block leaves while another reads its shared memory
}

// Sets the kernel's shared-memory attributes on the current device: as much
// dynamic shared memory as a block may opt in to, the largest carveout.
template <typename T, int MAXG, int NP, int DM>
int prepare() {
  auto kernel = decode_attention_kernel<T, MAXG, NP, DM>;
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
  return (int)err;
}

template <typename T, int MAXG, int NP, int DM>
int launch(const Params& p, cudaStream_t stream) {
  const int gchunks = (p.g + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(p.splits, p.hkv, p.b * gchunks);
  const size_t smem = smem_bytes(MAXG, p.d, p.bk, p.stages, (int)sizeof(T));
  if (p.splits == 1) {
    decode_attention_kernel<T, MAXG, NP, DM><<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, MAXG, NP, DM>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The kernel instance of (T, query rows g, head dim d): MAXG rows (1, 4, 5 or
// 8) and NP element pairs a lane (1, 2 or 4).
int maxg_for(int g) {
  const int c = g < kMaxGroup ? g : kMaxGroup;
  return c <= 1 ? 1 : c <= 4 ? 4 : c == 5 ? 5 : 8;
}

#define DECODE_INSTANCE(F, T, g, d, ...)                                   \
  do {                                                                     \
    const int np_ = (d) <= 64 ? 1 : (d) <= 128 ? 2 : 4;                    \
    switch (maxg_for(g) * 8 + np_) {                                       \
      case 9: return F<T, 1, 1, 0>(__VA_ARGS__);                           \
      case 10: return F<T, 1, 2, 0>(__VA_ARGS__);                          \
      case 12: return F<T, 1, 4, 0>(__VA_ARGS__);                          \
      case 33: return F<T, 4, 1, 0>(__VA_ARGS__);                          \
      case 34: return F<T, 4, 2, 0>(__VA_ARGS__);                          \
      case 36: return F<T, 4, 4, 0>(__VA_ARGS__);                          \
      case 41: return F<T, 5, 1, 0>(__VA_ARGS__);                          \
      case 42: return F<T, 5, 2, 0>(__VA_ARGS__);                          \
      case 44: return F<T, 5, 4, 0>(__VA_ARGS__);                          \
      case 65: return F<T, 8, 1, 0>(__VA_ARGS__);                          \
      case 66: return F<T, 8, 2, 0>(__VA_ARGS__);                          \
      default: return F<T, 8, 4, 0>(__VA_ARGS__);                          \
    }                                                                      \
  } while (0)

// Route "mma" (bf16 q, a bf16 or int8 cache KV): eight query rows a block, D
// one of 16, 32, 64, 72, 80, 96, 112, 128, 256.
#define DECODE_MMA_INSTANCE(F, KV, d, ...)                                 \
  do {                                                                     \
    switch (d) {                                                           \
      case 16: return F<KV, 8, 1, 16>(__VA_ARGS__);                        \
      case 32: return F<KV, 8, 1, 32>(__VA_ARGS__);                        \
      case 64: return F<KV, 8, 1, 64>(__VA_ARGS__);                        \
      case 72: return F<KV, 8, 1, 72>(__VA_ARGS__);                        \
      case 80: return F<KV, 8, 1, 80>(__VA_ARGS__);                        \
      case 96: return F<KV, 8, 1, 96>(__VA_ARGS__);                        \
      case 112: return F<KV, 8, 1, 112>(__VA_ARGS__);                      \
      case 128: return F<KV, 8, 1, 128>(__VA_ARGS__);                      \
      case 256: return F<KV, 8, 1, 256>(__VA_ARGS__);                      \
      default: return -1;                                                  \
    }                                                                      \
  } while (0)

template <typename T>
int prepare_t(int g, int d) {
  DECODE_INSTANCE(prepare, T, g, d);
}

template <typename T>
int launch_t(const Params& p, cudaStream_t stream) {
  DECODE_INSTANCE(launch, T, p.g, p.d, p, stream);
}

}  // namespace

extern "C" {

// Sets the shared-memory attributes on the current device of the kernel
// instance of (route 1 "mma" / 0 "fma", kv dtype 0 fp32 / 1 bf16 / 2 int8, head dim d,
// group size g) with the tiling of bk slots a tile and `stages`
// (kernels/decode_attention/kernel.py plans them), which
// decode_attention_launch needs.  Call it once for each device, route, cache
// type, head dim and group size before launching.  Returns 0, a CUDA error,
// or -1 for arguments it does not take.
int decode_attention_prepare(int route, int kv_dtype, int d, int g, int bk, int stages) {
  if (d <= 0 || d > 256 || d % 8 != 0 || g < 1 || (bk != 16 && bk != 32 && bk != 64) ||
      stages < kMinStages || stages > kMaxStages)
    return -1;
  if (route == 1) {
    if ((kv_dtype != 1 && kv_dtype != 2) || bk != 64 || stages % 2 != 0) return -1;
    if (kv_dtype == 2) DECODE_MMA_INSTANCE(prepare, int8_t, d);
    DECODE_MMA_INSTANCE(prepare, bf16, d);
  }
  if (kv_dtype == 2) return prepare_t<int8_t>(g, d);
  return kv_dtype == 1 ? prepare_t<bf16>(g, d) : prepare_t<float>(g, d);
}

// Launches the kernel on `stream`, one launch, no scratch; returns
// cudaGetLastError() (0 = launched), or -1 for arguments it does not take.
// slot_pos is (C,) (sp_stride 0) or (B, C) (sp_stride c); q_pos is null (one
// position q_pos_value), or (B,) (qp_stride 1), or one value (qp_stride 0).
// Route 1 "mma": q bf16, the caches bf16 or int8, bk 64, D one of 16, 32, 64,
// 72, 80, 96, 112, 128, 256; route 0 "fma": q and out fp32 (q_dtype 0) or bf16
// (1), the caches fp32, bf16 or int8 (kv_dtype 0, 1, 2), D a multiple of 8 up
// to 256; with a tiling decode_attention_prepare was called for.  An int8
// cache takes its scales k_scale, v_scale (B, Hkv, C) bf16, any other cache
// null ones.  All tensors are contiguous, the caches 16-byte aligned;
// `splits` (1 to 8) blocks of a cluster share each row's live tiles (a ring
// of more than 1024 tiles: tiles_per_split tiles each).
int decode_attention_launch(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const int* slot_pos, const int* q_pos, void* out,
                            int b, int hq, int hkv, int c, int d, int sp_stride, int qp_stride,
                            int q_pos_value, int window, float scale, int q_dtype, int kv_dtype,
                            int route, int bk, int stages, int tiles_per_split, int splits,
                            void* stream) {
  if (hkv < 1 || hq % hkv != 0 || d <= 0 || d > 256 || d % 8 != 0 || splits < 1 ||
      splits > kMaxSplits || b < 1 || c < 1 || (bk != 16 && bk != 32 && bk != 64) ||
      stages < kMinStages || stages > kMaxStages || tiles_per_split < 1 || kv_dtype < 0 ||
      kv_dtype > 2)
    return -1;
  if (route == 1 && (q_dtype != 1 || kv_dtype == 0 || bk != 64 || stages % 2 != 0)) return -1;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) return -1;
  const int elem = kv_dtype == 2 ? 1 : kv_dtype == 1 ? 2 : 4;
  Params p;
  const long long bh = (long long)b * hkv;
  p.lane_copy = elem == 1 && d % 16 != 0;
  // a tile's scales (64 bf16 of each) by bulk copies: their rows start on
  // 16 bytes (C a multiple of 8) and TMA brings K and V
  p.bulk_scales = route == 1 && elem == 1 && !p.lane_copy && c % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_scale) % 16 == 0;
  if (!p.lane_copy && (hg::tensor_map_3d(&p.k_map, k, elem, d, c, bh, bk) != 0 ||
                       hg::tensor_map_3d(&p.v_map, v, elem, d, c, bh, bk) != 0))
    return -1;
  p.k = k; p.v = v;
  p.k_scale = static_cast<const bf16*>(k_scale);
  p.v_scale = static_cast<const bf16*>(v_scale);
  p.q = q; p.slot_pos = slot_pos; p.q_pos = q_pos; p.out = out;
  p.b = b; p.hq = hq; p.hkv = hkv; p.c = c; p.d = d; p.g = hq / hkv;
  p.sp_stride = sp_stride; p.qp_stride = qp_stride; p.q_pos_value = q_pos_value;
  p.window = window; p.scale = scale; p.q_bf16 = q_dtype == 1;
  p.bk = bk; p.stages = stages; p.tiles_per_split = tiles_per_split; p.splits = splits;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1 && kv_dtype == 2) DECODE_MMA_INSTANCE(launch, int8_t, d, p, s);
  if (route == 1) DECODE_MMA_INSTANCE(launch, bf16, d, p, s);
  if (kv_dtype == 2) return launch_t<int8_t>(p, s);
  return kv_dtype == 1 ? launch_t<bf16>(p, s) : launch_t<float>(p, s);
}

}  // extern "C"
