// Quantization of a layer's new K and V rows into the int8 ring, for Hopper
// (sm_90a), with the rotary embedding of K folded in.
//
//   k            = rope(k_new)  where sin and cos are given        (K only)
//   scale        = max(max_d |x[d]|, 1e-6) / 127              (fp32)
//   ring[slot]   = clip(round_half_even(x[d] / scale), -127, 127)   (int8)
//   scales[slot] = bf16(scale)
//
// for every (batch row b, kv head h, new token t) of K and of V, at slot
// position % C of row b's ring.  Positions are one value for all rows (the
// lock-step decode step, T = 1) or (B, T) on the device (the slot-batched
// decode step and a chunk of a prompt).
//
// The rope is models/layers.apply_rope as PyTorch runs it on the card: the
// row in fp32, its head dim split in halves (not interleaved), x1 cos - x2
// sin and x2 cos + x1 sin with each product and the sum rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn: no FMA contraction), then rounded to the
// row's type (bf16 to nearest even, fp32 as it is) before it is quantized.
// The int8 serving paths call it on the projection's K before the rope, so
// that apply_rope's chain of about nine elementwise launches a layer (a
// cast, four products, a difference, a sum, a concatenation, a cast back),
// whose only consumer was this kernel, runs inside its one launch.
//
// Replaces no TPU kernel: the reference quantizes in jnp
// (src/repro/models/transformer.py, _quantize_kv, then a scatter), which in
// plain PyTorch is about ten launches a tensor.  Here it is one launch a layer
// a step, for K and V together.  Bit for bit the function of
// kernels/kv_quant/ref.py: the amax is exact, both divisions are IEEE
// round-to-nearest (__fdiv_rn, whatever -prec-div says; the elements are
// divided by the fp32 scale, not the stored one), rintf rounds half to even
// as torch.round, the stored scale is rounded to nearest even.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  It reads 2 B Hkv T D
// elements of the new rows and writes half or a quarter of that in int8 plus
// the scales: at a decode step of qwen3-14b (B 8, Hkv 8, T 1, D 128, bf16)
// 32.8 KB read and 16.6 KB written, about 15 ns, far below a launch; the
// rope's tables add B T D 4 bytes (the products are a few hundred
// operations a row).
//
// Design: one warp a row of D <= 256 elements, each lane up to eight of them
// (lane, lane + 32, ...: coalesced), the amax by shuffles, no shared memory;
// four warps a block, the grid's y the tensor (0 K, 1 V).  The rope's other
// half of a K element is loaded by the same lane (from L1: the warp has
// read the row), so no head dim needs its halves in one lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kMaxPerLane = 8;  // D <= 256

struct Params {
  const void* src[2];      // new K, V rows: (B, Hkv, T, D) at element strides below
  long long sb[2], sh[2], st[2];
  int8_t* ring[2];         // (B, Hkv, C, D) int8, contiguous
  bf16* scales[2];         // (B, Hkv, C) bf16, contiguous
  const int* positions;    // (B, T) int32, or null: pos_value for every row
  int pos_value;
  const float* sin;        // K's rope: (B, T, D / 2) fp32 at strides (rs_b, rs_t, 1), or null
  const float* cos;
  long long rs_b, rs_t;
  int b, hkv, t, c, d;
};

// ROPE: K rotated by p.sin, p.cos (a compile-time instance, so that the rows
// without a rope run the loop they ran before it was folded in)
template <typename T, bool ROPE>
__global__ void __launch_bounds__(32 * kWarps) kv_quant_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int which = blockIdx.y;
  if (row >= p.b * p.hkv * p.t) return;
  const int tt = row % p.t, h = (row / p.t) % p.hkv, b = row / (p.t * p.hkv);
  const T* src = reinterpret_cast<const T*>(p.src[which]) + b * p.sb[which] +
                 h * p.sh[which] + tt * p.st[which];
  auto load = [&](int e) {
    if constexpr (sizeof(T) == 2)
      return __bfloat162float(src[e]);
    else
      return src[e];
  };
  const int half = p.d / 2;
  const size_t rs = ROPE ? (size_t)b * p.rs_b + (size_t)tt * p.rs_t : 0;
  float x[kMaxPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    float v = 0.0f;
    if (e < p.d) {
      v = load(e);
      if (ROPE && which == 0) {
        const bool lo = e < half;
        const int j = lo ? e : e - half;
        const float other = load(lo ? e + half : j);
        const float c = p.cos[rs + j], s = p.sin[rs + j];
        v = lo ? __fsub_rn(__fmul_rn(v, c), __fmul_rn(other, s))
               : __fadd_rn(__fmul_rn(v, c), __fmul_rn(other, s));
        if constexpr (sizeof(T) == 2) v = __bfloat162float(__float2bfloat16_rn(v));
      }
    }
    x[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  const int pos = p.positions != nullptr ? p.positions[b * p.t + tt] : p.pos_value;
  const size_t slot = ((size_t)b * p.hkv + h) * p.c + pos % p.c;
  int8_t* dst = p.ring[which] + slot * p.d;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < p.d) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(x[i], scale)), -127.0f), 127.0f);
      dst[e] = (int8_t)(int)q;
    }
  }
  if (lane == 0) p.scales[which][slot] = __float2bfloat16_rn(scale);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched) or -1 for
// arguments it does not take.  k_new, v_new (B, Hkv, T, D) fp32 (src_dtype 0)
// or bf16 (1) at element strides (sb, sh, st) each, the last dimension
// contiguous; rings (B, Hkv, C, D) int8 and scales (B, Hkv, C) bf16,
// contiguous; positions (B, T) int32, or null and pos_value for every row;
// sin, cos: K's rope tables, (B, T, D / 2) fp32 at element strides (rs_b,
// rs_t, 1) (0 where one row serves all), or both null for no rope;
// 0 < D <= 256 (even with a rope), positions >= 0.
int kv_quant_launch(const void* k_new, const void* v_new, long long k_sb, long long k_sh,
                    long long k_st, long long v_sb, long long v_sh, long long v_st,
                    void* k_ring, void* v_ring, void* k_scales, void* v_scales,
                    const int* positions, int pos_value, const float* sin, const float* cos,
                    long long rs_b, long long rs_t, int b, int hkv, int t, int c, int d,
                    int src_dtype, void* stream) {
  if (b < 1 || hkv < 1 || t < 1 || c < 1 || d < 1 || d > 32 * kMaxPerLane || pos_value < 0)
    return -1;
  if ((sin == nullptr) != (cos == nullptr) || (sin != nullptr && d % 2 != 0)) return -1;
  Params p;
  p.src[0] = k_new; p.src[1] = v_new;
  p.sb[0] = k_sb; p.sh[0] = k_sh; p.st[0] = k_st;
  p.sb[1] = v_sb; p.sh[1] = v_sh; p.st[1] = v_st;
  p.ring[0] = static_cast<int8_t*>(k_ring); p.ring[1] = static_cast<int8_t*>(v_ring);
  p.scales[0] = static_cast<bf16*>(k_scales); p.scales[1] = static_cast<bf16*>(v_scales);
  p.positions = positions; p.pos_value = pos_value;
  p.sin = sin; p.cos = cos; p.rs_b = rs_b; p.rs_t = rs_t;
  p.b = b; p.hkv = hkv; p.t = t; p.c = c; p.d = d;
  const long long rows = (long long)b * hkv * t;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps), 2);
  cudaStream_t s = (cudaStream_t)stream;
  const bool rope = sin != nullptr;
  if (src_dtype == 1 && rope)
    kv_quant_kernel<bf16, true><<<grid, 32 * kWarps, 0, s>>>(p);
  else if (src_dtype == 1)
    kv_quant_kernel<bf16, false><<<grid, 32 * kWarps, 0, s>>>(p);
  else if (src_dtype == 0 && rope)
    kv_quant_kernel<float, true><<<grid, 32 * kWarps, 0, s>>>(p);
  else if (src_dtype == 0)
    kv_quant_kernel<float, false><<<grid, 32 * kWarps, 0, s>>>(p);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // extern "C"
