// Quantization of a layer's new K and V rows into the int8 ring, for Hopper
// (sm_90a).
//
//   scale        = max(max_d |x[d]|, 1e-6) / 127              (fp32)
//   ring[slot]   = clip(round_half_even(x[d] / scale), -127, 127)   (int8)
//   scales[slot] = bf16(scale)
//
// for every (batch row b, kv head h, new token t) of K and of V, at slot
// position % C of row b's ring.  Positions are one value for all rows (the
// lock-step decode step, T = 1) or (B, T) on the device (the slot-batched
// decode step and a chunk of a prompt).
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
// 32.8 KB read and 16.6 KB written, about 15 ns, far below a launch.
//
// Design: one warp a row of D <= 256 elements, each lane up to eight of them
// (lane, lane + 32, ...: coalesced), the amax by shuffles, no shared memory;
// four warps a block, the grid's y the tensor (0 K, 1 V).

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
  int b, hkv, t, c, d;
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) kv_quant_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int which = blockIdx.y;
  if (row >= p.b * p.hkv * p.t) return;
  const int tt = row % p.t, h = (row / p.t) % p.hkv, b = row / (p.t * p.hkv);
  const T* src = reinterpret_cast<const T*>(p.src[which]) + b * p.sb[which] +
                 h * p.sh[which] + tt * p.st[which];
  float x[kMaxPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    float v = 0.0f;
    if (e < p.d) {
      if constexpr (sizeof(T) == 2)
        v = __bfloat162float(src[e]);
      else
        v = src[e];
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
// 0 < D <= 256, positions >= 0.
int kv_quant_launch(const void* k_new, const void* v_new, long long k_sb, long long k_sh,
                    long long k_st, long long v_sb, long long v_sh, long long v_st,
                    void* k_ring, void* v_ring, void* k_scales, void* v_scales,
                    const int* positions, int pos_value, int b, int hkv, int t, int c, int d,
                    int src_dtype, void* stream) {
  if (b < 1 || hkv < 1 || t < 1 || c < 1 || d < 1 || d > 32 * kMaxPerLane || pos_value < 0)
    return -1;
  Params p;
  p.src[0] = k_new; p.src[1] = v_new;
  p.sb[0] = k_sb; p.sh[0] = k_sh; p.st[0] = k_st;
  p.sb[1] = v_sb; p.sh[1] = v_sh; p.st[1] = v_st;
  p.ring[0] = static_cast<int8_t*>(k_ring); p.ring[1] = static_cast<int8_t*>(v_ring);
  p.scales[0] = static_cast<bf16*>(k_scales); p.scales[1] = static_cast<bf16*>(v_scales);
  p.positions = positions; p.pos_value = pos_value;
  p.b = b; p.hkv = hkv; p.t = t; p.c = c; p.d = d;
  const long long rows = (long long)b * hkv * t;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps), 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (src_dtype == 1)
    kv_quant_kernel<bf16><<<grid, 32 * kWarps, 0, s>>>(p);
  else if (src_dtype == 0)
    kv_quant_kernel<float><<<grid, 32 * kWarps, 0, s>>>(p);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // extern "C"
