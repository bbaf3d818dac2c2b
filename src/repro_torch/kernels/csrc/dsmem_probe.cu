// Probe of the distributed shared memory (DSMEM) rate of a Hopper card, for
// sm_90a: what one SM reads of another SM's shared memory in a second, over
// the SM-to-SM network of a thread-block cluster.
//
// Replaces no TPU kernel.  It measures the one number of the card as an ICCA
// chip that no datasheet gives: ``ChipConfig.link_bw`` of ``h100_sxm()``
// (chip/h100.py), one inter-core link in one direction, which the planner's
// cost model divides by (core/cost_model.py).
//
// Design: clusters of 2 blocks, each block on an SM of its own (it asks for
// more shared memory than half an SM holds), as many clusters as the card
// holds at once.  Each block fills 64 KB of its shared memory with words of
// its cluster rank and their index, waits at a cluster barrier, and then
// reads its peer's 64 KB, `rounds` times over, in 16-byte loads
// (ld.shared::cluster.v4 at the address mapa gives), eight loads in flight a
// thread.  The words it read are summed (mod 2^32) and added to sums[block]:
// the host holds each sum against the peer's words, so a read that did not
// reach the peer's memory shows.  A last cluster barrier keeps every block
// resident until its peer has read it.  The rate of one SM is the bytes one
// block read over the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLoadsInFlight = 8;                        // 16-byte loads a thread a round
constexpr int kPieces = kThreads * kLoadsInFlight;       // 4096 pieces: 64 KB a block
constexpr int kWords = kPieces * 4;
// more than half of an SM's 228 KB, so that no SM holds two blocks and the
// two blocks of a cluster lie on two SMs
constexpr int kSmemBytes = 120 * 1024;

// word i of the buffer of the block of cluster rank `rank` (the host's
// expected_sums computes the same)
__device__ __forceinline__ unsigned word_of(unsigned rank, unsigned i) {
  return rank * 0x9E3779B9u + i * 0x85EBCA6Bu + 1u;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    dsmem_probe_kernel(unsigned* sums, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* buf = reinterpret_cast<unsigned*>(smem);
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  for (int i = threadIdx.x; i < kWords; i += kThreads) buf[i] = word_of(rank, i);
  cluster_barrier();  // both buffers are written before either is read

  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(local), "r"(rank ^ 1u));
  unsigned acc = 0;
  for (int r = 0; r < rounds; ++r) {
    uint4 v[kLoadsInFlight];
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) {
      const uint32_t addr = peer + 16u * (threadIdx.x + j * kThreads);
      asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[j].x), "=r"(v[j].y), "=r"(v[j].z), "=r"(v[j].w)
                   : "r"(addr));
    }
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) acc += v[j].x + v[j].y + v[j].z + v[j].w;
  }
  atomicAdd(sums + blockIdx.x, acc);
  cluster_barrier();  // no block leaves while its peer still reads its memory
}

cudaError_t prepare() {
  return cudaFuncSetAttribute(dsmem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace

extern "C" {

// Bytes of shared memory each block fills and its peer reads a round.
int dsmem_probe_buffer_bytes() { return kPieces * 16; }

// Clusters of 2 blocks the card holds at once, or -(CUDA error).
int dsmem_probe_max_clusters() {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)dsmem_probe_kernel, &cfg);
  return err != cudaSuccess ? -(int)err : clusters;
}

// Launches `clusters` clusters of 2 blocks on `stream`, each block reading its
// peer's buffer `rounds` times and adding the sum of the words it read to
// sums[block] (uint32, 2 * clusters of them, zeroed by the caller).  Returns
// cudaGetLastError() (0 = launched), or -1 for arguments it does not take.
int dsmem_probe_launch(unsigned* sums, int clusters, int rounds, void* stream) {
  if (sums == nullptr || clusters < 1 || rounds < 1) return -1;
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  dsmem_probe_kernel<<<dim3(2 * clusters), kThreads, kSmemBytes, (cudaStream_t)stream>>>(sums,
                                                                                       rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
