// Shared pieces of the clustered attention kernels K2
// (batched_decode_attention.cu) and K3 (verify_attention.cu).
//
// Both kernels give each (head, stream) pair one thread-block cluster of
// kCluster blocks.  Every block reads its stream's depth from device memory
// and takes an equal share, in whole tiles, of the rows to attend
// (share_rows); each warp streams its tiles through its own cp.async ring;
// the blocks' partials (m, l, acc) are merged in rank order through
// distributed shared memory under one split cluster barrier, with no global
// scratch.  K1 (decode_attention.cu) follows the same design with its own
// copy of these helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace llmvox_attn {

constexpr int kCluster = 8;               // blocks per (head, stream)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Vec;          // elements in 16 bytes
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte vector of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // a bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// split cluster barrier: arrive (relaxed or release), then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16-byte copy global -> shared; with fill == false the 16 bytes are
// zero-filled and nothing is read (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rows [b0, b1) of 0..n-1 that cluster rank `rank` attends.  While the
// rows fit one tile a warp (n <= tile * n_warps) rank 0 takes them all and
// works alone, with no exchange; beyond, each rank takes an equal share
// rounded up to whole tiles, and `used` ranks have rows.
struct Share {
  int b0, b1, used;
  bool alone;
};
__device__ __forceinline__ Share share_rows(int n, int rank, int tile,
                                            int n_warps) {
  Share s;
  s.alone = n <= tile * n_warps;
  const int chunk =
      s.alone ? n : ((n + kCluster - 1) / kCluster + tile - 1) / tile * tile;
  s.used = s.alone ? 1 : (n + chunk - 1) / chunk;
  s.b0 = rank * chunk;
  s.b1 = min(n, s.b0 + chunk);
  return s;
}

// The merge weight of partial (m, l) against the running max M: an empty
// partial (l == 0, m == -inf) weighs 0 without forming exp2(-inf - -inf).
__device__ __forceinline__ float weight(float m, float l, float M) {
  return l > 0.f ? exp2f(m - M) : 0.f;
}

// A function attribute applies on the current device only, so the raised
// shared-memory limit is set once on each device that launches the
// instantiation (`done` holds one bit a device).
template <typename F>
cudaError_t raise_smem_limit(F kern, std::atomic<unsigned long long>& done,
                             int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// A launch of `kern` on a grid (n_head, kCluster, B) whose kCluster blocks
// along y form one cluster per (head, stream).
template <typename K, typename... Args>
cudaError_t launch_clusters(K kern, int n_head, int B, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_head, kCluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kCluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace llmvox_attn
