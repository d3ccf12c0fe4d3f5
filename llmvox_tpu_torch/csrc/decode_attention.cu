// K1: single-token decode attention over a persistent KV cache, for Hopper.
//
// Replaces the TPU kernel llmvox_tpu/ops/pallas_attn.py::pallas_decode_attention
// (kernel body `_kernel`, wrapper at the end of that file).  It computes the
// same function as the plain version llmvox_tpu_torch/ops/attention.py::
// decode_attention: for each of the n_head heads, softmax(q_h . K_h[0..pos] /
// sqrt(D)) @ V_h[0..pos], with f32 arithmetic and the output in q's dtype.
//
// Bound on an H100 SXM: the work is a memory-bound read of the filled cache
// rows, bytes = 2 * (pos+1) * C * sizeof(T) (q and the output add 2*C*sizeof(T)).
// At pos = 8191, C = 768 in bf16 that is ~25 MB, ~7.5 us at 3.35 TB/s.  The
// arithmetic is 4 * (pos+1) * C flops, far below the card's rate.  At
// shallow positions the bytes are few and launch latency, not the bytes,
// sets the time.
//
// Design.  A single token with 8 heads cannot fill 132 SMs, so the cache
// rows are split (flash-decoding):
//   pass 1, grid (n_head, ceil(S / kSplit)): each block takes kSplit rows of
//     one head.  It reads `pos` from device memory, so the launch never needs
//     a host value and the grid is sized by S; a block whose first row lies
//     past `pos` writes an empty partial (m = -inf, l = 0) and exits.  The
//     other blocks compute each row's score with a warp-wide dot product
//     (q kept in registers, one lane per 32nd element, so head_dim need not
//     be a power of two), keep the scores in shared memory, take the block
//     max, and accumulate l = sum exp(s - m) and acc = sum exp(s - m) * v in
//     f32 per warp, then across warps.  The partial (m, l, acc[D]) goes to
//     scratch memory that the caller allocates.
//   pass 2, grid (n_head): combines the filled splits,
//     M = max m_i, l = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / l,
//     and casts to the output type.
// The kernels allocate nothing and do not synchronise; they run on the
// caller's stream.  Faster versions (16-byte loads, cp.async/TMA staging,
// fewer splits at low pos, one fused pass) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSplit = 256;        // cache rows per pass-1 block
constexpr int kWarps = 8;          // warps per pass-1 block
constexpr int kMaxDPerLane = 8;    // head_dim <= 256
constexpr int kMaxD = 32 * kMaxDPerLane;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Scratch layout, n = n_head * n_split: m[n], l[n], acc[n * D].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ pos_ptr,
             float* __restrict__ scratch, int S, int C, int D, int n_split,
             float scale) {
  const int h = blockIdx.x;
  const int split = blockIdx.y;
  const int n = gridDim.x * n_split;
  const int idx = h * n_split + split;
  float* m_out = scratch;
  float* l_out = scratch + n;
  float* acc_out = scratch + 2 * n;

  const int pos = *pos_ptr;
  const int row0 = split * kSplit;
  if (row0 > pos) {
    if (threadIdx.x == 0) {
      m_out[idx] = -INFINITY;
      l_out[idx] = 0.f;
    }
    return;
  }
  const int nrows = min(min(kSplit, pos + 1 - row0), S - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  __shared__ float s_score[kSplit];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];

  float qr[kMaxDPerLane];
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < D ? to_f32(q[h * D + d]) : 0.f;
  }

  // scores: one row per warp at a time; rows carry no dependency, so the
  // loads of successive rows overlap
  for (int i = warp; i < nrows; i += kWarps) {
    const T* kr = k + (size_t)(row0 + i) * C + h * D;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) s += qr[j] * to_f32(kr[d]);
    }
    s = warp_sum(s);
    if (lane == 0) s_score[i] = s * scale;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int i = lane; i < nrows; i += 32) m = fmaxf(m, s_score[i]);
  m = warp_max(m);

  float acc[kMaxDPerLane];
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) acc[j] = 0.f;
  float l = 0.f;
  for (int i = warp; i < nrows; i += kWarps) {
    const float p = expf(s_score[i] - m);
    l += p;
    const T* vr = v + (size_t)(row0 + i) * C + h * D;
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) acc[j] += p * to_f32(vr[d]);
    }
  }
  if (lane == 0) s_l[warp] = l;
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < D) s_acc[warp][d] = acc[j];
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][d];
    acc_out[(size_t)idx * D + d] = a;
  }
  if (threadIdx.x == 0) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lt += s_l[w];
    m_out[idx] = m;
    l_out[idx] = lt;
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ scratch,
                               const int* __restrict__ pos_ptr,
                               T* __restrict__ out, int D, int n_split) {
  const int h = blockIdx.x;
  const int n = gridDim.x * n_split;
  const float* m_in = scratch + h * n_split;
  const float* l_in = scratch + n + h * n_split;
  const float* acc_in = scratch + 2 * n + (size_t)h * n_split * D;

  const int pos = *pos_ptr;
  const int filled = min(pos / kSplit + 1, n_split);
  float mx = -INFINITY;
  for (int i = 0; i < filled; ++i) mx = fmaxf(mx, m_in[i]);
  float l = 0.f;
  for (int i = 0; i < filled; ++i) l += l_in[i] * expf(m_in[i] - mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < filled; ++i)
      a += acc_in[(size_t)i * D + d] * expf(m_in[i] - mx);
    store(out + h * D + d, a / l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* pos,
            void* out, float* scratch, int S, int C, int n_head,
            cudaStream_t stream) {
  const int D = C / n_head;
  const int n_split = (S + kSplit - 1) / kSplit;
  const float scale = (float)(1.0 / sqrt((double)D));
  split_kernel<T><<<dim3(n_head, n_split), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, scratch, S, C, D, n_split, scale);
  combine_kernel<T><<<n_head, 128, 0, stream>>>(scratch, pos,
                                                static_cast<T*>(out), D,
                                                n_split);
}

}  // namespace

extern "C" {

// Floats of scratch memory the caller must pass.
int llmvox_decode_attention_scratch_floats(int S, int C, int n_head) {
  const int n_split = (S + kSplit - 1) / kSplit;
  return n_head * n_split * (2 + C / n_head);
}

// q (C,), k and v (S, C) row-major, out (C,), all of one type
// (dtype: 0 = float32, 1 = bfloat16); pos is an int32 in device memory.
// Returns a cudaError_t: 0 when both launches were accepted.
int llmvox_decode_attention(const void* q, const void* k, const void* v,
                            const void* pos, void* out, void* scratch, int S,
                            int C, int n_head, int dtype, void* stream) {
  if (n_head <= 0 || C % n_head != 0 || C / n_head > kMaxD || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    launch<float>(q, k, v, p, out, sc, S, C, n_head, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, p, out, sc, S, C, n_head, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
