// K2: batched decode attention for the continuous-batching pool, for Hopper.
//
// Replaces the TPU kernel llmvox_tpu/ops/pallas_attn.py::
// pallas_batched_decode_attention (kernel body `_batched_kernel_v2`).  It
// computes the same function as the plain version
// llmvox_tpu_torch/ops/attention.py::batched_decode_attention: for each of
// B streams and each of the n_head heads, softmax(q_bh . K_bh[0..pos[b]] /
// sqrt(D)) @ V_bh[0..pos[b]], with f32 arithmetic and the output in q's
// dtype.  Row b attends only its own cache rows 0..pos[b].
//
// Bound on an H100 SXM: the work is a memory-bound read of each stream's
// filled cache rows, bytes = sum_b 2 * (pos_b+1) * C * sizeof(T), plus q
// and the output (2 * B * C * sizeof(T)), over 3.35 TB/s.  At B = 16,
// pos = 8191, C = 768 in bf16 that is ~403 MB, ~120 us.  The arithmetic,
// 4 * sum_b (pos_b+1) * C flops, is far below the card's rate.
//
// Design: K1's split over S (flash-decoding) with a stream index added.
//   pass 1, grid (n_head, ceil(S / kSplit), B): each block takes kSplit
//     rows of one head of one stream.  It reads its own pos[b] from device
//     memory, so the launch needs no host value and the grid is sized by S
//     and B; a block whose first row lies past pos[b] writes an empty
//     partial (m = -inf, l = 0) and exits, so a stream's cost follows its
//     own depth.  The other blocks compute each row's score with a
//     warp-wide dot product (q in registers, one lane per 32nd element, so
//     head_dim need not be a power of two), keep the scores in shared
//     memory, take the block max, and accumulate l and acc[D] in f32 per
//     warp and then across warps.  The partial (m, l, acc[D]) goes to
//     scratch memory that the caller allocates.
//   pass 2, grid (n_head, B): combines stream b's filled splits,
//     M = max m_i, l = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / l,
//     and casts to the output type.
// With B streams the grid holds B times as many live blocks as K1's, which
// is what hides each block's load latency; the bytes read stay the bound.
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

// Scratch layout, n = B * n_head * n_split partials indexed
// ((b * n_head + h) * n_split + split): m[n], l[n], acc[n * D].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ pos,
             float* __restrict__ scratch, int S, int C, int D, int n_split,
             float scale) {
  const int h = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int n_head = gridDim.x;
  const int n = gridDim.z * n_head * n_split;
  const int idx = (b * n_head + h) * n_split + split;
  float* m_out = scratch;
  float* l_out = scratch + n;
  float* acc_out = scratch + 2 * n;

  const int p = pos[b];
  const int row0 = split * kSplit;
  if (row0 > p) {
    if (threadIdx.x == 0) {
      m_out[idx] = -INFINITY;
      l_out[idx] = 0.f;
    }
    return;
  }
  const int nrows = min(min(kSplit, p + 1 - row0), S - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* kb = k + (size_t)b * S * C;
  const T* vb = v + (size_t)b * S * C;

  __shared__ float s_score[kSplit];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];

  float qr[kMaxDPerLane];
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < D ? to_f32(q[(size_t)b * C + h * D + d]) : 0.f;
  }

  for (int i = warp; i < nrows; i += kWarps) {
    const T* kr = kb + (size_t)(row0 + i) * C + h * D;
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
    const float pr = expf(s_score[i] - m);
    l += pr;
    const T* vr = vb + (size_t)(row0 + i) * C + h * D;
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) acc[j] += pr * to_f32(vr[d]);
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
                               const int* __restrict__ pos,
                               T* __restrict__ out, int C, int D,
                               int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_head = gridDim.x;
  const int n = gridDim.y * n_head * n_split;
  const int base = (b * n_head + h) * n_split;
  const float* m_in = scratch + base;
  const float* l_in = scratch + n + base;
  const float* acc_in = scratch + 2 * n + (size_t)base * D;

  const int filled = min(pos[b] / kSplit + 1, n_split);
  float mx = -INFINITY;
  for (int i = 0; i < filled; ++i) mx = fmaxf(mx, m_in[i]);
  float l = 0.f;
  for (int i = 0; i < filled; ++i) l += l_in[i] * expf(m_in[i] - mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < filled; ++i)
      a += acc_in[(size_t)i * D + d] * expf(m_in[i] - mx);
    store(out + (size_t)b * C + h * D + d, a / l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* pos,
            void* out, float* scratch, int B, int S, int C, int n_head,
            cudaStream_t stream) {
  const int D = C / n_head;
  const int n_split = (S + kSplit - 1) / kSplit;
  const float scale = (float)(1.0 / sqrt((double)D));
  split_kernel<T><<<dim3(n_head, n_split, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, scratch, S, C, D, n_split, scale);
  combine_kernel<T><<<dim3(n_head, B), 128, 0, stream>>>(
      scratch, pos, static_cast<T*>(out), C, D, n_split);
}

}  // namespace

extern "C" {

// Floats of scratch memory the caller must pass.
long long llmvox_batched_decode_attention_scratch_floats(int B, int S, int C,
                                                         int n_head) {
  const long long n_split = (S + kSplit - 1) / kSplit;
  return (long long)B * n_head * n_split * (2 + C / n_head);
}

// q (B, C), k and v (B, S, C) row-major, out (B, C), all of one type
// (dtype: 0 = float32, 1 = bfloat16); pos is B int32 values in device
// memory.  Returns a cudaError_t: 0 when both launches were accepted.
int llmvox_batched_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    void* scratch, int B, int S, int C,
                                    int n_head, int dtype, void* stream) {
  if (n_head <= 0 || C % n_head != 0 || C / n_head > kMaxD || S <= 0 ||
      B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    launch<float>(q, k, v, p, out, sc, B, S, C, n_head, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, p, out, sc, B, S, C, n_head, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
