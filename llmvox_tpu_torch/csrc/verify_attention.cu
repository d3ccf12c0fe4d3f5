// K3: batched verify attention for speculative decode, for Hopper.
//
// Replaces the TPU kernel llmvox_tpu/ops/pallas_attn.py::
// pallas_verify_attention (kernel bodies `_verify_kernel_mxu`, the default,
// and `_verify_kernel`; the two differ only in how they lay the queries
// out for the TPU's matrix unit, so one kernel stands for both).  It
// computes the same function as the plain version
// llmvox_tpu_torch/ops/attention.py::batched_verify_attention: for each of
// B streams, nq = k_draft + 1 teacher-forced queries, query j at position
// pos[b] + j, and for each of the n_head heads,
// softmax(q_bjh . K_bh[0..r] / sqrt(D)) @ V_bh[0..r] with
// r = min(pos[b] + j, S - 1), in f32 arithmetic with the output in q's
// dtype.  A query past the cache (pos[b] + j >= S) attends every row; its
// output is well defined but no committed token depends on it.
//
// Bound on an H100 SXM: the work reads each stream's rows 0..min(pos_b +
// nq - 1, S - 1) of K and V once, plus q and the output:
//   bytes = sum_b 2 * min(pos_b + nq, S) * C * sizeof(T) + 2 * B * nq * C *
//   sizeof(T), over 3.35 TB/s.
// At B = 16, full depth, C = 768 in bf16 that is ~403 MB, ~120 us, which
// is K2's bound: the draft window adds no bytes.  The arithmetic,
// 4 * nq * sum_b rows_b * C flops (~2.0 GFLOP at nq = 5, ~5.2 at nq = 13),
// stays below what the CUDA cores do in f32 over the same 120 us, so the
// kernel is memory-bound without tensor cores.
//
// Design: K2's split over S, with the draft window's queries sharing every
// row that is read, and the two products of a split done as small GEMMs.
//   pass 1, grid (n_head, ceil(S / kSplit), B), one thread per cache row
//     of the split: each block takes kSplit rows of one head of one
//     stream.  It reads its own pos[b] from device memory, so the launch
//     needs no host value and the grid is sized by S and B; a block whose
//     first row lies past its stream's last row min(pos[b] + nq - 1, S - 1)
//     exits at once.  The nq query slices of the head sit in shared memory
//     (zero rows up to MAXQ, 8 or 16).  Scores: each thread reads its K row
//     ONCE, in 16-byte loads, and takes all MAXQ
//     dot products from it, with no cross-lane reduction; the masked scores
//     (row <= pos[b] + j) go to shared memory.  Per query: the block max,
//     the probabilities in place, their sum.  Values: V is staged through
//     shared memory kTile rows at a time (each row read once, 16-byte
//     loads), and each thread owns one column d of a set of queries, so
//     the accumulators need no reduction across threads and the result
//     does not change from run to run.  The partial (m, l, acc[D]) per
//     query goes to scratch memory that the caller allocates.
//   pass 2, grid (n_head, nq, B): combines query j's splits that hold any
//     of its rows, M = max m_i, l = sum l_i e^(m_i - M),
//     out = sum acc_i e^(m_i - M) / l, and casts to the output type.
// The kernels allocate nothing and do not synchronise; they run on the
// caller's stream.  Faster versions (tensor cores for nq >= 8 with nq
// padded to 8 or 16, cp.async/TMA staging, one fused pass) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 256;        // cache rows per pass-1 block
constexpr int kThreads = kSplit;   // one thread per row of the split
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // V rows staged in shared memory at once
constexpr int kMaxQ = 16;          // queries per stream (k_draft + 1)
constexpr int kMaxD = 128;         // head_dim

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

// W consecutive elements (16 bytes) as floats; p is 16-byte aligned.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int W = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// Scratch layout, n = B * n_head * n_split * nq partials indexed
// ((b * n_head + h) * n_split + split) * nq + j: m[n], l[n], acc[n * D].
// MAXQ >= nq.  Rows are read in 16-byte chunks: D * sizeof(T) and
// C * sizeof(T) are multiples of 16 and k and v are 16-byte aligned (the
// entry point refuses anything else).
template <typename T, int MAXQ>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ pos,
             float* __restrict__ scratch, int S, int C, int D, int nq,
             int n_split, float scale) {
  const int h = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int n_head = gridDim.x;
  const int p = pos[b];
  const int last = min(p + nq - 1, S - 1);
  const int row0 = split * kSplit;
  if (row0 > last) return;   // pass 2 reads no split past a query's rows
  const int nrows = min(kSplit, last + 1 - row0);
  const size_t n = (size_t)gridDim.z * n_head * n_split * nq;
  const size_t base = ((size_t)(b * n_head + h) * n_split + split) * nq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  __shared__ float s_q[MAXQ][kMaxD];
  __shared__ float s_p[MAXQ][kSplit];
  __shared__ float s_v[kTile][kMaxD];
  __shared__ float s_m[MAXQ];
  __shared__ float s_l[MAXQ];

  const T* qb = q + (size_t)b * nq * C + h * D;
  for (int e = tid; e < MAXQ * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    s_q[j][d] = j < nq ? to_f32(qb[(size_t)j * C + d]) : 0.f;
  }
  __syncthreads();

  // scores: each K row is read once, by one thread, for all queries
  const T* kb = k + (size_t)b * S * C + h * D;
  if (tid < nrows) {
    const int r = row0 + tid;
    const T* kr = kb + (size_t)r * C;
    float s[MAXQ];
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) s[j] = 0.f;
    constexpr int W = Chunk<T>::W;
    for (int d0 = 0; d0 < D; d0 += W) {
      float kf[W];
      Chunk<T>::load(kr + d0, kf);
#pragma unroll
      for (int j = 0; j < MAXQ; ++j)
#pragma unroll
        for (int e = 0; e < W; ++e) s[j] += s_q[j][d0 + e] * kf[e];
    }
#pragma unroll
    for (int j = 0; j < MAXQ; ++j)
      if (j < nq) s_p[j][tid] = r <= p + j ? s[j] * scale : -INFINITY;
  }
  __syncthreads();

  for (int j = warp; j < nq; j += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < nrows; i += 32) m = fmaxf(m, s_p[j][i]);
    m = warp_max(m);
    if (lane == 0) s_m[j] = m;
  }
  __syncthreads();
  // probabilities in place; a query with no row in this split has m = -inf
  for (int e = tid; e < nq * nrows; e += kThreads) {
    const int j = e / nrows, i = e - j * nrows;
    const float m = s_m[j];
    s_p[j][i] = m == -INFINITY ? 0.f : expf(s_p[j][i] - m);
  }
  __syncthreads();
  for (int j = warp; j < nq; j += kWarps) {
    float l = 0.f;
    for (int i = lane; i < nrows; i += 32) l += s_p[j][i];
    l = warp_sum(l);
    if (lane == 0) s_l[j] = l;
  }

  // values: thread (g, d) owns column d of queries g, g + groups, ...
  const int groups = kThreads / D;   // >= 2: D <= kMaxD = kThreads / 2
  const int g = tid / D, d = tid - g * D;
  constexpr int kPer = MAXQ / 2;
  float acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
  const T* vb = v + (size_t)b * S * C + h * D;
  for (int t0 = 0; t0 < nrows; t0 += kTile) {
    const int tn = min(kTile, nrows - t0);
    constexpr int W = Chunk<T>::W;
    const int per_row = D / W;
    for (int e = tid; e < tn * per_row; e += kThreads) {
      const int i = e / per_row, c = (e - i * per_row) * W;
      float vf[W];
      Chunk<T>::load(vb + (size_t)(row0 + t0 + i) * C + c, vf);
#pragma unroll
      for (int w = 0; w < W; ++w) s_v[i][c + w] = vf[w];
    }
    __syncthreads();
    if (g < groups) {
      for (int i = 0; i < tn; ++i) {
        const float vv = s_v[i][d];
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          const int j = g + t * groups;
          if (j < nq) acc[t] += s_p[j][t0 + i] * vv;
        }
      }
    }
    __syncthreads();
  }

  if (g < groups) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int j = g + t * groups;
      if (j < nq) scratch[2 * n + (base + j) * D + d] = acc[t];
    }
  }
  if (tid < nq) {
    scratch[base + tid] = s_m[tid];
    scratch[n + base + tid] = s_l[tid];
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ scratch,
                               const int* __restrict__ pos,
                               T* __restrict__ out, int S, int C, int D,
                               int n_split) {
  const int h = blockIdx.x;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int n_head = gridDim.x;
  const int nq = gridDim.y;
  const size_t n = (size_t)gridDim.z * n_head * n_split * nq;
  // split i of (b, h, j) is partial base + i * nq
  const size_t base = (size_t)(b * n_head + h) * n_split * nq + j;
  const float* m_in = scratch;
  const float* l_in = scratch + n;
  const float* acc_in = scratch + 2 * n;

  // the splits that hold any of rows 0..min(pos[b] + j, S - 1); each of
  // them has at least one row for query j, so every m_i is finite
  const int filled = min(min(pos[b] + j, S - 1) / kSplit + 1, n_split);
  float mx = -INFINITY;
  for (int i = 0; i < filled; ++i) mx = fmaxf(mx, m_in[base + i * nq]);
  float l = 0.f;
  for (int i = 0; i < filled; ++i)
    l += l_in[base + i * nq] * expf(m_in[base + i * nq] - mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < filled; ++i) {
      const size_t idx = base + (size_t)i * nq;
      a += acc_in[idx * D + d] * expf(m_in[idx] - mx);
    }
    store(out + ((size_t)b * nq + j) * C + h * D + d, a / l);
  }
}

template <typename T, int MAXQ>
void launch_split(const void* q, const void* k, const void* v, const int* pos,
                  float* scratch, int B, int S, int C, int n_head, int nq,
                  int n_split, cudaStream_t stream) {
  const int D = C / n_head;
  const float scale = (float)(1.0 / sqrt((double)D));
  split_kernel<T, MAXQ><<<dim3(n_head, n_split, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, scratch, S, C, D, nq, n_split, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* scratch, int B, int S, int C, int n_head, int nq,
           cudaStream_t stream) {
  const int D = C / n_head;
  if ((D * sizeof(T)) % 16 != 0 || (C * sizeof(T)) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
       16) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_split = (S + kSplit - 1) / kSplit;
  if (nq <= 8)
    launch_split<T, 8>(q, k, v, pos, scratch, B, S, C, n_head, nq, n_split,
                       stream);
  else
    launch_split<T, kMaxQ>(q, k, v, pos, scratch, B, S, C, n_head, nq,
                           n_split, stream);
  combine_kernel<T><<<dim3(n_head, nq, B), 128, 0, stream>>>(
      scratch, pos, static_cast<T*>(out), S, C, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch memory the caller must pass.
long long llmvox_verify_attention_scratch_floats(int B, int S, int C,
                                                 int n_head, int nq) {
  const long long n_split = (S + kSplit - 1) / kSplit;
  return (long long)B * n_head * n_split * nq * (2 + C / n_head);
}

// q (B, nq, C), k and v (B, S, C) row-major, out (B, nq, C), all of one
// type (dtype: 0 = float32, 1 = bfloat16), with D and C rows a multiple of
// 16 bytes and k and v 16-byte aligned; pos is B int32 values in device
// memory.  Returns a cudaError_t: 0 when both launches were accepted.
int llmvox_verify_attention(const void* q, const void* k, const void* v,
                            const void* pos, void* out, void* scratch, int B,
                            int S, int C, int n_head, int nq, int dtype,
                            void* stream) {
  if (n_head <= 0 || C % n_head != 0 || C / n_head > kMaxD || S <= 0 ||
      (S + kSplit - 1) / kSplit > 65535 || B <= 0 || B > 65535 || nq <= 0 ||
      nq > kMaxQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(q, k, v, p, out, sc, B, S, C, n_head,
                                       nq, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, out, sc, B, S, C, n_head, nq, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
