// K4: int4 weight matmul for quantized serving (--quantize w4), for Hopper.
//
// Replaces the TPU kernel llmvox_tpu/ops/pallas_quant.py::_int4_mm (kernel
// body `_kernel`, wrapper `pallas_int4_matmul`).  It computes the same
// function as the plain version
// llmvox_tpu_torch/ops/cuda_int4_mm.py::plain_int4_matmul:
//
//   out[m, c] = sum_i bf16(x[m, 2i])   * bf16(lo[i, c] * s[g(i), c])
//                   + bf16(x[m, 2i+1]) * bf16(hi[i, c] * s[g(i), c])
//
// where q (P, Cout) int8 holds two signed 4-bit weights per byte (logical
// row 2i in the low nibble of packed row i, 2i+1 in the high one), s
// (G, 1, Cout) is one f32 or bf16 scale per (group of P/G packed rows,
// column), and g(i) = i / (P/G).  The scale product is taken in f32 and
// rounded once to bf16 (with bf16 scales the f32 product is exact, so this
// is the bf16 product); x rounds to bf16; the bf16 x bf16 products are
// exact in f32 and summed in f32; the output takes x's type.
//
// Bound on an H100 SXM: at the served shapes (M = 1..80 rows, 768 or 3072
// in, 768..3072 out) the work is a read of the packed weight (Cin/2 * Cout
// bytes), its scales, x and the output over 3.35 TB/s: 0.1-0.6 us.  The
// arithmetic, 2 * M * Cin * Cout flops on bf16 operands, takes less than
// that at the card's bf16 rate up to M = 80 (0.38 us for 80 x 3072 x 768).
// A call is so small that its cost is the launch and the latency of one
// pass over the weight, so the design aims at many blocks in flight, not
// at reuse, and computes on the CUDA cores.
//
// Design: two passes, deterministic.
//   pass 1, grid (ceil(Cout / 128), ceil(P / 64), ceil(M / MT)): a block of
//     128 threads owns 128 output columns, 64 packed rows (128 logical
//     rows of the contraction) and up to MT rows of x.  It stages its x
//     slice, rounded to bf16, in shared memory as (even, odd) pairs.  Each
//     thread reads one packed row's 16 bytes for 16 columns with one
//     16-byte load (8 threads cover a 128-byte row segment, 16 k-lanes take
//     every 16th packed row), sign-extends both nibbles in int32, scales,
//     rounds to bf16, and accumulates MT x 16 f32 sums.  The 16 k-lanes'
//     sums are added by warp shuffles and then across the 4 warps through
//     shared memory, in a fixed order, and the block writes its partial to
//     f32 scratch (n_split, M, Cout) that the caller allocates.  Splitting
//     the contraction gives the grid n_split times more blocks than Cout /
//     128 alone: a 768-column weight has 6 column tiles for 132 SMs.
//   pass 2: one thread per output sums the n_split partials in order and
//     casts to x's type.
// MT is 1, 4 or 8 by M, so a single row does not pay for eight.  Tensor
// cores, TMA staging and a fused single pass are later work.  The kernels
// allocate nothing and do not synchronise; they run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerThread = 16;                   // one 16-byte load
constexpr int kColThreads = 8;
constexpr int kTileCols = kColsPerThread * kColThreads;   // 128
constexpr int kKLanes = 16;
constexpr int kThreads = kColThreads * kKLanes;           // 128
constexpr int kWarps = kThreads / 32;
constexpr int kSplitRows = 64;                       // packed rows per split

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TX, typename TS, int MT>
__global__ void __launch_bounds__(kThreads)
split_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
             const TS* __restrict__ s, float* __restrict__ partial, int M,
             int P, int Cout, int rows_per_group) {
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int i0 = split * kSplitRows;
  const int tid = threadIdx.x;
  const int cc = tid % kColThreads;
  const int kl = tid / kColThreads;
  const int col0 = tile * kTileCols + cc * kColsPerThread;
  const int cin = 2 * P;

  __shared__ float2 s_x[MT][kSplitRows];   // bf16-rounded (x[2i], x[2i+1])
  __shared__ float s_red[kWarps][MT][kTileCols];

  for (int e = tid; e < MT * kSplitRows; e += kThreads) {
    const int m = e / kSplitRows, r = e % kSplitRows;
    const int row = m0 + m, i = i0 + r;
    float2 v = make_float2(0.f, 0.f);
    if (row < M && i < P) {
      const TX* xr = x + (size_t)row * cin + 2 * i;
      v.x = round_bf16(to_f32(xr[0]));
      v.y = round_bf16(to_f32(xr[1]));
    }
    s_x[m][r] = v;
  }
  __syncthreads();

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  if (col0 < Cout) {
    float sc[kColsPerThread];
    int g_cur = -1;
    const int i_end = min(i0 + kSplitRows, P);
    for (int i = i0 + kl; i < i_end; i += kKLanes) {
      const int g = i / rows_per_group;
      if (g != g_cur) {
        g_cur = g;
        const TS* sr = s + (size_t)g * Cout + col0;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) sc[j] = to_f32(sr[j]);
      }
      const int4 raw =
          __ldg(reinterpret_cast<const int4*>(q + (size_t)i * Cout + col0));
      const unsigned words[4] = {(unsigned)raw.x, (unsigned)raw.y,
                                 (unsigned)raw.z, (unsigned)raw.w};
      float xe[MT], xo[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float2 v = s_x[m][i - i0];
        xe[m] = v.x;
        xo[m] = v.y;
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        // byte j (little-endian), sign-extended, then its two nibbles
        const int b = (int)(words[j >> 2] << (24 - 8 * (j & 3))) >> 24;
        const int lo_n = (int)((unsigned)b << 28) >> 28;
        const int hi_n = b >> 4;
        const float lo = round_bf16(__fmul_rn((float)lo_n, sc[j]));
        const float hi = round_bf16(__fmul_rn((float)hi_n, sc[j]));
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][j] = fmaf(xo[m], hi, fmaf(xe[m], lo, acc[m][j]));
      }
    }
  }

  // lanes l, l^8, l^16, l^24 of a warp share a column group: add them
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < kColThreads) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s_red[warp][m][lane * kColsPerThread + j] = acc[m][j];
  }
  __syncthreads();
  for (int e = tid; e < MT * kTileCols; e += kThreads) {
    const int m = e / kTileCols, c = e % kTileCols;
    const int row = m0 + m, col = tile * kTileCols + c;
    if (row < M && col < Cout) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_red[w][m][c];
      partial[((size_t)split * M + row) * Cout + col] = v;
    }
  }
}

template <typename TO>
__global__ void reduce_kernel(const float* __restrict__ partial,
                              TO* __restrict__ out, long long n,
                              int n_split) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int k = 0; k < n_split; ++k) v += partial[(size_t)k * n + e];
  store(out + e, v);
}

int n_splits(int P) { return (P + kSplitRows - 1) / kSplitRows; }

template <typename TX, typename TS, int MT>
void launch_mt(const void* x, const void* q, const void* s, void* out,
               float* partial, int M, int P, int Cout, int G,
               cudaStream_t stream) {
  const int n_split = n_splits(P);
  const dim3 grid((Cout + kTileCols - 1) / kTileCols, n_split,
                  (M + MT - 1) / MT);
  split_kernel<TX, TS, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const TS*>(s), partial, M, P, Cout, P / G);
  const long long n = (long long)M * Cout;
  reduce_kernel<TX><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<TX*>(out), n, n_split);
}

template <typename TX, typename TS>
void launch(const void* x, const void* q, const void* s, void* out,
            float* partial, int M, int P, int Cout, int G,
            cudaStream_t stream) {
  if (M == 1)
    launch_mt<TX, TS, 1>(x, q, s, out, partial, M, P, Cout, G, stream);
  else if (M <= 4)
    launch_mt<TX, TS, 4>(x, q, s, out, partial, M, P, Cout, G, stream);
  else
    launch_mt<TX, TS, 8>(x, q, s, out, partial, M, P, Cout, G, stream);
}

}  // namespace

extern "C" {

// Floats of scratch memory the caller must pass.
long long llmvox_int4_matmul_scratch_floats(int M, int P, int Cout) {
  return (long long)n_splits(P) * M * Cout;
}

// x (M, 2P) row-major in x_dtype, q (P, Cout) int8 row-major and 16-byte
// aligned, s (G, 1, Cout) in s_dtype, out (M, Cout) in x_dtype (dtype 0 =
// float32, 1 = bfloat16).  Returns a cudaError_t: 0 when both launches
// were accepted.
int llmvox_int4_matmul(const void* x, const void* q, const void* s,
                       void* out, void* scratch, int M, int P, int Cout,
                       int G, int x_dtype, int s_dtype, void* stream) {
  if (M <= 0 || P <= 0 || G <= 0 || P % G != 0 || Cout <= 0 ||
      Cout % kColsPerThread != 0 || n_splits(P) > 65535 ||
      (M + 7) / 8 > 65535 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (x_dtype == 0 && s_dtype == 0)
    launch<float, float>(x, q, s, out, part, M, P, Cout, G, st);
  else if (x_dtype == 0 && s_dtype == 1)
    launch<float, __nv_bfloat16>(x, q, s, out, part, M, P, Cout, G, st);
  else if (x_dtype == 1 && s_dtype == 0)
    launch<__nv_bfloat16, float>(x, q, s, out, part, M, P, Cout, G, st);
  else if (x_dtype == 1 && s_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, part, M, P, Cout, G,
                                         st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
