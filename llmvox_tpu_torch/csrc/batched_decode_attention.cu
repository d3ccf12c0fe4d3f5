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
// 4 * sum_b (pos_b+1) * C flops, is far below the card's rate; one query a
// stream is a matrix-vector product, so tensor cores have nothing to do.
// At served depths (a few hundred rows a stream) latency, not the bytes,
// sets the time.
//
// Design: K1's (decode_attention.cu) with a stream axis.  One launch, grid
// (n_head, kCluster, B); the kCluster = 8 blocks of one (head, stream) form
// a thread-block cluster (attn_cluster.cuh).
//   - Rows split by the device's pos[b]: every block reads its stream's
//     depth and takes an equal share of rows 0..pos[b] in 8-row tiles, so a
//     stream's cost follows its own depth and the grid depends on (n_head,
//     B) alone (capturable in a CUDA graph).  While the rows fit one tile a
//     warp (pos[b] < 32) rank 0 takes them all and writes the output with
//     no exchange; a block with no rows contributes the empty partial.
//   - Four warps a block, not K1's eight: at B = 16 the grid is 128
//     clusters, and at served depths its time is the number of waves of
//     co-resident clusters times a short chain; four warps (~117 registers
//     a thread, 49 KB of ring) fit four blocks an SM against eight warps'
//     two, which halved the time at pos 127 and cost 2% at pos 8191
//     (PERF.md).
//   - Each warp owns 8 rows of every block tile and fills its own 4-stage
//     ring with 16-byte cp.async copies; four lanes a row against q in
//     registers (pre-scaled into the exp2 domain); online softmax in base 2
//     with the warp's running max; the warp's row slots summed in a fixed
//     order, the warps merged in warp order.
//   - Each block pushes its partial (m, l, acc[D]) into slot `rank` of rank
//     0's shared memory under one split cluster barrier; rank 0 merges them
//     in rank order (deterministic run to run) and writes the output.  No
//     global scratch.
// Caches whose rows are not 16-byte aligned are staged by plain loads; wide
// heads take fewer warps a block.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.
#include <cooperative_groups.h>

#include "attn_cluster.cuh"

namespace cg = cooperative_groups;
using namespace llmvox_attn;

namespace {

constexpr int kRows = 8;            // rows per warp per tile (a quad each)
constexpr int kStages = 4;          // per-warp ring depth
constexpr int kWarps = 4;           // 4 blocks an SM: served depths need
                                    // co-resident clusters (PERF.md)
constexpr int kMaxD = 256;
constexpr int kSmemBudget = 200 * 1024;   // for the ring
constexpr int kSmemMax = 227 * 1024;      // the ring and the partials

// q . k over one 16-byte vector of k in shared memory
template <typename T>
__device__ __forceinline__ float dot16(const float* q, const T* k) {
  constexpr int VEC = Vec<T>::n;
  float f[VEC];
  load16(k, f);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) s += q[e] * f[e];
  return s;
}

// NVL: 16-byte vectors of a head row per lane (4 lanes a row), at most.
template <typename T, int NVL>
__global__ void __launch_bounds__(kWarps * 32)
batched_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      T* __restrict__ out, int S, int C, int D, float qscale,
                      int vec_ok) {
  constexpr int VEC = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int rank = (int)cluster.block_rank();
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int NVP = (D + VEC - 1) / VEC;       // vectors per row, padded
  const int DP = NVP * VEC;                  // padded row in shared memory
  q += (size_t)b * C;
  out += (size_t)b * C;
  k += (size_t)b * S * C;
  v += (size_t)b * S * C;

  const int n = min(pos[b] + 1, S);
  const Share sh = share_rows(n, rank, kRows, n_warps);
  if (sh.alone && rank != 0) return;
  const int b1 = sh.b1;
  const int tile_rows = kRows * n_warps;
  const int first = sh.b0 + kRows * warp;    // this warp's rows in tile 0
  const int n_tiles = first < b1 ? (b1 - first + tile_rows - 1) / tile_rows
                                 : 0;

  // the block's partials, pushed to rank 0: kCluster slots of
  // (m, l, acc[D]), after the ring (peers write here while this block
  // still computes)
  float* recv = reinterpret_cast<float*>(
      smem_raw + (size_t)n_warps * kStages * 2 * kRows * DP * sizeof(T));
  if (!sh.alone) cluster_arrive_relaxed();   // phase 1: this block started

  const int j = lane & 3;
  T* my_ring = ring + (size_t)warp * kStages * 2 * kRows * DP;
  auto slot_ptr = [&](int slot) { return my_ring + slot * 2 * kRows * DP; };

  // The 16-byte copies of one tile (K and V, kRows rows, NVP vectors each)
  // are dealt to the lanes once: copy c of this lane moves vector cv[c] of
  // row cr[c] & 31 of K (cr[c] < 32) or of V; cr = -1 marks no copy.
  constexpr int kCopies = 2 * kRows * 4 * NVL / 32;
  int cr[kCopies], cv[kCopies];
  const float inv_nvp = 1.f / NVP;   // exact quotients: idx < 2^12
#pragma unroll
  for (int c = 0; c < kCopies; ++c) {
    const int idx = lane + 32 * c;
    const int row = (int)((idx + 0.5f) * inv_nvp);   // idx / NVP
    cr[c] = row < 2 * kRows ? row % kRows + 32 * (row / kRows) : -1;
    cv[c] = idx - row * NVP;
  }

  // stage the K and V rows of tile t into ring slot t % kStages
  auto stage = [&](int t) {
    if (t < n_tiles) {
      const int row0 = first + t * tile_rows;
      const int vt = min(kRows, b1 - row0);
      T* dst = slot_ptr(t % kStages);
      const size_t g0 = (size_t)row0 * C + (size_t)h * D;
      if (vec_ok) {
#pragma unroll
        for (int c = 0; c < kCopies; ++c) {
          const int r = cr[c] & 31, which = cr[c] >> 5;
          if (cr[c] >= 0 && r < vt)
            cp_async16(dst + (which * kRows + r) * DP + cv[c] * VEC,
                       (which ? v : k) + g0 + (size_t)r * C + cv[c] * VEC);
        }
      } else {
        for (int r = 0; r < vt; ++r) {
          for (int x = lane; x < 2 * DP; x += 32) {
            const int which = x >= DP;
            const int d = x - which * DP;
            dst[(which * kRows + r) * DP + d] =
                d < D ? (which ? v : k)[g0 + (size_t)r * C + d] : T(0.f);
          }
        }
      }
    }
    cp_async_commit();   // an empty group keeps the count uniform
  };

  // Each quad of lanes owns one row of the warp's 8-row tiles; lane j of
  // the quad holds vectors j, j+4, ... of the row for both the score and
  // the V product.  The running max is the warp's, so the rescale of l and
  // acc is uniform across the warp and skipped when the max holds.
  const int r_mine = lane >> 2;
  float m = -INFINITY, l = 0.f;
  float acc[NVL][VEC];
#pragma unroll
  for (int i = 0; i < NVL; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage(t);

  // q slice of this lane (vectors j, j+4, ...), scaled into the exp2
  // domain; loaded after the first tiles' copies are on their way
  float qr[NVL][VEC];
#pragma unroll
  for (int i = 0; i < NVL; ++i) {
    const int d0 = (j + 4 * i) * VEC;
    if (vec_ok && d0 < D) {
      load16(q + h * D + d0, qr[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[i][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[i][e] = d0 + e < D ? to_f32(q[h * D + d0 + e]) * qscale : 0.f;
    }
  }
  if (!sh.alone) cluster_wait();  // phase 1 done (while the first tiles land)
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* kr = slot_ptr(t % kStages) + r_mine * DP;
    const T* vr = kr + kRows * DP;
    const bool valid = r_mine < min(kRows, b1 - (first + t * tile_rows));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NVL; ++i)
      if (j + 4 * i < NVP) s += dot16(qr[i], kr + (j + 4 * i) * VEC);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (!valid) s = -INFINITY;
    float mt = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 4));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
    if (mt > m) {                            // warp-uniform
      const float alpha = exp2f(m - mt);     // 0 on the first tile
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NVL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
      m = mt;
    }
    if (valid) {
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int i = 0; i < NVL; ++i)
        if (j + 4 * i < NVP) {
          float f[VEC];
          load16(vr + (j + 4 * i) * VEC, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] += p * f[e];
        }
    }
    __syncwarp();        // the slot is refilled by the next stage()
  }

  cp_async_wait<0>();
  __syncthreads();

  // Merge every row slot of every warp through shared memory (the ring is
  // free now): slot (w, r) holds m (the warp's), l and acc[D] of quad r of
  // warp w.  Warps are weighted in warp order, slots summed in slot order.
  const int ss = D + 3;                          // slot stride, in floats
  float* stash = reinterpret_cast<float*>(smem_raw);
  float* wsum = stash + n_warps * kRows * ss;    // per warp: l summed
  {
    float* mine = stash + (warp * kRows + r_mine) * ss;
    if (j == 0) {
      mine[0] = m;
      mine[1] = l;
    }
    if (n_tiles > 0) {
#pragma unroll
      for (int i = 0; i < NVL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int d = (j + 4 * i) * VEC + e;
          if (d < D) mine[2 + d] = acc[i][e];
        }
    }
  }
  __syncthreads();
  if (threadIdx.x < n_warps) {
    float lw = 0.f;
    for (int r = 0; r < kRows; ++r)
      lw += stash[(threadIdx.x * kRows + r) * ss + 1];
    wsum[threadIdx.x] = lw;
  }
  __syncthreads();
  {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (w < n_warps && wsum[w] > 0.f) M = fmaxf(M, stash[w * kRows * ss]);
    float wt[kWarps];
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = w < n_warps ? wsum[w] : 0.f;
      wt[w] = weight(stash[w * kRows * ss], lw, M);
      L += lw * wt[w];
    }
    auto block_acc = [&](int d) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (wt[w] != 0.f) {
          float aw = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            aw += stash[(w * kRows + r) * ss + 2 + d];
          a += aw * wt[w];
        }
      return a;
    };
    if (sh.alone) {      // the block's partial is the answer
      const float inv = 1.f / L;
      for (int d = threadIdx.x; d < D; d += blockDim.x)
        store(out + h * D + d, block_acc(d) * inv);
      return;
    }
    // push this block's partial into rank 0's slot `rank`
    float* dst = cluster.map_shared_rank(recv + rank * (2 + D), 0);
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      dst[2 + d] = block_acc(d);
    if (threadIdx.x == 0) {
      dst[0] = M;
      dst[1] = L;
    }
  }
  cluster_arrive();            // phase 2: the pushes are visible to rank 0
  cluster_wait();
  if (rank != 0) return;

  // combine the partials of the blocks with rows in rank order; an empty
  // one weighs 0
  float M = -INFINITY;
#pragma unroll
  for (int r = 0; r < kCluster; ++r)
    if (r < sh.used && recv[r * (2 + D) + 1] > 0.f)
      M = fmaxf(M, recv[r * (2 + D)]);
  float wr[kCluster];
  float L = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const float lr = r < sh.used ? recv[r * (2 + D) + 1] : 0.f;
    wr[r] = weight(recv[r * (2 + D)], lr, M);
    L += lr * wr[r];
  }
  const float inv = 1.f / L;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (wr[r] != 0.f) a += recv[r * (2 + D) + 2 + d] * wr[r];
    store(out + h * D + d, a * inv);
  }
}

int n_warps_for(int D, int es) {
  const int dp_bytes = ((D * es + 15) / 16) * 16;
  const int fit = kSmemBudget / (kStages * 2 * kRows * dp_bytes);
  return fit < kWarps ? fit : kWarps;
}

template <typename T, int NVL>
int launch_nvl(const void* q, const void* k, const void* v, const int* pos,
               void* out, int B, int S, int C, int n_head,
               cudaStream_t stream) {
  auto kern = batched_decode_kernel<T, NVL>;
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t set = raise_smem_limit(kern, configured, kSmemMax);
  if (set != cudaSuccess) return (int)set;
  const int D = C / n_head;
  const int es = (int)sizeof(T);
  const int warps = n_warps_for(D, es);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int dp = ((D * es + 15) / 16) * 16 / es;
  // the ring (at the end it holds the row slots' partials, 8 * warps slots
  // of D + 3 floats, which the ring's 64 * D * sizeof(T) bytes a warp
  // exceed), then rank 0's receive slots
  const size_t smem = (size_t)warps * kStages * 2 * kRows * dp * es +
                      (size_t)kCluster * (2 + D) * sizeof(float);
  const int vec_ok =
      (D * es) % 16 == 0 && (C * es) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const float qscale = (float)(kLog2e / sqrt((double)D));
  return (int)launch_clusters(
      kern, n_head, B, warps * 32, smem, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), S, C, D, qscale, vec_ok);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int S, int C, int n_head, cudaStream_t stream) {
  const int vec = Vec<T>::n;
  const int D = C / n_head;
  const int nvl = ((D + vec - 1) / vec + 3) / 4;
  if (nvl <= 3)
    return launch_nvl<T, 3>(q, k, v, pos, out, B, S, C, n_head, stream);
  if (nvl <= 8)
    return launch_nvl<T, 8>(q, k, v, pos, out, B, S, C, n_head, stream);
  return launch_nvl<T, 16>(q, k, v, pos, out, B, S, C, n_head, stream);
}

}  // namespace

extern "C" {

// q (B, C), k and v (B, S, C) row-major, out (B, C), all of one type
// (dtype: 0 = float32, 1 = bfloat16); pos is B int32 values in device
// memory.  Returns a cudaError_t: 0 when the launch was accepted.
int llmvox_batched_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    int B, int S, int C, int n_head,
                                    int dtype, void* stream) {
  if (n_head <= 0 || C % n_head != 0 || C / n_head > kMaxD || S <= 0 ||
      B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0) return launch<float>(q, k, v, p, out, B, S, C, n_head, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, out, B, S, C, n_head, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
