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
// At B = 16, full depth, C = 768 in bf16 that is ~403 MB, ~120 us, K2's
// bound: the draft window adds no bytes.  The arithmetic, 4 * C flops per
// (query, attended row), is ~2.0 GFLOP at nq = 5 and ~5.2 at nq = 13: more
// than half of what the CUDA cores do in f32 in those 120 us at nq = 13,
// so in bf16 both products run on the tensor cores.
//
// Design: one launch, grid (n_head, kCluster, B); the kCluster = 8 blocks
// of one (head, stream) form a thread-block cluster (attn_cluster.cuh), so
// the grid depends on (n_head, B) alone and the launch is capturable in a
// CUDA graph.
//   - Rows split by the device's pos[b]: every block takes an equal share,
//     in 16-row tiles, of rows 0..min(pos[b] + nq - 1, S - 1); while they
//     fit one tile a warp, rank 0 takes them all, the others exit and rank
//     0 writes the output with no exchange.
//   - Each warp owns 16 rows of every block tile and streams its K and V
//     rows through its own ring of 16-byte cp.async copies (rows past the
//     share are zero-filled), so a warp needs only __syncwarp in the loop.
//     Two stages (one tile landing while one is computed): 53 KB of ring
//     fit three blocks an SM against four stages' two, so more of the 128
//     clusters of B = 16 run at once; measured faster at every shape, by
//     a third at served depths (PERF.md).
//   - bf16: the queries sit in the M dimension of mma.sync m16n8k16 (nq up
//     to 16 is one tile; rows j >= nq are zero and never written).  Their A
//     fragments are loaded once and stay in registers.  Scores: the 16-row
//     K tile is the B operand of two n8 tiles (ldmatrix, no transpose);
//     bf16 x bf16 products are exact in f32, only the order of the sum
//     differs from the plain version.  The online softmax runs per query in
//     f32 (base 2), with the mask row <= pos[b] + j.  Value sum: the score
//     accumulators of the two n8 tiles are exactly the A fragment of P for
//     the k16 step over the tile's rows (no shuffle); P is split into
//     hi = bf16(P) and lo = bf16(P - hi) and both go through an mma against
//     V (ldmatrix.trans), so P is carried to ~2^-17 and no product is
//     rounded to bf16 (P rounded to bf16 alone would break the tolerance).
//   - f32: the same fragment ownership on the CUDA cores (TF32 is off in
//     the port): each lane forms its eight scores from the queries in
//     shared memory and the K tile, and its value sums from the quad's
//     probabilities (shuffles) and the V tile.
//   - Each block merges its warps in warp order, then pushes its partial
//     (m, l, acc[D]) of query j into cluster rank j % 8, under one split
//     cluster barrier; rank r merges the partials of its queries in rank
//     order (deterministic run to run; an empty partial weighs 0) and
//     writes them.  No global scratch.
// The kernel allocates nothing and does not synchronise; it runs on the
// caller's stream.
#include <cooperative_groups.h>

#include "attn_cluster.cuh"

namespace cg = cooperative_groups;
using namespace llmvox_attn;

namespace {

constexpr int kTile = 16;           // rows per warp per tile
constexpr int kStages = 2;          // per-warp ring depth (PERF.md)
constexpr int kWarps = 4;
constexpr int kMaxQ = 16;           // queries per stream (k_draft + 1)
constexpr int kMaxD = 128;          // head_dim
constexpr int kSmemBudget = 200 * 1024;   // the ring (and f32 queries)
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row stride in shared memory, in elements: bf16 rows are padded to whole
// k16 steps plus 8 (16 bytes), so the eight rows of an ldmatrix land in
// distinct banks; f32 rows by 4 (16 bytes) for the same reason.
__host__ __device__ __forceinline__ int row_stride(int D, int es) {
  return es == 2 ? (D + 15) / 16 * 16 + 8 : D + 4;
}

// Fragment ownership, the mma's: lane = 4 g + t holds, for queries g and
// g + 8, the scores of tile rows 2t, 2t+1 (n8 tile 0) and 8+2t, 9+2t (n8
// tile 1): s[tile][0..1] for query g, s[tile][2..3] for query g + 8; and
// the outputs of columns 8 jd + 2t, +1: acc[jd][0..1] for query g,
// acc[jd][2..3] for query g + 8.
//
// DT: the head width when fixed at compile time (the deployed 96), else 0
// (any width up to kMaxD, read at run time).
template <typename T, int DT>
__global__ void __launch_bounds__(kWarps * 32)
verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ out, int S, int C, int d_arg, int nq,
              float qscale) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int VEC = Vec<T>::n;
  constexpr int kND = DT ? DT / 8 : kMaxD / 8;       // n8 column tiles
  constexpr int kKS = (kND + 1) / 2;                 // k16 steps over D
  const int D = DT ? DT : d_arg;
  const int nd = D / 8;
  const int ks_n = (D + 15) / 16;
  const int DP = row_stride(D, (int)sizeof(T));
  const int NVP = D / VEC;                           // 16-byte vectors a row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int rank = (int)cluster.block_rank();
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t tile_elems = (size_t)2 * kTile * DP;  // K and V of a tile
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* my_ring = ring + (size_t)warp * kStages * tile_elems;
  // f32: the queries, zero rows up to kMaxQ, after the ring
  float* qs = reinterpret_cast<float*>(
      smem_raw + (size_t)n_warps * kStages * tile_elems * sizeof(T));
  // the partials pushed to this rank: kCluster slots of the queries j with
  // j % kCluster == rank, each (m, l, acc[D])
  const int q_per_rank = (nq + kCluster - 1) / kCluster;
  float* recv = qs + (kBF16 ? 0 : kMaxQ * DP);
  const int slot_floats = q_per_rank * (2 + D);

  const int p = pos[b];
  const int n = min(p + nq, S);
  const Share sh = share_rows(n, rank, kTile, n_warps);
  if (sh.alone && rank != 0) return;
  const int b1 = sh.b1;
  const int tile_rows = kTile * n_warps;
  const int first = sh.b0 + kTile * warp;    // this warp's rows in tile 0
  const int n_tiles = first < b1 ? (b1 - first + tile_rows - 1) / tile_rows
                                 : 0;
  if (!sh.alone) cluster_arrive_relaxed();   // phase 1: this block started

  const T* kb = k + (size_t)b * S * C + (size_t)h * D;
  const T* vb = v + (size_t)b * S * C + (size_t)h * D;
  const T* qb = q + (size_t)b * nq * C + (size_t)h * D;

  // bf16 with D not a whole number of k16 steps: the K columns past D are
  // read by the score mma against zero queries, so they must be finite
  if (kBF16 && DT == 0 && D % 16) {
    for (int x = lane; x < kStages * 2 * kTile; x += 32)
      for (int d = D; d < ks_n * 16; ++d) my_ring[x * DP + d] = T(0.f);
    __syncwarp();
  }

  // stage the K and V rows of tile t into ring slot t % kStages; rows past
  // the block's share are zero-filled (P is 0 there, and 0 * V must be 0)
  auto stage = [&](int t) {
    if (t < n_tiles) {
      const int row0 = first + t * tile_rows;
      const int vt = min(kTile, b1 - row0);
      T* dst = my_ring + (size_t)(t % kStages) * tile_elems;
      for (int c = lane; c < 2 * kTile * NVP; c += 32) {
        const int r = c / NVP, x = c - r * NVP;      // r: K rows, then V
        const int rr = r & (kTile - 1);
        const T* src = (r < kTile ? kb : vb) + (size_t)(row0 + rr) * C +
                       x * VEC;
        cp_async16(dst + r * DP + x * VEC, rr < vt ? src : kb, rr < vt);
      }
    }
    cp_async_commit();   // an empty group keeps the count uniform
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage(t);

  // the queries: bf16 A fragments in registers for the whole kernel; f32
  // rows in shared memory
  unsigned qa[kKS][4];
  if constexpr (kBF16) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = g + 8 * (e & 1);
        const int d = 16 * ks + 8 * (e >> 1) + 2 * t4;
        qa[ks][e] = j < nq && d < D
            ? *reinterpret_cast<const unsigned*>(qb + (size_t)j * C + d)
            : 0u;
      }
  } else {
    for (int x = threadIdx.x; x < kMaxQ * D; x += blockDim.x) {
      const int j = x / D, d = x - j * D;
      qs[j * DP + d] = j < nq ? to_f32(qb[(size_t)j * C + d]) : 0.f;
    }
    __syncthreads();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kND][4];
#pragma unroll
  for (int jd = 0; jd < kND; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;

  if (!sh.alone) cluster_wait();  // phase 1 done (while the first tiles land)
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* kt = my_ring + (size_t)(t % kStages) * tile_elems;
    const T* vt_ = kt + kTile * DP;
    const int row0 = first + t * tile_rows;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (kBF16) {
      // lanes 0-7: rows 0-7 at column k0; 8-15: rows 0-7 at k0 + 8;
      // 16-23: rows 8-15 at k0; 24-31: rows 8-15 at k0 + 8
      const T* kl = kt + ((lane & 7) + 8 * (lane >> 4)) * DP +
                    8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if (DT == 0 && ks >= ks_n) break;
        unsigned kf[4];
        ldsm_x4(kf, kl + 16 * ks);
        mma_bf16(s[0], qa[ks], kf[0], kf[1]);
        mma_bf16(s[1], qa[ks], kf[2], kf[3]);
      }
    } else {
      const float* kf = reinterpret_cast<const float*>(kt);
      const float* q0 = qs + g * DP;
      const float* q1 = qs + (g + 8) * DP;
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
        const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kr = *reinterpret_cast<const float4*>(
                kf + (8 * tt + 2 * t4 + e) * DP + d);
            s[tt][e] += a0.x * kr.x + a0.y * kr.y + a0.z * kr.z + a0.w * kr.w;
            s[tt][2 + e] +=
                a1.x * kr.x + a1.y * kr.y + a1.z * kr.z + a1.w * kr.w;
          }
      }
    }

    // mask (row r attends query j iff r <= pos + j and r lies in the
    // block's share), scale into the exp2 domain, online softmax per query
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int j = g + 8 * hq;
      float mt = -INFINITY;
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + 8 * tt + 2 * t4 + e;
          float& x = s[tt][2 * hq + e];
          x = (r < b1 && r <= p + j) ? x * qscale : -INFINITY;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      if (mt > m[hq]) {                       // uniform over the quad
        const float alpha = exp2f(m[hq] - mt);  // 0 on the first rows
        l[hq] *= alpha;
#pragma unroll
        for (int jd = 0; jd < kND; ++jd) {
          acc[jd][2 * hq] *= alpha;
          acc[jd][2 * hq + 1] *= alpha;
        }
        m[hq] = mt;
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[tt][2 * hq + e];
          x = x == -INFINITY ? 0.f : exp2f(x - m[hq]);
          l[hq] += x;
        }
    }

    // acc += P V over the tile's 16 rows
    if constexpr (kBF16) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[e >> 1][2 * (e & 1)];
        const float x1 = s[e >> 1][2 * (e & 1) + 1];
        ph[e] = pack_bf16(x0, x1);
        pl[e] = pack_bf16(x0 - bf16_lo(ph[e]), x1 - bf16_hi(ph[e]));
      }
      // lanes 0-15: rows 0-15 at column 8 jd; 16-31: rows 0-15 at
      // 8 (jd + 1)
      const T* vl = vt_ + (lane & 15) * DP + 8 * (lane >> 4);
#pragma unroll
      for (int jd = 0; jd < kND; jd += 2) {
        if (DT == 0 && jd >= nd) break;
        if (jd + 1 < kND && (DT != 0 || jd + 1 < nd)) {
          unsigned vf[4];
          ldsm_x4_t(vf, vl + 8 * jd);
          mma_bf16(acc[jd], ph, vf[0], vf[1]);
          mma_bf16(acc[jd], pl, vf[0], vf[1]);
          mma_bf16(acc[jd + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[jd + 1], pl, vf[2], vf[3]);
        } else {
          unsigned vf[2];
          ldsm_x2_t(vf, vt_ + (lane & 15) * DP + 8 * jd);
          mma_bf16(acc[jd], ph, vf[0], vf[1]);
          mma_bf16(acc[jd], pl, vf[0], vf[1]);
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(vt_);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int src = 4 * g + ((r & 7) >> 1);
        const float pa = __shfl_sync(0xffffffffu, s[r >> 3][r & 1], src);
        const float pb = __shfl_sync(0xffffffffu, s[r >> 3][2 + (r & 1)], src);
        const float* vr = vf + r * DP + 2 * t4;
#pragma unroll
        for (int jd = 0; jd < kND; ++jd) {
          if (DT == 0 && jd >= nd) break;
          const float2 x = *reinterpret_cast<const float2*>(vr + 8 * jd);
          acc[jd][0] += pa * x.x;
          acc[jd][1] += pa * x.y;
          acc[jd][2] += pb * x.x;
          acc[jd][3] += pb * x.y;
        }
      }
    }
    __syncwarp();        // the slot is refilled by the next stage()
  }

  cp_async_wait<0>();
  __syncthreads();

  // Warp partials through shared memory (the ring is free now): warp w,
  // query j holds (m, l, acc[D]) at stash[(w * kMaxQ + j) * (D + 2)].
  const int ps = D + 2;
  float* stash = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int hq = 0; hq < 2; ++hq) {
    l[hq] += __shfl_xor_sync(0xffffffffu, l[hq], 1);
    l[hq] += __shfl_xor_sync(0xffffffffu, l[hq], 2);
    float* mine = stash + (warp * kMaxQ + g + 8 * hq) * ps;
    if (t4 == 0) {
      mine[0] = m[hq];
      mine[1] = l[hq];
    }
#pragma unroll
    for (int jd = 0; jd < kND; ++jd) {
      if (DT == 0 && jd >= nd) break;
      mine[2 + 8 * jd + 2 * t4] = acc[jd][2 * hq];
      mine[3 + 8 * jd + 2 * t4] = acc[jd][2 * hq + 1];
    }
  }
  __syncthreads();

  // The block's partial of query j, element c (0: m, 1: l, 2 + d: acc[d]),
  // its warps merged in warp order.
  auto block_part = [&](int j, int c) {
    float M = -INFINITY;
    for (int w = 0; w < n_warps; ++w) {
      const float* pw = stash + (w * kMaxQ + j) * ps;
      if (pw[1] > 0.f) M = fmaxf(M, pw[0]);
    }
    if (c == 0) return M;
    float a = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* pw = stash + (w * kMaxQ + j) * ps;
      const float wt = weight(pw[0], pw[1], M);
      if (wt != 0.f) a += pw[c] * wt;
    }
    return a;
  };

  T* ob = out + (size_t)b * nq * C + (size_t)h * D;
  if (sh.alone) {        // the block's partials are the answer
    for (int x = threadIdx.x; x < nq * D; x += blockDim.x) {
      const int j = x / D, d = x - j * D;
      store(ob + (size_t)j * C + d, block_part(j, 2 + d) / block_part(j, 1));
    }
    return;
  }
  // push query j's partial into slot `rank` of cluster rank j % kCluster
  for (int x = threadIdx.x; x < nq * ps; x += blockDim.x) {
    const int j = x / ps, c = x - j * ps;
    float* dst = cluster.map_shared_rank(
        recv + rank * slot_floats + (j / kCluster) * ps + c, j % kCluster);
    *dst = block_part(j, c);
  }
  cluster_arrive();            // phase 2: the pushes are visible
  cluster_wait();

  // combine this rank's queries over the blocks with rows, in rank order
  for (int x = threadIdx.x; x < q_per_rank * D; x += blockDim.x) {
    const int i = x / D, d = x - i * D;
    const int j = rank + kCluster * i;
    if (j >= nq) break;
    const float* slot = recv + i * ps;
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (r < sh.used && slot[r * slot_floats + 1] > 0.f)
        M = fmaxf(M, slot[r * slot_floats]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r >= sh.used) break;
      const float* pr = slot + r * slot_floats;
      const float wr = weight(pr[0], pr[1], M);
      if (wr != 0.f) {
        L += pr[1] * wr;
        a += pr[2 + d] * wr;
      }
    }
    store(ob + (size_t)j * C + d, a / L);
  }
}

int n_warps_for(int D, int es) {
  const int tile = kStages * 2 * kTile * row_stride(D, es) * es;
  const int queries = es == 4 ? kMaxQ * row_stride(D, es) * 4 : 0;
  const int fit = (kSmemBudget - queries) / tile;
  return fit < kWarps ? fit : kWarps;
}

template <typename T, int DT>
int launch_dt(const void* q, const void* k, const void* v, const int* pos,
              void* out, int B, int S, int C, int n_head, int nq,
              cudaStream_t stream) {
  auto kern = verify_kernel<T, DT>;
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t set = raise_smem_limit(kern, configured, kSmemMax);
  if (set != cudaSuccess) return (int)set;
  const int D = C / n_head;
  const int es = (int)sizeof(T);
  const int warps = n_warps_for(D, es);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int dp = row_stride(D, es);
  const int q_per_rank = (nq + kCluster - 1) / kCluster;
  // the rings (at the end they hold the warps' partials, warps * kMaxQ *
  // (D + 2) floats, which a ring's kStages * 32 * DP * sizeof(T) bytes
  // exceed),
  // the f32 queries, then the receive slots
  const size_t smem = (size_t)warps * kStages * 2 * kTile * dp * es +
                      (es == 4 ? (size_t)kMaxQ * dp * 4 : 0) +
                      (size_t)kCluster * q_per_rank * (2 + D) * 4;
  const float qscale = (float)(kLog2e / sqrt((double)D));
  return (int)launch_clusters(
      kern, n_head, B, warps * 32, smem, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), S, C, D, nq, qscale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int S, int C, int n_head, int nq,
           cudaStream_t stream) {
  const int D = C / n_head;
  if ((D * sizeof(T)) % 16 != 0 || (C * sizeof(T)) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
       16) != 0 ||
      (sizeof(T) == 2 && (reinterpret_cast<uintptr_t>(q) % 4) != 0))
    return (int)cudaErrorInvalidValue;
  if (D == 96)      // the deployed decoder's head
    return launch_dt<T, 96>(q, k, v, pos, out, B, S, C, n_head, nq, stream);
  return launch_dt<T, 0>(q, k, v, pos, out, B, S, C, n_head, nq, stream);
}

}  // namespace

extern "C" {

// q (B, nq, C), k and v (B, S, C) row-major, out (B, nq, C), all of one
// type (dtype: 0 = float32, 1 = bfloat16), with D and C rows a multiple of
// 16 bytes and k and v 16-byte aligned; pos is B int32 values in device
// memory.  Returns a cudaError_t: 0 when the launch was accepted.
int llmvox_verify_attention(const void* q, const void* k, const void* v,
                            const void* pos, void* out, int B, int S, int C,
                            int n_head, int nq, int dtype, void* stream) {
  if (n_head <= 0 || C % n_head != 0 || C / n_head > kMaxD || S <= 0 ||
      B <= 0 || B > 65535 || nq <= 0 || nq > kMaxQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0)
    return launch<float>(q, k, v, p, out, B, S, C, n_head, nq, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, out, B, S, C, n_head, nq, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
