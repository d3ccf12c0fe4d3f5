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
// that at the card's bf16 tensor-core rate up to M = 80 (0.38 us for
// 80 x 3072 x 768).  So a call costs the launch and the latency of one pass
// over the weight, and the design reads every packed byte once.
//
// Design: one launch, grid (ceil(Cout / 64), 8, ceil(M / rows)), the 8
// blocks along y forming a thread-block cluster that splits the contraction.
//   - Every M row in one block.  A block holds rows = 16 * MT rows of x
//     (MT = 1, 3 or 5 m16 tiles by M, so up to 80 rows: every served M), so
//     each packed byte is read and dequantized once per call.  An M above 80
//     takes more blocks along z.  x is rounded to bf16 and staged in shared
//     memory (bf16 x by cp.async), rows zero-padded to 16.
//   - The packed tile (the block's share of packed rows x 64 columns) is
//     staged by 16-byte cp.async copies, coalesced, in pieces of up to 256
//     packed rows.
//   - Tensor cores through mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16
//     .f32.  wgmma wants 64-row tiles, which M <= 80 does not fill, and the
//     k16 layout of mma.sync matches the packing: a lane's B register 0 holds
//     k rows 2t, 2t+1 of column lane/4 (t = lane % 4), which are the low and
//     high nibble of ONE packed byte q[i0 + t, c]; register 1 is byte
//     q[i0 + 4 + t, c].  So one byte, sign-extended, scaled in f32, rounded
//     to bf16 and packed as bf16x2, is one fragment register.  A fragments
//     come from the staged x by ldmatrix.x4.  Each of 4 column warps owns 16
//     columns (two n8 tiles) for all MT m-tiles; with 12 or more k16 steps a
//     block, 2 or 4 such warp groups take alternate steps and are folded in
//     group order through shared memory.  A lane keeps its two columns'
//     scales for the group of each of its two rows and reloads them only
//     when a row crosses into the next group.
//   - Split-K inside the cluster: block r pushes n8 tile j of its f32
//     partial into slot r of block j's shared memory (map_shared_rank), with
//     one split cluster barrier (arrive at the start, wait while the first
//     copies land; arrive with release after the pushes, wait with
//     acquire).  Block
//     j then sums its 8 slots in rank order (deterministic run to run) and
//     writes n8 tile j of the output in x's type.  No reduce kernel and no
//     scratch.
// The kernel allocates nothing and does not synchronise; it runs on the
// caller's stream.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 64;          // output columns per block
constexpr int kColWarps = 4;       // 16 columns each
constexpr int kMaxKWarps = 4;      // warp groups that split a block's k16 steps
constexpr int kMaxThreads = kColWarps * kMaxKWarps * 32;
constexpr int kSplit = 8;          // blocks per cluster along the contraction
constexpr int kPiece = 256;        // packed rows staged at once, at most
constexpr int kQStride = kCols + 16;   // bytes per staged packed row
constexpr int kMaxSmem = 140 * 1024;
static_assert(kCols / 8 == kSplit, "rank r reduces n8 tile r of the block");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// eight consecutive x values of one row from column col (zero past lim)
__device__ __forceinline__ void load8(const float* xr, int col, int lim,
                                      bool vec, float* f) {
  if (vec && col + 8 <= lim) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(xr + col));
    const float4 b = __ldg(reinterpret_cast<const float4*>(xr + col + 4));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = col + e < lim ? xr[col + e] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* xr, int col,
                                      int lim, bool vec, float* f) {
  if (vec && col + 8 <= lim) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + col));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = col + e < lim ? __bfloat162float(xr[col + e]) : 0.f;
  }
}

// one packed byte -> bf16x2 (low nibble in the low half), scaled in f32
__device__ __forceinline__ uint32_t dequant2(int8_t byte, float sc) {
  const int b = byte;
  const int lo = (int)((unsigned)b << 28) >> 28;
  const int hi = b >> 4;
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn((float)lo, sc),
                                                 __fmul_rn((float)hi, sc));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// packed rows per block of a cluster
__host__ __device__ int chunk_rows(int P) {
  return ((P + kSplit - 1) / kSplit + 7) / 8 * 8;
}

// shared memory: the staged x and packed tile (also the k-warp fold area),
// then the receive area for the cluster's pushed partials
__host__ __device__ int recv_offset(int MT, int P, int n_kw) {
  const int piece = chunk_rows(P) < kPiece ? chunk_rows(P) : kPiece;
  const int staged = 16 * MT * (2 * piece + 8) * 2 + piece * kQStride;
  const int fold = n_kw > 1 ? MT * 8 * kColWarps * 32 * 4 : 0;
  return staged > fold ? staged : fold;
}
__host__ __device__ int recv_bytes(int MT) {
  return kSplit * 16 * MT * 8 * 4;
}

template <typename TX, typename TS, int MT>
__global__ void __launch_bounds__(kMaxThreads)
int4_mm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
               const TS* __restrict__ s, TX* __restrict__ out, int M, int P,
               int Cout, int rpg, int x_vec) {
  constexpr int kRows = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_base = blockIdx.x * kCols;
  const int m_base = blockIdx.z * kRows;
  const int cin = 2 * P;
  const int G = P / rpg;
  const int chunk = chunk_rows(P);
  const int i_begin = rank * chunk;
  const int i_end = min(P, i_begin + chunk);
  const int piece = min(kPiece, chunk);
  const int xs = 2 * piece + 8;       // bf16 per staged x row (padded)
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* qsm = reinterpret_cast<int8_t*>(smem + kRows * xs * 2);
  cluster_arrive_relaxed();    // phase 1: this block has started

  const int n_threads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % kColWarps, kw = (tid >> 5) / kColWarps;
  const int n_kw = n_threads / (32 * kColWarps);
  const int g = lane >> 2, t = lane & 3;
  // rank r's partials land in slot r of each block's receive area
  float* recv = reinterpret_cast<float*>(smem + recv_offset(MT, P, n_kw));
  int cl[2], cg_[2];                  // local and global columns
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    cl[nt] = warp * 16 + nt * 8 + g;
    cg_[nt] = n_base + cl[nt];
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // this lane's two packed rows per k16 step (i0 + t, i0 + 4 + t): their
  // scale group, where it ends, and the two columns' scales
  int gi[2], bound[2];
  float sc[2][2];
  auto load_scales = [&](int rs) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      sc[rs][nt] = cg_[nt] < Cout
                       ? to_f32(s[(size_t)min(gi[rs], G - 1) * Cout +
                                  cg_[nt]])
                       : 0.f;
  };
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    gi[rs] = (i_begin + 8 * kw + 4 * rs + t) / rpg;
    bound[rs] = (gi[rs] + 1) * rpg;
    load_scales(rs);
  }

  bool waited = false;
  for (int p0 = i_begin; p0 < i_end; p0 += piece) {
    const int nk = (min(piece, i_end - p0) + 7) / 8;   // k16 steps
    // the packed tile: nk * 8 rows x 64 columns, zero past i_end or Cout
    for (int e = tid; e < nk * 8 * (kCols / 16); e += n_threads) {
      const int r = e / (kCols / 16), seg = e % (kCols / 16);
      const int row = p0 + r, col = n_base + seg * 16;
      int8_t* dst = qsm + r * kQStride + seg * 16;
      if (row < i_end && col < Cout)
        cp_async16(dst, q + (size_t)row * Cout + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    // x rows m_base.., logical columns 2*p0 .. 2*p0 + 16*nk, as bf16
    const int kc8 = 2 * nk;           // 8-column groups per row
    const float inv_kc8 = 1.f / kc8;  // exact quotients: e < 2^14
    for (int e = tid; e < kRows * kc8; e += n_threads) {
      const int m = (int)((e + 0.5f) * inv_kc8), kk = (e - m * kc8) * 8;
      const int row = m_base + m;
      if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
        if (x_vec && row < M && 2 * p0 + kk + 8 <= 2 * i_end) {
          cp_async16(xsm + m * xs + kk, x + (size_t)row * cin + 2 * p0 + kk);
          continue;
        }
      }
      float f[8];
      if (row < M) {
        load8(x + (size_t)row * cin, 2 * p0 + kk, 2 * i_end, x_vec, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        pw[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(xsm + m * xs + kk) = packed;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!waited) {               // phase 1 done while the copies land
      cluster_wait();
      waited = true;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

#pragma unroll 2
    for (int ks = kw; ks < nk; ks += n_kw) {
      const int i0 = p0 + 8 * ks;
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        const int i = i0 + 4 * rs + t;
        if (i >= bound[rs]) {
          while (i >= bound[rs]) {
            ++gi[rs];
            bound[rs] += rpg;
          }
          load_scales(rs);
        }
      }
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rs = 0; rs < 2; ++rs)
          b[nt][rs] = dequant2(qsm[(8 * ks + 4 * rs + t) * kQStride + cl[nt]],
                               sc[rs][nt]);
      const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int a_col = 16 * ks + 8 * (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, xsm + (16 * mt + a_row) * xs + a_col);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
    __syncthreads();                  // before the next piece or the tile
  }

  // fold the k-warp groups into group 0, in group order (the staging area
  // is free now)
  if (n_kw > 1) {
    float* fold = reinterpret_cast<float*>(smem);
    const int slot = (tid & (kColWarps * 32 - 1));
    for (int w = 1; w < n_kw; ++w) {
      if (kw == w) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* f = fold + ((mt * 2 + nt) * 4 + e) * kColWarps * 32 + slot;
              *f = w == 1 ? acc[mt][nt][e] : *f + acc[mt][nt][e];
            }
      }
      __syncthreads();
    }
    if (kw == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += fold[((mt * 2 + nt) * 4 + e) * kColWarps * 32 +
                                   slot];
    }
  }

  // push the partial tile: n8 tile j of the block goes to rank j's slot
  // `rank`, so each block then reduces 8 columns
  if (!waited) cluster_wait();   // a block with no rows: phase 1 done
  if (kw == 0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* dst = cluster.map_shared_rank(recv + rank * kRows * 8,
                                           warp * 2 + nt);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = 16 * mt + g;
        *reinterpret_cast<float2*>(dst + r * 8 + 2 * t) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(dst + (r + 8) * 8 + 2 * t) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
  cluster_arrive();            // phase 2: the pushes are visible
  cluster_wait();

  // sum the 8 partials of n8 tile `rank` in rank order
  const int rows = min(kRows, M - m_base);
  const int col0 = n_base + 8 * rank;
  for (int e = tid; e < rows * 8; e += n_threads) {
    const int m = e >> 3, c = e & 7;
    if (col0 + c < Cout) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kSplit; ++r) v += recv[(r * kRows + m) * 8 + c];
      store(out + (size_t)(m_base + m) * Cout + col0 + c, v);
    }
  }
}

// A function attribute applies on the current device only, so the raised
// shared-memory limit is set once on each device that launches the
// instantiation (`done` holds one bit a device).
template <typename F>
cudaError_t raise_smem_limit(F kern, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename TX, typename TS, int MT>
int launch_mt(const void* x, const void* q, const void* s, void* out, int M,
              int P, int Cout, int G, cudaStream_t stream) {
  auto kern = int4_mm_kernel<TX, TS, MT>;
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t set = raise_smem_limit(kern, configured);
  if (set != cudaSuccess) return (int)set;
  const int rows = 16 * MT;
  const int steps = chunk_rows(P) / 8;   // k16 steps of a block
  // warp groups that split the block's k16 steps: measured best with 1
  // group at 6 steps a block (the 768-row weights) and 4 at 24 (wproj)
  const int n_kw = steps >= 24 ? 4 : steps >= 12 ? 2 : 1;
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    ((size_t)2 * P * sizeof(TX)) % 16 == 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Cout + kCols - 1) / kCols, kSplit,
                     (M + rows - 1) / rows);
  cfg.blockDim = dim3(32 * kColWarps * n_kw);
  cfg.dynamicSmemBytes = (size_t)recv_offset(MT, P, n_kw) + recv_bytes(MT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kSplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const TS*>(s), static_cast<TX*>(out), M, P, Cout, P / G,
      x_vec);
}

template <typename TX, typename TS>
int launch(const void* x, const void* q, const void* s, void* out, int M,
           int P, int Cout, int G, cudaStream_t stream) {
  if (M <= 16) return launch_mt<TX, TS, 1>(x, q, s, out, M, P, Cout, G, stream);
  if (M <= 48) return launch_mt<TX, TS, 3>(x, q, s, out, M, P, Cout, G, stream);
  return launch_mt<TX, TS, 5>(x, q, s, out, M, P, Cout, G, stream);
}

}  // namespace

extern "C" {

// x (M, 2P) row-major in x_dtype, q (P, Cout) int8 row-major and 16-byte
// aligned, s (G, 1, Cout) in s_dtype, out (M, Cout) in x_dtype (dtype 0 =
// float32, 1 = bfloat16).  Returns a cudaError_t: 0 when the launch was
// accepted.
int llmvox_int4_matmul(const void* x, const void* q, const void* s,
                       void* out, int M, int P, int Cout, int G, int x_dtype,
                       int s_dtype, void* stream) {
  if (M <= 0 || P <= 0 || G <= 0 || P % G != 0 || Cout <= 0 ||
      Cout % 16 != 0 || (M + 79) / 80 > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, q, s, out, M, P, Cout, G, st);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, q, s, out, M, P, Cout, G, st);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, q, s, out, M, P, Cout, G, st);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, M, P, Cout, G,
                                                st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
