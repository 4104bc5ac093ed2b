// Fused phantom-layer GEMMs for Hopper (sm_90a): the forward and its two
// backward products.
//
// Replaces the TPU kernels of the JAX package's
// src/repro/kernels/phantom_fused.py:
//   phantom_fused_matmul (:118, pl.pallas_call :157)  z = x.L + g.D
//   matmul_nt            (:206, pl.pallas_call :221)  c = a.b^T  (dgrad)
//   matmul_tn            (:239, pl.pallas_call :254)  c = a^T.b  (wgrad)
// and match their oracles: float32 accumulation, the output in the input
// dtype (float32 or bfloat16).  The products are IEEE fp32 FMAs on the CUDA
// cores, no TF32 tensor cores, so float32 results hold the reference's
// rtol 2e-4.
//
// Bound.  At the paper-ffn-16k shapes per rank (p = 8, batch 64: x [64,2048],
// L [2048,2048], g [64,128], D [128,2048]) each of the three products is
// 0.57 GFLOP over ~19 MB: bound by fp32 operations, 8.5 us at 67 TFLOP/s.
//
// The two short-output products (forward z [64, 2048], dgrad [64, 2176])
// run through splitk_kernel.  A one-block-per-32x32-tile GEMM held them at
// 13-16x the bound for four reasons; what this design does about each:
//   * too few blocks (128 and 136 for 132 SMs): a block owns a 64x64 output
//     tile, so each element of L or [L;D] is read from device memory once,
//     and the contraction is split over S blocks, one cluster per tile.
//     The wrapper's gemm_plan takes the largest S <= 8 whose clusters the
//     card holds at once (cudaOccupancyMaxActiveClusters: 32 clusters of 7
//     and 39 of 6 at two blocks per SM, only 30 of 8) and that leaves
//     every block two slabs or more: 32 x 7 = 224 blocks for the forward
//     and 34 x 6 = 204 for the dgrad at the main shape, one wave each;
//   * a long serial walk (68 slabs per block): each block walks 9-11;
//   * narrow loads through registers: global -> shared copies are
//     cp.async.cg of 16 bytes into a ring of STAGES = 4 slabs in dynamic
//     shared memory (72 KB a block in fp32), so three slabs are in flight
//     while one is multiplied;
//   * 3 shared loads per 8 FMAs: each of 256 threads keeps a 4x4 fp32
//     register tile and, per 4-deep step of k, reads 4 vectors of A and 4
//     of B (16-byte float4, or 8-byte for bf16, converted on the read):
//     64 FMAs per 8 shared loads.
// Layout.  cp.async copies bytes and cannot transpose, so an operand whose
// contraction axis is contiguous in device memory (the forward's x and g,
// the dgrad's dz and [L;D]) stays k-contiguous in shared memory, one row
// per output row (column), pitch BK + 16 bytes.  The transpose happens in
// registers: a thread reads 4 consecutive k of each of its 4 rows as one
// vector and uses the 4x4 block column by column.  L and D in the forward
// are already k-major ([k][n], pitch BN + 16 bytes).  Bank conflicts: A rows
// are read as broadcasts (the 16 threads of a half-warp share their rows);
// k-major B rows are read as 128 contiguous bytes per quarter-warp; for
// the dgrad's k-contiguous B rows a thread's columns are tx + 16 j, so the
// 8 threads of a quarter-warp read 8 rows whose pitch of 36 words puts them
// on 8 disjoint groups of 4 banks (bf16, pitch 20 words: two-way).
// Reduction.  The S blocks of one output tile form one thread-block cluster
// (cudaLaunchAttributeClusterDimension).  After its loop each block leaves
// its fp32 partial tile in its own shared memory (the ring, reused); after
// cluster.sync() block r sums rows [r 64/S, (r+1) 64/S) over ranks 0..S-1
// in rank order, reading them through distributed shared memory
// (map_shared_rank), and writes them in the output dtype; a second
// cluster.sync() keeps every block's shared memory alive until then.  No
// atomics, no workspace, one launch, and the same bits on every run.
// Unaligned operands (a row pitch or contiguous width that is not a
// multiple of 16 bytes, or an unaligned base) take the masked variant of
// the same template (VEC = false): element-wise loads into the same ring.
// The wrapper picks the variant from strides and data_ptr().
// The forward keeps two contraction segments (x.L, then g.D) into the same
// registers, and a block's range of slabs may straddle the boundary; the
// dgrad reads [L;D] through two pointers; ragged edges are masked (zero
// fill), nothing is padded or concatenated in device memory.
//
// The wgrad ([x|g]^T.dz, output [2176, 2048], contraction 64: 285 M FMAs,
// 8.5 us at 67 TFLOP/s; the output alone is 17.8 MB in fp32, 5.3 us at
// 3.35 TB/s) runs through tn_kernel.  A one-block-per-32x32-tile GEMM held
// it at 4.8x the bound: 4352 blocks that each lived for two slabs, 2.7
// FMAs per shared load, element-wise slab fetches through registers and
// scalar 4-byte stores.  This design:
//   * both operands are k-major in device memory ([k][i], [k][n]), so
//     16-byte cp.async.cg copies put 16-deep slabs straight into the layout
//     the outer product reads, in a ring of 4 slabs in dynamic shared
//     memory (32 KB fp32): at M = 64 the whole contraction of a tile is in
//     flight at once;
//   * 64x64 output tiles per block of 256 threads, a 4x4 fp32 register tile
//     per thread: per step of k a thread reads 4 A and 4 B values as two
//     vectors (fp32 float4, bf16 8 bytes converted on the read) for 16 FMAs;
//   * stores are 16 bytes a thread (bf16: 8), row-contiguous, 256 bytes
//     per 16 threads and row;
//   * a persistent grid of one block per block the card holds at once
//     (wgrad_plan in the wrapper, from the card's
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor: 528 on the H100 for
//     the 16-byte variant), tiles round-robin.  The main shape's 1088
//     tiles take two full rounds and a third of 32 tiles.  128x128 tiles
//     with an 8x8 thread tile, whose 272 tiles filled one round of 264
//     with the 8 left over cut into strips, were 1.5% faster in fp32 (12%
//     in bf16) on the H100 (PERF.md, PR 14), within the spread of either
//     over repeated runs, so the one small tile stays.
// [x | g] is read through two pointers; the contraction is never split, so
// every launch gives the same bits.  Unaligned operands take the masked
// variant (element-wise loads and stores), as for splitk_kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One GEMM operand seen as rows x k: up to two matrices joined along the
// rows at `split` (rows >= split come from p1, shifted by split).  With
// KFAST the element (r, k) lies at p[r * ld + k], else at p[k * ld + r].
template <typename T>
struct Operand {
  const T* p0;
  const T* p1;
  long long ld0, ld1;
  int split, rows;
};

template <typename T>
struct Segment {      // one contraction of length kn: A (rows of C) . B (cols)
  Operand<T> a, b;
  int kn;
};

template <typename T>
struct Plan {
  Segment<T> seg[2];
  int nseg;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements of shared memory as fp32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// One operand's part of a slab into shared memory, copied by THREADS
// threads: R rows (of C's rows or columns) by BK of the contraction,
// starting at (r0, k0).  KFAST: the contraction is contiguous in device
// memory and in `dst` (dst[r * P + k]); else the rows are (dst[k * P + r]).
// Outside rows < op.rows, k < kn the slab is zero.  VEC: 16-byte cp.async
// copies (the wrapper checked that every row pitch, contiguous width and
// base is a multiple of 16 bytes); else element-wise: 4-byte cp.async for
// fp32, loads through registers for bf16 (cp.async has no 2-byte copy).
template <typename T, bool KFAST, bool VEC, int R, int P, int BK,
          int THREADS>
__device__ __forceinline__ void load_part(const Operand<T>& op, int r0,
                                          int k0, int kn, T* dst, int tid) {
  constexpr int OUTER = KFAST ? R : BK;   // rows of the slab in `dst`
  constexpr int INNER = KFAST ? BK : R;   // contiguous elements of each
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T), CH = INNER / V, NC = OUTER * CH;
    static_assert(NC % THREADS == 0 || NC < THREADS, "copies per thread");
#pragma unroll
    for (int t = 0; t < (NC + THREADS - 1) / THREADS; ++t) {
      const int c = tid + THREADS * t, o = c / CH, i = (c % CH) * V;
      if (NC < THREADS && c >= NC) break;
      const int r = r0 + (KFAST ? o : i), k = k0 + (KFAST ? i : o);
      const bool ok = r < op.rows && k < kn;
      const T* src = op.p0;
      if (ok) {
        const bool lo = r < op.split;
        const T* p = lo ? op.p0 : op.p1;
        const long long ld = lo ? op.ld0 : op.ld1;
        const long long rr = lo ? r : r - op.split;
        src = KFAST ? p + rr * ld + k : p + (long long)k * ld + rr;
      }
      cp_async16(dst + o * P + i, src, ok);
    }
  } else {
    constexpr int NE = OUTER * INNER;
    static_assert(NE % THREADS == 0 || NE < THREADS, "elements per thread");
#pragma unroll
    for (int t = 0; t < (NE + THREADS - 1) / THREADS; ++t) {
      const int e = tid + THREADS * t, o = e / INNER, i = e % INNER;
      if (NE < THREADS && e >= NE) break;
      const int r = r0 + (KFAST ? o : i), k = k0 + (KFAST ? i : o);
      const bool ok = r < op.rows && k < kn;
      const T* src = op.p0;
      if (ok) {
        const bool lo = r < op.split;
        const T* p = lo ? op.p0 : op.p1;
        const long long ld = lo ? op.ld0 : op.ld1;
        const long long rr = lo ? r : r - op.split;
        src = KFAST ? p + rr * ld + k : p + (long long)k * ld + rr;
      }
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + o * P + i, src, ok);   // in flight like the rest
      else
        dst[o * P + i] = ok ? *src : from_float<T>(0.f);
    }
  }
}

// ---- splitk_kernel: the forward and the dgrad --------------------------

namespace sk {

constexpr int BM = 64;          // output rows of a block
constexpr int BN = 64;          // output columns of a block
constexpr int BK = 32;          // contraction slab
constexpr int STAGES = 4;       // slabs in the cp.async ring
constexpr int TM = 4;           // output rows of a thread
constexpr int TN = 4;           // output columns of a thread
constexpr int RG = BM / TM;     // row groups: thread rows ty + RG i
constexpr int CG = BN / TN;     // column groups (see col_of)
constexpr int THREADS = RG * CG;
constexpr int MAX_SPLITS = 8;   // blocks in a cluster (the portable limit)

// Shared memory of one block, in T: A rows of BK (k contiguous), B either
// k-contiguous rows (B_KFAST, the dgrad) or k-major rows of BN (the
// forward).  Every pitch adds 16 bytes, so each row starts 16-byte aligned.
template <typename T, bool B_KFAST>
struct Layout {
  static constexpr int V = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int PA = BK + V;
  static constexpr int PB = B_KFAST ? BK + V : BN + V;
  static constexpr int A_ELEMS = BM * PA;
  static constexpr int B_ELEMS = B_KFAST ? BN * PB : BK * PB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int PARTIAL_BYTES = BM * BN * 4;   // the fp32 partial tile
  static constexpr int SMEM_BYTES =
      RING_BYTES > PARTIAL_BYTES ? RING_BYTES : PARTIAL_BYTES;
};

// Column j of thread column group tx.  B_KFAST: tx + CG j, so a
// quarter-warp reads 8 rows of pitch BK + 4 words on disjoint banks; else
// runs of 4 (one 16-byte read each), tx * 4 + 4 CG (j / 4) + j % 4.
template <bool B_KFAST>
__device__ __forceinline__ int col_of(int tx, int j) {
  return B_KFAST ? tx + CG * j : tx * 4 + 4 * CG * (j / 4) + j % 4;
}

template <typename T, bool B_KFAST, bool VEC>
__device__ __forceinline__ void load_slab(const Segment<T>& sg, int r0,
                                          int c0, int k0, T* stage,
                                          int tid) {
  using L = Layout<T, B_KFAST>;
  load_part<T, true, VEC, BM, L::PA, BK, THREADS>(sg.a, r0, k0, sg.kn,
                                                  stage, tid);
  load_part<T, B_KFAST, VEC, BN, L::PB, BK, THREADS>(
      sg.b, c0, k0, sg.kn, stage + L::A_ELEMS, tid);
}

// C[M, N] (row-major, ldc) = sum over the plan's segments of A . B, A with
// its contraction contiguous.  Grid (ceil(N / BN) * S, ceil(M / BM)), one
// cluster of S blocks along x per output tile; block rank r of the cluster
// walks the r-th of S near-equal ranges of the plan's slabs, numbered
// through segment 0 and then segment 1.
template <typename T, bool B_KFAST, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
splitk_kernel(const Plan<T> plan, T* __restrict__ c, long long ldc, int M,
              int N) {
  using L = Layout<T, B_KFAST>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, ty = tid / CG, tx = tid % CG;
  const int r0 = blockIdx.y * BM, c0 = (blockIdx.x / S) * BN;

  const int ns0 = (plan.seg[0].kn + BK - 1) / BK;
  const int ns1 = plan.nseg > 1 ? (plan.seg[1].kn + BK - 1) / BK : 0;
  const int total = ns0 + ns1, base = total / S, rem = total % S;
  const int first = rank * base + min(rank, rem);
  const int count = base + (rank < rem ? 1 : 0);

  auto load = [&](int i) {   // slab first + i into its ring stage
    T* stage = ring + (i % STAGES) * (L::A_ELEMS + L::B_ELEMS);
    const int s = first + i;
    if (s < ns0)
      load_slab<T, B_KFAST, VEC>(plan.seg[0], r0, c0, s * BK, stage, tid);
    else
      load_slab<T, B_KFAST, VEC>(plan.seg[1], r0, c0, (s - ns0) * BK, stage,
                                 tid);
  };

  float acc[TM][TN] = {};
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();   // empty groups keep the count of groups uniform
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();   // slab `it` has landed (this thread's)
    __syncthreads();               // ... every thread's; stage it-1 is free
    if (it + STAGES - 1 < count) load(it + STAGES - 1);
    cp_async_commit();
    const T* As = ring + (it % STAGES) * (L::A_ELEMS + L::B_ELEMS);
    const T* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[TM][4], b[4][TN];   // a[i][q] = A(row i, kk+q), b[q][j]
#pragma unroll
      for (int i = 0; i < TM; ++i)
        load4(As + (ty + RG * i) * L::PA + kk, a[i]);
      if constexpr (B_KFAST) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t[4];
          load4(Bs + col_of<true>(tx, j) * L::PB + kk, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) b[q][j] = t[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < TN; j += 4)
            load4(Bs + (kk + q) * L::PB + col_of<false>(tx, j), &b[q][j]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every thread is done with the ring: reuse it

  float* part = reinterpret_cast<float*>(smem);   // [BM][BN] fp32
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      part[(ty + RG * i) * BN + col_of<B_KFAST>(tx, j)] = acc[i][j];
  cluster.sync();   // every partial tile of the cluster is in place

  const int row0 = rank * BM / S, rows = (rank + 1) * BM / S - row0;
  for (int e = tid; e < rows * BN; e += THREADS) {
    const int row = row0 + e / BN, col = e % BN;
    float sum = 0.f;
    for (int q = 0; q < S; ++q)   // fixed order: the same bits every run
      sum += cluster.map_shared_rank(part, q)[row * BN + col];
    const int gr = r0 + row, gc = c0 + col;
    if (gr < M && gc < N) c[(long long)gr * ldc + gc] = from_float<T>(sum);
  }
  cluster.sync();   // no block leaves while another still reads its tile
}

template <typename T, bool B_KFAST, bool VEC>
cudaError_t launch_splitk_as(const Plan<T>& plan, T* c, long long ldc, int M,
                             int N, int splits, int smem,
                             cudaStream_t stream) {
  auto kernel = splitk_kernel<T, B_KFAST, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * splits, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, plan, c, ldc, M, N);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of `splits` blocks the card holds at once.
template <typename T, bool B_KFAST, bool VEC>
cudaError_t max_clusters_as(int splits, int* out) {
  auto kernel = splitk_kernel<T, B_KFAST, VEC>;
  const int smem = Layout<T, B_KFAST>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// The wrapper's plan (phantom_fused.py: gemm_plan) chose `splits` and the
// variant; its shared-memory bytes must be this layout's.
template <typename T, bool B_KFAST>
cudaError_t launch_splitk(const Plan<T>& plan, void* c, long long ldc, int M,
                          int N, int splits, int vec16, int smem,
                          cudaStream_t stream) {
  if (M <= 0 || N <= 0 || (M + BM - 1) / BM > 65535 || splits < 1 ||
      splits > MAX_SPLITS || smem != Layout<T, B_KFAST>::SMEM_BYTES)
    return cudaErrorInvalidValue;
  T* out = static_cast<T*>(c);
  return vec16 ? launch_splitk_as<T, B_KFAST, true>(plan, out, ldc, M, N,
                                                    splits, smem, stream)
               : launch_splitk_as<T, B_KFAST, false>(plan, out, ldc, M, N,
                                                     splits, smem, stream);
}

}  // namespace sk

// ---- tn_kernel: the wgrad -----------------------------------------------

namespace tn {

constexpr int BM = 64;          // output rows (i) of a tile
constexpr int BN = 64;          // output columns (n) of a tile
constexpr int BK = 16;          // contraction slab
constexpr int STAGES = 4;       // slabs in the cp.async ring
constexpr int THREADS = 256;    // 16 x 16 threads, a 4 x 4 tile each

// Shared memory of one block, in T: a ring of STAGES slabs, each A as BK
// rows of BM (a[k][i]) and B as BK rows of BN (b[k][n]), unpadded: a warp
// reads A as broadcasts and B as 128 (bf16: 64) contiguous bytes.
template <typename T>
struct Layout {
  static constexpr int A_ELEMS = BK * BM;
  static constexpr int STAGE_ELEMS = BK * (BM + BN);
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
};

// 4 consecutive outputs as one store: fp32 16 bytes, bf16 8 bytes.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// C[M, N] (row-major, ldc) = A^T . B over one contraction, A and B k-major,
// in BM x BN tiles.  Persistent: block p takes tiles p, p + gridDim.x, ...
// (row-major over tiles_n columns of tiles).  Per tile, the contraction
// goes through the ring: slab i + STAGES - 1 is copied while slab i is
// multiplied; thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns
// 4 tx .. 4 tx + 3 of the tile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
tn_kernel(const Segment<T> sg, T* __restrict__ c, long long ldc, int M,
          int N, int tiles, int tiles_n) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ns = (sg.kn + BK - 1) / BK;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = (t / tiles_n) * BM, c0 = (t % tiles_n) * BN;
    auto load = [&](int i) {
      T* stage = ring + (i % STAGES) * L::STAGE_ELEMS;
      load_part<T, false, VEC, BM, BM, BK, THREADS>(sg.a, r0, i * BK, sg.kn,
                                                    stage, tid);
      load_part<T, false, VEC, BN, BN, BK, THREADS>(sg.b, c0, i * BK, sg.kn,
                                                    stage + L::A_ELEMS, tid);
    };
    float acc[4][4] = {};
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < ns) load(i);
      cp_async_commit();
    }
    for (int i = 0; i < ns; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slab i landed for every thread; i - 1 is free
      if (i + STAGES - 1 < ns) load(i + STAGES - 1);
      cp_async_commit();
      const T* As = ring + (i % STAGES) * L::STAGE_ELEMS;
      const T* Bs = As + L::A_ELEMS;
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
        load4(As + k * BM + ty * 4, a);
        load4(Bs + k * BN + tx * 4, b);
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[y][x] = fmaf(a[y], b[x], acc[y][x]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every thread past its reads: the ring is free

    const int col = c0 + tx * 4;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int row = r0 + ty * 4 + y;
      if (row >= M) continue;
      T* out = c + (long long)row * ldc + col;
      if constexpr (VEC) {
        if (col < N) store4(out, acc[y]);   // N % 4 == 0: all or none
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (col + x < N) out[x] = from_float<T>(acc[y][x]);
      }
    }
  }
}

template <typename T, bool VEC>
cudaError_t prepare() {
  return cudaFuncSetAttribute(tn_kernel<T, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<T>::SMEM_BYTES);
}

// The wrapper's plan (phantom_fused.py: wgrad_plan) chose the grid and the
// variant; its shared-memory bytes must be this layout's.
template <typename T>
cudaError_t launch_tn(const Segment<T>& sg, void* c, long long ldc, int M,
                      int N, int grid, int vec16, int smem,
                      cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * tiles_n;
  if (M <= 0 || N <= 0 || tiles > 0x7fffffff || grid < 1 ||
      smem != Layout<T>::SMEM_BYTES)
    return cudaErrorInvalidValue;
  T* out = static_cast<T*>(c);
  cudaError_t err = vec16 ? prepare<T, true>() : prepare<T, false>();
  if (err != cudaSuccess) return err;
  if (vec16)
    tn_kernel<T, true><<<grid, THREADS, smem, stream>>>(sg, out, ldc, M, N,
                                                        (int)tiles, tiles_n);
  else
    tn_kernel<T, false><<<grid, THREADS, smem, stream>>>(sg, out, ldc, M, N,
                                                         (int)tiles, tiles_n);
  return cudaGetLastError();
}

// Blocks of the kernel one SM holds at once.
template <typename T, bool VEC>
cudaError_t blocks_per_sm(int* out) {
  cudaError_t err = prepare<T, VEC>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, tn_kernel<T, VEC>, THREADS, Layout<T>::SMEM_BYTES);
}

}  // namespace tn

template <typename T>
Operand<T> one(const void* p, long long ld, int rows) {
  const T* q = static_cast<const T*>(p);
  return Operand<T>{q, q, ld, ld, rows, rows};
}

template <typename T>
Operand<T> two(const void* p0, long long ld0, int rows0, const void* p1,
               long long ld1, int rows1) {
  const T* q0 = static_cast<const T*>(p0);
  const T* q1 = p1 ? static_cast<const T*>(p1) : q0;
  return Operand<T>{q0, q1, ld0, ld1, rows0, rows0 + rows1};
}

template <typename T>
cudaError_t fused_fwd(const void* x, const void* L, const void* g,
                      const void* D, void* z, int M, int K, int N, int PK,
                      long long ldx, long long ldl, long long ldg,
                      long long ldd, long long ldz, int splits, int vec16,
                      int smem, cudaStream_t stream) {
  Plan<T> plan{};
  // local: A = x [M, K] row-major (k contiguous), B = L [K, N] row-major
  plan.seg[0] = Segment<T>{one<T>(x, ldx, M), one<T>(L, ldl, N), K};
  // ghosts: A = g [M, PK], B = D [PK, N], into the same accumulator
  plan.seg[1] = Segment<T>{one<T>(g, ldg, M), one<T>(D, ldd, N), PK};
  plan.nseg = 2;
  return sk::launch_splitk<T, false>(plan, z, ldz, M, N, splits, vec16, smem,
                                     stream);
}

template <typename T>
cudaError_t nt(const void* a, const void* b0, const void* b1, void* c, int M,
               int N, int J0, int J1, long long lda, long long ldb0,
               long long ldb1, long long ldc, int splits, int vec16,
               int smem, cudaStream_t stream) {
  Plan<T> plan{};
  // A = a [M, N] (k = n contiguous); B rows j = [b0 ; b1] [J, N] (k contiguous)
  plan.seg[0] = Segment<T>{one<T>(a, lda, M),
                           two<T>(b0, ldb0, J0, b1, ldb1, J1), N};
  plan.nseg = 1;
  return sk::launch_splitk<T, true>(plan, c, ldc, M, J0 + J1, splits, vec16,
                                    smem, stream);
}

template <typename T>
cudaError_t tn_host(const void* a0, const void* a1, const void* b, void* c,
                    int M, int I0, int I1, int N, long long lda0,
                    long long lda1, long long ldb, long long ldc, int grid,
                    int vec16, int smem, cudaStream_t stream) {
  // A rows i = columns of [a0 | a1] [M, I] (i contiguous); B = b [M, N]
  const Segment<T> sg{two<T>(a0, lda0, I0, a1, lda1, I1), one<T>(b, ldb, N),
                      M};
  return tn::launch_tn<T>(sg, c, ldc, I0 + I1, N, grid, vec16, smem, stream);
}

}  // namespace

// C interface (loaded with ctypes).  Leading dimensions are in elements;
// the last dim of every operand is contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  The forward and the dgrad take the wrapper's plan:
// `splits` (blocks per cluster), `vec16` (1: 16-byte copies, 0: the masked
// variant) and `smem` (dynamic shared memory of a block).  Each returns the
// launch's cudaError_t (0 = success).

extern "C" int repro_phantom_fused_fwd(const void* x, const void* L,
                                       const void* g, const void* D, void* z,
                                       int M, int K, int N, int PK,
                                       long long ldx, long long ldl,
                                       long long ldg, long long ldd,
                                       long long ldz, int dtype,
                                       int splits, int vec16, int smem,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_fwd<float>(x, L, g, D, z, M, K, N, PK, ldx, ldl, ldg, ldd,
                            ldz, splits, vec16, smem, st);
  if (dtype == 1)
    return fused_fwd<__nv_bfloat16>(x, L, g, D, z, M, K, N, PK, ldx, ldl,
                                    ldg, ldd, ldz, splits, vec16, smem, st);
  return cudaErrorInvalidValue;
}

// Clusters of `splits` blocks of the split-contraction kernel resident at
// once on the current card (b_kfast: 1 for the dgrad, 0 for the forward).
extern "C" int repro_splitk_max_clusters(int dtype, int b_kfast, int vec16,
                                         int splits, int* out) {
  if (dtype == 0)
    return b_kfast ? (vec16 ? sk::max_clusters_as<float, true, true>(splits, out)
                            : sk::max_clusters_as<float, true, false>(splits, out))
                   : (vec16 ? sk::max_clusters_as<float, false, true>(splits, out)
                            : sk::max_clusters_as<float, false, false>(splits, out));
  if (dtype == 1)
    return b_kfast
        ? (vec16 ? sk::max_clusters_as<__nv_bfloat16, true, true>(splits, out)
                 : sk::max_clusters_as<__nv_bfloat16, true, false>(splits, out))
        : (vec16 ? sk::max_clusters_as<__nv_bfloat16, false, true>(splits, out)
                 : sk::max_clusters_as<__nv_bfloat16, false, false>(splits, out));
  return cudaErrorInvalidValue;
}

// c[M, J0 + J1] = a[M, N] . [b0 ; b1]^T  (b0 [J0, N], b1 [J1, N] or null)
extern "C" int repro_matmul_nt(const void* a, const void* b0, const void* b1,
                               void* c, int M, int N, int J0, int J1,
                               long long lda, long long ldb0, long long ldb1,
                               long long ldc, int dtype, int splits,
                               int vec16, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nt<float>(a, b0, b1, c, M, N, J0, J1, lda, ldb0, ldb1, ldc, splits,
                     vec16, smem, st);
  if (dtype == 1)
    return nt<__nv_bfloat16>(a, b0, b1, c, M, N, J0, J1, lda, ldb0, ldb1,
                             ldc, splits, vec16, smem, st);
  return cudaErrorInvalidValue;
}

// c[I0 + I1, N] = [a0 | a1]^T . b[M, N]  (a0 [M, I0], a1 [M, I1] or null),
// on the wrapper's plan: `grid` persistent blocks.
extern "C" int repro_matmul_tn(const void* a0, const void* a1, const void* b,
                               void* c, int M, int I0, int I1, int N,
                               long long lda0, long long lda1, long long ldb,
                               long long ldc, int dtype, int grid, int vec16,
                               int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tn_host<float>(a0, a1, b, c, M, I0, I1, N, lda0, lda1, ldb, ldc,
                          grid, vec16, smem, st);
  if (dtype == 1)
    return tn_host<__nv_bfloat16>(a0, a1, b, c, M, I0, I1, N, lda0, lda1,
                                  ldb, ldc, grid, vec16, smem, st);
  return cudaErrorInvalidValue;
}

// Blocks of the wgrad kernel one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) on the current card.
extern "C" int repro_matmul_tn_blocks_per_sm(int dtype, int vec16,
                                             int* out) {
  if (dtype == 0)
    return vec16 ? tn::blocks_per_sm<float, true>(out)
                 : tn::blocks_per_sm<float, false>(out);
  if (dtype == 1)
    return vec16 ? tn::blocks_per_sm<__nv_bfloat16, true>(out)
                 : tn::blocks_per_sm<__nv_bfloat16, false>(out);
  return cudaErrorInvalidValue;
}
