// Fused phantom-layer GEMMs for Hopper (sm_90a): the forward and its two
// backward products.
//
// Replaces the TPU kernels of the JAX package's
// src/repro/kernels/phantom_fused.py:
//   phantom_fused_matmul (:118, pl.pallas_call :157)  z = x.L + g.D
//   matmul_nt            (:206, pl.pallas_call :221)  c = a.b^T  (dgrad)
//   matmul_tn            (:239, pl.pallas_call :254)  c = a^T.b  (wgrad)
// and match their oracles: float32 accumulation, the output in the input
// dtype (float32 or bfloat16).
//
// Routes (the wrapper's plan picks one per call, phantom_fused.py):
//   bfloat16, every base and row pitch a multiple of 16 bytes: the tensor
//     cores, wgmma_fwd_kernel / wgmma_dgrad_kernel / wgmma_wgrad_kernel
//     (namespace wg, at the end of this header);
//   float32: splitk_kernel (forward, dgrad) and tn_kernel (wgrad), IEEE
//     fp32 FMAs on the CUDA cores.  TF32 would break the reference's rtol
//     2e-4, and these run within 1.03-1.26x torch.mm at the paper-FFN shape;
//   bfloat16, unaligned: the same CUDA-core kernels, masked variant
//     (VEC = false), converting on each shared-memory read.
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
//
// The bf16 route (namespace wg).  At an LM site a product is bound by
// operations: qwen2-vl-72b's MLP a rank at tp 4 (x [2048, 2048], L
// [2048, 7392], PK 128) is 66 GFLOP over 40 MB, 0.0666 ms at 989 TFLOP/s
// bf16 and 0.012 ms at 3.35 TB/s.  The CUDA-core kernels ran such sites at
// 12-29 TFLOP/s (15-31x torch.mm).  Only wgmma reaches the card's bf16
// rate, and TMA feeds it without spending registers.  One mainloop serves
// the three products:
//   * wgmma.mma_async m64nNk16, bf16 in, fp32 accumulators, both operands
//     in shared memory.  The forward and the dgrad run one instance per
//     tile shape (WG_SHAPES: BM x BN of 128 x 256, 128 x 128, 64 x 128,
//     64 x 64), the wrapper's plan (phantom_fused.py: wg_plan) picking
//     shape and split per call; the wgrad runs 128 x 256.  BM = 128: two
//     consumer warpgroups of 64 rows (m64n256k16: 128 accumulators a
//     thread, setmaxnreg 232; the producer warpgroup gives its registers
//     back, 40), one block an SM.  BM = 64: one consumer warpgroup, 256
//     threads, two blocks an SM, no setmaxnreg (its 32 or 64 accumulators
//     fit the 128 registers that leaves a thread).  128 x 256 has the most
//     FLOP per L2 byte (85 against 64 for 128 x 128) and keeps the wide
//     sites (K, N >= 768 at M = 2048); the small tiles spread a narrow or
//     short output over the card, where one 128 x 256 tile per block left
//     85-131 of the 132 SMs idle.
//   * Tiles arrive by cp.async.bulk.tensor (TMA, 128-byte swizzle: a slab
//     is 64 k = 128 bytes) into a ring of 4 slabs (6 for 64 x 64; 48 KB to
//     16 KB a slab) with full and empty mbarriers; one producer thread
//     issues the copies and runs ahead into the next tile while the
//     consumers finish this one.
//   * The operands' layouts differ by product and the smem descriptor's
//     transpose bits take them (bf16 allows both): the forward's A (x, g)
//     is K-major and its B (L, D) MN-major; the dgrad's both K-major; the
//     wgrad's both MN-major (slab_desc says where each layout's leading
//     and stride byte offsets come from).
//   * No tile straddles a join, so [L;D] and [x|g] are never built: the
//     forward runs two contraction segments (x.L, then g.D) into one
//     accumulator, each with its own descriptors; the dgrad's output
//     columns are tiled over L's rows and then over D's, the wgrad's
//     output rows over x's columns and then g's.  A tile narrower than BN
//     (D's PK columns, a ragged edge) multiplies at its own width (mma_n:
//     N = 8 .. BN), a warpgroup with no rows of C multiplies nothing, and
//     D's tiles come last, so they fill the last round.  Ragged edges read
//     TMA's zero fill and store masked.
//   * The grid: with a split, the contraction of each tile goes to a
//     cluster of S blocks, all clusters resident at once, and the partial
//     tiles' real rows and columns (a 4-row tile's 4) are summed in rank
//     order through distributed shared memory (no atomics: the same bits
//     every run).  Without, a
//     persistent grid of one block per tile and per resident block,
//     launched with no cluster.  The plan prices each shape and split on
//     the card's measured slab time, ring refills and a split's reduction
//     on the tile's real bytes.  Clusters that took more than one round of
//     split tiles were slower where tried, and so were clusters of 2
//     sharing B by TMA multicast.
//   * The epilogue shuffles the accumulators within each 4-lane quad so
//     that every lane stores 16 contiguous bytes, not 4.  It is straight-
//     line code run once a tile, about half of a 4-row 128 x 256 tile's
//     time and a fifth of a 64 x 64 one's (benchmarks/wgmma_plan.py).
//   * The TMA descriptors are encoded on the host for each call
//     (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint: the
//     library links the runtime alone) and passed by value as
//     __grid_constant__ parameters, so a CUDA graph captures them.  A
//     refused descriptor is an error (100000 + its CUresult), never a
//     switch to another kernel.
// Reached on the H100: the wide sites (M = 2048, K and N >= 768) as with
// 128 x 256 tiles alone, 1.3-2.4x their operations bound; the narrow and
// short ones (K or N <= 512; 4 and 192 rows) at 0.005-0.009 ms, 1.1-2.3x
// torch.mm, where 128 x 256 tiles took 0.008-0.015 (PERF.md).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  if (!vec16)
    return launch_splitk_as<T, B_KFAST, false>(plan, out, ldc, M, N, splits,
                                               smem, stream);
  if constexpr (sizeof(T) == 4)
    return launch_splitk_as<T, B_KFAST, true>(plan, out, ldc, M, N, splits,
                                              smem, stream);
  return cudaErrorInvalidValue;   // aligned bf16 takes the wgmma route
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
  if (!vec16) {
    const cudaError_t err = prepare<T, false>();
    if (err != cudaSuccess) return err;
    tn_kernel<T, false><<<grid, THREADS, smem, stream>>>(sg, out, ldc, M, N,
                                                         (int)tiles, tiles_n);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 4) {
    const cudaError_t err = prepare<T, true>();
    if (err != cudaSuccess) return err;
    tn_kernel<T, true><<<grid, THREADS, smem, stream>>>(sg, out, ldc, M, N,
                                                        (int)tiles, tiles_n);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;   // aligned bf16 takes the wgmma route
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

// ---- the bf16 route: wgmma on the tensor cores, fed by TMA ----------------

namespace wg {

constexpr int BK = 64;          // contraction slab: 128 bytes of bf16
constexpr int MAX_SPLITS = 8;   // blocks in a cluster (the portable limit)
constexpr int SLACK = 2048;     // the ring's 1024-byte alignment, its barriers
constexpr int PRODUCER_REGS = 40;    // setmaxnreg at two consumer warpgroups
constexpr int CONSUMER_REGS = 232;
constexpr int SM_SMEM = 233472;      // shared memory of an H100 SM (228 KB)
constexpr int BLOCK_RESERVED = 1024; // ... of which each resident block's

constexpr int ALIGN = 1024;     // a 128-byte swizzle repeats every 8 rows
constexpr int HALF = 64 * BK * 2;          // 64 rows (or columns) of a slab
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536,
              "the warpgroups' registers fit one SM");

// The forward's and the dgrad's tile shapes (BM, BN) and their rings'
// slabs, largest first: one instance of each kernel per shape, the
// wrapper's plan picks one per call (phantom_fused.py: WG_SHAPES,
// WG_RING).  The wgrad runs the first alone.  A block walking more slabs
// than its ring holds waits a TMA round trip again for each refill; the
// 64 x 64 ring holds 6 slabs, the shared memory that two blocks an SM
// leave it.
#define WG_SHAPES(X) X(128, 256, 4) X(128, 128, 4) X(64, 128, 4) X(64, 64, 6)

// A tile shape: BM output rows, 64 to a consumer warpgroup, by BN columns
// (the widest wgmma N of the tile), in a ring of STAGES slabs.
template <int BM_, int BN_, int STAGES_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int CONSUMERS = BM / 64;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + SLACK;
  static constexpr int ACC = BN / 2;   // accumulators of a consumer thread
  // blocks an SM holds at once: as many as its shared memory takes rings
  static constexpr int PER_SM = SM_SMEM / (SMEM_BYTES + BLOCK_RESERVED);
  // Two consumer warpgroups of up to 128 accumulators take the producer's
  // registers (setmaxnreg).  One warpgroup of 64 or 32 fits in the 128 or
  // 80 registers a thread that two or three blocks an SM leave it, so it
  // moves none: setmaxnreg.inc would wait on registers the block never
  // had, past what launch bounds of 2 or 3 blocks pin.
  static constexpr bool SETMAXNREG = CONSUMERS == 2;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "a wgmma N");
  static_assert(BM * BN * 4 <= STAGES * STAGE_BYTES,
                "the split's fp32 partial tile reuses the ring");
  static_assert(ALIGN + 2 * STAGES * 8 <= SLACK, "barriers past the ring");
  static_assert(PER_SM >= 1 && PER_SM * THREADS <= 2048, "fits an SM");
  static_assert(!SETMAXNREG || PER_SM == 1,
                "setmaxnreg's registers: one block an SM");
};

// The operands of one launch as TMA descriptors: A's (rows of C) and B's
// (columns of C).  The forward reads segment s through a[s] and b[s]; the
// dgrad's columns of C come from b[0] (L) and then b[1] (D); the wgrad's
// rows from a[0] (x) and then a[1] (g).
struct Maps {
  CUtensorMap a[2];
  CUtensorMap b[2];
};

struct Job {
  int nseg;          // contraction segments (the forward: x.L, then g.D)
  int kn[2];         // their lengths
  int m0, m;         // C's rows [0, m0) from a[0], [m0, m) from a[1]
  int n0, n;         // C's columns [0, n0) from b[0], [n0, n) from b[1]
  int tm0, tm;       // row tiles of the first part, row tiles in all
  int tn0, tn;       // column tiles likewise
  long long ldc;
};

// One output tile: which part of each operand it reads from which row,
// where it lands in C and how many of its rows and columns are C's.
struct Tile {
  int a_part, a_row, b_part, b_col;
  int out_row, out_col, rows, cols;
};

// Tile t of the job's BM x BN tiles: row-major over the first column
// part's tiles, then over the second's, so that the narrow tiles of D's
// columns come last.
template <int BM, int BN>
__device__ __forceinline__ Tile tile_of(const Job& j, int t) {
  const int first = j.tm * j.tn0, tn1 = j.tn - j.tn0;
  const int rt = t < first ? t / j.tn0 : (t - first) / tn1;
  const int ct = t < first ? t % j.tn0 : j.tn0 + (t - first) % tn1;
  Tile o;
  o.b_part = ct < j.tn0 ? 0 : 1;
  o.b_col = (o.b_part ? ct - j.tn0 : ct) * BN;
  o.out_col = (o.b_part ? j.n0 : 0) + o.b_col;
  o.cols = min(BN, (o.b_part ? j.n : j.n0) - o.out_col);
  o.a_part = rt < j.tm0 ? 0 : 1;
  o.a_row = (o.a_part ? rt - j.tm0 : rt) * BM;
  o.out_row = (o.a_part ? j.m0 : 0) + o.a_row;
  o.rows = min(BM, (o.a_part ? j.m : j.m0) - o.out_row);
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete.  A wait of over ~10 s at
// the card's clock is a fault of the kernel: it traps (the launch fails)
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete on `bar`.  Reads past the tensor's edges
// land as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The two layouts a slab takes in shared memory, as TMA's 128-byte swizzle
// writes them:
//   K-major (the contraction contiguous: x, g, dz as A; L, D as the
//     dgrad's B): per row of the tile side one row of 64 k (128 bytes),
//     rows 128 bytes apart, 8-row groups 1024 bytes apart (SBO); a step of
//     16 k is 32 bytes along the rows (LBO unused).
//   MN-major (the tile side contiguous: L, D as the forward's B; x, g and
//     dz in the wgrad): per 64 of the tile side, 64 k-rows of 128 bytes,
//     8-k groups 1024 bytes apart (SBO), the next 64 of the side HALF =
//     8192 bytes on (LBO); a step of 16 k is 2048 bytes.
template <bool MN>
__device__ __forceinline__ uint64_t slab_desc(const unsigned char* s,
                                              int kk) {
  return MN ? smem_desc(s + kk * 2048, HALF, 1024)
            : smem_desc(s + kk * 32, 16, 1024);
}

// d[64 x N] += A[64 x 16] . B[16 x N] with fp32 accumulators, N = 8 ..
// 256; TA, TB: the operand is MN-major (the wgmma's transpose bit).
// Accumulator d[4 j + 2 h + e] is row 16 (warp) + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e, for every N: a narrower product fills a prefix
// of d.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<32, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<8, TA, TB> {
  template <int A>
  static __device__ __forceinline__ void run(float (&d)[A], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence, commit or wait.
template <int A>
__device__ __forceinline__ void hold(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One slab (BK deep) of a warpgroup's products at N columns.
template <int N, bool A_MN, bool B_MN, int A>
__device__ __forceinline__ void slab_mma(float (&acc)[A],
                                         const unsigned char* sa,
                                         const unsigned char* sb) {
  static_assert(2 * A >= N, "the accumulators hold N columns");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<N, A_MN, B_MN>::run(acc, slab_desc<A_MN>(sa, kk),
                              slab_desc<B_MN>(sb, kk));
}

// One slab at the tile's width n (mma_n), among those a tile of 2 A
// columns has.
template <bool A_MN, bool B_MN, int A>
__device__ __forceinline__ void slab_at(int n, float (&acc)[A],
                                        const unsigned char* sa,
                                        const unsigned char* sb) {
  if constexpr (A >= 128) {
    if (n == 256) return slab_mma<256, A_MN, B_MN>(acc, sa, sb);
  }
  if constexpr (A >= 64) {
    if (n == 128) return slab_mma<128, A_MN, B_MN>(acc, sa, sb);
  }
  switch (n) {
    case 64: slab_mma<64, A_MN, B_MN>(acc, sa, sb); break;
    case 32: slab_mma<32, A_MN, B_MN>(acc, sa, sb); break;
    case 16: slab_mma<16, A_MN, B_MN>(acc, sa, sb); break;
    default: slab_mma<8, A_MN, B_MN>(acc, sa, sb); break;
  }
}

// The narrowest wgmma N that covers a tile's `cols` columns: 8 .. 256 for
// a K-major B (its rows are the columns, in groups of 8), 64 .. 256 for
// an MN-major B, whose swizzle atom is 64 columns wide.  A tile of D's
// few columns (the dgrad's PK) costs its width, not a full tile's.
template <bool B_MN>
__device__ __forceinline__ int mma_n(int cols) {
  if (cols > 128) return 256;
  if (cols > 64) return 128;
  if (B_MN || cols > 32) return 64;
  if (cols > 16) return 32;
  return cols > 8 ? 16 : 8;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::
                   : "memory");
}

// Two neighbouring outputs of a tile (row; col and col + 1) into C: one
// 4-byte store where both are C's and the pair is 4-byte aligned.
__device__ __forceinline__ void store2(__nv_bfloat16* c, long long ldc,
                                       const Tile& tl, int row, int col,
                                       float v0, float v1) {
  if (row >= tl.rows || col >= tl.cols) return;
  const long long gc = tl.out_col + col;
  __nv_bfloat16* p = c + (long long)(tl.out_row + row) * ldc + gc;
  if (col + 1 < tl.cols && ((gc | ldc) & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (col + 1 < tl.cols) p[1] = __float2bfloat16(v1);
  }
}

// Eight neighbouring outputs of a tile (row; col .. col + 7, bf16 pairs in
// v) into C: one 16-byte store where all are C's and the address is
// 16-byte aligned.
__device__ __forceinline__ void store8(__nv_bfloat16* c, long long ldc,
                                       const Tile& tl, int row, int col,
                                       const uint32_t (&v)[4]) {
  if (row >= tl.rows || col >= tl.cols) return;
  const long long gc = tl.out_col + col;
  __nv_bfloat16* p = c + (long long)(tl.out_row + row) * ldc + gc;
  if (col + 8 <= tl.cols && ((gc | ldc) & 7) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < tl.cols)
      p[e] = reinterpret_cast<const __nv_bfloat16*>(&v[e / 2])[e % 2];
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A consumer's part of a finished tile (2 A columns) into C.  In the
// accumulator layout the four lanes of a quad hold a row's 8 neighbouring
// columns 2 each, so a store would write 16 bytes of a row per quad;
// three shuffles within the quad give each lane 8 neighbouring columns
// instead (lane q the 8 j-th with j = 4 m + q), and each row's 32 columns
// go out as 64 contiguous bytes.  It runs whole, with no branch on the
// tile's real rows or columns: the stores mask them, and a branch that
// skipped a short tile's empty warps slowed every full tile's mainloop
// (PERF.md); short outputs take 64-row tiles instead.
template <int A>
__device__ __forceinline__ void store_tile(__nv_bfloat16* c, long long ldc,
                                           const Tile& tl,
                                           const float (&acc)[A],
                                           int row_lo, int lane) {
  const int q = lane % 4, quad = (lane % 32) & ~3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 0; m < A / 16; ++m) {
      uint32_t p[4], out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        p[jj] = bf16x2(acc[4 * (4 * m + jj) + 2 * h],
                       acc[4 * (4 * m + jj) + 2 * h + 1]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {   // from quad lane (q + k) % 4
        const int src = (q + k) & 3;
        const uint32_t got =
            __shfl_sync(0xffffffffu, pick(p, (q - k + 4) & 3), quad | src);
        out[0] = src == 0 ? got : out[0];
        out[1] = src == 1 ? got : out[1];
        out[2] = src == 2 ? got : out[2];
        out[3] = src == 3 ? got : out[3];
      }
      store8(c, ldc, tl, row_lo + 8 * h, 32 * m + 8 * q, out);
    }
  }
}

// C = A . B in bf16 with fp32 accumulators, over the job's tiles of Sh
// (BM x BN).  Blocks come in clusters of S (the split): cluster g takes
// tiles g, g + gridDim.x / S, ... (S > 1: one tile a cluster); block rank
// r of a cluster walks the r-th of S near-equal ranges of the
// contraction's slabs (segment 0's, then segment 1's).  Warpgroup 0 is the
// producer: one thread keeps the TMA ring of STAGES slabs full, running
// ahead into the next tile.  Each of the BM / 64 consumer warpgroups
// multiplies 64 rows of the tile with wgmma at the tile's width (mma_n),
// one slab's products in flight while the next is issued.  With S > 1 the
// partial tiles' real rows and columns meet through distributed shared
// memory, in the ring.
template <bool A_MN, bool B_MN, class Sh>
__device__ __forceinline__ void gemm(const Maps& maps, const Job& job,
                                     __nv_bfloat16* __restrict__ c) {
  constexpr int BM = Sh::BM, BN = Sh::BN, NC = Sh::CONSUMERS;
  constexpr int A_BYTES = Sh::A_BYTES, STAGE_BYTES = Sh::STAGE_BYTES;
  constexpr int STAGES = Sh::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ns0 = (job.kn[0] + BK - 1) / BK;
  const int ns1 = job.nseg > 1 ? (job.kn[1] + BK - 1) / BK : 0;
  const int total = ns0 + ns1, base = total / S, rem = total % S;
  const int first = rank * base + min(rank, rem);
  const int count = base + (rank < rem ? 1 : 0);
  const int tiles = job.tm * job.tn, step = gridDim.x / S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival, then the bytes
      mbar_init(&empty[s], NC);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // ---- the producer warpgroup
    if constexpr (Sh::SETMAXNREG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (threadIdx.x == 0) {   // the descriptors into the TMA unit's cache
      const CUtensorMap* all[4] = {&maps.a[0], &maps.a[1], &maps.b[0],
                                   &maps.b[1]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(all[i]))
                     : "memory");
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x / S; t < tiles; t += step) {
      if (threadIdx.x == 0) {
        const Tile tl = tile_of<BM, BN>(job, t);
        for (int i = 0; i < count; ++i) {
          const int s = first + i, seg = s < ns0 ? 0 : 1;
          const int k0 = (seg ? s - ns0 : s) * BK;
          const CUtensorMap* ma = &maps.a[seg + tl.a_part];
          const CUtensorMap* mb = &maps.b[seg + tl.b_part];
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* sa = ring + stage * STAGE_BYTES;
          unsigned char* sb = sa + A_BYTES;
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          if (A_MN) {   // boxes of 64 rows of C
#pragma unroll
            for (int q = 0; q < BM / 64; ++q)
              tma_load(sa + q * HALF, ma, bar, tl.a_row + 64 * q, k0);
          } else {
            tma_load(sa, ma, bar, k0, tl.a_row);
          }
          if (B_MN) {   // boxes of 64 columns
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_load(sb + q * HALF, mb, bar, tl.b_col + 64 * q, k0);
          } else {
            tma_load(sb, mb, bar, k0, tl.b_col);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (S > 1) {   // the ring holds the partial tile until the cluster
        cluster_sync_all();   // has summed it: the consumers' barriers
        cluster_sync_all();
      }
    }
    return;
  }

  // ---- the consumers: warpgroup w multiplies the tile's rows 64 w ..
  if constexpr (Sh::SETMAXNREG)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
  const int w = threadIdx.x / 128 - 1, lane = threadIdx.x % 128;
  const int row_lo = 64 * w + 16 * (lane / 32) + (lane % 32) / 4;
  const int col_lo = 2 * (lane % 4);
  int stage = 0;
  uint32_t phase = 0;
  auto release = [&](int s) {   // the stage goes back to the producer
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  for (int t = blockIdx.x / S; t < tiles; t += step) {
    const Tile tl = tile_of<BM, BN>(job, t);
    // a warpgroup none of whose rows are C's only hands the stages back
    const bool active = 64 * w < tl.rows;
    const int n = mma_n<B_MN>(tl.cols);
    float acc[Sh::ACC];
#pragma unroll
    for (int i = 0; i < Sh::ACC; ++i) acc[i] = 0.f;
    int held = -1;   // the stage the last committed wgmmas still read
    for (int i = 0; i < count; ++i) {
      mbar_wait(&full[stage], phase);
      if (active) {
        const unsigned char* sa = ring + stage * STAGE_BYTES + w * HALF;
        const unsigned char* sb = ring + stage * STAGE_BYTES + A_BYTES;
        hold(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        slab_at<A_MN, B_MN>(n, acc, sa, sb);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous slab's products are done: its stage goes back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        hold(acc);
        if (held >= 0) release(held);
        held = stage;
      } else {
        release(stage);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(acc);
    if (held >= 0) release(held);

    if (S == 1) {
      store_tile(c, job.ldc, tl, acc, row_lo, lane);
      continue;
    }
    // The split: every consumer is past its last wgmma and every copy has
    // landed, so the ring takes this block's fp32 partial tile: its real
    // rows, at the width the wgmmas ran (n >= the real columns).
    asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + col_lo;
      if (8 * j < n && row_lo < tl.rows)
        *reinterpret_cast<float2*>(part + row_lo * BN + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (8 * j < n && row_lo + 8 < tl.rows)
        *reinterpret_cast<float2*>(part + (row_lo + 8) * BN + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync_all();   // every partial tile of the cluster is in place
    // Block r sums the r-th of S near-equal ranges of the tile's real
    // 4-column groups (row-major) over ranks 0..S-1.
    const int groups = (tl.cols + 3) / 4, all = tl.rows * groups;
    const int end = (rank + 1) * all / S;
    for (int e = rank * all / S + threadIdx.x - 128; e < end; e += NC * 128) {
      const int row = e / groups, col = 4 * (e % groups);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < S; ++q) {   // rank order: the same bits every run
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + row * BN + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      store2(c, job.ldc, tl, row, col, sum.x, sum.y);
      store2(c, job.ldc, tl, row, col + 2, sum.z, sum.w);
    }
    cluster_sync_all();   // no block leaves while another reads its tile
  }
}

}  // namespace wg

// The three products' kernels: one mainloop, the operands' layouts set by
// the wgmma's transpose bits; the forward and the dgrad in one instance
// per tile shape of WG_SHAPES, the wgrad at 128 x 256.
//   forward  z = x.L + g.D:   A (x, g) K-major, B (L, D) MN-major
//   dgrad    dz.[L;D]^T:      A (dz) K-major, B (L, D rows) K-major
//   wgrad    [x|g]^T.dz:      A (x, g columns) MN-major, B (dz) MN-major
template <int BM, int BN, int ST>
__global__ void __launch_bounds__(wg::Shape<BM, BN, ST>::THREADS,
                                  wg::Shape<BM, BN, ST>::PER_SM)
    wgmma_fwd_kernel(const __grid_constant__ wg::Maps maps, const wg::Job job,
                     __nv_bfloat16* __restrict__ c) {
  wg::gemm<false, true, wg::Shape<BM, BN, ST>>(maps, job, c);
}

template <int BM, int BN, int ST>
__global__ void __launch_bounds__(wg::Shape<BM, BN, ST>::THREADS,
                                  wg::Shape<BM, BN, ST>::PER_SM)
    wgmma_dgrad_kernel(const __grid_constant__ wg::Maps maps,
                       const wg::Job job, __nv_bfloat16* __restrict__ c) {
  wg::gemm<false, false, wg::Shape<BM, BN, ST>>(maps, job, c);
}

__global__ void __launch_bounds__(wg::Shape<128, 256, 4>::THREADS, 1)
    wgmma_wgrad_kernel(const __grid_constant__ wg::Maps maps,
                       const wg::Job job, __nv_bfloat16* __restrict__ c) {
  wg::gemm<true, true, wg::Shape<128, 256, 4>>(maps, job, c);
}

namespace wg {

using Kernel = void (*)(const Maps, const Job, __nv_bfloat16*);

// One kernel instance and what its launch needs.
struct Instance {
  Kernel kernel;
  int bm, bn, threads, smem;
};

template <int BM, int BN, int ST>
Instance instance_as(Kernel kernel) {
  return Instance{kernel, BM, BN, Shape<BM, BN, ST>::THREADS,
                  Shape<BM, BN, ST>::SMEM_BYTES};
}

// Product `product`'s (0 forward, 1 dgrad, 2 wgrad) instance at tiles of
// bm x bn; a null kernel where it has none.
Instance instance_of(int product, int bm, int bn) {
  if (product == 2)
    return bm == 128 && bn == 256
               ? instance_as<128, 256, 4>(wgmma_wgrad_kernel)
               : Instance{};
  if (product != 0 && product != 1) return Instance{};
#define WG_INSTANCE(M, N, ST)                                     \
  if (bm == M && bn == N) {                                       \
    Kernel kernel = wgmma_dgrad_kernel<M, N, ST>;                 \
    if (product == 0) kernel = wgmma_fwd_kernel<M, N, ST>;        \
    return instance_as<M, N, ST>(kernel);                         \
  }
  WG_SHAPES(WG_INSTANCE)
#undef WG_INSTANCE
  return Instance{};
}

// cuTensorMapEncodeTiled belongs to the CUDA driver API and the library
// links the runtime alone (no -lcuda): it is looked up once through the
// runtime's cudaGetDriverEntryPoint.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// What the C functions return when a descriptor cannot be made: this
// plus the driver's CUresult (no cudaError_t comes near it).
constexpr int ENCODE_FAILED = 100000;

// A bf16 matrix [outer, inner] with a row pitch of `ld` elements, copied
// in boxes of box_outer x box_inner, 128-byte swizzled; reads past its
// edges give zeros.
int encode(CUtensorMap* m, const void* p, int inner, int outer, long long ld,
           int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A K-major operand [rows, k]: boxes of `rows_box` rows by BK.
int encode_k(CUtensorMap* m, const void* p, int rows, int k, long long ld,
             int rows_box) {
  return encode(m, p, k, rows, ld, BK, rows_box);
}

// An MN-major operand [k, cols]: boxes of BK k-rows by 64 columns.
int encode_mn(CUtensorMap* m, const void* p, int k, int cols, long long ld) {
  return encode(m, p, cols, k, ld, 64, BK);
}

void set_tiles(Job& job, int bm, int bn) {
  job.tm0 = (job.m0 + bm - 1) / bm;
  job.tm = job.tm0 + (job.m - job.m0 + bm - 1) / bm;
  job.tn0 = (job.n0 + bn - 1) / bn;
  job.tn = job.tn0 + (job.n - job.n0 + bn - 1) / bn;
}

// The forward's operands as the instance's descriptors and job (C's
// tiles not yet set).
int forward_job(Maps& maps, Job& job, const Instance& in, const void* x,
                const void* L, const void* g, const void* D, int M, int K,
                int N, int PK, long long ldx, long long ldl, long long ldg,
                long long ldd, long long ldz) {
  int err;
  if ((err = encode_k(&maps.a[0], x, M, K, ldx, in.bm)) ||
      (err = encode_mn(&maps.b[0], L, K, N, ldl)) ||
      (err = encode_k(&maps.a[1], g, M, PK, ldg, in.bm)) ||
      (err = encode_mn(&maps.b[1], D, PK, N, ldd)))
    return err;
  job = Job{};
  job.nseg = 2;
  job.kn[0] = K;
  job.kn[1] = PK;
  job.m0 = job.m = M;
  job.n0 = job.n = N;
  job.ldc = ldz;
  return 0;
}

// The instance on the wrapper's plan (phantom_fused.py: wg_plan, or
// wg_split for the wgrad): with a split, one cluster of `splits` blocks
// per tile, all resident at once; without, a persistent grid of at most
// one block per tile, launched with no cluster.
int launch(const Instance& in, const Maps& maps, Job job, void* c,
           int splits, int grid, cudaStream_t stream) {
  set_tiles(job, in.bm, in.bn);
  const long long tiles = (long long)job.tm * job.tn;
  if (in.kernel == nullptr || job.m <= 0 || job.n <= 0 ||
      tiles > 0x7fffffff || splits < 1 || splits > MAX_SPLITS || grid < 1 ||
      (splits > 1 ? grid != tiles * splits : grid > tiles))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(in.threads);
  cfg.dynamicSmemBytes = in.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, in.kernel, maps, job,
                           static_cast<__nv_bfloat16*>(c));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of `splits` blocks of an instance the card holds at once.
int max_clusters(const Instance& in, int splits, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 64);
  cfg.blockDim = dim3(in.threads);
  cfg.dynamicSmemBytes = in.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, in.kernel, &cfg);
}

}  // namespace wg

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
  if (dtype == 1 && !vec16)   // aligned bf16 takes the wgmma route
    return b_kfast
               ? sk::max_clusters_as<__nv_bfloat16, true, false>(splits, out)
               : sk::max_clusters_as<__nv_bfloat16, false, false>(splits, out);
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
  if (dtype == 1 && !vec16)   // aligned bf16 takes the wgmma route
    return tn::blocks_per_sm<__nv_bfloat16, false>(out);
  return cudaErrorInvalidValue;
}

// The bf16 tensor-core route (wgmma_*_kernel) on the wrapper's plan: the
// instance of `bm` x `bn` tiles (the forward and the dgrad; the wgrad
// runs at 128 x 256), `splits` blocks per cluster and `grid` blocks.
// Operands as for the functions above, bfloat16 only, every base and row
// pitch a multiple of 16 bytes (TMA's rule).  Each returns the launch's
// cudaError_t, or 100000 + the CUresult of a descriptor that
// cuTensorMapEncodeTiled refused.

extern "C" int repro_wgmma_fwd(const void* x, const void* L, const void* g,
                               const void* D, void* z, int M, int K, int N,
                               int PK, long long ldx, long long ldl,
                               long long ldg, long long ldd, long long ldz,
                               int bm, int bn, int splits, int grid,
                               void* stream) {
  const wg::Instance in = wg::instance_of(0, bm, bn);
  if (in.kernel == nullptr) return cudaErrorInvalidValue;
  wg::Maps maps;
  wg::Job job;
  const int err = wg::forward_job(maps, job, in, x, L, g, D, M, K, N, PK,
                                  ldx, ldl, ldg, ldd, ldz);
  if (err) return err;
  return wg::launch(in, maps, job, z, splits, grid,
                    static_cast<cudaStream_t>(stream));
}

// c[M, J0 + J1] = a[M, N] . [b0 ; b1]^T: C's columns tiled over b0's rows,
// then over b1's.
extern "C" int repro_wgmma_nt(const void* a, const void* b0, const void* b1,
                              void* c, int M, int N, int J0, int J1,
                              long long lda, long long ldb0, long long ldb1,
                              long long ldc, int bm, int bn, int splits,
                              int grid, void* stream) {
  const wg::Instance in = wg::instance_of(1, bm, bn);
  if (in.kernel == nullptr) return cudaErrorInvalidValue;
  wg::Maps maps;
  int err;
  if ((err = wg::encode_k(&maps.a[0], a, M, N, lda, bm)) ||
      (err = wg::encode_k(&maps.b[0], b0, J0, N, ldb0, bn)) ||
      (J1 > 0 && (err = wg::encode_k(&maps.b[1], b1, J1, N, ldb1, bn))))
    return err;
  maps.a[1] = maps.a[0];
  if (J1 == 0) maps.b[1] = maps.b[0];
  wg::Job job = {};
  job.nseg = 1;
  job.kn[0] = N;
  job.m0 = job.m = M;
  job.n0 = J0;
  job.n = J0 + J1;
  job.ldc = ldc;
  return wg::launch(in, maps, job, c, splits, grid,
                    static_cast<cudaStream_t>(stream));
}

// c[I0 + I1, N] = [a0 | a1]^T . b[M, N]: C's rows tiled over a0's columns,
// then over a1's.
extern "C" int repro_wgmma_tn(const void* a0, const void* a1, const void* b,
                              void* c, int M, int I0, int I1, int N,
                              long long lda0, long long lda1, long long ldb,
                              long long ldc, int splits, int grid,
                              void* stream) {
  wg::Maps maps;
  int err;
  if ((err = wg::encode_mn(&maps.a[0], a0, M, I0, lda0)) ||
      (I1 > 0 && (err = wg::encode_mn(&maps.a[1], a1, M, I1, lda1))) ||
      (err = wg::encode_mn(&maps.b[0], b, M, N, ldb)))
    return err;
  if (I1 == 0) maps.a[1] = maps.a[0];
  maps.b[1] = maps.b[0];
  wg::Job job = {};
  job.nseg = 1;
  job.kn[0] = M;
  job.m0 = I0;
  job.m = I0 + I1;
  job.n0 = job.n = N;
  job.ldc = ldc;
  return wg::launch(wg::instance_of(2, 128, 256), maps, job, c, splits, grid,
                    static_cast<cudaStream_t>(stream));
}

// Clusters of `splits` blocks of product `product`'s (0 forward, 1 dgrad,
// 2 wgrad) wgmma instance at `bm` x `bn` tiles resident at once on the
// current card.
extern "C" int repro_wgmma_max_clusters(int product, int bm, int bn,
                                        int splits, int* out) {
  const wg::Instance in = wg::instance_of(product, bm, bn);
  if (in.kernel == nullptr || splits < 1 || splits > wg::MAX_SPLITS)
    return cudaErrorInvalidValue;
  return wg::max_clusters(in, splits, out);
}
