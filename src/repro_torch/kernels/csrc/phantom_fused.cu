// Fused phantom-layer GEMMs for Hopper (sm_90a): the forward and its two
// backward products.
//
// Replaces the TPU kernels of the JAX package's
// src/repro/kernels/phantom_fused.py:
//   phantom_fused_matmul (:118, pl.pallas_call :157)  z = x.L + g.D
//   matmul_nt            (:206, pl.pallas_call :221)  c = a.b^T  (dgrad)
//   matmul_tn            (:239, pl.pallas_call :254)  c = a^T.b  (wgrad)
// and match their oracles: float32 accumulation, the output in the input
// dtype (float32 or bfloat16, converted on load).
//
// Design.  The TPU kernels walk one sequential "arbitrary" grid axis into
// a VMEM accumulator, 128x128 tiles, operands padded up to the tile grid.
// Here one generic tiled GEMM serves all three:
//   * one block of 128 threads per 32x32 output tile; each thread keeps a
//     2x4 sub-tile in fp32 registers; the tile is written once;
//   * the contraction runs in 32-wide slabs staged in shared memory in
//     k-major order (A pitch 33: the transposing stores are free of bank
//     conflicts; B pitch 36: 16-byte rows for float4 reads);
//   * the forward has two contraction segments into the same registers:
//     the local x.L slabs, then the ghost g.D slabs -- the fused update of
//     the reference, without concatenating anything;
//   * the dgrad reads [L ; D] and the wgrad reads [x | g] through two
//     pointers each, split at a row (column) index, where the reference
//     builds the concatenation in HBM first (phantom_fused.py:275, 284);
//   * ragged edges are masked on load and on store, so no operand is
//     padded or copied;
//   * the next slab is fetched into registers while the current one is
//     multiplied (one stage of software pipelining).
// The products are IEEE fp32 FMAs on the CUDA cores, no TF32 tensor cores,
// so float32 results hold the reference's rtol 2e-4.
//
// Bound.  At the paper-ffn-16k shapes per rank (p = 8, batch 64: x [64,2048],
// L [2048,2048], g [64,128], D [128,2048]) each of the three products is
// 0.57 GFLOP over ~19 MB: bound by fp32 operations, 8.5 us at 67 TFLOP/s.
// The forward and dgrad outputs are only 64 rows, so 32x32 tiles give 128
// and 136 blocks for 132 SMs, one block per SM with a serial walk over 68
// slabs; the wgrad output has 4352 tiles but a contraction of only 64.  A
// wgmma/TMA version (bf16, split-K for the short outputs) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;        // BM = BN = BK
constexpr int NT = 128;         // threads: 16 row groups x 8 column groups
constexpr int PER_THREAD = TILE * TILE / NT;   // slab elements each loads
constexpr int AP = TILE + 1;    // pitch of the k-major A slab
constexpr int BP = TILE + 4;    // pitch of the k-major B slab

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

struct __align__(16) Slab {
  float a[TILE][AP];  // a[k][r]
  float b[TILE][BP];  // b[k][c]
};

// Global -> registers: this thread's PER_THREAD elements of the slab at
// (r0, k0).  Consecutive threads walk the contiguous axis of the source.
template <typename T, bool KFAST>
__device__ __forceinline__ void fetch(const Operand<T>& op, int r0, int k0,
                                      int kn, int tid, float v[PER_THREAD]) {
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = tid + NT * i;
    const int r = KFAST ? e / TILE : e % TILE;
    const int k = KFAST ? e % TILE : e / TILE;
    const int gr = r0 + r, gk = k0 + k;
    float x = 0.f;
    if (gr < op.rows && gk < kn) {
      const T* p = gr < op.split ? op.p0 : op.p1;
      const long long ld = gr < op.split ? op.ld0 : op.ld1;
      const long long rr = gr < op.split ? gr : gr - op.split;
      x = to_float(KFAST ? p[rr * ld + gk] : p[(long long)gk * ld + rr]);
    }
    v[i] = x;
  }
}

// Registers -> shared memory, k-major, in fetch's element order.
template <bool KFAST>
__device__ __forceinline__ void put(float* base, int pitch, int tid,
                                    const float v[PER_THREAD]) {
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = tid + NT * i;
    const int r = KFAST ? e / TILE : e % TILE;
    const int k = KFAST ? e % TILE : e / TILE;
    base[k * pitch + r] = v[i];
  }
}

template <typename T, bool A_KFAST, bool B_KFAST>
__device__ __forceinline__ void fetch_slab(const Segment<T>& s, int r0,
                                           int c0, int k0, int tid,
                                           float va[PER_THREAD],
                                           float vb[PER_THREAD]) {
  fetch<T, A_KFAST>(s.a, r0, k0, s.kn, tid, va);
  fetch<T, B_KFAST>(s.b, c0, k0, s.kn, tid, vb);
}

template <typename T>
__device__ __forceinline__ void skip_done(const Plan<T>& plan, int& seg,
                                          int& k0) {
  while (seg < plan.nseg && k0 >= plan.seg[seg].kn) {
    ++seg;
    k0 = 0;
  }
}

// C[M, N] (row-major, ldc) = sum over the plan's segments of A . B.
template <typename T, bool A_KFAST, bool B_KFAST>
__global__ void __launch_bounds__(NT)
gemm_kernel(const Plan<T> plan, T* __restrict__ c, long long ldc, int M,
            int N) {
  __shared__ Slab s;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  float acc[2][4] = {};
  float va[PER_THREAD], vb[PER_THREAD];

  int seg = 0, k0 = 0;
  skip_done(plan, seg, k0);
  if (seg < plan.nseg)
    fetch_slab<T, A_KFAST, B_KFAST>(plan.seg[seg], r0, c0, k0, tid, va, vb);
  while (seg < plan.nseg) {
    put<A_KFAST>(&s.a[0][0], AP, tid, va);
    put<B_KFAST>(&s.b[0][0], BP, tid, vb);
    __syncthreads();
    k0 += TILE;
    skip_done(plan, seg, k0);
    if (seg < plan.nseg)   // the next slab's loads overlap this slab's FMAs
      fetch_slab<T, A_KFAST, B_KFAST>(plan.seg[seg], r0, c0, k0, tid, va,
                                      vb);
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {
      const float a0 = s.a[k][ty * 2], a1 = s.a[k][ty * 2 + 1];
      const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty * 2 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < N) c[(long long)row * ldc + col] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, bool A_KFAST, bool B_KFAST>
cudaError_t launch(const Plan<T>& plan, void* c, long long ldc, int M, int N,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || (M + TILE - 1) / TILE > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  gemm_kernel<T, A_KFAST, B_KFAST>
      <<<grid, NT, 0, stream>>>(plan, static_cast<T*>(c), ldc, M, N);
  return cudaGetLastError();
}

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
                      long long ldd, long long ldz, cudaStream_t stream) {
  Plan<T> plan{};
  // local: A = x [M, K] row-major (k contiguous), B = L [K, N] row-major
  plan.seg[0] = Segment<T>{one<T>(x, ldx, M), one<T>(L, ldl, N), K};
  // ghosts: A = g [M, PK], B = D [PK, N], into the same accumulator
  plan.seg[1] = Segment<T>{one<T>(g, ldg, M), one<T>(D, ldd, N), PK};
  plan.nseg = 2;
  return launch<T, true, false>(plan, z, ldz, M, N, stream);
}

template <typename T>
cudaError_t nt(const void* a, const void* b0, const void* b1, void* c, int M,
               int N, int J0, int J1, long long lda, long long ldb0,
               long long ldb1, long long ldc, cudaStream_t stream) {
  Plan<T> plan{};
  // A = a [M, N] (k = n contiguous); B rows j = [b0 ; b1] [J, N] (k contiguous)
  plan.seg[0] = Segment<T>{one<T>(a, lda, M),
                           two<T>(b0, ldb0, J0, b1, ldb1, J1), N};
  plan.nseg = 1;
  return launch<T, true, true>(plan, c, ldc, M, J0 + J1, stream);
}

template <typename T>
cudaError_t tn(const void* a0, const void* a1, const void* b, void* c, int M,
               int I0, int I1, int N, long long lda0, long long lda1,
               long long ldb, long long ldc, cudaStream_t stream) {
  Plan<T> plan{};
  // A rows i = columns of [a0 | a1] [M, I] (i contiguous); B = b [M, N]
  plan.seg[0] = Segment<T>{two<T>(a0, lda0, I0, a1, lda1, I1),
                           one<T>(b, ldb, N), M};
  plan.nseg = 1;
  return launch<T, false, false>(plan, c, ldc, I0 + I1, N, stream);
}

}  // namespace

// C interface (loaded with ctypes).  Leading dimensions are in elements;
// the last dim of every operand is contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Each returns the launch's cudaError_t (0 = success).

extern "C" int repro_phantom_fused_fwd(const void* x, const void* L,
                                       const void* g, const void* D, void* z,
                                       int M, int K, int N, int PK,
                                       long long ldx, long long ldl,
                                       long long ldg, long long ldd,
                                       long long ldz, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_fwd<float>(x, L, g, D, z, M, K, N, PK, ldx, ldl, ldg, ldd,
                            ldz, st);
  if (dtype == 1)
    return fused_fwd<__nv_bfloat16>(x, L, g, D, z, M, K, N, PK, ldx, ldl,
                                    ldg, ldd, ldz, st);
  return cudaErrorInvalidValue;
}

// c[M, J0 + J1] = a[M, N] . [b0 ; b1]^T  (b0 [J0, N], b1 [J1, N] or null)
extern "C" int repro_matmul_nt(const void* a, const void* b0, const void* b1,
                               void* c, int M, int N, int J0, int J1,
                               long long lda, long long ldb0, long long ldb1,
                               long long ldc, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nt<float>(a, b0, b1, c, M, N, J0, J1, lda, ldb0, ldb1, ldc, st);
  if (dtype == 1)
    return nt<__nv_bfloat16>(a, b0, b1, c, M, N, J0, J1, lda, ldb0, ldb1,
                             ldc, st);
  return cudaErrorInvalidValue;
}

// c[I0 + I1, N] = [a0 | a1]^T . b[M, N]  (a0 [M, I0], a1 [M, I1] or null)
extern "C" int repro_matmul_tn(const void* a0, const void* a1, const void* b,
                               void* c, int M, int I0, int I1, int N,
                               long long lda0, long long lda1, long long ldb,
                               long long ldc, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tn<float>(a0, a1, b, c, M, I0, I1, N, lda0, lda1, ldb, ldc, st);
  if (dtype == 1)
    return tn<__nv_bfloat16>(a0, a1, b, c, M, I0, I1, N, lda0, lda1, ldb,
                             ldc, st);
  return cudaErrorInvalidValue;
}
