// Flash attention forward for Hopper (sm_90a), causal or full, with GQA.
//
// Replaces the TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py, body `_kernel`, `pl.pallas_call`
// at :122).  Same function as its oracle `kernels/ref.py:
// flash_attention_ref`: q [B,S,H,hd], k/v [B,S,KV,hd] -> o [B,S,H,hd],
// scores scaled by hd^-0.5, online softmax with (m, l, acc) in fp32,
// kv tiles past the causal diagonal skipped.
//
// Design.  The TPU kernel keeps a kv head's whole K/V resident in VMEM and
// folds the Hg query heads of a group into the rows of its q block.  A
// Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so here:
//   * one block per (q tile of BQ=64 rows, query head, batch row); the kv
//     head is h / (H/KV), so the Hg blocks of a group read the same K/V
//     (from L2 after the first);
//   * an inner loop over kv tiles of BK=64 rows, staged in shared memory as
//     fp32 (row pitch hd+1 so the column walks are free of bank conflicts);
//   * 256 threads as a 16x16 grid; each thread owns 4 query rows x 4 keys
//     of the score tile and 4 rows x hd/16 columns of the accumulator, all
//     in fp32 registers; row max and row sum reduce over the 16 threads of
//     a row group with warp shuffles;
//   * the probability tile goes through shared memory to the P.V product;
//   * the ragged edge (S not a multiple of 64) is masked on load and in the
//     scores; reads follow the public [B,S,H,hd] strides, no transposes.
//
// Bound.  At the serving shapes (S <= 48, bf16) the work is a few MB and
// tens of MFLOP: the bound is bytes and well under a microsecond, so the
// time is launch latency and the serial tile loop of one block.  At long
// S the function is bound by tensor-core FLOPs; this kernel multiplies on
// the CUDA cores in fp32 (no wgmma, no TMA), so it runs far above that
// bound.  A tensor-core (wgmma) version with TMA-fed K/V tiles is later
// work; this one is the simple, exact first port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = 256;   // threads: 16 row groups x 16 key/column groups

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

struct Strides {       // in elements; the head dim is contiguous
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) + size_t(BK) * HD +
          size_t(BQ) * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int group,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 float scale) {
  constexpr int QP = HD + 1;      // padded pitch of the Q and K tiles
  constexpr int PP = BK + 1;      // padded pitch of the P tile
  constexpr int NC = HD / 16;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][QP]
  float* Ks = Qs + BQ * QP;       // [BK][QP]
  float* Vs = Ks + BK * QP;       // [BK][HD]
  float* Ps = Vs + BK * HD;       // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // key / column group (low 4 lane bits)
  const int ty = tid >> 4;        // row group: rows 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * QP + d] = s < S ? to_float(qb[s * sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done (and Qs is in)
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool ok = s < S;
      Ks[r * QP + d] = ok ? to_float(kb[s * sk.s + d]) : 0.f;
      Vs[r * HD + d] = ok ? to_float(vb[s * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // scores: 4 rows x 4 keys per thread
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, online softmax; a row's 16 owners are 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P . V: 4 rows x HD/16 columns per thread
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[s * so.s + tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, Strides sq, Strides sk,
                   Strides sv, Strides so, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, sq, sk, sv,
      so, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int KV, Strides sq,
                        Strides sk, Strides sv, Strides so, int causal,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  Strides are in elements, for the
// batch, sequence and head dims of each [B,S,heads,hd] tensor.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, int causal, int dtype, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      so{ob, os, oh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, sq, sk, sv, so,
                              causal, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, sq, sk, sv,
                                      so, causal, scale, st);
  return cudaErrorInvalidValue;
}
