// Flash attention forward for Hopper (sm_90a), causal or full, with GQA.
//
// Replaces the TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py:96, body `_kernel`,
// `pl.pallas_call` at :122).  Same function as its oracle `kernels/ref.py:
// flash_attention_ref`: q [B,S,H,hd], k/v [B,S,KV,hd] -> o [B,S,H,hd],
// scores scaled by hd^-0.5, online softmax with (m, l, acc) in fp32,
// kv tiles past the causal diagonal skipped.  Two kernels, by dtype.
//
// Bound.  At the serving shapes (bf16, B=4, H=32, KV=2, hd=128) the
// function is bound by bytes: q, o and the kv heads are 3.1 MB at S = 48
// (1.0 us at 3.35 TB/s) and 35.7 MB at S = 512 (10.6 us); the causal
// products are 0.9 and 8.6 GFLOP, 0.9 and 8.7 us on the bf16 tensor cores
// (989 TFLOP/s), but 13 and 128 us on the fp32 CUDA cores (67 TFLOP/s).
//
// bf16: tc::flash_mma_kernel, in the FlashAttention-2 style.
//   * Tensor cores: QK^T and PV are mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate), the operands read by ldmatrix (.trans for V).  A block
//     has 4 warps and BQ = 64 rows, 16 per warp.  Rows are padded to
//     hd + 8 elements in shared memory, so the 8 rows of every ldmatrix
//     fall on disjoint banks.
//   * Copies: Q, K and V tiles arrive by 16-byte cp.async; K/V are double
//     buffered over the kv loop (tile t+1 lands while t is multiplied).
//     87 KB of dynamic shared memory at hd = 128: two blocks an SM.
//   * Softmax on chip: scores stay in the mma accumulators; a row's max
//     and sum reduce over the 4 lanes of a quad (__shfl_xor_sync), with
//     ex2.approx of pre-scaled scores; P is rounded to bf16 in registers
//     and is
//     the A operand of PV as it stands, never written to shared memory.
//   * Masking only where it can bite: on the tile that holds a warp's
//     diagonal and on the ragged edge (S = 48 in a 64-key tile, zero-filled
//     by cp.async); kv tiles past the block's last position are skipped,
//     as are warps whose rows are all past S or all before the tile.
//   * Work order: the grid walks row tiles from the last (the longest
//     causal rows) to the first, so the short ones fill the tail.
//   * GQA: the group = H / KV query heads of a kv head share a block's
//     rows, row r being (position r / group, head r % group), as the TPU
//     kernel folds its Hg heads, so a K/V tile is copied once for all of
//     them.  One block per head measured the same on the H100 (PERF.md,
//     PR 14: its K/V tiles come from L2 after the first head's block);
//     the fold stays because at S = 48 it fills all 64 rows of every block
//     (48 positions x 16 heads), where a block per head fills 48.
//   * mma.sync rather than wgmma + TMA: at S <= 512 the bound is bytes,
//     and what held the CUDA-core kernel below at 13.7x SDPA (S = 512) was
//     its fp32 products, which mma.sync alone removes.  A warp-specialised
//     wgmma/TMA kernel pays only on long prompts (ROADMAP.md, queue 2).
//   * Output: each warp stages its normalised 16 rows in its own rows of
//     the Q tile and stores them as 16-byte row-contiguous pieces.
//
// Head dims: 16, 32, 64, 80, 96 and 128 (the configs' widths: 80 is
// stablelm-3b's, 96 phi3-mini's).  Both kernels take any multiple of 16:
// the fp32 one gives each thread HD / 16 accumulator columns, the bf16 one
// walks HD / 16 mma k-steps and HD / 8 output n-tiles in pairs (one
// ldmatrix.x4.trans each), copies HD / 8 16-byte pieces a row, and keeps
// its 4 x 16-row warp layout whatever HD is.  A padded row of HD + 8
// elements is an odd number of 16-byte pieces at every such HD (11 at 80,
// 13 at 96), so ldmatrix's 8 rows still fall on disjoint banks.
//
// fp32: flash_fwd_kernel, the CUDA-core kernel of the first port, kept for
// float32 because TF32 tensor cores would not hold the fp32 sweep's 2e-3.
//   * one block per (q tile of BQ=64 rows, query head, batch row); an inner
//     loop over kv tiles of BK=64 rows, staged in shared memory as fp32
//     (row pitch hd+1, free of bank conflicts on the column walks);
//   * 256 threads as a 16x16 grid; each owns 4 query rows x 4 keys of the
//     score tile and 4 rows x hd/16 columns of the accumulator in fp32
//     registers; row max and sum reduce over 16 lanes with shuffles;
//   * the probability tile goes through shared memory to the P.V product;
//   * the ragged edge is masked on load and in the scores; reads follow the
//     public [B,S,H,hd] strides, no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = 256;   // threads: 16 row groups x 16 key/column groups

struct Strides {       // in elements; the head dim is contiguous
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) + size_t(BK) * HD +
          size_t(BQ) * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int group,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 float scale) {
  static_assert(HD % 16 == 0, "16 accumulator column groups");
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * QP + d] = s < S ? qb[s * sq.s + d] : 0.f;
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
      Ks[r * QP + d] = ok ? kb[s * sk.s + d] : 0.f;
      Vs[r * HD + d] = ok ? vb[s * sv.s + d] : 0.f;
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

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[s * so.s + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int KV, Strides sq,
                        Strides sk, Strides sv, Strides so, int causal,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H / KV, sq,
      sk, sv, so, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(int hd, const void* q, const void* k,
                          const void* v, void* o, int B, int S, int H, int KV,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_fp32<16>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                             scale, stream);
    case 32:
      return launch_fp32<32>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                             scale, stream);
    case 64:
      return launch_fp32<64>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                             scale, stream);
    case 80:
      return launch_fp32<80>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                             scale, stream);
    case 96:
      return launch_fp32<96>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                             scale, stream);
    case 128:
      return launch_fp32<128>(q, k, v, o, B, S, H, KV, sq, sk, sv, so,
                              causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- tc::flash_mma_kernel: bf16 on the tensor cores ----------------------

namespace tc {

constexpr int BQ = 64;          // rows (position x folded head) of a block
constexpr int BKV = 64;         // keys of a kv tile
constexpr int WARPS = 4;        // 16 rows each
constexpr int THREADS = 32 * WARPS;

template <int HD>
struct Layout {
  static constexpr int P = HD + 8;       // row pitch in bf16 (+16 bytes)
  static constexpr int Q_ELEMS = BQ * P;
  static constexpr int KV_ELEMS = BKV * P;
  // Q, then K[2], then V[2]
  static constexpr int SMEM_BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));   // 0: zero-filled
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), d 16x8 fp32.
__device__ __forceinline__ void mma(float d[4], const unsigned a[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {   // ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows [row0, row0 + BQ) of the folded space of one (batch row, kv head):
// row r is (position r / group, query head kvh group + r % group).  Grid
// x = batch row x kv head, y = row tile, last first.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int S, int KV, int group,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 float scale_log2) {
  static_assert(HD % 16 == 0, "whole mma k-steps and n-tile pairs");
  using L = Layout<HD>;
  constexpr int P = L::P;
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  constexpr int NT = BKV / 8;     // score n-tiles of a warp
  constexpr int DT = HD / 8;      // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L::Q_ELEMS;            // [2][BKV][P]
  __nv_bfloat16* Vs = Ks + 2 * L::KV_ELEMS;       // [2][BKV][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int rows_total = S * group;

  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  // Q tile
  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8, R = row0 + r;
    const bool ok = R < rows_total;
    const __nv_bfloat16* src = q;
    if (ok)
      src = q + b * sq.b + (long long)(R / group) * sq.s +
            (long long)(kvh * group + R % group) * sq.h + d;
    cp_async16(Qs + r * P + d, src, ok);
  }
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * BKV;
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8, key = k0 + r;
      const bool ok = key < S;
      cp_async16(Ks + buf * L::KV_ELEMS + r * P + d,
                 ok ? kb + (long long)key * sk.s + d : kb, ok);
      cp_async16(Vs + buf * L::KV_ELEMS + r * P + d,
                 ok ? vb + (long long)key * sv.s + d : vb, ok);
    }
  };

  const int last_row = min(row0 + BQ, rows_total) - 1;
  int n_kv = (S + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, last_row / group / BKV + 1);
  load_kv(0, 0);
  cp_async_commit();

  // this warp's rows, and this lane's two of them (quad row g and g + 8)
  const int wr0 = row0 + warp * 16;
  const int wpos_lo = wr0 / group, wpos_hi = (wr0 + 15) / group;
  const int g = lane >> 2, cq = lane & 3;
  const int pos_r[2] = {(wr0 + g) / group, (wr0 + g + 8) / group};
  const bool warp_idle = wr0 >= rows_total;

  unsigned qf[HD / 16][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    const int buf = t & 1, k0 = t * BKV;
    if (t + 1 < n_kv) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t (and Q) landed for every thread
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * P +
                                kk * 16 + (lane >> 4) * 8);
    }
    if (!warp_idle && !(causal && k0 > wpos_hi)) {
      const __nv_bfloat16* Kt = Ks + buf * L::KV_ELEMS;
      const __nv_bfloat16* Vt = Vs + buf * L::KV_ELEMS;
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kf[4];
          ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma(sc[2 * np], qf[kk], kf[0], kf[1]);
          mma(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
      const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > wpos_lo);
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + cq * 2 + (e & 1);
            if (key >= S || (causal && key > pos_r[e >> 1]))
              sc[n][e] = -INFINITY;
          }
      }
      // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = fast_exp2(m[h] - m_use);   // 0 while m is -inf
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const float p = fast_exp2(sc[n][e] * scale_log2 - m_use);
            sc[n][e] = p;
            rs += p;
          }
        l[h] = l[h] * corr + rs;   // this lane's part; the quad sums last
        m[h] = m_new;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          acc[n][2 * h] *= corr;
          acc[n][2 * h + 1] *= corr;
        }
      }
      // acc += P . V, P from the score registers as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          unsigned vf[4];
          ldmatrix_x4_trans(
              vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                      dp * 16 + (lane >> 4) * 8);
          mma(acc[2 * dp], pa, vf[0], vf[1]);
          mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // buffer `buf` is free for tile t + 2
  }

  // normalise, stage this warp's rows in its own rows of Qs, store 16 B
  __nv_bfloat16* Ow = Qs + warp * 16 * P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<unsigned*>(Ow + (g + 8 * h) * P + n * 8 + cq * 2) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8, R = wr0 + r;
    if (R >= rows_total) continue;
    __nv_bfloat16* dst = o + b * so.b + (long long)(R / group) * so.s +
                         (long long)(kvh * group + R % group) * so.h + d;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(Ow + r * P + d);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, Strides sq, Strides sk,
                   Strides sv, Strides so, int causal, float scale,
                   cudaStream_t stream) {
  const int group = H / KV;
  constexpr int smem = Layout<HD>::SMEM_BYTES;
  auto kernel = flash_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long row_tiles = ((long long)S * group + BQ - 1) / BQ;
  if (row_tiles > 65535 || (long long)B * KV > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(B * KV, (unsigned)row_tiles);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, KV, group, sq, sk, sv, so, causal,
      scale * 1.4426950408889634f);   // exp(x) = exp2(x log2 e)
  return cudaGetLastError();
}

cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int KV, Strides sq,
                        Strides sk, Strides sv, Strides so, int causal,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                        scale, stream);
    case 32:
      return launch<32>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                        scale, stream);
    case 64:
      return launch<64>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                        scale, stream);
    case 80:
      return launch<80>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                        scale, stream);
    case 96:
      return launch<96>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                        scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                         scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// C interface (loaded with ctypes).  Strides are in elements, for the
// batch, sequence and head dims of each [B,S,heads,hd] tensor.  dtype: 0 =
// float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core kernel;
// every row start must be 16-byte aligned).  Returns the launch's
// cudaError_t (0 = success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, int causal, int dtype, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      so{ob, os, oh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fp32(hd, q, k, v, o, B, S, H, KV, sq, sk, sv, so, causal,
                         scale, st);
  if (dtype == 1)
    return tc::dispatch_hd(hd, q, k, v, o, B, S, H, KV, sq, sk, sv, so,
                           causal, scale, st);
  return cudaErrorInvalidValue;
}
