// Probes of the wgmma forward's fixed time, for benchmarks/wgmma_plan.py
// alone (no path of the port calls them): the forward's kernel of
// kernels/csrc/phantom_fused.cu on a job cut short, and an empty kernel
// launched as the forward's is.
//
// Built by that script: nvcc with the kernels' flags (kernels/build.py),
// -I src/repro_torch/kernels/csrc, into build/.

#include "phantom_fused.cu"

namespace {

__global__ void wgmma_probe_empty(const __grid_constant__ wg::Maps maps,
                                  const wg::Job job,
                                  __nv_bfloat16* __restrict__ c) {}

// A block's tiles stored from zero accumulators and nothing else: mode 0
// the kernels' epilogue (wg::store_tile), 1 two-element stores
// (wg::store2) with no shuffle.
template <int BM, int BN, int ST>
__global__ void __launch_bounds__(wg::Shape<BM, BN, ST>::THREADS,
                                  wg::Shape<BM, BN, ST>::PER_SM)
    wgmma_probe_store(const __grid_constant__ wg::Maps maps,
                      const wg::Job job, __nv_bfloat16* __restrict__ c,
                      int mode) {
  if (threadIdx.x < 128) return;
  const int w = threadIdx.x / 128 - 1, lane = threadIdx.x % 128;
  const int row_lo = 64 * w + 16 * (lane / 32) + (lane % 32) / 4;
  for (int t = blockIdx.x; t < job.tm * job.tn; t += gridDim.x) {
    const wg::Tile tl = wg::tile_of<BM, BN>(job, t);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wg::hold(acc);
    if (mode == 0) {
      wg::store_tile(c, job.ldc, tl, acc, row_lo, lane);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        wg::store2(c, job.ldc, tl, row_lo, col, acc[4 * j], acc[4 * j + 1]);
        wg::store2(c, job.ldc, tl, row_lo + 8, col, acc[4 * j + 2],
                   acc[4 * j + 3]);
      }
    }
  }
}

template <int BM, int BN, int ST>
wg::Kernel store_probe_of(int bm, int bn) {
  return bm == BM && bn == BN
             ? reinterpret_cast<wg::Kernel>(wgmma_probe_store<BM, BN, ST>)
             : nullptr;
}

}  // namespace

// The forward's instance at bm x bn tiles on the operands of
// repro_wgmma_fwd, `grid` blocks in clusters of `splits`, on a job cut to
//   what = 0: an empty kernel of the same grid, block and shared memory;
//          1: no tile (the kernel's set-up alone);
//          2: every tile, no slab (set-up and epilogue);
//          3: every tile, one slab of x.L;
//          4: the whole job;
//   5, 6: the tiles' stores alone (wgmma_probe_store, modes 0, 1).
// cluster = 1 sets the cluster attribute at splits = 1 too.  Returns the
// launch's cudaError_t (or 100000 + a refused descriptor's CUresult).
extern "C" int repro_wgmma_probe(const void* x, const void* L, const void* g,
                                 const void* D, void* z, int M, int K, int N,
                                 int PK, long long ldx, long long ldl,
                                 long long ldg, long long ldd, long long ldz,
                                 int bm, int bn, int splits, int grid,
                                 int what, int cluster, void* stream) {
  const wg::Instance in = wg::instance_of(0, bm, bn);
  if (in.kernel == nullptr || what < 0 || what > 6 || splits < 1 ||
      splits > wg::MAX_SPLITS || grid < 1 || grid % splits)
    return cudaErrorInvalidValue;
  wg::Maps maps;
  wg::Job job;
  const int err = wg::forward_job(maps, job, in, x, L, g, D, M, K, N, PK,
                                  ldx, ldl, ldg, ldd, ldz);
  if (err) return err;
  wg::set_tiles(job, bm, bn);
  if (what == 1) job.tm = job.tm0 = 0;
  if (what == 2) job.kn[0] = job.kn[1] = 0;
  if (what == 3) {
    job.nseg = 1;
    job.kn[0] = wg::BK;
  }
  wg::Kernel kernel = what == 0 ? wgmma_probe_empty : in.kernel;
  if (what >= 5) {
    kernel = nullptr;
#define WG_STORE_PROBE(M_, N_, ST_) \
    if (!kernel) kernel = store_probe_of<M_, N_, ST_>(bm, bn);
    WG_SHAPES(WG_STORE_PROBE)
#undef WG_STORE_PROBE
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(in.threads);
  cfg.dynamicSmemBytes = in.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 || cluster ? 1 : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(z);
  if (what >= 5) {
    auto store = reinterpret_cast<void (*)(const wg::Maps, const wg::Job,
                                           __nv_bfloat16*, int)>(kernel);
    e = cudaLaunchKernelEx(&cfg, store, maps, job, out, what - 5);
  } else {
    e = cudaLaunchKernelEx(&cfg, kernel, maps, job, out);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}
