"""Fused phantom-layer GEMMs: the hand-written CUDA kernels
(``csrc/phantom_fused.cu``) and their wrappers.

Forward:   z  = x @ L  +  g_cat @ D_cat           (phantom_fused_matmul)
Backward:  [dx | dg] = dz @ [L ; D]^T             (matmul_nt, one launch)
           [dL ; dD] = [x | g]^T @ dz             (matmul_tn, one launch)

Replaces the JAX package's Pallas TPU kernels of the same names in
``src/repro/kernels/phantom_fused.py``.  The source's header says how the
design maps them onto Hopper and what bounds them on the card.

The forward and the dgrad run through one split-contraction kernel whose
launch ``gemm_plan`` sets (splits per output tile, 16-byte or masked
copies); the wgrad through a persistent GEMM of 64 x 64 tiles whose grid
``wgrad_plan`` sets (one block per block the card holds at once).

Each wrapper checks shapes first (``KernelConfigError``, the reference's
messages), then takes the plain version (``kernels/ref.py``) only for
tensors that lie on the CPU.  A CUDA tensor launches the kernel or
raises: a failed build, a card other than sm_90 or a refused launch is
an error, never a switch to the plain version.  ``.launches`` on each
wrapper counts its kernel's launches.

The three are also dispatcher operators, ``torch.ops.repro_torch.
{phantom_fused_matmul, matmul_nt, matmul_tn}``, each with a fake
(shape-only) version and a flop formula (2·M·N·(K+PK), 2·M·J·N and
2·I·N·M).  ``FlopCounterMode`` is a dispatch mode and sees nothing of a
``ctypes`` launch; through the operators it counts the kernels by their
formulas (``telemetry/counted.py``).  ``kernels/ops.py`` calls the
operators; their CUDA implementation is the kernel, their CPU one the
plain version, both through the wrappers here.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import (matmul_nt_ref, matmul_tn_ref,
                                     phantom_fused_ref)

# splitk_kernel of csrc/phantom_fused.cu (the forward and the dgrad); the
# values must equal its namespace sk's constants
BM, BN, BK = 64, 64, 32      # output tile rows and columns, contraction slab
STAGES = 4                   # slabs in the cp.async ring
MAX_SPLITS = 8               # blocks in a cluster (the portable limit)
# Clusters of S blocks an H100 SXM (132 SMs, 700 W) holds at once, two
# blocks of the kernel on an SM (cudaOccupancyMaxActiveClusters, as
# chip_smoke.py prints it): the CPU's stand-in for resident_table().
H100_RESIDENT_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32,
                          8: 30}
SMEM_BUDGET_BYTES = 232_448  # shared memory one H100 block may use (227 KB)
# tn_kernel (the wgrad); the values must equal its namespace tn's constants
WGRAD_BM, WGRAD_BN, WGRAD_BK = 64, 64, 16     # output tile, contraction slab
WGRAD_STAGES = 4             # slabs in the cp.async ring
# Blocks of tn_kernel one SM of an H100 SXM (132 SMs, 700 W) holds at
# once, by (element size, variant)
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor, as chip_smoke.py prints
# it): the CPU's stand-in for wgrad_resident().
H100_SMS = 132
H100_WGRAD_BLOCKS_PER_SM = {(4, "vec16"): 4, (4, "masked"): 2,
                            (2, "vec16"): 4, (2, "masked"): 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelConfigError(ValueError):
    """Operand shapes the kernels cannot take together, or a tile
    configuration whose shared memory exceeds one block's."""


def kernel_smem_bytes(b_kfast: bool, esize: int, bm: int = BM, bn: int = BN,
                      bk: int = BK, stages: int = STAGES) -> int:
    """Dynamic shared memory of one ``splitk_kernel`` block: a ring of
    ``stages`` slabs in the input dtype (``esize`` bytes), A as ``bm`` rows
    of ``bk`` and B as ``bn`` rows of ``bk`` (``b_kfast``, the dgrad) or
    ``bk`` rows of ``bn`` (the forward), every row padded by 16 bytes; the
    fp32 ``[bm][bn]`` partial tile reuses the ring."""
    pad = 16 // esize
    a = bm * (bk + pad)
    b = bn * (bk + pad) if b_kfast else bk * (bn + pad)
    return max(stages * (a + b) * esize, 4 * bm * bn)


def check_kernel_fits(b_kfast: bool, esize: int, bm: int = BM, bn: int = BN,
                      bk: int = BK, stages: int = STAGES,
                      budget: int = SMEM_BUDGET_BYTES) -> int:
    need = kernel_smem_bytes(b_kfast, esize, bm, bn, bk, stages)
    if need > budget:
        raise KernelConfigError(
            f"phantom-kernel tiles bm={bm} bn={bn} bk={bk} x {stages} "
            f"stages need {need} B of shared memory per block, over the "
            f"{budget} B an H100 block may use; shrink the tiles")
    return need


# the built layouts' need, per (dgrad?, element size)
SMEM_BYTES = {(kf, es): check_kernel_fits(kf, es)
              for kf in (False, True) for es in (4, 2)}


@dataclass(frozen=True)
class GemmPlan:
    """How ``splitk_kernel`` runs one product: ``splits`` blocks (one
    cluster) share each ``bm x bn`` output tile, each walking one range of
    the ``slabs`` ``bk``-wide slabs of the contraction (``ranges``)."""
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    grid: Tuple[int, int]      # (column tiles x splits, row tiles)
    cluster: Tuple[int, int, int]
    variant: str               # "vec16" (16-byte cp.async) or "masked"
    smem_bytes: int
    slabs: int
    dgrad: bool                # B k-contiguous ([L;D] rows) or k-major (L)
    esize: int                 # bytes per input element

    def ranges(self) -> List[Tuple[int, int]]:
        """[first, end) slabs of each block rank, as the kernel splits
        them: near-equal, the first ``slabs % splits`` one longer."""
        base, rem = divmod(self.slabs, self.splits)
        out, first = [], 0
        for r in range(self.splits):
            n = base + (r < rem)
            out.append((first, first + n))
            first += n
        return out


def gemm_plan(M: int, N: int, seg_lens: Sequence[int], b_kfast: bool,
              esize: int, vec16: bool,
              resident: Mapping[int, int] = H100_RESIDENT_CLUSTERS
              ) -> GemmPlan:
    """The plan of C[M, N] = sum of A.B over contraction segments of
    ``seg_lens``: the most splits (up to ``MAX_SPLITS``) whose clusters,
    one per output tile, the card holds at once (``resident``: clusters
    of S blocks resident at once, by S) and that leave every block at
    least two slabs.  A grid of more clusters runs in a second wave,
    which costs more than the extra splits gain (PERF.md); short
    contractions and grids past one wave get ``splits = 1``."""
    tiles_m, tiles_n = -(-M // BM), -(-N // BN)
    slabs = sum(-(-k // BK) for k in seg_lens)
    splits = 1
    for s in range(MAX_SPLITS, 1, -1):
        if slabs >= 2 * s and tiles_m * tiles_n <= resident[s]:
            splits = s
            break
    return GemmPlan(BM, BN, BK, STAGES, splits, (tiles_n * splits, tiles_m),
                    (splits, 1, 1), "vec16" if vec16 else "masked",
                    SMEM_BYTES[(b_kfast, esize)], slabs, b_kfast, esize)


def wgrad_smem_bytes(esize: int) -> int:
    """Dynamic shared memory of one ``tn_kernel`` block: a ring of
    ``WGRAD_STAGES`` slabs of A and B (``WGRAD_BK`` rows of a tile side
    each) in the input dtype, unpadded."""
    return WGRAD_STAGES * WGRAD_BK * (WGRAD_BM + WGRAD_BN) * esize


@dataclass(frozen=True)
class WgradPlan:
    """How ``tn_kernel`` runs c[I, N] = [a | a2]^T . b: ``grid``
    persistent blocks take its ``tiles_m x tiles_n`` tiles in turn."""
    tiles_m: int
    tiles_n: int
    resident: int              # blocks the card holds at once
    grid: int
    variant: str               # "vec16" (16-byte copies) or "masked"
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def rounds(self) -> int:
        return -(-self.tiles // self.grid)


def wgrad_plan(I: int, N: int, esize: int, vec16: bool,
               resident: int) -> WgradPlan:
    """The plan of the wgrad c[I, N] on a card that holds ``resident``
    blocks of the kernel at once: one block per resident block (fewer if
    there are fewer tiles), so every block the card runs is resident from
    the start and no launch waits for a free SM."""
    tiles_m, tiles_n = -(-I // WGRAD_BM), -(-N // WGRAD_BN)
    return WgradPlan(tiles_m, tiles_n, resident,
                     min(tiles_m * tiles_n, resident),
                     "vec16" if vec16 else "masked", wgrad_smem_bytes(esize))


def takes_16b(*ts) -> bool:
    """Whether every operand can be copied in 16-byte pieces: base, row
    pitch and contiguous width all multiples of 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and (t.stride(0) * t.element_size()) % 16 == 0
               and (t.shape[1] * t.element_size()) % 16 == 0 for t in ts)


def _resident(dgrad: bool, t) -> Mapping[int, int]:
    """Clusters resident at once, by S, for the kernel that ``t`` (the
    first operand) launches: queried on its card, the H100 table on the
    CPU."""
    if t.device.type != "cuda":
        return H100_RESIDENT_CLUSTERS
    return resident_table(t.device.index if t.device.index is not None
                          else torch.cuda.current_device(), dgrad,
                          t.element_size())


def _wgrad_resident(t, variant: str) -> int:
    """Blocks of the wgrad kernel that ``t``'s card holds at once: queried
    on the card, the H100's on the CPU."""
    if t.device.type != "cuda":
        return H100_SMS * H100_WGRAD_BLOCKS_PER_SM[(t.element_size(),
                                                    variant)]
    return wgrad_resident(t.device.index if t.device.index is not None
                          else torch.cuda.current_device(),
                          t.element_size(), variant)


def forward_plan(x, L, g, D) -> GemmPlan:
    vec16 = takes_16b(x, L, g, D)
    return gemm_plan(x.shape[0], L.shape[1], (x.shape[1], g.shape[1]),
                     False, x.element_size(), vec16, _resident(False, x))


def dgrad_plan(a, *bs) -> GemmPlan:
    return gemm_plan(a.shape[0], sum(b.shape[0] for b in bs), (a.shape[1],),
                     True, a.element_size(), takes_16b(a, *bs),
                     _resident(True, a))


def tn_plan(a, b, a2=None) -> WgradPlan:
    """The wgrad's plan for ``matmul_tn(a, b, a2)``."""
    parts = [a] if a2 is None else [a, a2]
    variant = "vec16" if takes_16b(b, *parts) else "masked"
    return wgrad_plan(sum(t.shape[1] for t in parts), b.shape[1],
                      a.element_size(), variant == "vec16",
                      _wgrad_resident(a, variant))


def _library() -> ctypes.CDLL:
    lib = build.load("phantom_fused")
    if lib.repro_phantom_fused_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_phantom_fused_fwd.argtypes = (
            [p] * 5 + [i] * 4 + [ll] * 5 + [i] * 4 + [p])
        lib.repro_matmul_nt.argtypes = (
            [p] * 4 + [i] * 4 + [ll] * 4 + [i] * 4 + [p])
        lib.repro_matmul_tn.argtypes = (
            [p] * 4 + [i] * 4 + [ll] * 4 + [i] * 4 + [p])
        lib.repro_splitk_max_clusters.argtypes = [i] * 4 + [p]
        lib.repro_matmul_tn_blocks_per_sm.argtypes = [i] * 2 + [p]
        for fn in (lib.repro_phantom_fused_fwd, lib.repro_matmul_nt,
                   lib.repro_matmul_tn, lib.repro_splitk_max_clusters,
                   lib.repro_matmul_tn_blocks_per_sm):
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def resident_table(index: int, dgrad: bool, esize: int) -> Dict[int, int]:
    """Clusters of S blocks (S = 1..``MAX_SPLITS``) that card ``index``
    holds at once (``cudaOccupancyMaxActiveClusters``) for the forward's
    or the dgrad's kernel at ``esize``-byte inputs; a grid of more
    clusters runs in more than one wave.  Both variants use the same
    shared memory and two blocks per SM."""
    lib, out = _library(), {}
    with torch.cuda.device(index):
        for s in range(1, MAX_SPLITS + 1):
            n = ctypes.c_int(0)
            err = lib.repro_splitk_max_clusters(
                {4: 0, 2: 1}[esize], int(dgrad), 1, s, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                                   f"cudaError {err} for {s} blocks")
            out[s] = n.value
    return out


@functools.lru_cache(maxsize=None)
def wgrad_resident(index: int, esize: int, variant: str) -> int:
    """Blocks of the wgrad kernel that card ``index`` holds at once: its
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at ``esize``-byte
    inputs, times its SMs."""
    lib, n = _library(), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.repro_matmul_tn_blocks_per_sm(
            {4: 0, 2: 1}[esize], int(variant == "vec16"), ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           f"failed for the wgrad kernel: cudaError {err}, "
                           f"{n.value} blocks")
    return n.value * torch.cuda.get_device_properties(
        index).multi_processor_count


def _check_cuda(*ts):
    dev, dt = ts[0].device, ts[0].dtype
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype != dt or dt not in _DTYPE_CODES:
            raise ValueError(f"dtypes {[u.dtype for u in ts]}: the kernels "
                             f"take float32 or bfloat16, all alike")
        if t.dim() != 2 or t.stride(-1) != 1:
            raise ValueError(f"the kernels take 2-D operands with a "
                             f"contiguous last dim; got shape "
                             f"{tuple(t.shape)} stride {t.stride()}")
    _check_sm90(dev.index if dev.index is not None
                else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _check_sm90(index: int) -> None:
    if torch.cuda.get_device_capability(index) != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} is not sm_90; the phantom "
            f"kernels are built for Hopper (sm_90a) only")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _plan_args(plan: GemmPlan):
    return plan.splits, int(plan.variant == "vec16"), plan.smem_bytes


def _raised(err: int, what: str, *ts):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} for "
                           f"{[tuple(t.shape) for t in ts]} {ts[0].dtype}")


def _on_cpu(*ts) -> bool:
    if all(t.device.type == "cpu" for t in ts):
        return True
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"no phantom kernel for devices "
                         f"{sorted({str(t.device) for t in ts})}")
    return False


def phantom_fused_matmul(x, L, g, D):
    """z[M, N] = x[M, K] @ L[K, N] + g[M, PK] @ D[PK, N], float32
    accumulation, in x's dtype.  CPU tensors: the plain version; CUDA
    tensors: the kernel, counted in ``phantom_fused_matmul.launches``."""
    M, K = x.shape
    PK = g.shape[1]
    if L.shape[0] != K:
        raise KernelConfigError(
            f"L rows {L.shape[0]} != x contraction dim {K}")
    N = L.shape[1]
    if tuple(D.shape) != (PK, N):
        raise KernelConfigError(
            f"D shape {tuple(D.shape)} != ghost-width x n_out ({PK}, {N})")
    if g.shape[0] != M:
        raise KernelConfigError(f"g rows {g.shape[0]} != x rows {M}")
    if _on_cpu(x, L, g, D):
        return phantom_fused_ref(x, L, g, D)
    _check_cuda(x, L, g, D)
    plan = forward_plan(x, L, g, D)
    z = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _library().repro_phantom_fused_fwd(
        x.data_ptr(), L.data_ptr(), g.data_ptr(), D.data_ptr(), z.data_ptr(),
        M, K, N, PK, x.stride(0), L.stride(0), g.stride(0), D.stride(0),
        z.stride(0), _DTYPE_CODES[x.dtype], *_plan_args(plan),
        _stream(x.device))
    _raised(err, "phantom_fused_matmul", x, L, g, D)
    phantom_fused_matmul.launches += 1
    return z


def matmul_nt(a, b, b2=None):
    """c[M, J] = a[M, N] @ [b ; b2]^T, float32 accumulation, in a's dtype
    (the dgrad shape).  ``b2`` (optional, ``[J2, N]``) is read through its
    own pointer: the stacked ``[b ; b2]`` is never built on the card."""
    M, N = a.shape
    parts = [b] if b2 is None else [b, b2]
    for part in parts:
        if part.shape[1] != N:
            raise KernelConfigError(f"b cols {part.shape[1]} != a cols {N}")
    if _on_cpu(a, *parts):
        return matmul_nt_ref(a, b if b2 is None else torch.cat(parts))
    _check_cuda(a, *parts)
    plan = dgrad_plan(a, *parts)
    J0, J1 = b.shape[0], 0 if b2 is None else b2.shape[0]
    c = torch.empty((M, J0 + J1), dtype=a.dtype, device=a.device)
    err = _library().repro_matmul_nt(
        a.data_ptr(), b.data_ptr(), 0 if b2 is None else b2.data_ptr(),
        c.data_ptr(), M, N, J0, J1, a.stride(0), b.stride(0),
        b.stride(0) if b2 is None else b2.stride(0), c.stride(0),
        _DTYPE_CODES[a.dtype], *_plan_args(plan), _stream(a.device))
    _raised(err, "matmul_nt", a, *parts)
    matmul_nt.launches += 1
    return c


def matmul_tn(a, b, a2=None):
    """c[I, N] = [a | a2]^T @ b[M, N] with a [M, I0], a2 [M, I1], float32
    accumulation, in a's dtype (the wgrad shape).  ``a2`` is read through
    its own pointer: ``[a | a2]`` is never built on the card."""
    M, N = b.shape
    parts = [a] if a2 is None else [a, a2]
    for part in parts:
        if part.shape[0] != M:
            raise KernelConfigError(f"b rows {M} != a rows {part.shape[0]}")
    if _on_cpu(b, *parts):
        return matmul_tn_ref(a if a2 is None else torch.cat(parts, 1), b)
    _check_cuda(b, *parts)
    plan = tn_plan(a, b, a2)
    I0, I1 = a.shape[1], 0 if a2 is None else a2.shape[1]
    c = torch.empty((I0 + I1, N), dtype=a.dtype, device=a.device)
    err = _library().repro_matmul_tn(
        a.data_ptr(), 0 if a2 is None else a2.data_ptr(), b.data_ptr(),
        c.data_ptr(), M, I0, I1, N, a.stride(0),
        a.stride(0) if a2 is None else a2.stride(0), b.stride(0),
        c.stride(0), _DTYPE_CODES[a.dtype], plan.grid,
        int(plan.variant == "vec16"), plan.smem_bytes, _stream(a.device))
    _raised(err, "matmul_tn", b, *parts)
    matmul_tn.launches += 1
    return c


phantom_fused_matmul.launches = 0
matmul_nt.launches = 0
matmul_tn.launches = 0


# --- the kernels as dispatcher operators ------------------------------------

_DEVICES = ("cpu", "cuda")


@torch.library.custom_op(
    "repro_torch::phantom_fused_matmul", mutates_args=(),
    device_types=_DEVICES,
    schema="(Tensor x, Tensor L, Tensor g, Tensor D) -> Tensor")
def _phantom_fused_matmul_op(x, L, g, D):
    return phantom_fused_matmul(x, L, g, D)


@_phantom_fused_matmul_op.register_fake
def _(x, L, g, D):
    return x.new_empty((x.shape[0], L.shape[1]))


@torch.library.custom_op(
    "repro_torch::matmul_nt", mutates_args=(), device_types=_DEVICES,
    schema="(Tensor a, Tensor b, Tensor? b2=None) -> Tensor")
def _matmul_nt_op(a, b, b2=None):
    return matmul_nt(a, b, b2)


@_matmul_nt_op.register_fake
def _(a, b, b2=None):
    return a.new_empty((a.shape[0],
                        b.shape[0] + (0 if b2 is None else b2.shape[0])))


@torch.library.custom_op(
    "repro_torch::matmul_tn", mutates_args=(), device_types=_DEVICES,
    schema="(Tensor a, Tensor b, Tensor? a2=None) -> Tensor")
def _matmul_tn_op(a, b, a2=None):
    return matmul_tn(a, b, a2)


@_matmul_tn_op.register_fake
def _(a, b, a2=None):
    return a.new_empty((a.shape[1] + (0 if a2 is None else a2.shape[1]),
                        b.shape[1]))


@register_flop_formula(torch.ops.repro_torch.phantom_fused_matmul)
def _phantom_fused_matmul_flops(x, L, g, D, *args, out_shape=None, **kw):
    """2·M·N·(K + PK): the local and the ghost product."""
    return 2 * x[0] * L[1] * (x[1] + g[1])


@register_flop_formula(torch.ops.repro_torch.matmul_nt)
def _matmul_nt_flops(a, b, b2=None, *args, out_shape=None, **kw):
    """2·M·J·N for c[M, J] = a[M, N] @ [b ; b2]^T."""
    return 2 * a[0] * (b[0] + (0 if b2 is None else b2[0])) * a[1]


@register_flop_formula(torch.ops.repro_torch.matmul_tn)
def _matmul_tn_flops(a, b, a2=None, *args, out_shape=None, **kw):
    """2·I·N·M for c[I, N] = [a | a2]^T @ b[M, N]."""
    return 2 * (a[1] + (0 if a2 is None else a2[1])) * b[1] * b[0]


def phantom_fused_dgrad(dz, L, D):
    """dx [M, K], dg [M, PK] = dz @ [L ; D]^T in one ``matmul_nt``
    launch (through its operator); both are column views of its one
    output."""
    K = L.shape[0]
    din = torch.ops.repro_torch.matmul_nt(dz, L, D)
    return din[:, :K], din[:, K:]


def phantom_fused_wgrad(x, g, dz):
    """dL [K, N], dD [PK, N] = [x | g]^T @ dz in one ``matmul_tn``
    launch (through its operator); both are row views of its one
    output."""
    K = x.shape[1]
    dW = torch.ops.repro_torch.matmul_tn(x, dz, g)
    return dW[:K], dW[K:]
