"""Fused phantom-layer GEMMs: the hand-written CUDA kernels
(``csrc/phantom_fused.cu``) and their wrappers.

Forward:   z  = x @ L  +  g_cat @ D_cat           (phantom_fused_matmul)
Backward:  [dx | dg] = dz @ [L ; D]^T             (matmul_nt, one launch)
           [dL ; dD] = [x | g]^T @ dz             (matmul_tn, one launch)

Replaces the JAX package's Pallas TPU kernels of the same names in
``src/repro/kernels/phantom_fused.py``.  The source's header says how the
design maps them onto Hopper and what bounds them on the card.

Each wrapper checks shapes first (``KernelConfigError``, the reference's
messages), then takes the plain version (``kernels/ref.py``) only for
tensors that lie on the CPU.  A CUDA tensor launches the kernel or
raises: a failed build, a card other than sm_90 or a refused launch is
an error, never a switch to the plain version.  ``.launches`` on each
wrapper counts its kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (matmul_nt_ref, matmul_tn_ref,
                                     phantom_fused_ref)

TILE = 32                    # BM = BN = BK of csrc/phantom_fused.cu
SMEM_BUDGET_BYTES = 232_448  # shared memory one H100 block may use (227 KB)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelConfigError(ValueError):
    """Operand shapes the kernels cannot take together, or a tile
    configuration whose shared memory exceeds one block's."""


def kernel_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of one block: the A slab ``[bk][bm + 1]`` and the B
    slab ``[bk][bn + 4]``, both float32 whatever the input dtype (inputs
    are converted on load).  The ghost slabs reuse the same buffers."""
    return 4 * (bk * (bm + 1) + bk * (bn + 4))


def check_kernel_fits(bm: int, bn: int, bk: int,
                      budget: int = SMEM_BUDGET_BYTES) -> int:
    need = kernel_smem_bytes(bm, bn, bk)
    if need > budget:
        raise KernelConfigError(
            f"phantom-kernel tiles bm={bm} bn={bn} bk={bk} need {need} B "
            f"of shared memory per block, over the {budget} B an H100 "
            f"block may use; shrink the tiles")
    return need


SMEM_BYTES = check_kernel_fits(TILE, TILE, TILE)   # the built tiles' need


def _library() -> ctypes.CDLL:
    lib = build.load("phantom_fused")
    if lib.repro_phantom_fused_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_phantom_fused_fwd.argtypes = (
            [p] * 5 + [i] * 4 + [ll] * 5 + [i, p])
        lib.repro_matmul_nt.argtypes = [p] * 4 + [i] * 4 + [ll] * 4 + [i, p]
        lib.repro_matmul_tn.argtypes = [p] * 4 + [i] * 4 + [ll] * 4 + [i, p]
        for fn in (lib.repro_phantom_fused_fwd, lib.repro_matmul_nt,
                   lib.repro_matmul_tn):
            fn.restype = ctypes.c_int
    return lib


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
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} is not sm_90; the phantom "
            f"kernels are built for Hopper (sm_90a) only")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    z = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _library().repro_phantom_fused_fwd(
        x.data_ptr(), L.data_ptr(), g.data_ptr(), D.data_ptr(), z.data_ptr(),
        M, K, N, PK, x.stride(0), L.stride(0), g.stride(0), D.stride(0),
        z.stride(0), _DTYPE_CODES[x.dtype], _stream(x.device))
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
    J0, J1 = b.shape[0], 0 if b2 is None else b2.shape[0]
    c = torch.empty((M, J0 + J1), dtype=a.dtype, device=a.device)
    err = _library().repro_matmul_nt(
        a.data_ptr(), b.data_ptr(), 0 if b2 is None else b2.data_ptr(),
        c.data_ptr(), M, N, J0, J1, a.stride(0), b.stride(0),
        b.stride(0) if b2 is None else b2.stride(0), c.stride(0),
        _DTYPE_CODES[a.dtype], _stream(a.device))
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
    I0, I1 = a.shape[1], 0 if a2 is None else a2.shape[1]
    c = torch.empty((I0 + I1, N), dtype=a.dtype, device=a.device)
    err = _library().repro_matmul_tn(
        a.data_ptr(), 0 if a2 is None else a2.data_ptr(), b.data_ptr(),
        c.data_ptr(), M, I0, I1, N, a.stride(0),
        a.stride(0) if a2 is None else a2.stride(0), b.stride(0),
        c.stride(0), _DTYPE_CODES[a.dtype], _stream(a.device))
    _raised(err, "matmul_tn", b, *parts)
    matmul_tn.launches += 1
    return c


def phantom_fused_dgrad(dz, L, D):
    """dx [M, K], dg [M, PK] = dz @ [L ; D]^T in one ``matmul_nt``
    launch; both are column views of its one output."""
    K = L.shape[0]
    din = matmul_nt(dz, L, D)
    return din[:, :K], din[:, K:]


def phantom_fused_wgrad(x, g, dz):
    """dL [K, N], dD [PK, N] = [x | g]^T @ dz in one ``matmul_tn``
    launch; both are row views of its one output."""
    K = x.shape[1]
    dW = matmul_tn(x, dz, g)
    return dW[:K], dW[K:]


phantom_fused_matmul.launches = 0
matmul_nt.launches = 0
matmul_tn.launches = 0
