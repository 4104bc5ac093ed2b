"""Phantom parallelism — the paper's core contribution.

A phantom linear replaces a tensor-parallel ``n_in x n_out`` projection.
The weight matrix is viewed in ``p x p`` blocks (p = model-axis size):

  * diagonal blocks stay exact:      L^(j)      [n_in/p, n_out/p]
  * off-diagonal blocks are rank-k:  W^(i,j) ~= C^(i) D^(i,j)

Per-rank forward (paper Eqn. 11):
  g^(j)  = x^(j) C^(j)                      (compress: k ghost neurons)
  g_all  = AllGather_k(g)                   (k-wide collective, not n/p-wide)
  z^(j)  = x^(j) L^(j) + sum_{i != j} g^(i) D^(i,j)  (+ bias)

The backward falls out of autograd; the ghost-gradient reduce-scatter of
the paper's Algorithm 1 is the backward of ``all_gather_ghosts``.

Variants (the reference's names):
  * ``faithful`` — p-1 separate skinny decompress GEMMs, as the paper;
  * ``fused``    — one concatenated decompress GEMM ``g_cat @ D_cat``,
    run as the fused phantom kernel when the site's kernel backend
    selects it (``kernels/ops.py: phantom_fused_linear``);
  * ``ring``     — a ppermute ring: hop s brings the ghosts of rank
    (j - s) mod p and adds their decompress GEMM, in plain torch ops
    (the reference's kernel path is ``fused`` only).

``phantom_apply`` runs inside one rank and sees that rank's local
parameter shards (layout in ``phantom_decls``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import PhantomConfig
from repro_torch.core.autograd import all_gather_ghosts, ppermute
from repro_torch.kernels.ops import (phantom_fused_linear,
                                     resolve_kernel_backend)
from repro_torch.parallel.params import ParamDecl


def phantom_decls(n_in: int, n_out: int, k: int, tp: int,
                  bias: bool = True, fsdp: bool = False,
                  dp: int = 1) -> Dict[str, ParamDecl]:
    """Global shapes (local views in brackets):
      L [tp, n_in/tp, n_out/tp]  sharded on dim0   ([1, n_in/tp, n_out/tp])
      C [n_in, k]                sharded on dim0   ([n_in/tp, k])
      D [tp, k, n_out]           sharded on dim2   ([tp, k, n_out/tp])
      b [n_out]                  sharded           ([n_out/tp])

    Under FSDP only L is also sharded over dp, on the first of its local
    dims that dp divides (C and D are k wide: small, and a k-sized dim
    need not divide dp)."""
    if n_in % tp or n_out % tp:
        raise ValueError(f"phantom widths {n_in}x{n_out} do not divide "
                         f"tp={tp}")
    l_spec = ("tp", None, None)
    if fsdp:
        if (n_in // tp) % max(dp, 1) == 0:
            l_spec = ("tp", "dp", None)
        elif (n_out // tp) % max(dp, 1) == 0:
            l_spec = ("tp", None, "dp")
    d = {
        "L": ParamDecl((tp, n_in // tp, n_out // tp), l_spec,
                       scale=(n_in // tp) ** -0.5),
        "C": ParamDecl((n_in, k), ("tp", None), scale=(n_in // tp) ** -0.5),
        "D": ParamDecl((tp, k, n_out), (None, None, "tp"),
                       scale=(max(tp - 1, 1) * k) ** -0.5),
    }
    if bias:
        d["b"] = ParamDecl((n_out,), ("tp",), init="zeros")
    return d


def phantom_param_count(n_in: int, n_out: int, k: int, tp: int,
                        bias: bool = True) -> int:
    """Paper §VI-B model-size accounting: n_in*n_out/p + n_in*k + p*k*n_out."""
    n = (n_in // tp) * (n_out // tp) * tp + n_in * k + tp * k * n_out
    return n + (n_out if bias else 0)


def phantom_apply(pp: PhantomConfig, params, x, axes, compute_dtype=None):
    """x: [..., n_in/p] local feature shard -> [..., n_out/p].

    Activations stay feature-sharded end to end — the paper's "no
    concatenation between layers" property."""
    p = axes.tp
    L = params["L"][0]                      # [n_in/p, n_out/p] local
    C = params["C"]                         # [n_in/p, k]
    D = params["D"]                         # [p, k, n_out/p]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        L, C, D = (a.to(compute_dtype) for a in (L, C, D))
    j = axes.tp_rank

    # --- compress: k ghost neurons (paper: g = C y); at p = 1 only the
    # self term reads them ---
    if p > 1 or pp.include_self_term:
        g = x @ C

    use_kernel = (p > 1 and pp.variant == "fused"
                  and resolve_kernel_backend(pp.kernel_backend) == "pallas")

    # --- local update --- (on the kernel path it fuses with decompress)
    if not use_kernel:
        z = x @ L

    if pp.variant == "ring" and p > 1:
        # ppermute ring: hop s brings the ghosts of rank (j - s) mod p
        perm = [(s, (s + 1) % p) for s in range(p)]
        g_rot = g
        for s in range(1, p):
            g_rot = ppermute(g_rot, axes, perm)
            z = z + g_rot @ D[(j - s) % p]
        if pp.include_self_term:
            z = z + g @ D[j]
    elif pp.variant == "faithful" and p > 1:
        # paper-faithful: Algorithm 1 all-gather and p-1 separate skinny
        # decompress GEMMs D^(i,j) g^(i) (the self block only when asked)
        g_all = all_gather_ghosts(g, axes)          # [p, ..., k]
        for i in range(p):
            if i != j or pp.include_self_term:
                z = z + g_all[i] @ D[i]
    elif p > 1:
        # fused: one concatenated GEMM over all sources
        g_all = all_gather_ghosts(g, axes)          # [p, ..., k]
        gcat = torch.movedim(g_all, 0, -2)          # [..., p, k]
        gcat = gcat.reshape(*gcat.shape[:-2], p * D.shape[1])
        Dcat = D.reshape(p * D.shape[1], D.shape[2])  # [p*k, n_out/p]
        if use_kernel:
            z = phantom_fused_linear(x, L, gcat, Dcat)
        else:
            z = z + gcat @ Dcat
        if not pp.include_self_term:
            z = z - g @ D[j]
    elif pp.include_self_term:  # p == 1: the self term is the only one
        z = z + g @ D[0]

    if "b" in params:
        z = z + params["b"].to(z.dtype)
    return z


def phantom_dense_equivalent(params, include_self_term: bool = False):
    """The dense [n_in, n_out] matrix this phantom layer computes, from
    GLOBAL (unsharded) params: ``phantom_apply(x)`` equals
    ``x @ W_dense + b`` for the global x."""
    L, C, D = params["L"], params["C"], params["D"]
    p, nin_p, nout_p = L.shape
    k = C.shape[1]
    W = torch.zeros((p * nin_p, p * nout_p), dtype=L.dtype, device=L.device)
    Csh = C.reshape(p, nin_p, k)
    Dsh = D.reshape(p, k, p, nout_p)     # [src, k, dst, n_out/p]
    for i in range(p):
        for j in range(p):
            blk = Csh[i] @ Dsh[i, :, j, :]
            if i == j:
                blk = L[j] + blk if include_self_term else L[j]
            W[i * nin_p:(i + 1) * nin_p, j * nout_p:(j + 1) * nout_p] = blk
    return W
