"""Phantom parallelism, the paper's core contribution, at p = 1.

A phantom linear replaces a tensor-parallel ``n_in x n_out`` projection:
the weight is viewed in ``p x p`` blocks, diagonal blocks stay exact
(``L``), off-diagonal blocks are rank-k (compressor ``C``, decompressor
``D``).  ``phantom_decls`` keeps the reference's L/C/D/b layout so
weights carry across unchanged.

With one rank there are no off-diagonal blocks and no ghosts to gather:
the layer is ``x·L`` (plus ``(x·C)·D_self`` when ``include_self_term``)
plus the bias, as in the reference's ``p == 1`` branch.  The fused,
faithful and ring variants, and the fused projection kernel behind
them, need p > 1 and arrive with the collectives slice.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import PhantomConfig
from repro_torch.parallel.axes import MULTI_DEVICE_TODO
from repro_torch.parallel.params import ParamDecl


def phantom_decls(n_in: int, n_out: int, k: int, tp: int,
                  bias: bool = True) -> Dict[str, ParamDecl]:
    """Global shapes: L [tp, n_in/tp, n_out/tp], C [n_in, k],
    D [tp, k, n_out], b [n_out]."""
    if n_in % tp or n_out % tp:
        raise ValueError(f"phantom widths {n_in}x{n_out} do not divide "
                         f"tp={tp}")
    d = {
        "L": ParamDecl((tp, n_in // tp, n_out // tp), ("tp", None, None),
                       scale=(n_in // tp) ** -0.5),
        "C": ParamDecl((n_in, k), ("tp", None), scale=(n_in // tp) ** -0.5),
        "D": ParamDecl((tp, k, n_out), (None, None, "tp"),
                       scale=(max(tp - 1, 1) * k) ** -0.5),
    }
    if bias:
        d["b"] = ParamDecl((n_out,), ("tp",), init="zeros")
    return d


def phantom_apply(pp: PhantomConfig, params, x, p: int = 1,
                  compute_dtype=None):
    """x: [..., n_in] -> [..., n_out] on a one-rank model axis."""
    if p != 1:
        raise NotImplementedError(
            f"phantom_apply at p={p}: see {MULTI_DEVICE_TODO}")
    L = params["L"][0]
    if compute_dtype is not None:
        x, L = x.to(compute_dtype), L.to(compute_dtype)
    z = x @ L
    if pp.include_self_term:
        C, D = params["C"], params["D"][0]
        if compute_dtype is not None:
            C, D = C.to(compute_dtype), D.to(compute_dtype)
        z = z + (x @ C) @ D
    if "b" in params:
        z = z + params["b"].to(z.dtype)
    return z
