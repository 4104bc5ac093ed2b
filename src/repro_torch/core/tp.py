"""Conventional tensor parallelism, the paper's baseline: Megatron-style
column/row projections.  At tp = 1 the feature gathers and scatters of
the reference are the identity, so only the projections remain."""
from __future__ import annotations

from typing import Dict

from repro_torch.parallel.params import ParamDecl


def col_linear_decls(n_in: int, n_out: int, tp: int, bias: bool = True
                     ) -> Dict[str, ParamDecl]:
    """Column-parallel: W [n_in, n_out] sharded on n_out."""
    d = {"w": ParamDecl((n_in, n_out), (None, "tp"))}
    if bias:
        d["b"] = ParamDecl((n_out,), ("tp",), init="zeros")
    return d


def row_linear_decls(n_in: int, n_out: int, tp: int, bias: bool = True
                     ) -> Dict[str, ParamDecl]:
    """Row-parallel: W [n_in, n_out] sharded on n_in."""
    d = {"w": ParamDecl((n_in, n_out), ("tp", None))}
    if bias:
        d["b"] = ParamDecl((n_out,), (), init="zeros")
    return d


def col_linear_apply(params, x_full, compute_dtype=None):
    """x_full: [..., n_in] -> [..., n_out] (the whole shard at tp = 1)."""
    w = params["w"]
    if compute_dtype is not None:
        x_full, w = x_full.to(compute_dtype), w.to(compute_dtype)
    z = x_full @ w
    if "b" in params:
        z = z + params["b"].to(z.dtype)
    return z


def row_linear_apply(params, x_shard, compute_dtype=None):
    """x_shard: [..., n_in] -> partial [..., n_out]; the caller adds the
    bias after the (identity) reduction."""
    w = params["w"]
    if compute_dtype is not None:
        x_shard, w = x_shard.to(compute_dtype), w.to(compute_dtype)
    return x_shard @ w
