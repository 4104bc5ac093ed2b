"""Conventional tensor parallelism, the paper's baseline: Megatron-style
column/row projections with explicit collectives, so the communication
is exactly the paper's Table II schedule:

  TP per layer:  All-Gather of the n/p activation shard forward,
                 Reduce-Scatter of the activation gradients backward.

The projections run on the rank's local weight shard; the gathers and
scatters (over features, or over the sequence for the residual stream's
sequence-parallel layout) run over ``axes.tp_comm`` and are the
identity at tp = 1.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.autograd import all_gather_tiled, psum_scatter_tiled
from repro_torch.parallel.params import ParamDecl


def col_linear_decls(n_in: int, n_out: int, tp: int, bias: bool = True,
                     fsdp: bool = False) -> Dict[str, ParamDecl]:
    """Column-parallel: W [n_in, n_out] sharded on n_out (and on n_in
    over dp under FSDP)."""
    d = {"w": ParamDecl((n_in, n_out), ("dp" if fsdp else None, "tp"))}
    if bias:
        d["b"] = ParamDecl((n_out,), ("tp",), init="zeros")
    return d


def row_linear_decls(n_in: int, n_out: int, tp: int, bias: bool = True,
                     fsdp: bool = False) -> Dict[str, ParamDecl]:
    """Row-parallel: W [n_in, n_out] sharded on n_in (and on n_out over
    dp under FSDP)."""
    d = {"w": ParamDecl((n_in, n_out), ("tp", "dp" if fsdp else None))}
    if bias:
        d["b"] = ParamDecl((n_out,), (), init="zeros")
    return d


def col_linear_apply(params, x_full, compute_dtype=None):
    """x_full: [..., n_in] (replicated features) -> [..., n_out/p]."""
    w = params["w"]
    if compute_dtype is not None:
        x_full, w = x_full.to(compute_dtype), w.to(compute_dtype)
    z = x_full @ w
    if "b" in params:
        z = z + params["b"].to(z.dtype)
    return z


def row_linear_apply(params, x_shard, compute_dtype=None):
    """x_shard: [..., n_in/p] -> partial [..., n_out]; the caller
    reduces and then adds the bias."""
    w = params["w"]
    if compute_dtype is not None:
        x_shard, w = x_shard.to(compute_dtype), w.to(compute_dtype)
    return x_shard @ w


def gather_features(x_shard, axes):
    """[..., n/p] feature shard -> [..., n] full (fwd AG, bwd RS)."""
    return all_gather_tiled(x_shard, axes, -1)


def scatter_features(z_partial, axes):
    """partial [..., n] -> reduced [..., n/p] (fwd RS, bwd AG)."""
    return psum_scatter_tiled(z_partial, axes, -1)


def gather_seq(x, axes, axis=1):
    """Sequence-parallel gather: [B, S/p, d] -> [B, S, d] (fwd AG, bwd
    RS)."""
    return all_gather_tiled(x, axes, axis)


def scatter_seq(z, axes, axis=1):
    """partial [B, S, d] -> reduced [B, S/p, d] (fwd RS, bwd AG)."""
    return psum_scatter_tiled(z, axes, axis)
