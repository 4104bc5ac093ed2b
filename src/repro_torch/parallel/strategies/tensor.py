"""Tensor-parallel (Megatron-style) projection strategies — the
paper's baseline.

Table II accounting (per layer, per pass):
  column path: forward All-Gather of the n_in/p activation shard, backward
  Reduce-Scatter (the gather's gradient) — message n_in/p * batch floats.
  row path:    forward Reduce-Scatter of the partial n_out sums, backward
  All-Gather — message n_out/p * batch floats.
"""
from __future__ import annotations

from repro_torch.core import tp as tpmod
from repro_torch.parallel.strategies.base import (CommEvent, ProjectionStrategy,
                                                  register)


@register("tensor_col")
class TensorColStrategy(ProjectionStrategy):
    """Column-parallel: W sharded on n_out; consumes full features."""

    in_layout = "full"
    out_layout = "shard"

    def decls(self):
        return tpmod.col_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias, fsdp=self.fsdp)

    def apply(self, params, x, *, axes=None, compute_dtype=None):
        return tpmod.col_linear_apply(params, x, compute_dtype)

    def apply_shard(self, params, x_shard, axes, compute_dtype=None):
        x_full = tpmod.gather_features(x_shard, axes)
        return tpmod.col_linear_apply(params, x_full, compute_dtype)

    def param_count(self):
        return self.n_in * self.n_out + (self.n_out if self.bias else 0)

    def flops(self, batch):
        return 2.0 * self.n_in * (self.n_out / self.tp) * batch

    def comm_events(self, batch):
        m = (self.n_in / self.tp) * batch
        return [CommEvent("all_gather", m, "fwd"),
                CommEvent("reduce_scatter", m, "bwd")]

    def dense_equivalent(self, params):
        return params["w"], params.get("b")


@register("tensor_row")
class TensorRowStrategy(ProjectionStrategy):
    """Row-parallel: W sharded on n_in; emits partial sums."""

    in_layout = "shard"
    out_layout = "partial"

    def decls(self):
        return tpmod.row_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias, fsdp=self.fsdp)

    def apply(self, params, x, *, axes=None, compute_dtype=None):
        """Partial sums over the sharded contraction dim, without the
        bias (the reference adds it after the reduction; no ported site
        has one)."""
        return tpmod.row_linear_apply(params, x, compute_dtype)

    def apply_shard(self, params, x_shard, axes, compute_dtype=None):
        """The partial sums reduce-scattered onto the feature shard."""
        return tpmod.scatter_features(
            tpmod.row_linear_apply(params, x_shard, compute_dtype), axes)

    def param_count(self):
        return self.n_in * self.n_out + (self.n_out if self.bias else 0)

    def flops(self, batch):
        return 2.0 * (self.n_in / self.tp) * self.n_out * batch

    def comm_events(self, batch):
        m = (self.n_out / self.tp) * batch
        return [CommEvent("reduce_scatter", m, "fwd"),
                CommEvent("all_gather", m, "bwd")]

    def dense_equivalent(self, params):
        return params["w"], params.get("b")
