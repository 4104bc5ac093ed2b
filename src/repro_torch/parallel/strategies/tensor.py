"""Tensor-parallel (Megatron-style) projection strategies — the
paper's baseline."""
from __future__ import annotations

from repro_torch.core import tp as tpmod
from repro_torch.parallel.strategies.base import ProjectionStrategy, register


@register("tensor_col")
class TensorColStrategy(ProjectionStrategy):
    """Column-parallel: W sharded on n_out; consumes full features."""

    def decls(self):
        return tpmod.col_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias)

    def apply(self, params, x, *, axes=None, compute_dtype=None):
        return tpmod.col_linear_apply(params, x, compute_dtype)

    def apply_shard(self, params, x_shard, axes, compute_dtype=None):
        x_full = tpmod.gather_features(x_shard, axes)
        return tpmod.col_linear_apply(params, x_full, compute_dtype)

    def param_count(self):
        return self.n_in * self.n_out + (self.n_out if self.bias else 0)

    def dense_equivalent(self, params):
        return params["w"], params.get("b")


@register("tensor_row")
class TensorRowStrategy(ProjectionStrategy):
    """Row-parallel: W sharded on n_in; emits partial sums."""

    def decls(self):
        return tpmod.row_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias)

    def apply(self, params, x, *, axes=None, compute_dtype=None):
        """Partial sums over the sharded contraction dim, without the
        bias (the reference adds it after the reduction; no ported site
        has one)."""
        return tpmod.row_linear_apply(params, x, compute_dtype)

    def param_count(self):
        return self.n_in * self.n_out + (self.n_out if self.bias else 0)

    def dense_equivalent(self, params):
        return params["w"], params.get("b")
