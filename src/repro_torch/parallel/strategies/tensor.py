"""Tensor-parallel (Megatron-style) projection strategies, at tp = 1."""
from __future__ import annotations

from repro_torch.core import tp as tpmod
from repro_torch.parallel.strategies.base import ProjectionStrategy, register


@register("tensor_col")
class TensorColStrategy(ProjectionStrategy):
    """Column-parallel: W sharded on n_out; consumes full features."""

    def decls(self):
        return tpmod.col_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias)

    def apply(self, params, x, *, compute_dtype=None):
        return tpmod.col_linear_apply(params, x, compute_dtype)


@register("tensor_row")
class TensorRowStrategy(ProjectionStrategy):
    """Row-parallel: W sharded on n_in; emits partial sums, which at
    tp = 1 are already the reduced output."""

    def decls(self):
        return tpmod.row_linear_decls(self.n_in, self.n_out, self.tp,
                                      bias=self.bias)

    def apply(self, params, x, *, compute_dtype=None):
        """Partial sums, without the bias (the reference adds it after
        the reduction; no ported site has one)."""
        return tpmod.row_linear_apply(params, x, compute_dtype)
