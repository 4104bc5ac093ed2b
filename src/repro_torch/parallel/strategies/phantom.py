"""Phantom-parallel projection strategy (the paper's contribution):
feature shard in, feature shard out, k-wide ghost collectives."""
from __future__ import annotations

from repro_torch.configs.base import PhantomConfig
from repro_torch.core.phantom import (phantom_apply, phantom_decls,
                                      phantom_dense_equivalent,
                                      phantom_param_count)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.strategies.base import ProjectionStrategy, register


@register("phantom")
class PhantomStrategy(ProjectionStrategy):
    """Feature-shard in, feature-shard out; k-wide ghost collectives."""

    def __init__(self, n_in, n_out, tp, *, dp=1, bias=True, spec=None):
        super().__init__(n_in, n_out, tp, dp=dp, bias=bias, spec=spec)
        s = self.spec
        self.k = s.k
        self.pp = PhantomConfig(k=s.k, variant=s.variant,
                                include_self_term=s.include_self_term,
                                kernel_backend=s.kernel_backend)

    def decls(self):
        return phantom_decls(self.n_in, self.n_out, self.k, self.tp,
                             bias=self.bias)

    def apply_shard(self, params, x_shard, axes=None, compute_dtype=None):
        return phantom_apply(self.pp, params, x_shard, axes or MeshAxes(),
                             compute_dtype=compute_dtype)

    # the feature shard is phantom's own layout: one entry point
    apply = apply_shard

    def param_count(self):
        return phantom_param_count(self.n_in, self.n_out, self.k, self.tp,
                                   bias=self.bias)

    def dense_equivalent(self, params):
        W = phantom_dense_equivalent(
            params, include_self_term=self.pp.include_self_term)
        return W, params.get("b")
