"""Phantom-parallel projection strategies (the paper's contribution):
feature shard in, feature shard out, k-wide ghost collectives.

Table II accounting (per layer, per pass): the ghost collectives carry
k*batch floats — All-Gather forward, Reduce-Scatter backward — against
the tensor path's (n/p)*batch.  Per-rank forward flops: local diagonal
block (n_in/p)(n_out/p), compress k*n_in/p, decompress (p-1)*k*n_out/p
(2 flops per MAC), the paper's Eqn. 8 operating regime.

``lowrank_distill`` has the same computation and cost structure; its
parameters come from a dense teacher through ``svd_phantom_init``
(``core/lowrank.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PhantomConfig
from repro_torch.core.phantom import (phantom_apply, phantom_decls,
                                      phantom_dense_equivalent,
                                      phantom_param_count)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.strategies.base import (CommEvent,
                                                  ProjectionStrategy,
                                                  register)


@register("phantom")
class PhantomStrategy(ProjectionStrategy):
    """Feature-shard in, feature-shard out; k-wide ghost collectives."""

    in_layout = "shard"
    out_layout = "shard"

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

    def flops(self, batch):
        p, k = self.tp, self.k
        local = (self.n_in / p) * (self.n_out / p)
        compress = k * (self.n_in / p)
        nsrc = (p - 1) + (1 if self.pp.include_self_term else 0)
        decompress = max(nsrc, 0) * k * (self.n_out / p)
        return 2.0 * (local + compress + decompress) * batch

    def comm_events(self, batch):
        m = self.k * batch
        if self.tp <= 1:
            return []
        return [CommEvent("all_gather", m, "fwd"),
                CommEvent("reduce_scatter", m, "bwd")]

    def dense_equivalent(self, params):
        W = phantom_dense_equivalent(
            params, include_self_term=self.pp.include_self_term)
        return W, params.get("b")


@register("lowrank_distill")
class LowrankDistillStrategy(PhantomStrategy):
    """Phantom factors initialised from a dense teacher matrix: the same
    runtime and cost structure as ``phantom``; ``init_from_dense`` makes
    the global params by truncated SVD, so a dense weight can be dropped
    into the phantom model class and fine-tuned."""

    def init_from_dense(self, W, b=None):
        """W [n_in, n_out] dense teacher -> global phantom params."""
        from repro_torch.core.lowrank import svd_phantom_init
        params = svd_phantom_init(W, self.tp, self.k)
        if self.bias:
            params["b"] = (torch.zeros((self.n_out,), dtype=torch.float32)
                           if b is None else
                           torch.as_tensor(b, dtype=torch.float32))
        return params

    def distill_error(self, W) -> float:
        """Relative Frobenius error of the rank-k phantom fit of W."""
        from repro_torch.core.lowrank import block_lowrank_error
        return block_lowrank_error(W, self.tp, self.k)
