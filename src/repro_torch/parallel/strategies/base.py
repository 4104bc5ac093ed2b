"""ProjectionStrategy: one object per projection site that declares the
site's parameters, computes its sharded projection AND predicts its cost.

``apply()`` computes the projection in the strategy's own feature
layout (``in_layout`` -> ``out_layout``): tensor_col takes full features
and returns the rank's output shard, tensor_row takes an input shard and
returns partial sums, phantom takes and returns feature shards.
``apply_shard()`` is the uniform feature-shard -> feature-shard form
that the paper-FFN stack composes (tensor_col and phantom).

``flops()``, ``comm_events()`` and ``param_count()`` are the same
object's per-operator account: the energy model (``core/energy.py``)
and the ledger's predictions (``telemetry/predict.py``) sum them, so the
paper's Table II schedule falls out of the operators that execute.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Type

from repro_torch.configs.base import (PHANTOM_KINDS, PROJECTION_SITES,
                                      ProjectionSpec)


@dataclass(frozen=True)
class CommEvent:
    """One collective issued by a strategy, in paper Eqn. 26 units."""
    collective: str        # all_gather | reduce_scatter | all_reduce
    m_floats: float        # per-rank message size, floats
    phase: str = "fwd"     # fwd | bwd


class ProjectionStrategy:
    """Base class; concrete strategies register themselves by ``kind``."""

    kind: str = "?"
    in_layout: str = "full"        # "full" | "shard"
    out_layout: str = "shard"      # "shard" | "partial"

    def __init__(self, n_in: int, n_out: int, tp: int, *, dp: int = 1,
                 bias: bool = True, fsdp: bool = False,
                 spec: Optional[ProjectionSpec] = None):
        self.n_in, self.n_out, self.tp, self.dp = n_in, n_out, tp, dp
        self.bias, self.fsdp = bias, fsdp
        self.spec = spec or ProjectionSpec(kind=self.kind)

    def decls(self) -> Dict:
        raise NotImplementedError

    def apply(self, params, x, *, axes=None, compute_dtype=None):
        """The projection in the strategy's own feature layout."""
        raise NotImplementedError

    def apply_shard(self, params, x_shard, axes, compute_dtype=None):
        """Uniform feature-shard [..., n_in/p] -> [..., n_out/p]."""
        raise NotImplementedError

    def param_count(self) -> int:
        raise NotImplementedError

    def flops(self, batch: int) -> float:
        """Per-rank FORWARD flops for ``batch`` rows (2 * MACs).  Training
        cost models multiply by 3 (fwd + bwd-input + bwd-weight)."""
        raise NotImplementedError

    def comm_events(self, batch: int) -> List[CommEvent]:
        """Collectives this strategy issues per fwd+bwd pass."""
        raise NotImplementedError

    def dense_equivalent(self, params):
        """GLOBAL (unsharded) params -> (W [n_in, n_out], b or None): the
        dense matrix this strategy computes."""
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}({self.n_in}x{self.n_out}, "
                f"tp={self.tp}, kind={self.kind})")


_REGISTRY: Dict[str, Type[ProjectionStrategy]] = {}


def register(kind: str) -> Callable[[type], type]:
    def deco(cls):
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return deco


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def get_strategy_cls(kind: str) -> Type[ProjectionStrategy]:
    if kind not in _REGISTRY:
        raise KeyError(f"unknown projection strategy {kind!r}; "
                       f"registered: {available_strategies()}")
    return _REGISTRY[kind]


def make_strategy(spec: ProjectionSpec, n_in: int, n_out: int, tp: int, *,
                  dp: int = 1, bias: bool = True,
                  fsdp: bool = False) -> ProjectionStrategy:
    """Instantiate the strategy a ProjectionSpec selects for one site."""
    return get_strategy_cls(spec.kind)(n_in, n_out, tp, dp=dp, bias=bias,
                                       fsdp=fsdp, spec=spec)


def site_strategy(cfg, site: str, n_in: int, n_out: int, tp: int, *,
                  dp: int = 1, bias: bool = True, fsdp: bool = False,
                  allow_phantom: bool = True) -> ProjectionStrategy:
    """Resolve cfg's spec for ``site`` and instantiate it;
    ``allow_phantom=False`` (or a width the model axis does not divide)
    forces the site's natural dense strategy."""
    spec = cfg.projection_spec(site)
    if spec.kind in PHANTOM_KINDS and (
            not allow_phantom or n_in % tp or n_out % tp):
        spec = ProjectionSpec(kind=PROJECTION_SITES[site])
    return make_strategy(spec, n_in, n_out, tp, dp=dp, bias=bias,
                         fsdp=fsdp)
