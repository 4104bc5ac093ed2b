"""Projection-strategy registry; importing the package registers the
ported strategies."""
from repro_torch.parallel.strategies.base import (  # noqa: F401
    ProjectionStrategy, available_strategies, get_strategy_cls,
    make_strategy, register, site_strategy)
from repro_torch.parallel.strategies import phantom, tensor  # noqa: F401
