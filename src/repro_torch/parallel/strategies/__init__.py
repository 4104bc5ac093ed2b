"""Projection-strategy registry; importing the package registers the
ported strategies.

    st = site_strategy(cfg, "ffn_up", d, ff, axes.tp, dp=axes.dp,
                       bias=False, fsdp=cfg.fsdp)
    decls = st.decls()                          # ParamDecl tree
    y = st.apply_shard(params, x, axes)         # sharded forward
    st.flops(batch), st.comm_events(batch)      # Table II accounting
"""
from repro_torch.parallel.strategies.base import (  # noqa: F401
    CommEvent, ProjectionStrategy, available_strategies, get_strategy_cls,
    make_strategy, register, site_strategy)
from repro_torch.parallel.strategies.phantom import (  # noqa: F401
    LowrankDistillStrategy, PhantomStrategy)
from repro_torch.parallel.strategies.tensor import (  # noqa: F401
    TensorColStrategy, TensorRowStrategy)
