"""Predicted per-step costs of the paper-FFN step, summed from the very
``ProjectionStrategy`` objects that execute: the port of the FFN half of
the JAX package's ``telemetry/predict.py``, with the same keys and
formulas, so the two packages' reports compare key by key.

Everything here is a thin sum over ``strategy.flops()`` /
``strategy.comm_events()`` (the account ``core/energy.py`` prices, paper
Eqns. 1-2, 24-26) plus the ring-model conversion of a ``CommEvent`` to
wire bytes, which is the SAME formula the measured side applies to the
collectives the ranks issued (``telemetry/counted.py``):

  all_gather      m·(p-1)·itemsize   (gathered result = m·p, ring wire
                                      = result·(p-1)/p)
  reduce_scatter  m·(p-1)·itemsize   (result = m, ring wire = result·(p-1))
  all_reduce      2·m·(p-1)/p·itemsize

with ``m`` the per-rank message in floats (the ``CommEvent`` unit).

Serving, pipeline, KV-transfer and recovery predictions are not ported:
they come with the slices that port those paths (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.energy import (FRONTIER_A_W, FRONTIER_B_W,
                                     H100_PEAK_FLOPS_FP32,
                                     PAPER_COLLECTIVE_FITS, comm_time_us,
                                     costs_from_strategies,
                                     energy_per_iteration)
from repro_torch.parallel.strategies.base import CommEvent

FLOAT_BYTES = 4.0


def event_wire_bytes(ev: CommEvent, p: int,
                     itemsize: float = FLOAT_BYTES) -> float:
    """Per-device ring wire bytes for one strategy collective — the
    prediction the measured wire bytes are compared to."""
    if p <= 1:
        return 0.0
    m = ev.m_floats * itemsize
    if ev.collective == "all_gather":
        return m * (p - 1)
    if ev.collective == "reduce_scatter":
        return m * (p - 1)
    if ev.collective == "all_reduce":
        return 2.0 * m * (p - 1) / p
    if ev.collective == "all_to_all":
        return m * (p - 1) / p
    return m                                  # collective_permute: one hop


def events_for(strategies: Sequence, batch: int,
               training: bool = True) -> List[CommEvent]:
    """All collectives the strategies issue per pass; inference drops the
    backward-phase events (no gradient collectives at serving time)."""
    out = []
    for st in strategies:
        for ev in st.comm_events(batch):
            if not training and ev.phase == "bwd":
                continue
            out.append(ev)
    return out


def strategy_prediction(strategies: Sequence, p: int, L: int, batch: int,
                        *, training: bool = True,
                        peak_flops: float = H100_PEAK_FLOPS_FP32,
                        fits=None, A: float = FRONTIER_A_W,
                        B: float = FRONTIER_B_W,
                        itemsize: float = FLOAT_BYTES) -> dict:
    """The ledger's ``predicted`` block for a step executing each of
    ``strategies`` once per layer, ``L`` layers.

    Keys are aligned with ``MeasuredCosts.measured_fields()`` so the
    ledger can ratio them directly; the energy projection applies the
    paper's E = p·(A·α + B·β) per iteration.
    """
    alpha_s, beta_s = costs_from_strategies(
        strategies, p, L, batch, peak_flops, fits, training=training)
    events = events_for(strategies, batch, training)
    wire = sum(event_wire_bytes(ev, p, itemsize) for ev in events) * L
    m_floats = sum(ev.m_floats for ev in events) * L
    comm_us = sum(comm_time_us(ev.collective, ev.m_floats, p, fits)
                  for ev in events) * L
    return {
        "flops_per_device": alpha_s * peak_flops,
        "collective_wire_bytes_per_device": wire,
        "collective_m_floats": m_floats,
        "comm_us": comm_us,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s, p,
                                                  A, B),
        "training": training,
        "model": "E = nu*p*(A*alpha + B*beta)",
        "A_w": A, "B_w": B,
        "peak_flops": peak_flops,
    }


def measured_energy_fields(costs, p: int, *, fits=None,
                           peak_flops: float = H100_PEAK_FLOPS_FP32,
                           A: float = FRONTIER_A_W,
                           B: float = FRONTIER_B_W) -> dict:
    """Price the MEASURED account of one step with the same
    E = p·(A·α + B·β) the predictions use: α from the counted flops, β
    from the issued collectives' per-event message sizes run through the
    Eqn. 26 comm model.  The measured/predicted ``energy_j_per_iter``
    ratio is then a pure model-accuracy number (same constants both
    sides, wall time out of the picture).  ``costs`` is a
    ``MeasuredCosts``; its ``collectives`` are keyed by the paper's
    collective names."""
    alpha_s = costs.flops / peak_flops
    table = dict(fits or PAPER_COLLECTIVE_FITS)
    # collectives without a Table III fit of their own are priced at the
    # nearest fitted shape: a2a moves (p-1)/p of a gather's wire, a
    # permute hop is broadcast-like
    fallback = {"all_to_all": "all_gather",
                "collective_permute": "broadcast"}
    us = 0.0
    for op, rec in costs.collectives.items():
        count = rec.get("count", 0)
        if not count:
            continue
        paper = op if op in table else fallback.get(op, "all_gather")
        if paper not in table:
            continue
        us += comm_time_us(paper, rec["m_floats"] / count, p, table) * count
    beta_s = us * 1e-6
    return {
        "flops_per_device": costs.flops,
        "collective_wire_bytes_per_device": costs.collective_wire_bytes,
        "collective_m_floats": costs.collective_m_floats,
        "alpha_s": alpha_s,
        "beta_s": beta_s,
        "energy_j_per_iter": energy_per_iteration(alpha_s, beta_s, p,
                                                  A, B),
    }


def ffn_step_prediction(cfg, p: int, global_batch: int, *,
                        training: bool = True,
                        peak_flops: float = H100_PEAK_FLOPS_FP32,
                        fits=None, A: float = FRONTIER_A_W,
                        B: float = FRONTIER_B_W) -> dict:
    """Prediction for one paper-FFN step (the strategy ``cfg`` selects at
    the ``ffn_layer`` site, applied once per layer)."""
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    pred = strategy_prediction([st], p, cfg.num_layers, global_batch,
                               training=training, peak_flops=peak_flops,
                               fits=fits, A=A, B=B)
    pred["strategy"] = st.kind
    pred["param_count"] = st.param_count() * cfg.num_layers
    return pred


def fused_kernel_step_events(cfg, p: int, rows: int,
                             training: bool = True) -> List[tuple]:
    """(CommEvent, layer-repeats) account of a phantom FFN step running
    with ``kernel_backend="pallas"`` (the hand-written kernels) —
    IDENTICAL to the plain path's account by construction: the fused
    kernel moves GEMM traffic, never collectives (the ghost all-gather /
    reduce-scatter stay outside the autograd op), so this re-exports the
    strategy's own ``comm_events``."""
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    return [(ev, cfg.num_layers)
            for ev in events_for([st], rows, training)]


def fused_ffn_step_prediction(cfg, p: int, global_batch: int, *,
                              training: bool = True,
                              itemsize: float = FLOAT_BYTES,
                              **kw) -> dict:
    """``ffn_step_prediction`` for the kernel backend: same flops, same
    collectives, same energy projection (zero drift), annotated with
    what fusion DOES change — the decompress GEMM accumulates into the
    local GEMM's tile instead of a second read+write pass of z over HBM
    (one saved round trip per layer per pass)."""
    pred = ffn_step_prediction(cfg, p, global_batch,
                               training=training, **kw)
    from repro_torch.core.ffn import ffn_strategy
    st = ffn_strategy(cfg, p)
    z_bytes = global_batch * (st.n_out // p) * itemsize
    passes = 3 if training else 1          # fwd + fused dgrad + wgrad
    pred["kernel_backend"] = cfg.projection_spec("ffn_layer").kernel_backend
    pred["hbm_bytes_saved_per_device"] = (2.0 * z_bytes * passes
                                          * cfg.num_layers)
    return pred
