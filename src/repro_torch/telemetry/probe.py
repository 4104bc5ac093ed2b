"""Measured-vs-predicted probe for the paper-FFN step, per rank: the port
of the JAX package's ``telemetry/probe.py`` at pp = 1.

``make_ffn_probe_step`` builds a pure fwd+bwd step (loss + grads w.r.t.
the parameters AND the input, no optimizer) for the strategy ``cfg``
selects: the train step's own ``core/ffn.py: ffn_loss_and_grads``, with
the input differentiated too.  Input gradients are requested on purpose: the
analytic Table II schedule charges every layer an all-gather forward and
a reduce-scatter backward, but the first layer's backward collective
(and its input-grad GEMM) would not run for a constant input —
differentiating w.r.t. the input keeps the schedule complete, so the
measured/predicted ratios pin to ~1.

``measure_ffn_step`` runs the probe once under the counters
(``telemetry/counted.py``), optionally runs ``steps`` metered steps, and
returns the (measured, predicted) pair the ledger joins.  It runs inside
a rank (``launch/mesh.py: spawn``).  The pipelined probe comes with the
pipeline slice (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.ffn import ffn_decls, ffn_loss_and_grads, local_batch
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import materialize, shard_params
from repro_torch.telemetry.counted import count_step
from repro_torch.telemetry.meter import StepMeter
from repro_torch.telemetry.predict import (ffn_step_prediction,
                                           measured_energy_fields)


def make_ffn_probe_step(cfg, axes: MeshAxes, global_batch: int):
    """Returns ``(probe_fn, decls)``: ``probe_fn(params, x, y) -> (loss,
    (param_grads, input_grad))`` on this rank's shards, the train step's
    ``ffn_loss_and_grads`` with the input differentiated too: ``loss`` the
    global loss, the parameter gradients summed over the data axis."""
    decls = ffn_decls(cfg, axes)

    def probe(params, x, y):
        loss, grads, x_grad = ffn_loss_and_grads(
            cfg, axes, params, x.detach().requires_grad_(True), y,
            global_batch)
        return loss, (grads, x_grad)
    return probe, decls


def measure_ffn_step(cfg, axes: MeshAxes, global_batch: int, *,
                     steps: int = 0, seed: int = 0,
                     device=None) -> Tuple[dict, dict]:
    """Count one probe step, then run ``steps`` metered ones.

    Returns ``(measured, predicted)`` ready for a ``LedgerEntry``:
    measured carries the counted flops, collective wire bytes and
    message floats (per collective in ``collectives``, with the calls
    that ran them), the same account priced by the energy model, and
    wall stats when ``steps > 0``; predicted is ``ffn_step_prediction``
    summed from the same strategy objects, both priced at the H100's
    float32 peak.  Parameters and the global batch come from a generator
    seeded ``seed`` on ``device``.
    """
    dev = torch.device(device or "cpu")
    p = axes.tp
    probe, decls = make_ffn_probe_step(cfg, axes, global_batch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = shard_params(materialize(decls, gen, dev), decls, axes)
    x, y = (local_batch(torch.randn((global_batch, cfg.ffn_width),
                                    generator=gen, device=dev), axes)
            for _ in range(2))

    costs, _ = count_step(probe, params, x, y, device=dev)
    measured = measured_energy_fields(costs, p)
    measured["collectives"] = costs.collectives
    if costs.memory:
        measured["memory"] = costs.memory
    if steps > 0:
        meter = StepMeter(f"ffn_probe_{cfg.name}", warmup=1, device=dev)
        for _ in range(steps + meter.warmup):
            meter.call(probe, params, x, y)
        measured.update({k: v for k, v in meter.summary().items()
                         if k != "name"})
    predicted = ffn_step_prediction(cfg, p, global_batch, training=True)
    return measured, predicted
