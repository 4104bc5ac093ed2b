"""Measured-vs-predicted probe for the paper-FFN step, per rank: the port
of the JAX package's ``telemetry/probe.py``.

``make_ffn_probe_step`` builds a pure fwd+bwd step (loss + grads w.r.t.
the parameters AND the input, no optimizer) for the strategy ``cfg``
selects: the train step's own ``core/ffn.py: ffn_loss_and_grads``, with
the input differentiated too.  Input gradients are requested on purpose: the
analytic Table II schedule charges every layer an all-gather forward and
a reduce-scatter backward, but the first layer's backward collective
(and its input-grad GEMM) would not run for a constant input —
differentiating w.r.t. the input keeps the schedule complete, so the
measured/predicted ratios pin to ~1.  For a pipelined config the same
step runs the 1F1B schedule (``make_ffn_pipeline_probe_step``).

``measure_ffn_step`` and ``measure_ffn_pipeline_step`` run the probe
once under the counters (``telemetry/counted.py``), optionally run
``steps`` metered steps, and return the (measured, predicted) pair the
ledger joins.  They run inside a rank (``launch/mesh.py: spawn``), on the
card unless the caller asks for the CPU.

Which account the pipelined ledger uses.  The reference predicts its
pipeline with ``executed=True`` (``pipeline_ffn_step_prediction``),
because its SPMD wavefront computes in the bubbles and every device takes
part in every ``ppermute``.  The port's bubbles idle, so its flops and
layer collectives follow ``executed=False``: M repetitions per layer and
no bubble flops.  Its boundary sends depend on the stage: stage 0 sends
M activations forward and nothing backward, the last stage M gradients
backward and nothing forward, an interior stage M each way.  A rank's
measured boundary bytes are ``(M·[s < S-1] + M·[s > 0]) · m · 4`` with
``m = rows_mb · n / tp``; their mean over a pipe group is ``(S-1)/S`` of
the per-device ``executed=False`` figure, which counts 2M sends.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.ffn import ffn_decls, ffn_loss_and_grads, local_batch
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.params import materialize_shards
from repro_torch.telemetry.counted import count_step
from repro_torch.telemetry.meter import StepMeter
from repro_torch.telemetry.predict import (ffn_step_prediction,
                                           measured_energy_fields,
                                           pipeline_ffn_step_prediction)


def make_ffn_probe_step(cfg, axes: MeshAxes, global_batch: int):
    """Returns ``(probe_fn, decls)``: ``probe_fn(params, x, y) -> (loss,
    (param_grads, input_grad))`` on this rank's shards, the train step's
    ``ffn_loss_and_grads`` with the input differentiated too: ``loss`` the
    global loss, the parameter gradients summed over the data axis (and
    the pipe axis for mixed stages)."""
    decls = ffn_decls(cfg, axes)

    def probe(params, x, y):
        loss, grads, x_grad = ffn_loss_and_grads(
            cfg, axes, params, x.detach().requires_grad_(True), y,
            global_batch)
        return loss, (grads, x_grad)
    return probe, decls


# The reference's pipelined probe unrolls its wavefront so that XLA counts
# every tick; the port runs eagerly, and ``ffn_loss_and_grads`` runs the
# 1F1B schedule for a pipelined config, so the probe is the same step.
make_ffn_pipeline_probe_step = make_ffn_probe_step


def probe_inputs(cfg, axes: MeshAxes, decls, global_batch: int, seed: int,
                 device):
    """``(params, x, y)`` of a probe on ``device``: the rank's shards of
    the global parameters drawn on the host from a generator seeded
    ``seed`` (``materialize_shards``), and of a global ``[global_batch,
    n]`` pair (x, y) drawn on the host from one seeded ``seed + 1``, as
    the reference draws its batch from ``PRNGKey(seed + 1)``."""
    params = materialize_shards(decls, axes, seed, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x, y = (local_batch(torch.randn((global_batch, cfg.ffn_width),
                                    generator=gen), axes).to(device)
            for _ in range(2))
    return params, x, y


def _measure(cfg, axes, global_batch, steps, seed, device):
    """Count one probe step and meter ``steps`` more: the counted costs
    and the wall fields."""
    dev = resolve_device(device)
    probe, decls = make_ffn_probe_step(cfg, axes, global_batch)
    params, x, y = probe_inputs(cfg, axes, decls, global_batch, seed, dev)
    costs, _ = count_step(probe, params, x, y, device=dev)
    wall = {}
    if steps > 0:
        meter = StepMeter(f"ffn_probe_{cfg.name}", warmup=1, device=dev)
        for _ in range(steps + meter.warmup):
            meter.call(probe, params, x, y)
        wall = {k: v for k, v in meter.summary().items() if k != "name"}
    return costs, wall


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
    float32 peak.  Inputs come from ``probe_inputs``.
    """
    p = axes.tp
    costs, wall = _measure(cfg, axes, global_batch, steps, seed, device)
    measured = measured_energy_fields(costs, p)
    measured["collectives"] = costs.collectives
    if costs.memory:
        measured["memory"] = costs.memory
    measured.update(wall)
    predicted = ffn_step_prediction(cfg, p, global_batch, training=True)
    return measured, predicted


def measure_ffn_pipeline_step(cfg, axes: MeshAxes, global_batch: int, *,
                              steps: int = 0, seed: int = 0,
                              device=None) -> Tuple[dict, dict]:
    """The pipelined probe's ``(measured, predicted)`` ledger join on a
    pp x dp x tp mesh, with the stage-boundary (``collective_permute``)
    wire bytes split out on both sides
    (``boundary_wire_bytes_per_device``).  Measured: the counted flops,
    wire bytes and message floats of this rank (``stage`` says which),
    and wall stats when ``steps > 0``.  Predicted:
    ``pipeline_ffn_step_prediction(..., executed=False)``, the account
    of idle bubbles (the module's docstring says why, and why a rank's
    boundary bytes differ from it by stage)."""
    costs, wall = _measure(cfg, axes, global_batch, steps, seed, device)
    measured = costs.measured_fields()
    measured["boundary_wire_bytes_per_device"] = costs.collectives.get(
        "collective_permute", {}).get("wire_bytes", 0.0)
    measured["collectives"] = costs.collectives
    measured["stage"] = axes.pp_rank
    if costs.memory:
        measured["memory"] = costs.memory
    measured.update(wall)
    predicted = pipeline_ffn_step_prediction(
        cfg, axes.pp, axes.tp, axes.dp, global_batch, executed=False)
    return measured, predicted
