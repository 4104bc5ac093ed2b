"""Pipeline smoke: the 1F1B FFN probe on pipe 2 x dp 2 x tp 2 (the
counterpart of the JAX package's ``benchmarks/pipeline_smoke.py``).

For ``tensor_col`` and phantom stages (n = 256, L = 4, k = 8, M = 4,
batch 32) each of 8 ranks counts its pipelined probe step once (flops
by ``FlopCounterMode``, wire bytes from the collective log, the
stage-boundary sends split out), runs ``--steps`` metered steps, and
joins them against ``pipeline_ffn_step_prediction(..., executed=False)``
(``telemetry/probe.py`` says why that account).  Held on every rank: its
boundary bytes equal its stage's sends exactly (``boundary_bytes``).
Phantom runs through the kernel backend (the CUDA kernels on the card,
their plain versions on the CPU).

    PYTHONPATH=src python -m repro_torch.benchmarks.pipeline_smoke --device cpu

writes ``build/torch_pipeline_smoke_report.json`` (``--report-out``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      PipelineConfig, dense_projection_map,
                                      phantom_projection_map)
from repro_torch.kernels import build
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.axes import resolve_device
from repro_torch.telemetry import Ledger, measure_ffn_pipeline_step
from repro_torch.telemetry.ledger import REPORT_DIR

N, LAYERS, K, M, BATCH = 256, 4, 8, 4, 32
PP, DP, TP = 2, 2, 2
SUITE = "pipeline_smoke"
IMPLS = (("dense", "tensor_col"), ("phantom", "phantom"))


def smoke_config(impl: str) -> ModelConfig:
    proj = (phantom_projection_map(K, ffn_layer=True,
                                   kernel_backend="pallas")
            if impl == "phantom" else dense_projection_map())
    return ModelConfig(name=f"pipe{N}-{impl}", family="ffn",
                       num_layers=LAYERS, d_model=N, ffn_width=N,
                       ffn_depth=LAYERS, mlp="relu",
                       phantom=PhantomConfig(k=K), projections=proj,
                       pipeline=PipelineConfig(stages=PP), microbatches=M)


def boundary_bytes(cfg, pp: int, dp: int, tp: int, stage: int,
                   global_batch: int) -> float:
    """The stage-boundary bytes one rank of ``stage`` sends in a step:
    M activations forward unless it is the last stage, M gradients back
    unless it is the first, each ``rows_mb * n / tp`` floats."""
    M_ = max(cfg.microbatches, 1)
    m = global_batch / (dp * M_) * cfg.ffn_width / tp
    return (M_ * (stage < pp - 1) + M_ * (stage > 0)) * m * 4.0


def probe_rank(axes, device, steps: int):
    """Inside one rank: (measured, predicted) per strategy."""
    return {strat: measure_ffn_pipeline_step(smoke_config(impl), axes,
                                             BATCH, steps=steps,
                                             device=device)
            for impl, strat in IMPLS}


def run(ledger: Ledger, steps: int = 3, device=None) -> list:
    dev = resolve_device(device)
    if dev.type == "cuda":
        build.build(["phantom_fused"])   # once, before the ranks load it
    ranks = spawn(probe_rank, DP, TP, dev, args=(steps,), pp=PP)
    wrong = []
    for impl, strat in IMPLS:
        cfg = smoke_config(impl)
        for r, res in enumerate(ranks):
            measured, predicted = res[strat]
            want = boundary_bytes(cfg, PP, DP, TP, measured["stage"], BATCH)
            got = measured["boundary_wire_bytes_per_device"]
            if got != want:
                wrong.append((strat, r, got, want))
        measured, predicted = ranks[0][strat]
        rf = measured["flops_per_device"] / predicted["flops_per_device"]
        rb = (measured["boundary_wire_bytes_per_device"]
              / predicted["boundary_wire_bytes_per_device"])
        emit(ledger, f"pipeline_smoke_{strat}",
             measured.get("wall_us_median", 0.0),
             f"n={N};L={LAYERS};k={K};pp={PP};mb={M};flops_ratio={rf:.3f};"
             f"boundary_wire_ratio={rb:.4f}", suite=SUITE, kind="train",
             arch=cfg.name, impl=strat, p=TP, measured=measured,
             predicted=predicted,
             extra={"n": N, "L": LAYERS, "k": K, "batch": BATCH, "pp": PP,
                    "dp": DP, "microbatches": M,
                    "bubble_fraction": predicted["bubble_fraction"],
                    "boundary_bytes_by_rank": [
                        x[strat][0]["boundary_wire_bytes_per_device"]
                        for x in ranks],
                    "steps": steps, "device": str(dev)})
    if wrong:
        raise RuntimeError(f"stage-boundary bytes differ from the stages' "
                           f"sends (strategy, rank, got, want): {wrong}")
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--report-out", default=str(
        REPORT_DIR / "torch_pipeline_smoke_report.json"))
    args = ap.parse_args(argv)
    ledger = Ledger(run=SUITE, meta={"device": str(resolve_device(
        args.device))})
    run(ledger, args.steps, args.device)
    print(f"wrote {ledger.write_report(args.report_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
