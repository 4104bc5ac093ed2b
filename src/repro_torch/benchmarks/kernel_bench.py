"""The phantom FFN probe under each kernel backend: the kernel ledger
join (the counterpart of the JAX package's ``benchmarks/kernel_bench.py``).

On 8 ranks (dp = 1, tp = 8) at the reference's shape (n = 512, L = 2,
k = 8, batch 32), the same phantom probe step (``telemetry/probe.py``)
runs twice: ``kernel_backend="xla"`` (plain torch ops) and ``"pallas"``
(the hand-written CUDA kernels on the card, their plain versions on the
CPU).  Each is counted once, run ``--steps`` metered times and joined
with its prediction.  The wire ratio must be 1.00 for both backends: the
kernels fuse GEMMs, never collectives, so a drift means a collective
got into or out of the fused path.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --device cpu

writes ``build/torch_kernel_bench_report.json`` (``--report-out``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)
from repro_torch.kernels import build
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.axes import resolve_device
from repro_torch.telemetry import Ledger, measure_ffn_step
from repro_torch.telemetry.ledger import REPORT_DIR

N, LAYERS, K, BATCH, DP, TP = 512, 2, 8, 32, 1, 8
SUITE = "kernel_bench"
BACKENDS = ("xla", "pallas")
WIRE_TOL = 0.005          # the ratio, printed to two places, reads 1.00


def bench_config(backend: str) -> ModelConfig:
    return ModelConfig(name=f"ffn{N}-phantom-{backend}", family="ffn",
                       num_layers=LAYERS, d_model=N, ffn_width=N,
                       ffn_depth=LAYERS, mlp="relu",
                       phantom=PhantomConfig(k=K),
                       projections=phantom_projection_map(
                           K, ffn_layer=True, kernel_backend=backend))


def probe_rank(axes, device, steps: int):
    return {b: measure_ffn_step(bench_config(b), axes, BATCH, steps=steps,
                                device=device) for b in BACKENDS}


def run(ledger: Ledger, steps: int = 5, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        build.build(["phantom_fused"])   # once, before the ranks load it
    res = spawn(probe_rank, DP, TP, dev, args=(steps,))[0]
    off = {}
    for backend in BACKENDS:
        measured, predicted = res[backend]
        rf = measured["flops_per_device"] / predicted["flops_per_device"]
        rw = (measured["collective_wire_bytes_per_device"]
              / predicted["collective_wire_bytes_per_device"])
        emit(ledger, f"kernel_bench_{backend}",
             measured.get("wall_us_median", 0.0),
             f"n={N};L={LAYERS};k={K};flops_ratio={rf:.3f};"
             f"wire_ratio={rw:.4f}", suite=SUITE, kind="kernel",
             arch=bench_config(backend).name, impl=f"phantom_{backend}",
             p=TP, measured=measured, predicted=predicted,
             extra={"n": N, "L": LAYERS, "k": K, "batch": BATCH,
                    "steps": steps, "kernel_backend": backend,
                    "device": str(dev)})
        if abs(rw - 1) > WIRE_TOL:
            off[backend] = rw
    if off:
        raise RuntimeError(f"wire ratio is not 1.00 for {off}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--report-out",
                    default=str(REPORT_DIR / "torch_kernel_bench_report.json"))
    args = ap.parse_args(argv)
    ledger = Ledger(run=SUITE, meta={"device": str(resolve_device(
        args.device))})
    run(ledger, args.steps, args.device)
    print(f"wrote {ledger.write_report(args.report_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
