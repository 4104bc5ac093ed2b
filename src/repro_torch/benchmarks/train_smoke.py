"""Metered tensor-vs-phantom FFN train step: the ledger's core join (the
counterpart of the JAX package's ``benchmarks/train_smoke.py``).

On 8 ranks (dp = 1, tp = 8) at the reference's shape (n = 512, L = 2,
k = 8, batch 32), each strategy's probe step (``telemetry/probe.py``:
input grads kept) is counted once — flops by ``FlopCounterMode``, wire
bytes from the collective log — then run ``--steps`` metered times, and
joined against the account predicted from the same strategy objects.
Phantom runs through the kernel backend (the CUDA kernels on the card,
their plain versions on the CPU).

    PYTHONPATH=src python -m repro_torch.benchmarks.train_smoke --device cpu

writes ``build/torch_train_smoke_report.json`` (``--report-out``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      dense_projection_map,
                                      phantom_projection_map)
from repro_torch.kernels import build
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.axes import resolve_device
from repro_torch.telemetry import Ledger, measure_ffn_step
from repro_torch.telemetry.ledger import REPORT_DIR

N, LAYERS, K, BATCH, DP, TP = 512, 2, 8, 32, 1, 8
SUITE = "train_smoke"
# (config impl, strategy the ffn_layer site runs)
IMPLS = (("dense", "tensor_col"), ("phantom", "phantom"))


def smoke_config(impl: str) -> ModelConfig:
    proj = (phantom_projection_map(K, ffn_layer=True,
                                   kernel_backend="pallas")
            if impl == "phantom" else dense_projection_map())
    return ModelConfig(name=f"ffn{N}-{impl}", family="ffn",
                       num_layers=LAYERS, d_model=N, ffn_width=N,
                       ffn_depth=LAYERS, mlp="relu",
                       phantom=PhantomConfig(k=K), projections=proj)


def probe_rank(axes, device, steps: int):
    """Inside one rank: (measured, predicted) per strategy."""
    return {strat: measure_ffn_step(smoke_config(impl), axes, BATCH,
                                    steps=steps, device=device)
            for impl, strat in IMPLS}


def run(ledger: Ledger, steps: int = 5, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        build.build(["phantom_fused"])   # once, before the ranks load it
    res = spawn(probe_rank, DP, TP, dev, args=(steps,))[0]
    for impl, strat in IMPLS:
        measured, predicted = res[strat]
        rf = measured["flops_per_device"] / predicted["flops_per_device"]
        rw = (measured["collective_wire_bytes_per_device"]
              / predicted["collective_wire_bytes_per_device"])
        emit(ledger, f"train_smoke_{strat}",
             measured.get("wall_us_median", 0.0),
             f"n={N};L={LAYERS};k={K};flops_ratio={rf:.3f};"
             f"wire_ratio={rw:.4f}", suite=SUITE, kind="train",
             arch=smoke_config(impl).name, impl=strat, p=TP,
             measured=measured, predicted=predicted,
             extra={"n": N, "L": LAYERS, "k": K, "batch": BATCH,
                    "steps": steps, "device": str(dev)})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--report-out",
                    default=str(REPORT_DIR / "torch_train_smoke_report.json"))
    args = ap.parse_args(argv)
    ledger = Ledger(run=SUITE, meta={"device": str(resolve_device(
        args.device))})
    run(ledger, args.steps, args.device)
    print(f"wrote {ledger.write_report(args.report_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
