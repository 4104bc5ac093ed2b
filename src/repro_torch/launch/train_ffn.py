"""Train the paper's FFN under phantom or tensor parallelism: the port's
counterpart of ``examples/train_ffn_phantom.py`` and of
``benchmarks/table1_energy.py: train_to_target``.

    PYTHONPATH=src python -m repro_torch.launch.train_ffn \\
        --arch paper-ffn-16k --dp 1 --tp 8 --impl phantom --steps 20

spawns ``dp * tp`` ranks (``launch/mesh.py: spawn``), each training its
shards on the Gaussian-teacher data at the paper's Table I settings
(batch 64, AdamW at 3e-3 with weight decay 0, seed 0), and prints each
step's loss and the model's parameter count.  The ranks run
on the card unless ``--device cpu`` is given; ``--smoke`` takes the
config's CPU-sized geometry.  ``--ledger-out PATH`` then counts and
meters the run's step once more (``telemetry/probe.py:
measure_ffn_step``: flops, collective wire bytes, energy, measured
against predicted) and writes that ledger entry's report to PATH.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from repro_torch.configs.base import (PhantomConfig, dense_projection_map,
                                      get_config, phantom_projection_map)
from repro_torch.core.ffn import (ffn_model_params, init_ffn, local_batch,
                                  make_ffn_train_step)
from repro_torch.data.synthetic import TeacherDataset
from repro_torch.kernels import build
from repro_torch.kernels.ops import KERNEL_BACKENDS, resolve_kernel_backend
from repro_torch.launch.mesh import spawn
from repro_torch.optim import AdamW
from repro_torch.parallel.axes import resolve_device
from repro_torch.telemetry import Ledger, LedgerEntry, measure_ffn_step

BATCH, LR, SEED = 64, 3e-3, 0     # the paper's Table I run
PROBE_STEPS = 5                   # metered probe steps for --ledger-out
TIMEOUT_S = 1800.0                # the whole run, before the ranks are killed


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="paper-ffn-16k")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced CPU geometry")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=8)
    ap.add_argument("--impl", choices=("phantom", "tensor"),
                    default="phantom")
    ap.add_argument("--k", type=int, default=0,
                    help="ghost width (0: the config's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--target", type=float, default=None,
                    help="stop at the first step whose loss is <= this")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--kernel-backend", default="pallas",
                    choices=KERNEL_BACKENDS)
    ap.add_argument("--ledger-out", default=None, metavar="PATH",
                    help="after training, write a measured-vs-predicted "
                         "ledger report of the run's step to PATH")
    return ap


def train_config(arch: str, *, smoke: bool = False, impl: str = "phantom",
                 k: int = 0, kernel_backend: str = "pallas"):
    """The arch's FFN config with one projection strategy at the paper's
    ``ffn_layer`` site: phantom (ghost width ``k``, the config's when 0)
    or the tensor-parallel baseline."""
    cfg = get_config(arch, smoke=smoke)
    k = k or cfg.phantom.k
    proj = (phantom_projection_map(k, ffn_layer=True,
                                   kernel_backend=kernel_backend)
            if impl == "phantom" else dense_projection_map())
    return cfg.replace(phantom=PhantomConfig(k=k), projections=proj)


def train_rank(axes, device, cfg, steps: int, target=None):
    """One rank's run: ``steps`` AdamW steps (or fewer, at ``target``).
    Returns the global losses and the wall seconds of each step (each
    ended by reading the loss, which waits for the device)."""
    opt = AdamW(LR, weight_decay=0.0)
    step_fn, _, _ = make_ffn_train_step(cfg, axes, opt, BATCH)
    params, state = init_ffn(cfg, axes, opt, SEED, device)
    ds = TeacherDataset(cfg.ffn_width, BATCH, SEED, device)
    losses, step_s = [], []
    for s in range(steps):
        x, y = ds(s)
        x, y = local_batch(x, axes), local_batch(y, axes)
        t0 = time.perf_counter()
        params, state, loss = step_fn(params, state, s, x, y)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if target is not None and losses[-1] <= target:
            break
    return {"losses": losses, "step_s": step_s}


def train_and_probe_rank(axes, device, cfg, steps: int, target=None,
                         probe: bool = False):
    """``train_rank``, then, with ``probe``, the step's
    ``(measured, predicted)`` pair from ``measure_ffn_step``."""
    out = train_rank(axes, device, cfg, steps, target)
    if probe:
        out["probe"] = measure_ffn_step(cfg, axes, BATCH, steps=PROBE_STEPS,
                                        seed=SEED, device=device)
    return out


def needs_kernels(cfg, device: torch.device) -> bool:
    spec = cfg.projection_spec("ffn_layer")
    return (device.type == "cuda" and spec.kind == "phantom"
            and resolve_kernel_backend(spec.kernel_backend) == "pallas")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = train_config(args.arch, smoke=args.smoke, impl=args.impl,
                       k=args.k, kernel_backend=args.kernel_backend)
    if needs_kernels(cfg, device):
        build.build(["phantom_fused"])   # once, before the ranks load it
    out = spawn(train_and_probe_rank, args.dp, args.tp, device,
                args=(cfg, args.steps, args.target, bool(args.ledger_out)),
                timeout_s=TIMEOUT_S)
    res = out[0]
    print(f"# {cfg.name} impl={args.impl} k={cfg.phantom.k} "
          f"dp={args.dp} tp={args.tp} on {device} "
          f"(kernel_backend={args.kernel_backend}): "
          f"{ffn_model_params(cfg, args.tp):,} params")
    for i, loss in enumerate(res["losses"]):
        print(f"step {i + 1:4d} loss {loss:.6f}")
    med = statistics.median(res["step_s"]) * 1e3
    print(f"rank 0 step time median {med:.3f} ms")
    if args.target is not None:
        hit = res["losses"][-1] <= args.target
        print(f"target {args.target}: "
              f"{'reached at step ' + str(len(res['losses'])) if hit else 'not reached'}")
    if args.ledger_out:
        measured, predicted = res["probe"]
        ledger = Ledger(run="train_ffn", meta={"device": str(device)})
        entry = ledger.record(LedgerEntry(
            name=f"train_ffn_{cfg.name}_{predicted['strategy']}",
            suite="train_ffn", kind="train", arch=cfg.name,
            impl=predicted["strategy"], p=args.tp, measured=measured,
            predicted=predicted,
            extra={"dp": args.dp, "tp": args.tp, "batch": BATCH,
                   "kernel_backend": args.kernel_backend,
                   "train_steps": len(res["losses"])}))
        print("ledger ratios: " + ", ".join(
            f"{k} {v:.4f}" for k, v in entry.ratios().items()))
        print(f"wrote {ledger.write_report(args.ledger_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
