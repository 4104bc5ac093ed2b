"""Serving launcher of the port: the energy-aware serving runtime over a
dp x tp mesh (the reference's ``python -m repro.launch.serve``).

Fixed config, closed batch of equal prompts (the classic smoke run):

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --requests 8                        # on the card, full size, tp 1
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --device cpu --dp 2 --tp 4 --trace poisson    # 8 gloo ranks

Routed: price tensor/phantom x mesh x slots candidates in predicted
joules per token, pick the cheapest meeting the SLO, replay a synthetic
trace through it and print the measured TTFT/TPOT/e2e percentiles and
the measured/predicted energy per phase:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --device cpu --dp 2 --tp 4 --trace poisson --route auto --slo 200ms

Every family serves on any ``--dp`` x ``--tp`` mesh whose model axis
divides the heads its layers shard (``--arch olmoe-1b-7b``,
``mamba2-370m``, ``jamba-1.5-large-398b``, ``qwen2.5-14b`` (ring
attention), ``qwen2-vl-72b``, ``seamless-m4t-large-v2``):

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --device cpu --arch mamba2-370m --tp 4      # 4 gloo ranks

The engine adds the stubbed frontends' inputs to every prefill, as the
reference's does.  The SSM, hybrid and encoder-decoder families prefill
exact-length groups: a prompt's length must be a multiple of
``--page-size`` (the default closed batch's 16 tokens are).

Weights are random, drawn from ``--seed`` (which also seeds the trace
and the prompts).  ``--route fixed`` serves ``tensor`` sites on the
``--dp`` x ``--tp`` mesh, as the reference's fixed route does;
``--dp`` x ``--tp`` (or the routed winner's mesh) above 1 spawns that
many ranks (``launch/mesh.py: spawn``), rank 0 printing.  The router
prices with ``--calibration`` (a ``PLAN_report.json`` with fitted
constants) or, without one, the paper's defaults: never the
repo-root records, which are the reference's.  ``--ledger PATH``
writes rank 0's serve rows as JSONL; ``--sample "t=0.8,k=40,p=0.95"``
switches the trace from greedy to seeded sampling.  ``--fleet`` and
``--route-out`` (whose only reader is the fleet planner) are ROADMAP.md
queue 1, item 7.
"""
from __future__ import annotations

import argparse
import re
import sys

from repro_torch.kernels.ops import KERNEL_BACKENDS

FLEET_TODO = ("ROADMAP.md queue 1, item 7 (the disaggregated fleet and "
              "its route table)")
TIMEOUT_S = 1800.0


def parse_slo_ms(text):
    """'200ms' | '0.2s' | '200' (ms) -> float ms; None/'' -> 0."""
    if not text:
        return 0.0
    m = re.fullmatch(r"\s*([\d.]+)\s*(ms|s)?\s*", str(text))
    if not m:
        raise argparse.ArgumentTypeError(f"bad SLO {text!r} "
                                         "(want e.g. 200ms or 0.2s)")
    val = float(m.group(1))
    return val * 1e3 if m.group(2) == "s" else val


def parse_sampling(text):
    """'t=0.8,k=40,p=0.95' -> SamplingParams; ''/None -> greedy."""
    from repro_torch.serve.sampling import SamplingParams
    if not text:
        return None
    kw = {}
    keys = {"t": "temperature", "temperature": "temperature",
            "k": "top_k", "top_k": "top_k",
            "p": "top_p", "top_p": "top_p", "seed": "seed"}
    for part in str(text).split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        k = k.strip().lower()
        if k not in keys:
            raise argparse.ArgumentTypeError(
                f"bad --sample key {k!r} (known: t/k/p/seed)")
        name = keys[k]
        kw[name] = int(v) if name in ("top_k", "seed") else float(v)
    kw.setdefault("temperature", 0.8)
    return SamplingParams(**kw)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="continuous-batching serving with paged KV cache, "
                    "traffic/SLO harness and joules-per-token routing")
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=8,
                    help="trace length")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis ranks: every arch, where tp divides "
                         "the heads its layers shard (query heads in head "
                         "mode, SSD heads; qwen2.5's ring attention keeps "
                         "every head) and --page-size")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight, trace and prompt seed")
    ap.add_argument("--ledger", default="",
                    help="write rank 0's serve rows to this JSONL path")
    ap.add_argument("--trace", default="",
                    choices=["", "poisson", "bursty", "closed"],
                    help="synthetic workload; empty = a closed batch of "
                         "--requests 16-token prompts")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="trace arrival rate in requests/s")
    ap.add_argument("--slo", type=parse_slo_ms, default=0.0,
                    help="TTFT/TPOT SLO, e.g. 200ms")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request e2e deadline for goodput")
    ap.add_argument("--sample", default="",
                    help="sampling params, e.g. 't=0.8,k=40,p=0.95' "
                         "(default greedy)")
    ap.add_argument("--route", default="fixed", choices=["fixed", "auto"],
                    help="auto: price candidates in predicted J/token "
                         "and serve the cheapest meeting --slo")
    ap.add_argument("--order", default="fcfs", choices=["fcfs", "edf"])
    ap.add_argument("--calibration", default="",
                    help="PLAN_report.json with fitted constants "
                         "(default: the paper's constants)")
    ap.add_argument("--route-out", default="",
                    help=f"the route table's path: {FLEET_TODO}")
    ap.add_argument("--fleet", action="store_true",
                    help=f"disaggregated fleet replay: {FLEET_TODO}")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=KERNEL_BACKENDS)
    ap.add_argument("--device", default=None,
                    help="default: the card ('cuda'); 'cpu' runs the "
                         "plain torch path")
    return ap


def make_workload(args):
    """The trace the launcher replays: a synthetic ``--trace``, or the
    closed batch of ``--requests`` equal 16-token prompts."""
    from repro_torch.serve.traffic import TraceItem, make_trace
    if args.trace:
        return make_trace(args.trace, n=args.requests, rate_rps=args.rate,
                          prompt_len_range=(4, min(48, args.max_len - 1)),
                          new_tokens_range=(4, args.new_tokens),
                          deadline_ms=args.deadline_ms, seed=args.seed)
    return [TraceItem(arrival_s=0.0, prompt_len=16,
                      max_new_tokens=args.new_tokens,
                      deadline_ms=args.deadline_ms, seed=args.seed)
            for _ in range(args.requests)]


def serve_rank(axes, device, sc, trace, calib, args):
    """One rank's ``run_config``; rank 0 keeps the ledger."""
    from repro_torch.serve.router import run_config
    from repro_torch.telemetry import Ledger
    ledger = None
    if args.ledger and axes.rank == 0:
        ledger = Ledger(run="launch.serve", jsonl_path=args.ledger)
    out = run_config(sc, trace, axes, device=device, ledger=ledger,
                     calib=calib, seed=args.seed, slo_ms=args.slo,
                     sampling=parse_sampling(args.sample), order=args.order)
    if ledger is not None:
        out["ledger_rows"] = len(ledger)
        ledger.close()
    return out


def print_slo(report):
    for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
        pc = report.get(key) or {}
        if pc:
            print(f"{key:8s} p50={pc['p50']:9.3f}  p95={pc['p95']:9.3f}  "
                  f"p99={pc['p99']:9.3f}  (ms)")
    print(f"requests={report.get('requests', 0)} "
          f"tokens={report.get('generated_tokens', 0)} "
          f"tokens/s={report.get('tokens_per_s', 0.0):.1f} "
          f"slo_met={report.get('slo_met_fraction', 0.0):.0%} "
          f"goodput_tokens={report.get('goodput_tokens', 0)}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fleet or args.route_out:
        raise NotImplementedError(
            f"{'--fleet' if args.fleet else '--route-out'}: see "
            f"{FLEET_TODO}")
    from repro_torch.configs.base import PROJECTION_SITES, get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import resolve_kernel_backend
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import require_serving_mesh
    from repro_torch.parallel.axes import MeshAxes, resolve_device
    from repro_torch.planner import load_calibration
    from repro_torch.serve.router import (ServeConfig, candidate_configs,
                                          route)

    device = resolve_device(args.device)
    calib = load_calibration(plan_report_path=args.calibration or None)
    trace = make_workload(args)
    if args.route == "auto":
        cands = candidate_configs(args.arch, args.dp * args.tp,
                                  slots_options=(args.slots,),
                                  max_len=args.max_len,
                                  page_size=args.page_size,
                                  smoke=args.smoke,
                                  kernel_backend=args.kernel_backend)
        winner, priced = route(cands, calib, trace, slo_ms=args.slo)
        print(f"# calibration: {calib.source}")
        print("# candidates (predicted, modelled accelerator):")
        for pc in priced:
            flag = "*" if pc is winner else " "
            print(f"# {flag} {pc.config.name:<44s} "
                  f"J/tok={pc.j_per_token:.3e} "
                  f"ttft={pc.ttft_s * 1e3:.3f}ms "
                  f"tpot={pc.tpot_s * 1e3:.3f}ms slo_ok={pc.meets_slo}")
        sc = winner.config
        print(f"# routed -> {sc.name} "
              f"(predicted {winner.j_per_token:.3e} J/token)")
    else:
        sc = ServeConfig(args.arch, "tensor", args.dp, args.tp, args.slots,
                         max_len=args.max_len, page_size=args.page_size,
                         smoke=args.smoke,
                         kernel_backend=args.kernel_backend)
    cfg = sc.model_config()
    require_serving_mesh(cfg, MeshAxes(tp=sc.tp, dp=sc.dp), "serving")
    if device.type == "cuda" and any(
            resolve_kernel_backend(cfg.projection_spec(s).kernel_backend)
            == "pallas" for s in PROJECTION_SITES):
        build.build(build.KERNELS)   # once, before any rank loads them
    if sc.devices == 1:
        result = serve_rank(MeshAxes(), device, sc, trace, calib, args)
    else:
        result = spawn(serve_rank, sc.dp, sc.tp, device,
                       args=(sc, trace, calib, args),
                       timeout_s=TIMEOUT_S)[0]
    print(f"# served {get_config(sc.arch, smoke=sc.smoke).name} on {device} "
          f"as {sc.name} (mesh {sc.dp}x{sc.tp}, "
          f"kernel_backend={sc.kernel_backend})")
    print_slo(result["slo"])
    print(f"joules/token (measured account): "
          f"{result['j_per_token_measured']:.3e}")
    for kind in ("prefill", "decode"):
        if kind in result["energy_ratio"]:
            print(f"energy measured/predicted [{kind}]: "
                  f"{result['energy_ratio'][kind]:.3f}")
    pages = result["pages"]
    print(f"pages: high_water={pages['high_water_pages']}"
          f"/{pages['total_pages']} allocs={pages['page_allocs']} "
          f"frees={pages['page_frees']} "
          f"fragmentation={pages['fragmentation']:.2f}")
    agree = result["telemetry"]["agreement"]
    if any(v["calls"] for v in agree.values()):
        print("agreement (rank 0, host): " + " ".join(
            f"{k}={v['calls']} calls {v['ms']:.1f} ms {v['bytes']} B"
            for k, v in agree.items()))
    if args.ledger:
        print(f"# wrote {result['ledger_rows']} ledger rows to "
              f"{args.ledger}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
