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
switches the trace from greedy to seeded sampling.  ``--route auto``
writes the priced candidate table (``serve-route/v1``) to
``--route-out``.

The disaggregated fleet (``serve/fleet``): prefill and decode pools,
each planned by predicted joules per unit of its phase (from
``--route-table`` when it holds the arch, else priced fresh; one device
plans both pools as the tensor config at tp 1, since the router's
candidates are model-parallel), the KV pages migrated through a priced
transfer channel, the pools autoscaled.  Modeled (no card needed,
100,000 bursty requests by default) or executed on real engines (64 by
default; ``--dp`` x ``--tp`` above 1 spawns the pools' ranks):

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --fleet
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --device cpu --fleet --executed --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --device cpu --tp 2 --route auto --route-out build/route.json
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --tp 2 --fleet --route-table build/route.json

The route table and the fleet's ledger report go under ``build/`` by
default; the repo root holds the JAX package's records
(``SERVE_route.json``, ``BENCH_report.json``), and a path there raises.

``--trace-out PATH`` writes the run's Chrome trace (``serve/route``,
``serve/replay``, a ``serve/prefill`` span a prefill group and a
``serve/decode`` span a decode step, each rank's under its pid; the
fleet's ``fleet/*`` spans) and ``--metrics-out PATH`` its metrics
(the serving histograms and token counters, rank 0's); ``--trace``
keeps its meaning, the synthetic workload to replay.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from repro_torch.kernels.ops import KERNEL_BACKENDS
from repro_torch.launch.obs import add_obs_args, obs_session
from repro_torch.telemetry.ledger import REPORT_DIR

TIMEOUT_S = 1800.0
DEFAULT_ROUTE_OUT = str(REPORT_DIR / "serve_route.json")
DEFAULT_REPORT = str(REPORT_DIR / "fleet_report.json")


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
    ap.add_argument("--requests", type=int, default=None,
                    help="trace length (default 8; the fleet's 100000 "
                         "modeled, 64 executed)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-axis ranks (the reference defaults to --dp "
                         "2 --tp 4; the port keeps 1 x 1: its ranks share "
                         "one card through gloo, and 8 of them took 2.1 s "
                         "a decode step of chatglm3-6b at 28 layers, "
                         "PERF.md section 4)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis ranks: every arch, where tp divides "
                         "the heads its layers shard (query heads in head "
                         "mode, SSD heads; qwen2.5's ring attention keeps "
                         "every head) and --page-size (default 1: see "
                         "--dp)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight, trace and prompt seed")
    ap.add_argument("--ledger", default="",
                    help="write rank 0's serve rows to this JSONL path")
    ap.add_argument("--trace", default="",
                    choices=["", "poisson", "bursty", "closed"],
                    help="synthetic workload; empty = a closed batch of "
                         "--requests 16-token prompts")
    ap.add_argument("--rate", type=float, default=None,
                    help="trace arrival rate in requests/s (default 4.0; "
                         "the fleet sizes it to the decode pool's "
                         "modeled capacity)")
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
    ap.add_argument("--route-out", default=DEFAULT_ROUTE_OUT,
                    help="write the --route auto candidate J/token table "
                         "here as serve-route/v1 JSON ('' disables)")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=KERNEL_BACKENDS)
    ap.add_argument("--device", default=None,
                    help="default: the card ('cuda'); 'cpu' runs the "
                         "plain torch path")
    fleet = ap.add_argument_group("fleet (disaggregated serving)")
    fleet.add_argument("--fleet", action="store_true",
                       help="disaggregated prefill/decode fleet replay "
                            "with J/token autoscaling (modeled "
                            "discrete-event run by default)")
    fleet.add_argument("--executed", action="store_true",
                       help="fleet on real engines (small traces; the "
                            "kernels on the card)")
    fleet.add_argument("--colocated", action="store_true",
                       help="run the single-engine baseline through the "
                            "fleet simulator instead")
    fleet.add_argument("--prefill-replicas", type=int, default=1,
                       help="initial prefill pool size")
    fleet.add_argument("--decode-replicas", type=int, default=1,
                       help="initial decode pool size")
    fleet.add_argument("--route-table", default=DEFAULT_ROUTE_OUT,
                       help="serve-route/v1 JSON the fleet planner reads "
                            "when present (else it prices candidates "
                            "fresh)")
    fleet.add_argument("--report-out", default=DEFAULT_REPORT,
                       help="the fleet's ledger report ('' disables)")
    add_obs_args(ap)
    return ap


def refuse_repo_root(path: str, flag: str):
    """Raise for a ``path`` in the repo root, whose records
    (``SERVE_route.json``, ``BENCH_report.json``) are the JAX
    package's: the port's go under ``build/``."""
    if path and Path(path).resolve().parent == REPORT_DIR.parent:
        raise ValueError(f"{flag} {path}: the repo root holds the JAX "
                         f"package's records; the port's go under "
                         f"{REPORT_DIR}")


def make_workload(args):
    """The trace the launcher replays: a synthetic ``--trace``, or the
    closed batch of ``--requests`` equal 16-token prompts."""
    from repro_torch.serve.traffic import TraceItem, make_trace
    n = args.requests if args.requests is not None else 8
    if args.trace:
        return make_trace(args.trace, n=n,
                          rate_rps=args.rate if args.rate is not None
                          else 4.0, **_lengths(args))
    return [TraceItem(arrival_s=0.0, prompt_len=16,
                      max_new_tokens=args.new_tokens,
                      deadline_ms=args.deadline_ms, seed=args.seed)
            for _ in range(n)]


def _lengths(args) -> dict:
    """A synthetic trace's length ranges, deadline and seed."""
    return dict(prompt_len_range=(4, min(48, args.max_len - 1)),
                new_tokens_range=(4, args.new_tokens),
                deadline_ms=args.deadline_ms, seed=args.seed)


def build_kernels(device, cfgs):
    """Build every kernel library once, before any rank loads them,
    when a site of ``cfgs`` resolves to the kernels on the card."""
    from repro_torch.configs.base import PROJECTION_SITES
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import resolve_kernel_backend
    if device.type == "cuda" and any(
            resolve_kernel_backend(cfg.projection_spec(s).kernel_backend)
            == "pallas" for cfg in cfgs for s in PROJECTION_SITES):
        build.build(build.KERNELS)


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
    for flag in ("route_out", "route_table", "report_out"):
        refuse_repo_root(getattr(args, flag), "--" + flag.replace("_", "-"))
    with obs_session(args.trace_out, args.metrics_out,
                     meta={"run": "launch.serve", "arch": args.arch}):
        return _main(args)


def _main(args) -> int:
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import require_serving_mesh
    from repro_torch.parallel.axes import MeshAxes, resolve_device
    from repro_torch.planner import load_calibration
    from repro_torch.serve.router import (ServeConfig, candidate_configs,
                                          route)

    calib = load_calibration(plan_report_path=args.calibration or None)
    if args.fleet:
        return fleet_main(args, calib)
    device = resolve_device(args.device)
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
        if args.route_out:
            from repro_torch.serve.fleet import write_route_table
            from repro_torch.serve.router import trace_stats
            Path(args.route_out).parent.mkdir(parents=True, exist_ok=True)
            write_route_table(args.route_out, args.arch, winner, priced,
                              calibration=calib.source,
                              stats=trace_stats(trace, args.page_size),
                              slo_ms=args.slo)
            print(f"# route table ({len(priced)} candidates) -> "
                  f"{args.route_out}")
    else:
        sc = ServeConfig(args.arch, "tensor", args.dp, args.tp, args.slots,
                         max_len=args.max_len, page_size=args.page_size,
                         smoke=args.smoke,
                         kernel_backend=args.kernel_backend)
    cfg = sc.model_config()
    require_serving_mesh(cfg, MeshAxes(tp=sc.tp, dp=sc.dp), "serving")
    build_kernels(device, [cfg])
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


def fleet_rank(axes, device, fc, trace, calib, args):
    """One rank's executed fleet replay (every rank runs the same
    discrete-event loop); rank 0 keeps the ledger.  Returns the report,
    with the greedy streams."""
    from repro_torch.serve.fleet import FleetRouter
    from repro_torch.telemetry import Ledger
    ledger = None
    if axes.rank == 0:
        ledger = Ledger(run="launch.serve.fleet",
                        jsonl_path=args.ledger or None,
                        meta={"arch": args.arch, "trace": args.trace
                              or "bursty", "requests": len(trace)},
                        report_path=args.report_out or None)
    router = FleetRouter(fc, calib=calib, ledger=ledger, seed=args.seed,
                         axes=axes, device=device)
    report = router.run(trace, sampling=parse_sampling(args.sample))
    if ledger is not None:
        report["ledger_rows"] = len(ledger)
        ledger.close()
    return report


def fleet_main(args, calib) -> int:
    """Disaggregated fleet replay: plan the pools, size the trace, run
    it modeled here or executed on the pools' mesh (spawned ranks above
    one device), print the report."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.axes import MeshAxes, resolve_device
    from repro_torch.serve.fleet import (FleetConfig, auto_rate_rps,
                                         baseline_config, load_route_table,
                                         plan_pools)
    from repro_torch.serve.fleet.router import executed_mesh
    from repro_torch.serve.router import ServeConfig
    from repro_torch.serve.traffic import make_trace

    n = args.requests if args.requests is not None else \
        (64 if args.executed else 100_000)
    kind = args.trace or "bursty"
    devices = args.dp * args.tp
    kw = dict(slots=args.slots, max_len=args.max_len,
              page_size=args.page_size)
    cands = dict(smoke=args.smoke, kernel_backend=args.kernel_backend)
    if args.colocated:
        pre_sc = dec_sc = baseline_config(args.arch, devices, **kw,
                                          **cands)
        print(f"# baseline (colocated single engine): {dec_sc.name}")
    elif devices == 1:
        pre_sc = dec_sc = ServeConfig(args.arch, "tensor", 1, 1, **kw,
                                      **cands)
        print(f"# one device: both pools serve {dec_sc.name} (the "
              f"router's candidates are model-parallel, tp >= 2)")
    else:
        # probe trace: the pool planner needs length statistics only
        probe = make_trace(kind, n=min(n, 2000), rate_rps=10.0,
                           **_lengths(args))
        table = None
        if args.route_table:
            try:
                table = load_route_table(args.route_table)
            except ValueError as exc:
                print(f"# ignoring route table: {exc}")
        pre_sc, dec_sc, notes = plan_pools(
            args.arch, devices, calib, probe, slo_ms=args.slo,
            route_table=table, **kw, **cands)
        print(f"# pool plan ({notes['source']}, "
              f"calibration: {calib.source}):")
        print(f"#   prefill -> {pre_sc.name} "
              f"({notes['prefill']['j_per_prompt']:.3e} J/prompt)")
        print(f"#   decode  -> {dec_sc.name} "
              f"({notes['decode']['j_per_token']:.3e} J/token)")

    rate = args.rate if args.rate is not None else \
        auto_rate_rps(dec_sc, calib, (4 + args.new_tokens) / 2,
                      replicas=args.decode_replicas)
    trace = make_trace(kind, n=n, rate_rps=rate, **_lengths(args))
    print(f"# trace: {kind} n={n} rate={rate:.2f} rps "
          f"slo={args.slo:.0f}ms "
          f"mode={'executed' if args.executed else 'modeled'}")
    fc = FleetConfig(prefill=pre_sc, decode=dec_sc, slo_ms=args.slo,
                     executed=args.executed, colocated=args.colocated,
                     prefill_replicas=args.prefill_replicas,
                     decode_replicas=args.decode_replicas)
    if not args.executed:
        report = fleet_rank(MeshAxes(), None, fc, trace, calib, args)
    else:
        dp, tp = executed_mesh(fc)
        device = resolve_device(args.device)
        build_kernels(device, [pre_sc.model_config(),
                               dec_sc.model_config()])
        if dp * tp == 1:
            report = fleet_rank(MeshAxes(), device, fc, trace, calib, args)
        else:
            report = spawn(fleet_rank, dp, tp, device,
                           args=(fc, trace, calib, args),
                           timeout_s=TIMEOUT_S)[0]

    print_slo(report["slo"])
    pools = report["pools"]
    print(f"scale events: {report['scale_ups']} up / "
          f"{report['scale_downs']} down "
          f"(decode peak {pools['decode']['replicas_peak']} replicas)")
    for ev in report["scale_events"]:
        print(f"  t={ev['t_s']:8.2f}s {ev['pool']:7s} {ev['action']:4s} "
              f"-> {ev['replicas']} ({ev['reason']})")
    jt = report["j_per_token"]
    print(f"joules/token: prefill={jt['prefill']:.3e} "
          f"decode={jt['decode']:.3e} transfer={jt['transfer']:.3e}")
    print(f"joules/token [fleet]: {jt['fleet']:.3e}")
    xfer = report["transfer"]
    print(f"kv transfer: {xfer['measured']['migrations']:.0f} "
          f"migrations, "
          f"{xfer['measured']['transfer_wire_bytes']:.3e} bytes, "
          f"measured/predicted wire ratio = "
          f"{xfer['ratio_wire_bytes']:.4f}")
    if args.report_out:
        print(f"# wrote {report['ledger_rows']} ledger rows -> "
              f"{args.report_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
