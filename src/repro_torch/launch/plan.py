"""Energy-aware configuration planner CLI: the port's counterpart of the
reference's ``python -m repro.launch.plan``.

    PYTHONPATH=src python -m repro_torch.launch.plan --devices 8 \\
        --target-loss 0.2                       # pilots on the card
    PYTHONPATH=src python -m repro_torch.launch.plan --device cpu \\
        --width 512 --ks 4,8 --pilot-steps 80 --target-loss 0.25

Calibrates the analytic energy model (the paper's defaults, or a fit
from ``--ledger``, a ledger JSONL the port wrote), enumerates mesh x
strategy x ghost-width candidates up to ``--devices``, filters them for
HBM fit (``--hbm-gb``, an H100's 80 GB by default) and throughput, runs
small pilot training runs on ``--pilot-tp`` ranks of ``--device`` (the
card unless ``cpu`` is given) to normalize every plan to the target
loss (``--no-pilots`` skips them and prices plans at the calibrated ν
scales instead), and writes the plan report (``plan-report/v1``) with
the Pareto frontier, the matched-loss phantom-vs-TP comparison and the
winning plan to ``--out`` (``build/PLAN_report.json``; a repo-root path
raises: the repo root holds the JAX package's report).
``--compiled-hbm-check`` runs one train step of each frontier plan on
its ranks and drops a plan whose measured peak card memory exceeds the
budget (``planner/constraints.py: measured_hbm_bytes``; on the CPU it
measures nothing and keeps every plan).  The frontier is audited
(``analysis/engine.py: audit_plans``: one probe step of each plan on
ranks of its mesh, on ``--device``, its collectives held to its priced
account): a plan with an active error is dropped and the frontier
recomputed, the report carries an ``audit`` block, and ``--no-audit``
skips it.  ``python -m repro_torch.launch.train --plan PATH`` applies
the winner, and ``python -m repro_torch.launch.serve --calibration
PATH`` prices its routes with the report's calibration.
``--trace-out`` / ``--metrics-out`` write the pass's trace (the
``plan/calibrate``, ``plan/enumerate``, ``plan/score`` or ``plan/pilots``
spans, each pilot's ``plan/pilot`` span from every rank) and metrics
(``plan_pilot_steps_total``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.obs import add_obs_args, obs_session
from repro_torch.obs import get_tracer
from repro_torch.planner.constraints import DEFAULT_HBM_BYTES
from repro_torch.planner.report import DEFAULT_REPORT

DEFAULT_OUT = str(DEFAULT_REPORT)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.plan",
        description="calibrated search over mesh x strategy x ghost "
                    "width with an iso-loss frontier")
    ap.add_argument("--devices", type=int, default=8,
                    help="device budget (the FULL mesh TP plans use)")
    ap.add_argument("--target-loss", type=float, default=0.2,
                    help="the fixed loss every plan is normalized to")
    ap.add_argument("--width", type=int, default=1024,
                    help="base FFN width n")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ks", default="4,8,16",
                    help="comma-separated ghost widths to search")
    ap.add_argument("--strategies", default="tensor_col,phantom")
    ap.add_argument("--microbatches", default="1",
                    help="comma-separated gradient-accumulation options")
    ap.add_argument("--pps", default="1,2",
                    help="comma-separated pipeline-stage counts to "
                         "search (1 = no pipeline axis)")
    ap.add_argument("--hbm-gb", type=float,
                    default=DEFAULT_HBM_BYTES / 1e9,
                    help="per-device HBM budget in GB of 1e9 bytes "
                         "(default: an H100's 80)")
    ap.add_argument("--min-throughput", type=float, default=0.0,
                    help="global rows/s floor (0 = unconstrained)")
    ap.add_argument("--ledger", default=None,
                    help="a ledger JSONL the port wrote, to calibrate "
                         "from (default: the paper's constants)")
    ap.add_argument("--no-pilots", action="store_true",
                    help="skip pilot runs; price plans at the "
                         "calibrated nu scales")
    ap.add_argument("--pilot-steps", type=int, default=300,
                    help="pilot iteration budget (also the censored nu)")
    ap.add_argument("--pilot-tp", type=int, default=4,
                    help="model-axis size the pilots train at")
    ap.add_argument("--compiled-hbm-check", action="store_true",
                    help="verify the frontier's HBM fit against the peak "
                         "card memory of one train step of each plan")
    ap.add_argument("--no-audit", dest="audit", action="store_false",
                    help="skip the audit of the frontier plans")
    ap.add_argument("--device", default=None,
                    help="where the pilots, the HBM check and the audit "
                         "run: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    add_obs_args(ap)
    return ap


def _csv_ints(s):
    return tuple(int(x) for x in s.split(",") if x)


def pilots(args, ledger=None, pool=None):
    """The pilot phase at ``args``' settings (``planner/isoloss.py:
    run_pilots``), in a ``plan/pilots`` span; ``ledger`` optionally
    receives the pilot rows; ``pool``, a ``RankPool`` of ``--pilot-tp``
    ranks, runs them (else they start their own)."""
    from repro_torch.planner import run_pilots
    strategies = tuple(s for s in args.strategies.split(",") if s)
    with get_tracer().span("plan/pilots", cat="plan",
                           strategies=list(strategies)):
        return run_pilots(strategies, min(args.pilot_tp, args.devices),
                          width=args.width, depth=args.depth,
                          batch=args.batch, steps=args.pilot_steps,
                          target_loss=args.target_loss,
                          ks=_csv_ints(args.ks), seed=args.seed,
                          ledger=ledger, device=args.device, pool=pool)


def plan(args, ledger=None, calib_rows=None, iso=None, pools=None) -> dict:
    """Run the full planning pass; returns the report dict (also
    written to ``args.out``).  ``ledger`` optionally receives the pilot
    and frontier rows; ``calib_rows`` calibrates from already-loaded
    ledger rows instead of the ``--ledger`` file; ``iso``, the
    ``IsoLossResult`` of ``pilots(args)`` when the caller ran them,
    takes the place of the pilot phase; ``pools``, the caller's
    ``analysis/units.py: RankPools`` (left open), runs the audit of the
    frontier plans (else the pass's own, one world per size, closed when
    the audit ends)."""
    import os

    from repro_torch.launch.serve import refuse_repo_root
    from repro_torch.planner import (Constraints, apply_iso_loss,
                                     apply_throughput_floor, build_report,
                                     calibrate_from_ledger,
                                     calibrate_from_rows, enumerate_plans,
                                     filter_feasible,
                                     matched_loss_comparison,
                                     measured_hbm_bytes, pareto_frontier,
                                     plan_summary_lines, record_frontier,
                                     score_plans, write_plan_report)

    refuse_repo_root(args.out, "--out")
    tracer = get_tracer()
    strategies = tuple(s for s in args.strategies.split(",") if s)
    ks = _csv_ints(args.ks)
    mbs = _csv_ints(args.microbatches)

    # 1. calibrate
    with tracer.span("plan/calibrate", cat="plan") as sp:
        if calib_rows is not None:
            calib = calibrate_from_rows(calib_rows)
            print(f"# calibration: {calib.source} (in-process ledger "
                  f"rows)")
        else:
            if args.ledger and not os.path.exists(args.ledger):
                raise FileNotFoundError(
                    f"--ledger {args.ledger}: no such file")
            calib = calibrate_from_ledger(jsonl_path=args.ledger)
            print(f"# calibration: {calib.source}"
                  + (f" ({args.ledger})" if args.ledger else ""))
        sp.annotate(source=calib.source)

    # 2. enumerate + resource-filter
    constraints = Constraints(
        max_devices=args.devices,
        hbm_bytes_per_device=args.hbm_gb * 1e9,
        min_throughput_rows_s=args.min_throughput)
    with tracer.span("plan/enumerate", cat="plan",
                     devices=args.devices) as sp:
        candidates = enumerate_plans(
            args.devices, width=args.width, depth=args.depth,
            batch=args.batch, strategies=strategies, ks=ks,
            microbatch_options=mbs, pps=_csv_ints(args.pps) or (1,))
        feasible, rejected = filter_feasible(candidates, constraints)
        sp.annotate(candidates=len(candidates), feasible=len(feasible))
    print(f"# {len(candidates)} candidates, {len(feasible)} feasible, "
          f"{len(rejected)} rejected")

    # 3. pilots -> iso-loss normalization
    if args.no_pilots:
        iso = None
        with tracer.span("plan/score", cat="plan"):
            scored = score_plans(feasible, calib,
                                 iterations=float(args.pilot_steps))
        for s in scored:
            s.predicted_loss = args.target_loss
            s.notes["iso_loss"] = False
    else:
        if iso is None:
            iso = pilots(args, ledger)
        for key, nu in sorted(iso.nu.items()):
            fl = iso.final_loss.get(key)
            print(f"# pilot {key}: nu={nu} final_loss="
                  f"{fl:.4f}" if fl is not None else f"# pilot {key}")
        for kind, curve in iso.curves.items():
            print(f"# pilot curve {kind}: loss(k) = "
                  f"exp({curve.a:.3f}) * k^{curve.b:.3f}")
        scored = apply_iso_loss(feasible, iso, calib)

    # 4. throughput floor + frontier + verdict (the verdict quantifies
    # over the SURVIVORS: a plan the floor rejected must not win it).
    # The frontier (and hence the winner) is drawn from the MATCHED
    # pool: a censored plan that never reached the target has a cheap
    # ν·e product but does not deliver the target loss.
    scored_kept, thr_rejected = apply_throughput_floor(
        scored, args.min_throughput)

    def make_frontier(pool_):
        m = [s for s in pool_ if s.notes.get("reached_target", True)]
        return pareto_frontier(m if m else pool_)

    frontier = make_frontier(scored_kept)

    # ground-truth the frontier's HBM fit with one measured train step
    # of each plan; an over-budget plan is dropped and the frontier
    # recomputed, so newly exposed plans get checked too
    if args.compiled_hbm_check:
        checked = set()
        while True:
            over = []
            for s in frontier:
                if id(s) in checked:
                    continue
                checked.add(id(s))
                got = measured_hbm_bytes(s.plan, args.device)
                s.notes["measured_hbm_bytes"] = got
                if got is not None and \
                        got > constraints.hbm_bytes_per_device:
                    over.append(s)
            if not over:
                break
            for s in over:
                thr_rejected.append(
                    (s, f"measured HBM "
                        f"{s.notes['measured_hbm_bytes'] / 1e9:.2f} GB > "
                        f"{args.hbm_gb:.2f} GB budget"))
                scored_kept.remove(s)
            frontier = make_frontier(scored_kept)

    # the audit of the frontier: one probe step of each plan, its
    # collectives held to its priced account; a rejected plan is dropped
    # and the frontier recomputed, so that newly exposed plans are
    # audited too
    audit_results = {}
    if args.audit:
        from repro_torch.analysis import audit_plans
        from repro_torch.analysis.units import caller_or_own
        with caller_or_own(pools, args.device) as pools:
            while True:
                todo = [s for s in frontier
                        if s.plan.name not in audit_results]
                if todo:
                    audit_results.update(audit_plans(
                        [s.plan for s in todo], pools=pools,
                        device=args.device))
                bad = [s for s in frontier
                       if not audit_results[s.plan.name]["ok"]]
                if not bad:
                    break
                for s in bad:
                    errs = audit_results[s.plan.name]["errors"]
                    thr_rejected.append(
                        (s, f"static audit: {len(errs)} error(s), first: "
                            f"{errs[0] if errs else 'did not run'}"))
                    scored_kept.remove(s)
                frontier = make_frontier(scored_kept)
        n_bad = sum(1 for r in audit_results.values() if not r["ok"])
        print(f"# audit: {len(audit_results)} frontier plans checked, "
              f"{n_bad} rejected")

    comparison = matched_loss_comparison(scored_kept, args.devices)
    if iso is not None and not comparison.get("matched_plans"):
        reachable = min(iso.final_loss.values(), default=float("nan"))
        print(f"# WARNING: no pilot reached --target-loss "
              f"{args.target_loss} within {args.pilot_steps} steps "
              f"(best final loss {reachable:.4f}); the matched-loss "
              f"comparison is empty: raise the target or "
              f"--pilot-steps", file=sys.stderr)

    report = build_report(
        calibration=calib, constraints=constraints, scored=scored_kept,
        frontier=frontier, rejected=rejected,
        throughput_rejected=thr_rejected, iso=iso, comparison=comparison,
        meta={"argv": vars(args), "target_loss": args.target_loss,
              "devices": args.devices})
    if audit_results:
        report["audit"] = audit_results
    if ledger is not None:
        record_frontier(ledger, frontier, calib)
    write_plan_report(report, args.out)
    print("\n".join(plan_summary_lines(report)))
    print(f"# wrote {args.out} ({len(frontier)} frontier plans)")
    return report


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with obs_session(args.trace_out, args.metrics_out,
                     meta={"run": "launch.plan"}):
        report = plan(args)
    return 0 if report["frontier"] else 1


if __name__ == "__main__":
    sys.exit(main())
