"""The sharding and energy audit CLI: the port's counterpart of the
reference's ``python -m repro.launch.audit``.

    PYTHONPATH=src python -m repro_torch.launch.audit --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.audit --source-only

Runs one step of every shipped entry point family on ranks of its mesh
(the paper-FFN train probes, the probe through the phantom kernels, the
1F1B pipeline probe, serving prefill and decode: ``analysis/units.py``),
on ``--device`` (the card unless ``cpu`` is given; a card that is not
there raises), runs the ``repro_torch.analysis`` rules over what each
step did, lints the port's source, and writes the report
(``audit-report/v1``) to ``--out`` (``build/AUDIT_report.json``; a
repo-root path raises: the repo root holds the JAX package's report).
Exit status 1 when an ERROR-severity finding survives the port's
suppression baseline (``analysis/AUDIT_baseline.json``, beside the
rules; the repo root's is the reference's): warnings and info report
but do not gate.  The reference's ``--devices`` sized XLA's virtual
devices; the ranks here are processes, so ``--device`` takes its place.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "analysis", "AUDIT_baseline.json")
DEFAULT_OUT = os.path.join(ROOT, "build", "AUDIT_report.json")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.audit",
        description="show that every collective an executed step issues "
                    "is priced")
    ap.add_argument("--all", action="store_true",
                    help="audit every shipped entry point family plus "
                         "the source lint")
    ap.add_argument("--unit", default="",
                    help="only units whose name contains this substring")
    ap.add_argument("--arch", default="qwen2.5-14b",
                    help="architecture for the serving units")
    ap.add_argument("--source-only", action="store_true",
                    help="AST lint only: no step runs (fast)")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                    help="where the units' ranks run: cuda (default) or "
                         "cpu")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression baseline (missing file = empty)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "(deliberate ratchet reset)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="report path (audit-report/v1)")
    return ap


def audit(args) -> int:
    from repro_torch.analysis import Baseline, load_baseline, run_audit
    from repro_torch.launch.serve import refuse_repo_root

    refuse_repo_root(args.out, "--out")
    units = []
    if not args.source_only:
        from repro_torch.analysis.units import (RankPools,
                                                build_default_units)
        from repro_torch.parallel.axes import resolve_device
        resolve_device(args.device)     # no card: raise before any rank
        with RankPools(args.device) as pools:
            units = build_default_units(pools, arch=args.arch,
                                        device=args.device)
        if args.unit:
            units = [u for u in units if args.unit in u.name]
    baseline = load_baseline(args.baseline)
    result = run_audit(units, baseline=baseline, source_root=ROOT)

    if args.update_baseline:
        # today's findings join the suppressions that still match, whose
        # reasons stay; stale ones go
        sup = {f.fingerprint: baseline.reason(f.fingerprint)
               for f in result.suppressed}
        sup.update({f.fingerprint: "accepted pre-existing finding"
                    for f in result.findings})
        with open(args.baseline, "w") as f:
            json.dump(Baseline(sup).as_dict(), f, indent=1)
            f.write("\n")
        print(f"# baseline: accepted {len(result.findings)} findings "
              f"into {args.baseline} ({len(sup)} in all)")
        result = run_audit(units, baseline=load_baseline(args.baseline),
                           source_root=ROOT)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result.write(args.out)
    print("\n".join(result.summary_lines()))
    print(f"# wrote {args.out}")
    return 0 if result.ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.all or args.unit or args.source_only):
        build_parser().error("pick a scope: --all, --unit, or "
                             "--source-only")
    return audit(args)


if __name__ == "__main__":
    sys.exit(main())
