"""The port's audit units (``repro_torch.analysis.units``) against the
reference's, and the gates that use them.

``build_default_units(pools, device="cpu")`` runs one step of each of
the nine entry points of the reference's ``audit --all`` on gloo CPU
ranks (8 for
the FFN, kernel and pipeline units, 4 for serving: one world of each
size for the module, which the gates' tests reuse); the reference's units are lowered on the conftest's 8 virtual
devices, as ``tests/test_audit_units.py`` lowers them.  Held:

* the nine names, in the reference's order;
* every FFN, kernel and serving unit's predicted buckets equal the
  reference unit's ``predicted_buckets()`` exactly; the pipeline unit's
  equal the reference's account of idle bubbles (``executed=False``, the
  port's 1F1B), its permutes at the per-rank mean, and differ from the
  reference unit's (its SPMD wavefront's ticks) by exactly that;
* the FFN probes' measured buckets equal the reference's lowered ones
  where XLA issues one collective per logical one (tp 8);
* the port's measured buckets reconcile: 0 errors, 0 warnings, as the
  reference's; the info findings that differ are listed below with why;
* the kernel unit's recorded plans fit an H100 block and launched no
  kernel on the CPU (the plain versions ran);
* ``audit_plans`` passes a good candidate (as the reference's does),
  rejects one whose parameters do not split over its mesh, and raises
  where a step fails on its ranks; the CLI over these units exits 0.
"""
import json

import pytest
import torch

from repro.analysis import build_default_units as jax_default_units
from repro.analysis import run_audit as jax_run_audit
from repro_torch.analysis import (audit_plans, build_default_units,
                                  run_audit)
from repro_torch.analysis.units import RankPools

# the info findings of one side only, each a count or byte difference
# under the small-message floor:
REFERENCE_ONLY_INFO = {
    # XLA lowers the dp gradient psums of W and b as fewer all-reduces
    "collective-accounting:ffn_train/audit-ffn-phantom/dp2tp4:"
    "all_reduce@g2:count",
    # XLA relowers the decode head gathers: its bytes, the port's counts
    "collective-accounting:serve_decode/qwen2.5-14b-phantom-mesh1x4-slots4:"
    "all_gather@g4:bytes",
    "collective-accounting:serve_decode/qwen2.5-14b-tensor-mesh1x4-slots4:"
    "all_gather@g4:bytes",
    "collective-accounting:serve_prefill/qwen2.5-14b-phantom-mesh1x4-slots4:"
    "reduce_scatter@g4:count",
}
PORT_ONLY_INFO = {
    # the port's pipeline all-reduces each leaf's gradient over dp after
    # the schedule (the account prices one)
    "collective-accounting:pipeline/audit-ffn-pipe/pp2dp2tp2:"
    "all_reduce@g2:count",
    "collective-accounting:serve_decode/qwen2.5-14b-phantom-mesh1x4-slots4:"
    "all_gather@g4:count",
    "collective-accounting:serve_decode/qwen2.5-14b-tensor-mesh1x4-slots4:"
    "all_gather@g4:count",
    # the port's phantom prefill issues one reduce-scatter of bf16 rows
    "collective-accounting:serve_prefill/qwen2.5-14b-phantom-mesh1x4-slots4:"
    "reduce_scatter@g4:bytes",
}


@pytest.fixture(scope="module")
def pools():
    """The module's worlds, one of each size (8 and 4 for the units, 2
    for the gates; the re-plan's run reuses 4 and 2), each started once:
    their ranks import torch while the reference lowers its units."""
    with RankPools("cpu") as worlds:
        for size in (8, 4, 2):
            worlds.get(size)
        yield worlds


@pytest.fixture(scope="module")
def units(pools, reference):
    return build_default_units(pools, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return jax_default_units()


def test_default_units_carry_the_reference_names(units, reference):
    assert [u.name for u in units] == [u.name for u in reference]
    assert len(units) == 9
    assert [u.kind for u in units] == [u.kind for u in reference]
    for u, r in zip(units, reference):
        assert (u.axes, u.strict, u.wire_rtol, u.small_m_floats,
                u.compute_dtype) == (r.axes, r.strict, r.wire_rtol,
                                     r.small_m_floats, r.compute_dtype)


@pytest.mark.parametrize("i", [0, 1, 2, 3, 5, 6, 7, 8])
def test_predicted_buckets_equal_the_references(units, reference, i):
    assert units[i].predicted_buckets() == reference[i].predicted_buckets()
    assert units[i].predicted_buckets()


def test_pipeline_predicts_the_ports_1f1b(units, reference):
    """The reference's wavefront runs every tick (M + S - 1 = 5) and
    permutes at all but the last, both ways (8); the port's 1F1B runs M
    = 4 microbatches a layer, and its stages send 2M (S - 1) / S = 4 a
    rank on the mean: the same account with ``executed=False``."""
    from repro.telemetry.predict import pipeline_ffn_step_events
    got, ref = units[4], reference[4]
    assert got.name == "pipeline/audit-ffn-pipe/pp2dp2tp2"
    cfg = ref.static_args["cfg"]
    acct = pipeline_ffn_step_events(cfg, 2, 2, 2, 64, executed=False)
    want = {}
    for ev, g, n in acct["events"]:
        n = n / 2 if ev.collective == "collective_permute" else n
        b = want.setdefault((ev.collective, g),
                            {"count": 0.0, "m_floats": 0.0})
        b["count"] += n
        b["m_floats"] += ev.m_floats * n
    want[("all_reduce", 8)] = {"count": 1.0, "m_floats": 1.0}
    assert got.predicted_buckets() == want
    theirs = ref.predicted_buckets()
    for key in (("all_gather", 2), ("reduce_scatter", 2)):
        assert {k: v * 5 / 4 for k, v in want[key].items()} == theirs[key]
    assert {k: v * 2 for k, v in want[("collective_permute", 2)].items()} \
        == theirs[("collective_permute", 2)]
    for key in (("all_reduce", 2), ("all_reduce", 8)):
        assert want[key] == theirs[key]
    # the logs: each rank's sends by stage, the mean the predicted one
    assert got.measured_buckets()[("collective_permute", 2)] == \
        want[("collective_permute", 2)]
    assert [sum(e.collective == "collective_permute" for e in log)
            for log in got.logs] == [4] * 8


@pytest.mark.parametrize("i", [0, 1, 3])
def test_measured_ffn_buckets_equal_the_references(units, reference, i):
    """At tp 8 XLA issues one collective for each logical one: the
    port's logs and the reference's lowered HLO bucket alike."""
    assert units[i].measured_buckets() == reference[i].measured_buckets()


def test_audit_reconciles_and_matches_the_references_findings(units,
                                                              reference):
    res, ref = run_audit(units), jax_run_audit(reference)
    assert res.ok and res.counts["error"] == res.counts["warning"] == 0, \
        "\n".join(res.summary_lines())
    gated = {(f.severity, f.fingerprint) for f in res.findings
             if f.severity != "info"}
    assert gated == {(f.severity, f.fingerprint) for f in ref.findings
                     if f.severity != "info"} == set()
    mine = {f.fingerprint for f in res.findings if f.severity == "info"}
    theirs = {f.fingerprint for f in ref.findings if f.severity == "info"}
    assert theirs - mine == REFERENCE_ONLY_INFO
    assert mine - theirs == PORT_ONLY_INFO
    # every unit ran its step and logged collectives the account prices
    for u in units:
        assert u.logs and all(u.logs), u.name
        assert u.measured_buckets() and u.predicted_buckets(), u.name
        assert u.costs.flops > 0 and u.upcasts is not None, u.name


def test_probe_units_record_their_bytes(units):
    """A probe unit's ``argument_bytes`` are its rank's parameter shards
    and its rows of x and y, exactly; ``step_bytes`` what the step
    allocated (on the CPU, the live bytes the dispatch mode tracked)."""
    import numpy as np
    from repro_torch.core.ffn import ffn_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    for u in units[:4]:
        cfg, dp, tp = u.static_args["cfg"], u.axes["dp"], u.axes["tp"]
        ways = {"tp": tp, "dp": dp}
        params = sum(int(np.prod([n // ways.get(a, 1) for n, a in zip(
            d.shape, tuple(d.spec) + (None,) * len(d.shape))]))
            for _, d in tree_leaves(ffn_decls(cfg, MeshAxes(tp=tp, dp=dp))))
        rows = 64 // dp * cfg.ffn_width // tp * 2     # x and y, fp layout
        assert u.costs.memory["argument_bytes"] == 4 * (params + rows)
        assert u.costs.memory["step_bytes"] > 0


def test_kernel_unit_plans_fit_and_the_cpu_launches_nothing(units):
    """The kernel unit's step took the phantom operators: float32 plans
    (``splitk_kernel`` forward and dgrad, ``tn_kernel`` wgrad) that fit
    one H100 block; on the CPU the wrappers ran their plain versions."""
    from repro_torch.kernels.phantom_fused import SMEM_BUDGET_BYTES
    u = units[3]
    assert u.meta["kernel_backend"] == "pallas"
    plans = u.meta["kernel_plans"]
    assert {(p["product"], p["kernel"]) for p in plans} == {
        ("forward", "splitk_kernel"), ("dgrad", "splitk_kernel"),
        ("wgrad", "tn_kernel")}
    assert 0 < u.meta["kernel_smem_bytes"] <= SMEM_BUDGET_BYTES
    assert u.meta["kernel_launches"] == 0


def test_audit_plans_gates_candidates(pools):
    """A good candidate passes, as the reference's does; one whose step
    cannot run (width 256 over tp 3) is an audit error, not a crash."""
    from repro.analysis import audit_plans as jax_audit_plans
    from repro.planner.space import PlanCandidate as JPlan
    from repro_torch.planner.space import PlanCandidate
    good = PlanCandidate(dp=1, tp=2, strategy="phantom", width=256,
                         depth=2, batch=64, k=4)
    bad = PlanCandidate(dp=1, tp=3, strategy="phantom", width=256,
                        depth=2, batch=64, k=4)
    res = audit_plans([good, bad], pools=pools, device="cpu")
    assert res[good.name]["ok"], res[good.name]["errors"]
    assert res[good.name]["counts"]["error"] == 0
    want = jax_audit_plans([JPlan(dp=1, tp=2, strategy="phantom",
                                  width=256, depth=2, batch=64, k=4)])
    assert want[good.name]["ok"]
    assert not res[bad.name]["ok"]
    assert "could not run" in res[bad.name]["errors"][0]
    assert "does not split" in res[bad.name]["errors"][0]


def test_audit_plans_raises_where_a_step_fails_on_its_ranks():
    """Only a candidate's own failure to split is an audit error: a step
    that fails on its ranks (a rank lost, a fault on the card) raises
    through ``audit_plans`` and is never read as a rejected plan."""
    from repro_torch.planner.space import PlanCandidate

    class LostWorld:
        def get(self, world):
            raise RuntimeError(f"rank 1 of a world of {world} exited")
    good = PlanCandidate(dp=1, tp=2, strategy="phantom", width=256,
                         depth=2, batch=64, k=4)
    with pytest.raises(RuntimeError, match="rank 1 of a world of 2"):
        audit_plans([good], pools=LostWorld(), device="cpu")


def test_audit_cli_over_the_units(units, tmp_path, monkeypatch):
    """``launch/audit.py --all --device cpu`` over these units: exit 0,
    the report's schema, the nine units and their buckets, the kernel
    unit's launches; ``--unit`` filters by name; no card: it raises."""
    from repro_torch.analysis import units as units_mod
    from repro_torch.launch import audit as audit_cli
    monkeypatch.setattr(units_mod, "build_default_units",
                        lambda pools, arch, device: list(units))
    out = tmp_path / "build" / "AUDIT_report.json"
    assert audit_cli.main(["--all", "--device", "cpu", "--out",
                           str(out)]) == 0
    rec = json.load(open(out))
    assert rec["schema"] == "audit-report/v1" and rec["ok"] is True
    assert [u["name"] for u in rec["units"]] == [u.name for u in units]
    assert rec["units"][0]["collectives"] == {
        f"{k}@g{g}": b for (k, g), b in
        sorted(units[0].measured_buckets().items())}
    assert rec["units"][3]["meta"]["kernel_launches"] == 0
    assert audit_cli.main(["--unit", "serve_decode", "--device", "cpu",
                           "--out", str(out)]) == 0
    assert [u["name"] for u in json.load(open(out))["units"]] == \
        [u.name for u in units if "serve_decode" in u.name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            audit_cli.main(["--all", "--out", str(out)])


def test_replan_audits_on_the_worlds_its_phases_run_on(pools, tmp_path):
    """``run_elastic`` with the caller's ``RankPools`` (the module's):
    each plan is audited with a probe step on the world its phase then
    runs on (the caller's world of that size, no new one started, left
    open), and the re-plan after a host loss passes its audit, as in the
    reference.
    The initial plan's audit, which starts the first world, is priced in
    the first phase's ``compile_s``."""
    import time

    from repro_torch.train import elastic
    from repro_torch.train.elastic import ElasticConfig, run_elastic
    from repro_torch.train.fault import FaultScript
    solve_s = []

    def timed_solve(*a, **kw):
        t0 = time.perf_counter()
        out = solve_plan(*a, **kw)
        solve_s.append(time.perf_counter() - t0)
        return out
    solve_plan = elastic.solve_plan
    cfg = ElasticConfig(workdir=str(tmp_path), devices=4, hosts=2, width=32,
                        depth=2, batch=16, target_loss=1e-9, max_steps=8,
                        checkpoint_every=3, ks=(4,),
                        initial_strategy="tensor_col",
                        straggler_threshold=1e6)
    worlds = dict(pools._own)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "solve_plan", timed_solve)
        res = run_elastic(cfg, fault_script=FaultScript(
            kills=((5, "host1"),)), log_fn=lambda *a: None, device="cpu",
            pools=pools)
    assert pools._own == worlds and all(w.alive for w in worlds.values())
    assert not res.aborted and res.final_step == 8
    assert [r["audit_ok"] for r in res.recoveries] == [True]
    assert [p["devices"] for p in res.phases] == [4, 2]
    assert len(solve_s) == 2
    assert res.phases[0]["compile_s"] >= solve_s[0]
    assert res.recoveries[0]["replan_s"] >= solve_s[1]
