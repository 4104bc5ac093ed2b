"""Seeded violations: every rule of the port's audit
(``repro_torch.analysis``) must fire, as ``tests/test_audit_rules.py``
holds the reference's.

Each case plants one violation (an unpriced all-reduce, a reshard over a
non-mesh group, a bf16 -> f32 cast, an unhashable static arg, a phantom
kernel plan over one H100 block's shared memory) and asserts the
matching rule reports it at the right severity.  Where the reference
feeds synthetic HLO through its real parser, the port's collective
fixtures issue their collectives through the real recorder: a
``parallel/axes.py: DryGroup`` of the fixture's size under
``record_collectives`` (the dry run's group, which logs each collective
as a ``Group`` does and exchanges nothing), so the rule runs on a real
log; the casts come from the real dispatch mode (``analysis/units.py:
StepMode``) over a step that runs.  No card, no ranks."""
import json

import pytest
import torch

from repro_torch.analysis import (ERROR, INFO, WARNING, AuditUnit, Baseline,
                                  Finding, PricedCollective, apply_baseline,
                                  load_baseline, run_audit, run_rules)
from repro_torch.analysis.rules import (DTYPE_DRIFT_MIN_ELEMENTS,
                                        PROGRAM_RULES,
                                        rule_collective_accounting,
                                        rule_dtype_drift, rule_kernel_smem,
                                        rule_recompilation_hazard,
                                        rule_sharding_hygiene)
from repro_torch.analysis.units import StepMode
from repro_torch.parallel.axes import (DryGroup, IssuedCollective,
                                       record_collectives)
from repro_torch.telemetry.counted import MeasuredCosts


def _logged(fn, size=8, ranks=1):
    """The ``record_collectives`` logs of ``fn(group)`` on ``ranks``
    ranks, each a ``DryGroup`` of ``size`` (rank ``r`` of it)."""
    logs = []
    for r in range(ranks):
        with record_collectives() as log:
            fn(DryGroup(size=size, rank=r, ranks=tuple(range(size))))
        logs.append(list(log.events))
    return logs


def _unit(logs, predicted, *, axes=None, **kw):
    return AuditUnit(name="fixture", kind="fixture", logs=logs,
                     predicted=predicted, axes=axes or {"dp": 1, "tp": 8},
                     **kw)


def _ar(shape, size=8):
    """One all-reduce of a float32 ``shape`` over a group of ``size``."""
    return _logged(lambda g: g.all_reduce(torch.ones(shape)), size)


def _findings(fs, rule=None, severity=None):
    return [f for f in fs
            if (rule is None or f.rule == rule)
            and (severity is None or f.severity == severity)]


AR_BIG = (64, 512)


# ---------------------------------------------------------------------------
# R1 collective-accounting
# ---------------------------------------------------------------------------

def test_unpriced_psum_is_caught():
    """The headline fixture: a step that all-reduces 8,192 floats over
    the model axis of 8, which nothing prices, is an error."""
    def step(g):
        return g.all_reduce(torch.ones(64, 128) * 2.0)
    unit = _unit(_logged(step), predicted=[])
    errs = _findings(rule_collective_accounting(unit), severity=ERROR)
    assert errs, "an unpriced 8192-float all-reduce must be an error"
    assert "unpriced" in errs[0].message
    assert "all_reduce" in errs[0].message


def test_priced_psum_is_clean():
    def step(g):
        return g.all_reduce(torch.ones(64, 128) * 2.0)
    unit = _unit(_logged(step),
                 predicted=[PricedCollective("all_reduce", 64 * 128, 8)])
    assert not _findings(rule_collective_accounting(unit), severity=ERROR)


def test_phantom_prediction_is_caught():
    """Pricing a collective the step never issues is the dual error
    (the account bills energy that never flows)."""
    unit = _unit(_ar(AR_BIG), predicted=[
        PricedCollective("all_reduce", 64 * 512, 8),
        PricedCollective("reduce_scatter", 32_768, 8)])
    errs = _findings(rule_collective_accounting(unit), severity=ERROR)
    assert len(errs) == 1
    assert "phantom prediction" in errs[0].message
    assert "reduce_scatter" in errs[0].message


def test_mispriced_bytes_and_count_only_mismatch():
    # bytes off by 2x -> error; counts off with bytes agreeing -> info
    unit = _unit(_ar(AR_BIG), predicted=[
        PricedCollective("all_reduce", 2 * 64 * 512, 8)])
    errs = _findings(rule_collective_accounting(unit), severity=ERROR)
    assert len(errs) == 1 and "mispriced" in errs[0].message

    unit2 = _unit(_ar(AR_BIG), predicted=[
        PricedCollective("all_reduce", 64 * 512 / 4, 8, count=4)])
    fs = rule_collective_accounting(unit2)
    assert not _findings(fs, severity=ERROR)
    infos = _findings(fs, severity=INFO)
    assert len(infos) == 1 and "fusion/splitting" in infos[0].message


def test_small_messages_and_loose_units_demote():
    unit = _unit(_ar((16,)), predicted=[])
    fs = rule_collective_accounting(unit)
    assert _findings(fs, severity=INFO) and not _findings(fs,
                                                          severity=ERROR)
    # the same big unpriced all-reduce on a loose (serving) unit demotes
    # to a warning instead of an error
    loose = _unit(_ar(AR_BIG), predicted=[], strict=False)
    fs = rule_collective_accounting(loose)
    assert _findings(fs, severity=WARNING) and not _findings(
        fs, severity=ERROR)


def test_wrong_mesh_axis_same_kind_is_two_findings():
    """Matching is by (kind, group): pricing the right kind on the wrong
    mesh axis must NOT reconcile."""
    unit = _unit(_ar(AR_BIG), axes={"dp": 2, "tp": 4},
                 predicted=[PricedCollective("all_reduce", 64 * 512, 4)])
    errs = _findings(rule_collective_accounting(unit), severity=ERROR)
    kinds = sorted(e.message.split(":")[0] for e in errs)
    assert kinds == ["phantom prediction", "unpriced collective"]


def test_degenerate_group_of_one_collectives_ignored():
    """A group of one rank issues nothing (``Group`` returns at once, and
    so does the dry group); a logged group of one would move nothing and
    must not show up as unpriced traffic."""
    assert _logged(lambda g: g.all_gather(torch.ones(64, 512)), size=1) \
        == [[]]
    unit = _unit([[IssuedCollective("all_gather", 64 * 512.0, 1,
                                    "all_gather")]], predicted=[])
    assert unit.measured_buckets() == {}
    assert rule_collective_accounting(unit) == []


def test_per_rank_mean_reconciles_a_pipeline_of_sends():
    """The port's ranks of a pipeline issue different sends (stage 0
    forward, the last stage backward): the unit's measured buckets are
    the per-rank mean over the ranks' logs, the figure the pipeline
    unit's account predicts."""
    def stage(g):
        if g.rank == 0:
            for _ in range(4):
                g.send(torch.ones(8, 64), 1)
        else:
            for _ in range(4):
                g.recv(torch.ones(8, 64), 0)
    logs = _logged(stage, size=2, ranks=2)
    assert [len(log) for log in logs] == [4, 0]
    unit = _unit(logs, axes={"pp": 2}, predicted=[
        PricedCollective("collective_permute", 8 * 64, 2, 2.0)])
    assert unit.measured_buckets() == {("collective_permute", 2): {
        "count": 2.0, "m_floats": 2 * 8 * 64.0}}
    assert rule_collective_accounting(unit) == []


# ---------------------------------------------------------------------------
# R2 sharding-hygiene
# ---------------------------------------------------------------------------

def test_reshard_over_non_mesh_group_warns():
    unit = _unit(_ar(AR_BIG, size=3), predicted=[],
                 axes={"dp": 2, "tp": 4})
    ws = _findings(rule_sharding_hygiene(unit), severity=WARNING)
    assert len(ws) == 1
    assert "group of 3" in ws[0].message
    # mesh-legal groups (1, 2, 4, 8) raise nothing
    ok = _unit(_ar(AR_BIG), predicted=[], axes={"dp": 1, "tp": 8})
    assert rule_sharding_hygiene(ok) == []


def test_memory_blowup_vs_napkin_warns():
    costs = MeasuredCosts(memory={"argument_bytes": 4e6,
                                  "step_bytes": 5e6})
    unit = AuditUnit(name="fixture", kind="fixture", costs=costs,
                     axes={"tp": 8}, napkin_bytes=1e6)
    ws = _findings(rule_sharding_hygiene(unit), severity=WARNING)
    assert len(ws) == 1 and "blowup" in ws[0].message
    unit.napkin_bytes = 5e6                 # within 8x: fine
    assert rule_sharding_hygiene(unit) == []


# ---------------------------------------------------------------------------
# R3 dtype-drift
# ---------------------------------------------------------------------------

def _casts(fn, *args):
    mode = StepMode()
    with mode:
        fn(*args)
    return mode.upcasts


def test_bf16_upcast_flagged_scalars_exempt():
    def f(x, s):
        big = x.to(torch.float32) * 2.0             # 512*512 upcast
        small = s.float()                           # scalar: exempt
        return big.sum() + small

    casts = _casts(f, torch.ones(512, 512, dtype=torch.bfloat16),
                   torch.ones((), dtype=torch.bfloat16))
    assert sorted(c["elements"] for c in casts) == [1, 512 * 512]
    unit = AuditUnit(name="fixture", kind="fixture", upcasts=casts,
                     compute_dtype="bfloat16")
    ws = _findings(rule_dtype_drift(unit), severity=WARNING)
    assert len(ws) == 1
    assert "(512, 512)" in ws[0].message
    # f32 units don't run the rule at all, nor units that recorded none
    unit_f32 = AuditUnit(name="fixture", kind="fixture", upcasts=casts,
                         compute_dtype="float32")
    assert rule_dtype_drift(unit_f32) == []
    assert rule_dtype_drift(AuditUnit(name="fixture", kind="fixture",
                                      compute_dtype="bfloat16")) == []


def test_dtype_drift_descends_into_scan_bodies():
    """The reference walks sub-jaxprs (scan bodies); the dispatch mode
    sees every executed op, a loop's and a backward pass's too: a
    ``copy_`` into float32 in a loop body and the casts autograd runs
    backward through a ``.float()``."""
    def f(xs, w):
        acc = torch.zeros(256, 512)
        for x in xs:                                # the loop body
            acc.copy_(x)
        return (w.float() * acc).sum()

    w = torch.ones(256, 512, dtype=torch.bfloat16, requires_grad=True)
    mode = StepMode()
    with mode:
        f(torch.ones(4, 256, 512, dtype=torch.bfloat16), w).backward()
    casts = mode.upcasts
    assert casts[0]["shape"] == [256, 512] and casts[0]["count"] >= 5
    unit = AuditUnit(name="fixture", kind="fixture", upcasts=casts,
                     compute_dtype="bfloat16")
    assert _findings(rule_dtype_drift(unit), severity=WARNING)
    assert 256 * 512 >= DTYPE_DRIFT_MIN_ELEMENTS


# ---------------------------------------------------------------------------
# R4 recompilation-hazard
# ---------------------------------------------------------------------------

class _UnstableHash:
    def __hash__(self):
        return id(self)             # deepcopy changes id -> cache miss

    def __eq__(self, other):
        return isinstance(other, _UnstableHash)


def test_unhashable_and_hash_unstable_static_args():
    unit = AuditUnit(name="fixture", kind="fixture",
                     static_args={"cfg": [1, 2, 3]})
    errs = _findings(rule_recompilation_hazard(unit), severity=ERROR)
    assert len(errs) == 1 and "unhashable" in errs[0].message

    unit2 = AuditUnit(name="fixture", kind="fixture",
                      static_args={"cfg": _UnstableHash()})
    errs = _findings(rule_recompilation_hazard(unit2), severity=ERROR)
    assert len(errs) == 1 and "hash-unstable" in errs[0].message

    # frozen hashable config objects pass
    from repro_torch.configs.base import get_config
    unit3 = AuditUnit(name="fixture", kind="fixture",
                      static_args={"cfg": get_config("paper-ffn-4k",
                                                     smoke=True)})
    assert rule_recompilation_hazard(unit3) == []


# ---------------------------------------------------------------------------
# R5 kernel-smem
# ---------------------------------------------------------------------------

def _kernel_plans(x, L, g, D):
    """The plans one phantom forward, dgrad and wgrad take, through the
    operators (``kernels/ops.py: phantom_fused_linear``), as a kernel
    unit's step records them."""
    from repro_torch.kernels.ops import phantom_fused_linear
    mode = StepMode()
    x, g = (t.requires_grad_(True) for t in (x, g))
    with mode:
        phantom_fused_linear(x, L, g, D).sum().backward()
    return mode.plans


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_plans_fit_and_an_oversized_plan_is_caught(dtype):
    """The plans the three phantom products take (``splitk_kernel`` and
    ``tn_kernel`` in float32, the wgmma kernels in bf16) fit one H100
    block; a plan with a 256 x 256 wgmma tile (a ring of 256 KB) is an
    error, and so is a CUDA-core tile over the budget."""
    L, D = (torch.ones(256, 128, dtype=dtype, requires_grad=True),
            torch.ones(32, 128, dtype=dtype, requires_grad=True))
    plans = _kernel_plans(torch.ones(64, 256, dtype=dtype), L,
                          torch.ones(64, 32, dtype=dtype), D)
    assert sorted(p["product"] for p in plans) == ["dgrad", "forward",
                                                   "wgrad"]
    want = ({"splitk_kernel", "tn_kernel"} if dtype == torch.float32 else
            {"wgmma_fwd_kernel", "wgmma_dgrad_kernel", "wgmma_wgrad_kernel"})
    assert {p["kernel"] for p in plans} == want
    unit = AuditUnit(name="fixture", kind="kernel",
                     meta={"kernel_plans": plans})
    assert rule_kernel_smem(unit) == []
    fwd = next(p for p in plans if p["product"] == "forward")
    big = dict(fwd, bm=256, bn=256, stages=4, bk=64)
    bad = AuditUnit(name="fixture", kind="kernel",
                    meta={"kernel_plans": [big]})
    errs = _findings(rule_kernel_smem(bad), severity=ERROR)
    assert len(errs) == 1 and "shared memory" in errs[0].message
    assert errs[0].fingerprint == \
        f"kernel-smem:fixture:kernel-smem:forward:{fwd['kernel']}"


# ---------------------------------------------------------------------------
# baseline ratchet
# ---------------------------------------------------------------------------

def test_baseline_suppresses_and_reports_stale(tmp_path):
    f1 = Finding("collective-accounting", ERROR, "u", "msg",
                 key="all_reduce@g8")
    f2 = Finding("sharding-hygiene", WARNING, "u", "msg2", key="group3")
    base = Baseline(suppressions={f1.fingerprint: "known",
                                  "dtype-drift:u:gone": "stale entry"})
    active, suppressed, stale = apply_baseline([f1, f2], base)
    assert [f.key for f in active] == ["group3"]
    assert [f.key for f in suppressed] == ["all_reduce@g8"]
    assert stale == ["dtype-drift:u:gone"]

    # run_audit's ok gate looks at ACTIVE errors only
    unit = _unit(_ar(AR_BIG), predicted=[])
    res = run_audit([unit])
    assert not res.ok
    fp = res.findings[0].fingerprint
    res2 = run_audit([unit], baseline=Baseline(suppressions={fp: "ok"}))
    assert res2.ok and len(res2.suppressed) == 1

    # baseline files round-trip; a missing file is an empty baseline
    from repro_torch.analysis.findings import write_baseline
    path = tmp_path / "AUDIT_baseline.json"
    write_baseline([f1], str(path))
    loaded = load_baseline(str(path))
    assert loaded.reason(f1.fingerprint)
    assert load_baseline(str(tmp_path / "nope.json")).suppressions == {}


def test_fingerprints_have_no_volatile_numbers():
    unit = _unit(_ar(AR_BIG), predicted=[])
    for f in run_rules(unit):
        assert "32768" not in f.fingerprint     # 64*512 floats
        assert f.fingerprint.count(":") == 2


def test_report_dict_schema(tmp_path):
    unit = _unit(_ar(AR_BIG), predicted=[])
    res = run_audit([unit])
    rec = res.as_dict()
    assert rec["schema"] == "audit-report/v1"
    assert rec["ok"] is False
    assert rec["counts"]["error"] == 1
    assert rec["units"][0]["collectives"] == {
        "all_reduce@g8": {"count": 1, "m_floats": 64 * 512.0}}
    out = tmp_path / "AUDIT_report.json"
    res.write(str(out))
    assert json.load(open(out))["schema"] == "audit-report/v1"


def test_rule_catalog_is_the_references_but_for_the_port_rules():
    """The same program rules in the same order, but ``kernel-vmem`` (a
    TPU core's VMEM) is ``kernel-smem`` (an H100 block's shared memory);
    the source rules are the reference's, but ``raw-shard-map`` (jax's
    shard_map outside its shim) is ``raw-collective``."""
    from repro.analysis.rules import PROGRAM_RULES as JAX_RULES
    from repro.analysis.rules import rule_catalog as jax_catalog
    from repro_torch.analysis import rule_catalog
    port = {"kernel-vmem": "kernel-smem", "raw-shard-map": "raw-collective"}
    assert list(PROGRAM_RULES) == [port.get(r, r) for r in JAX_RULES]
    assert [(c["id"], c["severity"], c["kind"]) for c in rule_catalog()] \
        == [(port.get(c["id"], c["id"]), c["severity"], c["kind"])
            for c in jax_catalog()]
