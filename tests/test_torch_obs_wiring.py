"""The port's observability wiring against the reference's, on the CPU:
for each runtime layer, both packages run the same work under a
``Tracer`` and a fresh ``MetricsRegistry``, and their traces and metrics
are compared.  Span and instant names, cats, counts and argument keys
must be equal (times are not compared); counter values and histogram
counts exact; ``train_loss`` within ``tests/test_torch_trainer.py``'s
rtol 1e-5.  Where the port runs ranks, the comparison reads pid 0 (the
parent and rank 0), which is the reference's single process.

1. Three AdamW steps of phi3-smoke through both ``Trainer``s, from the
   reference's weights and batches, a checkpoint at step 2 and a
   restore.
2. The reference's ``_elastic_cfg`` (``tests/test_obs.py``) with host3
   lost at step 12, the straggler detector off on both sides (threshold
   1e6: a loaded host's step times would flag stragglers at random);
   ``verify-recovery`` on the port's own trace and report.  Then, port
   only, on an injected step clock (``torch_ranks.VirtualStepClock``):
   ``slow_steps=(12,)`` trips the watchdog exactly once, a spike at 12,
   and the clean run trips nothing.  The reference's own slow-step test
   times real CPU steps and is unsteady (ROADMAP.md queue 3).
3. ``launch/plan.py`` at the reference test's argv, its pilots on the
   file's ranks fed the reference's draws.
4. Both ``ServeEngine``s on the same requests, their SLO reports and
   ``route``.
5. The modeled fleet (the reference test's phantom fleet, 300 bursty
   requests).
6. One merged trace from the file's ranks (``torch_ranks.
   obs_trainer_body``: phi3-smoke at dp 2 x tp 2, a checkpoint each
   step, a watchdog that rank 0 trips): 4 pids on the parent's origin,
   rank 0's metrics exported, the ranks' checkpoint bytes summing to
   the checkpoint's.

One world of 4 gloo ranks serves items 3 and 6; the elastic runs spawn
a world per phase, as ``run_elastic`` does.
"""
import collections
import contextlib
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.configs.base import get_config as jax_get_config
from repro.core.energy import TPU_PEAK_FLOPS
from repro.core.ffn import init_ffn as jax_init_ffn
from repro.data.synthetic import LMDataset as JLMDataset
from repro.data.synthetic import TeacherDataset as JTeacherDataset
from repro.launch import plan as jax_plan_cli
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim import AdamW as JAdamW
from repro.planner.calibration import Calibration as JCalibration
from repro.planner.calibration import paper_default_calibration as jpaper
from repro.planner.space import PlanCandidate as JPlanCandidate
from repro.serve import fleet as jfleet
from repro.serve import router as jrouter
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.traffic import SLOTracker as JSLOTracker
from repro.serve.traffic import make_trace as jax_make_trace
from repro.telemetry import Ledger as JLedger
from repro.train.elastic import ElasticConfig as JElasticConfig
from repro.train.elastic import run_elastic as jax_run_elastic
from repro.train.fault import FaultScript as JFaultScript
from repro.train.trainer import Trainer as JTrainer

import repro_torch.obs as tobs
from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.launch import obs as obs_cli
from repro_torch.launch import plan as plan_cli
from repro_torch.launch.mesh import RankPool
from repro_torch.optim import AdamW
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import from_jax_params
from repro_torch.planner import paper_default_calibration, score_plans
from repro_torch.planner.calibration import Calibration
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import router as trouter
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.traffic import SLOTracker, make_trace
from repro_torch.telemetry import Ledger
from repro_torch.train import elastic
from repro_torch.train.elastic import ElasticConfig, run_elastic
from repro_torch.train.fault import FaultScript
from repro_torch.train.trainer import Trainer, TrainState

import torch_ranks

LOSS_RTOL = 1e-5                  # tests/test_torch_trainer.py's
B, S, STEPS, LR, WD = 4, 32, 3, 1e-3, 0.1


def _quiet(*a, **k):
    pass


@contextlib.contextmanager
def observed(obs):
    """A fresh tracer and registry of ``obs`` for the block."""
    tr, reg = obs.Tracer(), obs.MetricsRegistry()
    prev = obs.set_metrics(reg)
    try:
        with obs.use_tracer(tr):
            yield tr, reg
    finally:
        obs.set_metrics(prev)


def signature(doc, pid=0):
    """Each (phase, name, cat, argument keys) of a trace's spans and
    instants on ``pid``, counted."""
    return collections.Counter(
        (e["ph"], e["name"], e["cat"], tuple(sorted(e["args"])))
        for e in doc["traceEvents"]
        if e["ph"] in ("X", "i") and e["pid"] == pid)


def metric_view(reg, skip=()):
    """Counter values, histogram counts and gauge label keys by name."""
    out = {}
    for name, m in reg.snapshot()["metrics"].items():
        if name in skip:
            continue
        if m["kind"] == "counter":
            out[name] = ("counter", m["values"])
        elif m["kind"] == "histogram":
            out[name] = ("histogram", {k: h["count"]
                                       for k, h in m["values"].items()})
        else:
            out[name] = ("gauge", sorted(m["values"]))
    return out


@pytest.fixture(scope="module")
def pool():
    """The file's one world: 4 gloo CPU ranks."""
    with RankPool(1, 4, "cpu", timeout_s=600) as p:
        yield p


# ---------------------------------------------------------------------------
# 1. the trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    jcfg = jax_get_config("phi3-mini-3.8b", smoke=True).replace(
        dtype="float32")
    jds = JLMDataset(jcfg.vocab_size, B, S + 1, seed=1)
    out = {}
    with observed(jobs) as (tr, reg):
        jt = JTrainer(jcfg, jax_local_mesh(1, 1), JAdamW(LR, weight_decay=WD),
                      jds, checkpoint_dir=str(root / "jax"),
                      checkpoint_every=2, log_fn=_quiet, ledger=JLedger())
        state = jt.init_state(seed=3)
        start = jax.tree.map(np.array, state.params)
        jt.run(state, STEPS)
        jt.restore_or_init()
        out["jax"] = tr.to_chrome(), reg
    batches = [jax.tree.map(np.array, jds(s)) for s in range(STEPS)]
    cfg = with_kernel_backend(get_config("phi3-mini-3.8b", smoke=True,
                                         dtype="float32"), "auto")
    with observed(tobs) as (tr, reg):
        opt = AdamW(LR, weight_decay=WD)
        t = Trainer(cfg, MeshAxes(), opt, lambda s: {
            k: torch.from_numpy(v) for k, v in batches[s].items()},
            checkpoint_dir=str(root / "torch"), checkpoint_every=2,
            log_fn=_quiet, ledger=Ledger(), device="cpu")
        params = from_jax_params(start)
        t.run(TrainState(params, opt.init(params), 0), STEPS)
        t.restore_or_init()
        out["torch"] = tr.to_chrome(), reg
    return out


def test_trainer_spans_and_metrics_equal_the_references(trainers):
    (jdoc, jreg), (doc, reg) = trainers["jax"], trainers["torch"]
    assert signature(doc) == signature(jdoc)
    names = collections.Counter(e["name"] for e in tobs.span_events(doc))
    assert names == {"train/run": 1, "train/step": STEPS, "ckpt/save": 1,
                     "ckpt/restore": 1}
    save = tobs.span_events(doc, name_prefix="ckpt/save")[0]
    assert save["tid"] == 1              # the writer thread's own row
    assert metric_view(reg) == metric_view(jreg)
    loss = reg.gauge("train_loss").value(suite="trainer")
    assert loss == pytest.approx(
        jreg.gauge("train_loss").value(suite="trainer"), rel=LOSS_RTOL)
    assert reg.counter("ckpt_bytes_total").value() == \
        jreg.counter("ckpt_bytes_total").value() > 0


# ---------------------------------------------------------------------------
# 2. the elastic runtime
# ---------------------------------------------------------------------------

ELASTIC = dict(devices=8, hosts=4, width=32, depth=2, batch=16,
               target_loss=1e-9, max_steps=24, checkpoint_every=5, ks=(4,),
               audit_replan=False, heartbeat_timeout_s=2.5,
               initial_strategy="tensor_col")
KILL12 = ((12, "host3"),)


@contextlib.contextmanager
def _tpu_peak():
    """The port's scoring at the reference's peak, so both pick the same
    plans (``tests/test_torch_elastic.py``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "score_plans", functools.partial(
            score_plans, peak_flops=TPU_PEAK_FLOPS))
        yield


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    kw = dict(ELASTIC, straggler_threshold=1e6)
    out = {}
    with observed(jobs) as (tr, reg):
        res = jax_run_elastic(
            JElasticConfig(workdir=str(root / "jax"), **kw),
            fault_script=JFaultScript(kills=KILL12), calibration=jpaper(),
            ledger=JLedger(run="t"), log_fn=_quiet)
        out["jax"] = res, tr.to_chrome(), reg
    ledger = Ledger(run="t")
    with observed(tobs) as (tr, reg), _tpu_peak():
        res = run_elastic(ElasticConfig(workdir=str(root / "torch"), **kw),
                          fault_script=FaultScript(kills=KILL12),
                          calibration=paper_default_calibration(),
                          ledger=ledger, log_fn=_quiet, device="cpu")
        trace = tr.write(str(root / "trace.json"))
    report = ledger.write_report(str(root / "build" / "report.json"))
    out["torch"] = res, tobs.load_trace(trace), reg
    out["files"] = trace, report
    return out


def test_elastic_spans_and_metrics_equal_the_references(elastic_runs):
    jres, jdoc, jreg = elastic_runs["jax"]
    res, doc, reg = elastic_runs["torch"]
    assert len(res.recoveries) == len(jres.recoveries) == 1
    assert res.plan_names == jres.plan_names
    assert signature(doc) == signature(jdoc)
    names = {e["name"] for e in tobs.span_events(doc)}
    assert {"elastic/run", "elastic/plan", "elastic/compile",
            "elastic/replan", "elastic/restore", "elastic/step"} <= names
    run = tobs.span_events(doc, name_prefix="elastic/run")[0]
    assert run["args"]["ledger"]["kind"] == "elastic"
    # every rank of both phases traced its steps under its own pid
    pids = {e["pid"] for e in tobs.span_events(doc, name_prefix=
                                               "elastic/step")}
    assert pids == set(range(8))
    skip = ("ckpt_bytes_total",)
    assert metric_view(reg, skip) == metric_view(jreg, skip)
    # rank 0's blocks are exported; the phases hold every rank's, whose
    # sum is the reference's one process's bytes
    phase_bytes = sum(p["ckpt_io_bytes"] for p in res.phases)
    assert phase_bytes == jreg.counter("ckpt_bytes_total").value()
    assert 0 < reg.counter("ckpt_bytes_total").value() < phase_bytes


def test_elastic_trace_passes_verify_recovery(elastic_runs, capsys):
    trace, report = elastic_runs["files"]
    assert obs_cli.main(["verify-recovery", "--trace", trace,
                         "--report", report]) == 0
    assert "OK" in capsys.readouterr().out
    acct = elastic_runs["torch"][0].account
    span_s = sum(e["dur"] * 1e-6 for e in tobs.span_events(
        tobs.load_trace(trace)) if e["name"] in obs_cli.RECOVERY_SPANS)
    acct_s = sum(acct[k] for k in obs_cli.RECOVERY_SPANS.values())
    assert acct_s > 0 and span_s == pytest.approx(acct_s, rel=0.35)


@pytest.mark.parametrize("slow", [(12,), ()], ids=["slow12", "clean"])
def test_slow_step_trips_the_watchdog_on_an_injected_clock(tmp_path, slow):
    ledger = Ledger(run="t")
    wd = tobs.EnergyDriftWatchdog(ledger=ledger, name="t")
    with observed(tobs) as (tr, reg):
        res = run_elastic(
            ElasticConfig(workdir=str(tmp_path), slow_steps=slow,
                          **dict(ELASTIC, max_steps=16)),
            watchdog=wd, ledger=ledger, log_fn=_quiet, device="cpu",
            step_clock=torch_ranks.VirtualStepClock(0.01))
    assert not res.aborted and res.final_step == 16
    assert wd.summary()["observations"] == 16
    anomalies = [e for e in ledger.entries if e.kind == "anomaly"]
    spikes = [e for e in tr.events() if e["name"] == "watchdog/spike"]
    if slow:
        assert [(t.kind, t.step) for t in wd.trips] == [("spike", 12)]
        assert wd.trips[0].ratio == pytest.approx(6.0)
        assert [e.measured["step"] for e in anomalies] == [12]
        assert len(spikes) == 1 and spikes[0]["pid"] == 0
        assert reg.counter("obs_watchdog_trips_total").value(
            kind="spike") == 1
    else:
        assert wd.trips == [] and anomalies == [] and spikes == []


# ---------------------------------------------------------------------------
# 3. the planner CLI
# ---------------------------------------------------------------------------

REF_ARGV = ["--devices", "8", "--target-loss", "0.25", "--width", "512",
            "--batch", "64", "--ks", "4,8", "--pilot-steps", "80",
            "--pilot-tp", "4"]


def _reference_draws():
    """The reference pilots' initial weights and teacher batches
    (``tests/test_torch_planner_pilots.py``)."""
    mesh = jax_local_mesh(1, 4)
    params = {}
    for strat, k in (("tensor_col", 0), ("phantom", 4), ("phantom", 8)):
        cfg = JPlanCandidate(dp=1, tp=4, strategy=strat, width=512, depth=2,
                             batch=64, k=k).model_config()
        p, _ = jax_init_ffn(cfg, mesh, JAdamW(3e-3, weight_decay=0.0),
                            seed=0)
        params[cfg.name] = jax.tree.map(np.array, p)
    ds = JTeacherDataset(512, 64, seed=0)
    return {"params": params,
            "batches": [tuple(np.array(a) for a in ds(s))
                        for s in range(80)]}


@pytest.fixture(scope="module")
def plans(tmp_path_factory, pool):
    root = tmp_path_factory.mktemp("plan")
    out = {}
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        assert jax_plan_cli.main(REF_ARGV + [
            "--out", str(root / "jax.json"), "--trace-out",
            str(root / "jax_trace.json"), "--metrics-out",
            str(root / "jax.jsonl"), "--no-audit"]) == 0
        pool.run(torch_ranks.install_pilot_draws, 1, 4,
                 (_reference_draws(),))
        args = plan_cli.build_parser().parse_args(REF_ARGV + [
            "--device", "cpu", "--out", str(root / "build" / "plan.json"),
            "--trace-out", str(root / "trace.json"), "--metrics-out",
            str(root / "m.jsonl")])
        with obs_cli.obs_session(args.trace_out, args.metrics_out,
                                 meta={"run": "launch.plan"}):
            report = plan_cli.plan(args, iso=plan_cli.pilots(args,
                                                             pool=pool))
    for name, trace, metrics in (("jax", "jax_trace.json", "jax.jsonl"),
                                 ("torch", "trace.json", "m.jsonl")):
        snap = json.loads(open(root / metrics).read().splitlines()[-1])
        out[name] = tobs.load_trace(str(root / trace)), snap
    out["report"] = report
    return out


def test_plan_spans_and_metrics_equal_the_references(plans):
    (jdoc, jsnap), (doc, snap) = plans["jax"], plans["torch"]
    assert signature(doc) == signature(jdoc)
    stages = collections.Counter(e["name"] for e in tobs.span_events(doc)
                                 if e["pid"] == 0)
    assert stages == {"plan/calibrate": 1, "plan/enumerate": 1,
                      "plan/pilots": 1, "plan/pilot": 3}
    # each of the 4 ranks traced each pilot under its own pid
    for pid in range(4):
        assert signature(doc, pid)[next(
            k for k in signature(doc) if k[1] == "plan/pilot")] == 3
    got = [e["args"] for e in tobs.span_events(doc)
           if e["pid"] == 0 and e["name"] == "plan/pilot"]
    want = [e for e in tobs.span_events(jdoc) if e["name"] == "plan/pilot"]
    assert [(a["strategy"], a["k"], a["steps_run"], a["iters_to_target"])
            for a in got] == [(e["args"]["strategy"], e["args"]["k"],
                               e["args"]["steps_run"],
                               e["args"]["iters_to_target"]) for e in want]
    assert snap["metrics"] == jsnap["metrics"]
    assert sum(snap["metrics"]["plan_pilot_steps_total"]["values"]
               .values()) == 3 * 80
    assert plans["report"]["winner"]


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN = 2, 64


def _requests(cls):
    rng = np.random.RandomState(2)
    return [cls(prompt=rng.randint(0, 256, n).astype(np.int32),
                max_new_tokens=m, req_id=i)
            for i, (n, m) in enumerate(((5, 4), (17, 3), (16, 1), (9, 5)))]


@pytest.fixture(scope="module")
def serving():
    from repro.models.model import model_decls as jax_model_decls
    from repro.parallel.axes import MeshAxes as JMeshAxes
    from repro.parallel.params import materialize as jax_materialize
    jcfg = jax_get_config("chatglm3-6b", smoke=True)
    mesh = jax_local_mesh(1, 1)
    params = jax_materialize(jax_model_decls(
        jcfg, JMeshAxes.from_mesh(mesh)), 5)
    trace = make_trace("poisson", n=16, rate_rps=4.0, seed=1)
    out = {}
    with observed(jobs) as (tr, reg):
        reqs = _requests(JRequest)
        JServeEngine(jcfg, mesh, params, slots=SLOTS,
                     max_len=MAX_LEN).run(reqs, max_steps=200)
        tracker = JSLOTracker(slo_ttft_ms=200.0)
        tracker.observe_all(reqs)
        tracker.report()
        jrouter.route(jrouter.candidate_configs(
            "chatglm3-6b", 8, slots_options=(4,), max_len=128),
            JCalibration(), jax_make_trace("poisson", n=16, rate_rps=4.0,
                                           seed=1), slo_ms=200.0)
        out["jax"] = tr.to_chrome(), reg, reqs
    cfg = with_kernel_backend(get_config("chatglm3-6b", smoke=True), "auto")
    with observed(tobs) as (tr, reg):
        reqs = _requests(Request)
        ServeEngine(cfg, from_jax_params(jax.tree.map(np.asarray, params)),
                    slots=SLOTS, max_len=MAX_LEN, device="cpu").run(
                        reqs, max_steps=200)
        tracker = SLOTracker(slo_ttft_ms=200.0)
        tracker.observe_all(reqs)
        tracker.report()
        trouter.route(trouter.candidate_configs(
            "chatglm3-6b", 8, slots_options=(4,), max_len=128),
            Calibration(), trace, slo_ms=200.0,
            peak_flops=TPU_PEAK_FLOPS)
        out["torch"] = tr.to_chrome(), reg, reqs
    return out


def test_serve_spans_and_metrics_equal_the_references(serving):
    (jdoc, jreg, jreqs), (doc, reg, reqs) = serving["jax"], serving["torch"]
    # (bf16 greedy streams may part at a near tie: the counts hold)
    assert [len(r.out_tokens) for r in reqs] == \
        [len(r.out_tokens) for r in jreqs]
    assert signature(doc) == signature(jdoc)
    assert metric_view(reg) == metric_view(jreg)
    assert 0.0 <= reg.gauge("serve_slo_met_fraction").value() <= 1.0
    spans = collections.Counter(e["name"] for e in tobs.span_events(doc))
    assert spans["serve/route"] == 1
    assert reg.counter("serve_prefill_tokens_total").value() == \
        sum(len(r.prompt) for r in reqs)
    assert reg.counter("serve_decode_tokens_total").value() == sum(
        e["args"]["active"] for e in tobs.span_events(
            doc, name_prefix="serve/decode")) > 0
    assert reg.histogram("serve_ttft_ms").count() == len(reqs)
    assert reg.histogram("serve_tpot_ms").count() == sum(
        len(r.out_tokens) > 1 for r in reqs)


# ---------------------------------------------------------------------------
# 5. the modeled fleet
# ---------------------------------------------------------------------------

def _fleet_fc(mod, cls):
    pol = mod.AutoscalePolicy
    sc = cls("chatglm3-6b", "phantom", dp=1, tp=2, slots=4, max_len=64)
    return mod.FleetConfig(prefill=sc, decode=sc, slo_ms=200.0,
                           prefill_policy=pol(min_replicas=1,
                                              max_replicas=1),
                           decode_policy=pol(min_replicas=1,
                                             max_replicas=2))


def test_fleet_spans_and_metrics_equal_the_references():
    kw = dict(n=300, rate_rps=40.0, prompt_len_range=(4, 48),
              new_tokens_range=(4, 16), seed=3)
    with observed(jobs) as (tr, jreg):
        jrep = jfleet.FleetRouter(_fleet_fc(jfleet, jrouter.ServeConfig),
                                  calib=JCalibration()).run(
                                      jax_make_trace("bursty", **kw))
        jdoc = tr.to_chrome()
    with observed(tobs) as (tr, reg):
        rep = tfleet.FleetRouter(_fleet_fc(tfleet, trouter.ServeConfig),
                                 calib=Calibration(),
                                 peak_flops=TPU_PEAK_FLOPS).run(
                                     make_trace("bursty", **kw))
        doc = tr.to_chrome()
    assert rep["requests"] == jrep["requests"]
    assert signature(doc) == signature(jdoc)
    kinds = {k[1] for k in signature(doc)}
    assert {"fleet/run", "fleet/prefill", "fleet/decode",
            "fleet/transfer"} <= kinds
    assert metric_view(reg) == metric_view(jreg)
    for name in ("fleet_prefill_replicas", "fleet_decode_replicas",
                 "fleet_prefill_queue_depth", "fleet_decode_queue_depth",
                 "serve_slo_met_fraction"):
        assert reg.gauge(name).value() == jreg.gauge(name).value(), name
    assert reg.counter("fleet_migrations_total").value() > 0


# ---------------------------------------------------------------------------
# 6. one merged trace from the ranks
# ---------------------------------------------------------------------------

def test_merged_trace_of_the_ranks(tmp_path, pool):
    steps = 2
    with observed(tobs) as (tr, reg):
        with tr.span("test/ranks", cat="test"):
            ranks = pool.run(torch_ranks.obs_trainer_body, 2, 2,
                             (str(tmp_path), steps))
        doc = tr.to_chrome()
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {r: f"rank {r}" for r in range(4)}
    outer = tobs.span_events(doc, name_prefix="test/ranks")[0]
    for pid in range(4):
        names = collections.Counter(
            e["name"] for e in tobs.span_events(doc) if e["pid"] == pid)
        assert names["train/run"] == 1 and names["train/step"] == steps
        assert names["ckpt/save"] == steps
    for e in tobs.span_events(doc):
        if e["pid"] != 0 or e["name"] != "test/ranks":
            # one origin: every rank's span inside the parent's
            assert outer["ts"] <= e["ts"] <= outer["ts"] + outer["dur"]
    # rank 0 observes: its trip, every rank's capture of the next step
    assert [len(r["trips"]) for r in ranks] == [1, 0, 0, 0]
    assert ranks[0]["trips"][0]["step"] == 0
    assert all(r["captures"] == [f"{tmp_path}/prof"] for r in ranks)
    assert sorted(os.listdir(tmp_path / "prof")) == [
        f"rank{r}.json" for r in range(4)]
    spikes = [e for e in doc["traceEvents"] if e["name"] == "watchdog/spike"]
    assert [e["pid"] for e in spikes] == [0]
    # the exported metrics are rank 0's: one count a step, not four
    assert reg.counter("train_steps_total").value(suite="trainer") == steps
    assert reg.counter("obs_watchdog_trips_total").value(kind="spike") == 1
    # each rank counts its own blocks; together they are the checkpoints
    index = json.loads((tmp_path / "ck" / f"step_{steps:010d}"
                        / "index.json").read_text())
    global_bytes = sum(int(np.prod(rec["shape"]))
                       * (2 if rec["dtype"] == "bfloat16"
                          else np.dtype(rec["dtype"]).itemsize)
                       for rec in index["leaves"].values())
    summed = sum(tobs.MetricsRegistry().absorb(d).counter(
        "ckpt_bytes_total").value() for d in pool.rank_metrics)
    assert summed == steps * global_bytes


# ---------------------------------------------------------------------------
# the launchers' artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launcher", ["serve", "plan"])
def test_launcher_writes_trace_and_metrics(tmp_path, launcher, capsys):
    """``launch/serve.py`` and ``launch/plan.py --no-pilots`` with
    ``--trace-out`` and ``--metrics-out``: each writes both artifacts,
    with the spans and metrics of its path (the serve replay's, the
    plan's ``plan/score`` pass, whose pp plans set the bubble gauge)."""
    from repro_torch.launch import serve as serve_cli
    trace, prom = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    obs = ["--trace-out", trace, "--metrics-out", prom]
    if launcher == "serve":
        rc = serve_cli.main(["--smoke", "--device", "cpu", "--requests",
                             "3", "--new-tokens", "2"] + obs)
        want = {"serve/replay", "serve/prefill", "serve/decode"}
        metric = "serve_decode_tokens_total"
    else:
        rc = plan_cli.main(REF_ARGV + ["--no-pilots", "--device", "cpu",
                                       "--out", str(tmp_path / "p.json")]
                           + obs)
        want = {"plan/calibrate", "plan/enumerate", "plan/score"}
        metric = "pipeline_bubble_fraction{"     # the pp plans' scoring
    assert rc == 0
    names = {e["name"] for e in tobs.span_events(tobs.load_trace(trace))}
    assert want <= names
    if launcher == "plan":
        assert "plan/pilots" not in names
    assert metric in open(prom).read()
    out = capsys.readouterr().out
    assert f"[obs] trace -> {trace}" in out and "[obs] metrics" in out
