"""The port's ``obs/`` (tracer, metrics, energy-drift watchdog) and its
``launch/obs.py`` against the reference's, on the CPU in one process.

Every case of the reference's ``tests/test_obs.py`` (tracer, metrics,
watchdog, CLI) runs through both packages on the same manual clock and
inputs: the Chrome trace JSON byte for byte, the Prometheus text equal,
the JSONL snapshots equal apart from ``unix_time``, the watchdog's trips,
``summary()`` and anomaly rows equal over the reference's spike, drift,
cooldown and self-baseline sequences.  Then what ranks as processes add:
``dump``/``absorb``, the merge under ``pid = rank`` on a shared origin,
and ``capture`` through ``torch.profiler`` (monkeypatched, then for real
on the CPU)."""
import json
import threading

import pytest
import torch

import repro.launch.obs as jax_obs_cli
import repro.obs as jax_obs
import repro.telemetry as jax_tel
import repro_torch.launch.obs as torch_obs_cli
import repro_torch.obs as torch_obs
import repro_torch.telemetry as torch_tel
from repro_torch.obs import ranks as obs_ranks

PKGS = {"jax": (jax_obs, jax_tel, jax_obs_cli),
        "torch": (torch_obs, torch_tel, torch_obs_cli)}


class ManualClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(build):
    """``build(obs, telemetry)`` through both packages."""
    return {k: build(obs, tel) for k, (obs, tel, _) in PKGS.items()}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _golden(obs, tel):
    clk = ManualClock()
    tr = obs.Tracer(clock=clk, meta={"run": "test"})
    with tr.span("plan/calibrate", cat="plan", source="paper"):
        clk.advance(0.25)
    sp = tr.begin("train/run", cat="train")
    clk.advance(0.5)
    with tr.span("train/step", cat="train", step=0):
        clk.advance(0.125)
    tr.instant("fault/straggler", cat="fault", step=0)
    tr.end(sp.annotate(final_step=1))
    return tr


def _unclosed(obs, tel):
    clk = ManualClock()
    tr = obs.Tracer(clock=clk)
    tr.begin("train/run", cat="train")
    clk.advance(1.0)
    return tr


def _linked(obs, tel):
    tr = obs.Tracer(clock=ManualClock())
    entry = tel.LedgerEntry(
        name="train_smoke_phantom", suite="train", kind="train",
        measured={"wall_us_median": 123.0, "total_s": 0.5, "calls": 4},
        predicted={"energy_j_per_iter": 1.5})
    with tr.span("train/run", cat="train") as sp:
        sp.link_ledger(entry)
    return tr


def _threaded(obs, tel):
    tr = obs.Tracer(clock=ManualClock())
    with tr.span("main/work"):
        t = threading.Thread(
            target=lambda: tr.end(tr.begin("ckpt/save", cat="ckpt")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    return tr


@pytest.mark.parametrize("build", [_golden, _unclosed, _linked, _threaded])
def test_trace_document_is_the_references_byte_for_byte(build):
    docs = both(lambda obs, tel: json.dumps(build(obs, tel).to_chrome()))
    assert docs["torch"] == docs["jax"]


def test_trace_golden_schema():
    """The reference's golden assertions, on the port."""
    doc = _golden(torch_obs, torch_tel).to_chrome()
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        _golden(torch_obs, torch_tel).to_chrome(), sort_keys=True)
    assert doc["otherData"]["schema"] == torch_obs.TRACE_SCHEMA
    evs = doc["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    cal = spans["plan/calibrate"]
    assert cal["ts"] == 0.0 and cal["dur"] == 250_000.0
    assert cal["args"]["span_id"] == "s000000"
    assert spans["train/run"]["args"]["span_id"] == "s000001"
    assert spans["train/step"]["args"]["span_id"] == "s000002"
    assert spans["train/run"]["dur"] == 625_000.0
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(inst) == 1 and inst[0]["s"] == "t"
    unclosed = torch_obs.span_events(_unclosed(torch_obs, None).to_chrome())
    assert unclosed[0]["args"]["unclosed"] is True
    link = torch_obs.span_events(_linked(torch_obs, torch_tel).to_chrome(
        ))[0]["args"]["ledger"]
    assert link["entry"] == "train_smoke_phantom"
    assert link["predicted_energy_j_per_iter"] == 1.5
    tids = {e["name"]: e["tid"] for e in torch_obs.span_events(
        _threaded(torch_obs, None).to_chrome())}
    assert tids == {"main/work": 0, "ckpt/save": 1}


def test_null_tracer_and_set_tracer():
    tr = torch_obs.Tracer(enabled=False)
    sp = tr.begin("x")
    sp.annotate(a=1).link_ledger(None)
    tr.end(sp)
    tr.instant("y")
    with tr.span("z"):
        pass
    assert len(tr) == 0
    assert torch_obs.get_tracer() is torch_obs.NULL_TRACER
    mine = torch_obs.Tracer()
    prev = torch_obs.set_tracer(mine)
    try:
        assert torch_obs.get_tracer() is mine
    finally:
        torch_obs.set_tracer(prev)
    assert torch_obs.get_tracer() is not mine
    with torch_obs.use_tracer(mine):
        assert torch_obs.get_tracer() is mine
    assert torch_obs.get_tracer() is torch_obs.NULL_TRACER


def test_trace_write_load_roundtrip(tmp_path):
    paths = {}
    for name, (obs, tel, _) in PKGS.items():
        paths[name] = _golden(obs, tel).write(str(tmp_path / f"{name}.json"))
    assert open(paths["torch"]).read() == open(paths["jax"]).read()
    doc = torch_obs.load_trace(paths["torch"])
    assert torch_obs.span_events(doc, cat="train", name_prefix="train/")
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    with pytest.raises(ValueError):
        torch_obs.load_trace(str(bad))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("train_steps_total", "steps run").inc(3, suite="elastic")
    reg.gauge("pipeline_bubble_fraction").set(0.25, stages="2")
    h = reg.histogram("step_seconds", "step wall", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.counter("serve_prefill_tokens_total").inc(64, arch="ffn")
    reg.histogram("ttft_ms", buckets=(1, 10)).observe(3.0, arch="ffn")
    return reg


def test_prometheus_text_equals_the_references():
    text = {k: _registry(obs).to_prometheus()
            for k, (obs, _, _) in PKGS.items()}
    assert text["torch"] == text["jax"]
    assert ('step_seconds_bucket{le="+Inf"} 3\nstep_seconds_sum 5.55\n'
            in text["torch"])


def test_jsonl_snapshots_equal_but_for_unix_time(tmp_path):
    snaps = {}
    for name, (obs, _, _) in PKGS.items():
        p = str(tmp_path / f"{name}.jsonl")
        reg = _registry(obs)
        reg.write(p, meta={"run": "t"})
        reg.write(p)
        snaps[name] = [json.loads(ln) for ln in open(p)]
        for s in snaps[name]:
            assert s["meta"].pop("unix_time") > 0
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"][0]["schema"] == torch_obs.SNAPSHOT_SCHEMA


def test_registration_idempotent_and_kind_checked():
    reg = torch_obs.MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        a.inc(-1)
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=())


def test_metrics_concurrent_updates_are_exact():
    reg = torch_obs.MetricsRegistry()
    c = reg.counter("n_total")
    h = reg.histogram("v", buckets=(0.5,))

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(0.1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert c.value() == 8000 and h.count() == 8000


def test_dump_absorb_adds_counters_and_histograms():
    """A rank's ``dump`` absorbed into an empty registry exports what the
    rank's own registry does; absorbed twice, counters and histograms
    add and a gauge keeps the value."""
    rank = _registry(torch_obs)
    once = torch_obs.MetricsRegistry().absorb(rank.dump())
    assert once.to_prometheus() == rank.to_prometheus()
    twice = torch_obs.MetricsRegistry().absorb(rank.dump()).absorb(
        rank.dump())
    assert twice.counter("train_steps_total").value(suite="elastic") == 6
    assert twice.histogram("step_seconds").count() == 6
    assert twice.histogram("step_seconds").sum() == 2 * 5.55
    assert twice.gauge("pipeline_bubble_fraction").value(stages="2") == 0.25


# ---------------------------------------------------------------------------
# ranks as processes: the merge
# ---------------------------------------------------------------------------

def test_ranks_merge_under_their_pids_on_one_origin():
    """``observed`` in two 'ranks' on the parent's origin, then ``merge``:
    each rank's spans under ``pid = rank`` with ``rank r`` process names,
    timestamps from the shared origin, per-rank span ids, rank 0's
    metrics added to the parent's registry."""
    parent = torch_obs.Tracer(meta={"run": "t"})
    reg = torch_obs.MetricsRegistry()

    def body(rank):
        with torch_obs.get_tracer().span("train/step", cat="train",
                                         rank=rank):
            torch_obs.get_metrics().counter("train_steps_total").inc(
                1 + rank)
        return rank * 10

    prev_m = torch_obs.set_metrics(reg)
    try:
        with torch_obs.use_tracer(parent):
            with parent.span("train/run", cat="train"):
                spec = obs_ranks.rank_spec()
                assert spec["origin"] == parent.origin
                outs = [obs_ranks.observed(body, spec, r) for r in (0, 1)]
                obs_ranks.merge([seen for _, seen in outs])
    finally:
        torch_obs.set_metrics(prev_m)
    assert [o for o, _ in outs] == [0, 10]
    doc = parent.to_chrome()
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {0: "rank 0", 1: "rank 1"}
    steps = sorted((e["pid"], e["args"]["span_id"])
                   for e in torch_obs.span_events(doc, name_prefix=
                                                  "train/step"))
    assert steps == [(0, "s000000"), (1, "s000000")]
    run = torch_obs.span_events(doc, name_prefix="train/run")[0]
    for e in torch_obs.span_events(doc, name_prefix="train/step"):
        assert run["ts"] <= e["ts"] <= run["ts"] + run["dur"]
    assert reg.counter("train_steps_total").value() == 1
    # without a tracer the ranks record no events, and still metrics
    out, seen = obs_ranks.observed(body, obs_ranks.rank_spec(), 3)
    assert seen["trace"] == [] and out == 30
    assert torch_obs.MetricsRegistry().absorb(seen["metrics"]).counter(
        "train_steps_total").value() == 4


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def _spike(wd):
    for step in range(5):
        wd.observe(step, 0.1)
    return [wd.observe(5, 0.65)]


def _drift(wd):
    for step in range(8):
        wd.observe(step, 0.1)
    return [wd.observe(step, 0.26) for step in range(8, 16)]


def _cooldown(wd):
    return [wd.observe(step, 1.0) for step in range(20)]


def _baseline(wd):
    return [wd.observe(step, 0.2) for step in range(3)] + [wd.observe(3, 1.0)]


def _clean(wd):
    return [wd.observe(step, 0.1 + 0.01 * (step % 3)) for step in range(50)]


SEQUENCES = {
    "spike": (dict(predicted_s=0.1, name="wd", profile_dir="/tmp/none"),
              _spike),
    "drift": (dict(predicted_s=0.1, window=4), _drift),
    "cooldown": (dict(predicted_s=0.1, cooldown=5), _cooldown),
    "self_baseline": (dict(min_samples=3), _baseline),
    "clean": (dict(predicted_s=0.1), _clean),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_watchdog_trips_equal_the_references(case):
    kw, seq = SEQUENCES[case]
    got = {}
    for name, (obs, tel, _) in PKGS.items():
        ledger = tel.Ledger(run="t")
        reg, prev = obs.MetricsRegistry(), None
        prev = obs.set_metrics(reg)
        try:
            wd = obs.EnergyDriftWatchdog(ledger=ledger, **kw)
            events = [e.as_dict() if e else None for e in seq(wd)]
        finally:
            obs.set_metrics(prev)
        got[name] = {"events": events,
                     "trips": [t.as_dict() for t in wd.trips],
                     "summary": wd.summary(),
                     "pending": wd.capture_pending(),
                     "rows": [e.as_dict() for e in ledger.entries],
                     "metrics": reg.to_prometheus()}
    assert got["torch"] == got["jax"]
    trips = got["torch"]["trips"]
    if case == "clean":
        assert trips == [] and got["torch"]["summary"]["observations"] == 50
    elif case == "drift":
        assert [t["kind"] for t in trips] == ["drift"]
    elif case == "cooldown":
        assert 1 <= len(trips) <= 4
    else:
        assert [t["kind"] for t in trips] == ["spike"]
    if case == "spike":
        assert got["torch"]["pending"]
        assert got["torch"]["rows"][0]["extra"]["event"] == "watchdog_spike"


class _FakeProfile:
    calls = []

    def __init__(self, activities):
        self.calls.append(("init", tuple(activities)))

    def start(self):
        self.calls.append(("start",))

    def stop(self):
        self.calls.append(("stop",))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))


def _armed(tmp_path, **kw):
    wd = torch_obs.EnergyDriftWatchdog(predicted_s=0.1,
                                       profile_dir=str(tmp_path / "prof"),
                                       **kw)
    assert wd.capture(lambda: 7) == 7            # not armed: plain call
    for step in range(5):
        wd.observe(step, 0.1)
    wd.observe(5, 1.0)                           # trip arms the capture
    assert wd.capture_pending()
    return wd


def test_watchdog_capture_oneshot(monkeypatch, tmp_path):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    tr = torch_obs.Tracer()
    with torch_obs.use_tracer(tr):
        wd = _armed(tmp_path, rank=3)
        assert wd.capture(lambda x: x + 1, 1) == 2
        assert not wd.capture_pending()          # one-shot
        assert wd.capture(lambda: 5) == 5
    prof = str(tmp_path / "prof")
    assert _FakeProfile.calls == [
        ("init", (torch.profiler.ProfilerActivity.CPU,)), ("start",),
        ("stop",), ("export", f"{prof}/rank3.json")]
    assert wd.captures == [prof]
    names = [e["name"] for e in tr.events() if e["ph"] == "i"]
    assert names == ["watchdog/spike", "watchdog/capture"]
    # rank 0's decision carried to another rank's watchdog
    other = torch_obs.EnergyDriftWatchdog(profile_dir=prof)
    other.set_capture_pending(True)
    assert other.capture_pending()
    torch_obs.EnergyDriftWatchdog().set_capture_pending(True)


def test_watchdog_capture_failure_never_breaks_the_step(monkeypatch,
                                                        tmp_path):
    def broken(activities):
        raise RuntimeError("profiler busy")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    tr = torch_obs.Tracer()
    with torch_obs.use_tracer(tr):
        wd = _armed(tmp_path)
        assert wd.capture(lambda: 3) == 3
    assert wd.captures == []
    fails = [e for e in tr.events() if e["name"] == "watchdog/capture_failed"]
    assert fails and "profiler busy" in fails[0]["args"]["error"]


def test_watchdog_capture_writes_a_torch_profiler_trace(tmp_path):
    """For real on the CPU: the armed step's ops land in rank0.json."""
    wd = _armed(tmp_path)
    a = torch.randn(64, 64)
    out = wd.capture(torch.mm, a, a)
    assert torch.equal(out, a @ a)
    doc = json.loads((tmp_path / "prof" / "rank0.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    assert wd.captures == [str(tmp_path / "prof")]


# ---------------------------------------------------------------------------
# the obs CLI
# ---------------------------------------------------------------------------

def _recovery_fixture(obs, path, *, replan_s=0.2, restore_s=0.3,
                      compile_s=1.5, span_scale=1.0):
    clk = ManualClock()
    tr = obs.Tracer(clock=clk)
    for name, secs in (("elastic/compile", compile_s),
                       ("elastic/replan", replan_s),
                       ("elastic/restore", restore_s)):
        with tr.span(name, cat="elastic"):
            clk.advance(secs * span_scale)
    trace = str(path / "trace.json")
    tr.write(trace)
    report = str(path / "report.json")
    with open(report, "w") as f:
        json.dump({"entries": [
            {"name": "elastic_run", "kind": "elastic",
             "extra": {"recovery": {
                 "schema": "recovery-account/v1",
                 "replan_s": replan_s, "restore_s": restore_s,
                 "compile_s": compile_s}}}]}, f)
    return trace, report


@pytest.mark.parametrize("kw,rc", [({}, 0), ({"span_scale": 2.0}, 1),
                                   ({"replan_s": 0.0, "restore_s": 0.0,
                                     "compile_s": 0.8}, 0)])
def test_verify_recovery_equals_the_references(tmp_path, capsys, kw, rc):
    out = {}
    for name, (obs, _, cli) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        trace, report = _recovery_fixture(obs, d, **kw)
        assert cli.main(["verify-recovery", "--trace", trace,
                         "--report", report]) == rc
        cap = capsys.readouterr()
        out[name] = (cap.out, cap.err)
    assert out["torch"] == out["jax"]
    assert ("OK" in out["torch"][0]) == (rc == 0)
    assert torch_obs_cli.RECOVERY_SPANS == jax_obs_cli.RECOVERY_SPANS


def test_summary_and_metrics_equal_the_references(tmp_path, capsys):
    out = {}
    for name, (obs, _, cli) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        trace, _ = _recovery_fixture(obs, d)
        assert cli.main(["summary", "--trace", trace]) == 0
        summary = capsys.readouterr().out.replace(trace, "T")
        reg = obs.MetricsRegistry()
        reg.counter("a_total").inc()
        texts = []
        for ext in ("jsonl", "prom"):
            p = str(d / f"m.{ext}")
            reg.write(p)
            assert cli.main(["metrics", p]) == 0
            cap = capsys.readouterr()
            texts.append((cap.out.replace(p, "P"), cap.err.replace(p, "P")))
        out[name] = (summary, texts)
    assert out["torch"] == out["jax"]
    assert "elastic" in out["torch"][0] and "3 spans" in out["torch"][0]
    assert "a_total 1" in out["torch"][1][1][0]


def test_obs_session_writes_both_artifacts(tmp_path, capsys):
    trace, prom = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    with torch_obs_cli.obs_session(trace, prom, meta={"run": "t"}) as tr:
        with torch_obs.get_tracer().span("plan/score", cat="plan"):
            torch_obs.get_metrics().counter("x_total").inc()
    assert torch_obs.get_tracer() is torch_obs.NULL_TRACER
    doc = torch_obs.load_trace(trace)
    assert doc["otherData"] == {"run": "t", "schema": "chrome-trace-event"}
    assert [e["name"] for e in torch_obs.span_events(doc)] == ["plan/score"]
    assert "x_total 1" in open(prom).read()
    assert tr is not None and "[obs] trace ->" in capsys.readouterr().out
