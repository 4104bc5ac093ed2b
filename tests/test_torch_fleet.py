"""The port's modeled serving fleet (``repro_torch.serve.fleet``) against
the JAX reference, on the CPU (no card, no engine: pure host logic).

  * the reference's ``tests/test_fleet.py`` cases on the port: the
    autoscaler's decisions, pool planning and the route table's round
    trip, the modeled discrete-event replay (completion, scale events,
    the KV-transfer wire band, idle static power, determinism,
    rejection) and the colocated baseline; its executed case is in
    ``tests/test_torch_fleet_executed.py``;
  * parity: ``kv_cache_token_bytes`` / ``kv_transfer_prediction`` for
    every registered config, smoke and published; ``plan_pools``,
    ``auto_rate_rps`` and ``baseline_config``; the whole modeled
    ``FleetRouter.run`` report (percentiles, scale events, per-pool and
    fleet J/token, the transfer account) and its ledger rows, within
    1e-9 relative, for a phantom overload, the colocated baseline and
    mamba2-smoke.

The port prices at the H100's float32 peak unless told otherwise; every
parity case passes the reference's ``TPU_PEAK_FLOPS``, as
``tests/test_torch_serve_router.py`` does.  The port's ``ServeConfig``
carries two fields the reference's has not (``smoke``,
``kernel_backend``); they are left out of the comparison.
"""
import json

import pytest

from repro.core.energy import TPU_PEAK_FLOPS
from repro.planner.calibration import Calibration as JCalibration
from repro.serve import fleet as jfleet
from repro.serve.router import ServeConfig as JServeConfig
from repro.serve.traffic import make_trace as jax_make_trace
from repro.telemetry import Ledger as JLedger
from repro.telemetry.predict import kv_cache_token_bytes as jax_kv_bytes
from repro.telemetry.predict import \
    kv_transfer_prediction as jax_kv_prediction
from repro_torch.configs.base import _MODULES, get_config
from repro_torch.planner.calibration import Calibration
from repro_torch.serve.fleet import (AutoscalePolicy, Autoscaler, FleetConfig,
                                     FleetRouter, PoolStats, auto_rate_rps,
                                     baseline_config, load_route_table,
                                     plan_pools, write_route_table)
from repro_torch.serve.router import ServeConfig, route, trace_stats
from repro_torch.serve.traffic import make_trace
from repro_torch.telemetry import Ledger
from repro_torch.telemetry.predict import (kv_cache_token_bytes,
                                           kv_transfer_prediction)

ARCH = "chatglm3-6b"
REL = 1e-9
PORT_ONLY = ("smoke", "kernel_backend")


def _sc(impl="phantom", tp=2, slots=4, cls=ServeConfig, **kw):
    return cls(ARCH, impl, dp=1, tp=tp, slots=slots, max_len=64, **kw)


def _fleet_fc(mod=None, cls=ServeConfig, **kw):
    """The reference test's fleet (phantom at tp 2 for both pools),
    built from the port's classes or (``mod``) the reference's."""
    kw.setdefault("prefill", _sc(cls=cls))
    kw.setdefault("decode", _sc(cls=cls))
    kw.setdefault("slo_ms", 200.0)
    pol = mod.AutoscalePolicy if mod else AutoscalePolicy
    kw.setdefault("prefill_policy", pol(min_replicas=1, max_replicas=1))
    kw.setdefault("decode_policy", pol(min_replicas=1, max_replicas=2))
    return (mod.FleetConfig if mod else FleetConfig)(**kw)


def _overload_trace(n=4000, seed=0):
    calib = Calibration()
    probe = make_trace("bursty", n=500, rate_rps=10.0, seed=seed)
    mean_new = trace_stats(probe)["mean_new_tokens"]
    rate = auto_rate_rps(_sc(), calib, mean_new, replicas=1,
                         utilization=0.9)
    return make_trace("bursty", n=n, rate_rps=rate, seed=seed), calib


# ---------------------------------------------------------------------------
# the reference's cases: autoscaler decision logic (pure, no simulation)
# ---------------------------------------------------------------------------

class TestAutoscaler:
    POL = AutoscalePolicy(min_replicas=1, max_replicas=3, cooldown_s=1.0,
                          idle_ticks=2, scale_down_util=0.35)

    def _busy(self, depth=40, n=1):
        return PoolStats(queue_depth=depth, n_active=n, n_warming=0,
                         service_s_per_item=0.05, busy_fraction=1.0)

    def _idle(self, n=2):
        return PoolStats(queue_depth=0, n_active=n, n_warming=0,
                         service_s_per_item=0.05, busy_fraction=0.0)

    def test_scales_up_on_deep_queue(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        # 40 items * 50ms / 1 replica = 2s wait >> 0.7 * 200ms budget
        assert sc.evaluate(0.0, self._busy()) == "up"
        assert sc.events[-1].action == "up"
        assert sc.events[-1].replicas == 2

    def test_cooldown_blocks_consecutive_decisions(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        assert sc.evaluate(0.0, self._busy()) == "up"
        assert sc.evaluate(0.5, self._busy(n=2)) is None
        assert sc.evaluate(1.5, self._busy(n=2)) == "up"

    def test_up_clamped_at_max(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        assert sc.evaluate(0.0, self._busy(n=3)) is None

    def test_warming_counts_as_capacity(self):
        """A replica already ordered suppresses the next scale-up (no
        thundering herd while one is warming)."""
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        st = PoolStats(queue_depth=4, n_active=1, n_warming=1,
                       service_s_per_item=0.05, busy_fraction=1.0)
        # 4 * 50ms / 2 = 100ms < 140ms budget
        assert sc.evaluate(0.0, st) is None

    def test_scales_down_after_idle_ticks(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        assert sc.evaluate(0.0, self._idle()) is None
        assert sc.evaluate(2.0, self._idle()) == "down"
        assert sc.events[-1].replicas == 1

    def test_down_clamped_at_min(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        for t in range(10):
            assert sc.evaluate(float(2 * t), self._idle(n=1)) is None

    def test_busy_tick_resets_idle_streak(self):
        sc = Autoscaler(self.POL, pool="decode", slo_ms=200.0)
        assert sc.evaluate(0.0, self._idle()) is None
        st = PoolStats(queue_depth=0, n_active=2, n_warming=0,
                       service_s_per_item=0.05, busy_fraction=0.9)
        assert sc.evaluate(2.0, st) is None      # streak broken
        assert sc.evaluate(4.0, self._idle()) is None  # streak = 1 again

    def test_no_slo_uses_default_wait_budget(self):
        sc = Autoscaler(self.POL, pool="prefill", slo_ms=0.0)
        # est wait 2s > default 0.5s budget
        assert sc.evaluate(0.0, self._busy()) == "up"


# ---------------------------------------------------------------------------
# the reference's cases: pool planning + route table
# ---------------------------------------------------------------------------

class TestPlanPools:
    def test_plans_dp1_pools(self):
        trace = make_trace("poisson", n=64, seed=0)
        pre, dec, notes = plan_pools(ARCH, 8, Calibration(), trace,
                                     slo_ms=200.0)
        assert pre.dp == 1 and dec.dp == 1
        assert notes["source"] == "priced"
        assert notes["candidates"] > 0
        assert notes["decode"]["j_per_token"] > 0

    def test_route_table_round_trip(self, tmp_path):
        trace = make_trace("poisson", n=64, seed=0)
        calib = Calibration()
        stats = trace_stats(trace)
        configs = [_sc("tensor"), _sc("phantom")]
        winner, priced = route(configs, calib, trace, slo_ms=200.0)
        path = str(tmp_path / "route.json")
        block = write_route_table(path, ARCH, winner, priced,
                                  calibration=calib.source,
                                  stats=stats, slo_ms=200.0)
        assert block["schema"] == "serve-route/v1"
        loaded = load_route_table(path)
        assert loaded == json.load(open(path))
        pre, dec, notes = plan_pools(ARCH, 8, calib, trace,
                                     slo_ms=200.0, route_table=loaded)
        assert notes["source"] == "route-table"
        assert notes["candidates"] == len(priced)
        assert pre.dp == 1 and dec.dp == 1

    def test_missing_route_table_is_none(self, tmp_path):
        assert load_route_table(str(tmp_path / "nope.json")) is None
        assert load_route_table("") is None

    def test_wrong_schema_fails_loudly(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text('{"schema": "other/v9"}')
        with pytest.raises(ValueError, match="serve-route/v1"):
            load_route_table(str(path))

    def test_mismatched_arch_falls_back_to_pricing(self):
        trace = make_trace("poisson", n=64, seed=0)
        table = {"schema": "serve-route/v1", "arch": "other-model",
                 "candidates": [{"config": {}}]}
        _, _, notes = plan_pools(ARCH, 8, Calibration(), trace,
                                 route_table=table)
        assert notes["source"] == "priced"

    def test_baseline_config_is_full_node_tensor(self):
        sc = baseline_config(ARCH, 8)
        assert sc.impl == "tensor" and sc.dp == 1
        assert sc.tp in (8, 4, 2) and sc.devices == sc.tp

    def test_auto_rate_scales_with_replicas(self):
        calib = Calibration()
        r1 = auto_rate_rps(_sc(), calib, 14.0, replicas=1)
        r2 = auto_rate_rps(_sc(), calib, 14.0, replicas=2)
        assert r1 > 0
        assert r2 == pytest.approx(2 * r1)


# ---------------------------------------------------------------------------
# the reference's cases: the modeled discrete-event replay
# ---------------------------------------------------------------------------

class TestModeledFleet:
    @pytest.fixture(scope="class")
    def run(self):
        trace, calib = _overload_trace()
        router = FleetRouter(_fleet_fc(), calib=calib)
        return router, router.run(trace), trace

    def test_completes_all_admitted(self, run):
        _, rep, trace = run
        req = rep["requests"]
        assert rep["mode"] == "modeled"
        assert req["trace"] == len(trace)
        assert req["finished"] == req["trace"] - req["rejected"]
        assert rep["slo"]["generated_tokens"] > 0

    def test_scales_up_and_down(self, run):
        _, rep, _ = run
        assert rep["scale_ups"] >= 1
        assert rep["scale_downs"] >= 1
        assert rep["pools"]["decode"]["replicas_peak"] >= 2
        for ev in rep["scale_events"]:
            assert ev["pool"] in ("prefill", "decode")
            assert ev["action"] in ("up", "down")

    def test_transfer_wire_band(self, run):
        _, rep, _ = run
        x = rep["transfer"]
        assert x["measured"]["migrations"] > 0
        assert 0.9 <= x["ratio_wire_bytes"] <= 1.1
        assert x["ratio_migrations"] == pytest.approx(1.0)

    def test_idle_static_power_billed(self, run):
        """Every powered device-second not spent stepping is billed at
        B watts: what makes over-provisioning visible in J/token."""
        _, rep, _ = run
        for phase in ("prefill", "decode"):
            p = rep["pools"][phase]
            assert p["device_s"] > 0
            assert p["idle_j"] >= 0
            assert p["j_per_token"] > 0
        j = rep["j_per_token"]
        assert j["fleet"] == pytest.approx(
            j["prefill"] + j["decode"] + j["transfer"])

    def test_deterministic_replay(self):
        trace, calib = _overload_trace(n=1500)
        a = FleetRouter(_fleet_fc(), calib=calib).run(trace)
        b = FleetRouter(_fleet_fc(), calib=calib).run(trace)
        assert json.dumps(a, sort_keys=True) == \
            json.dumps(b, sort_keys=True)

    def test_oversize_requests_rejected(self):
        trace = make_trace("poisson", n=32, prompt_len_range=(60, 80),
                           new_tokens_range=(8, 16), seed=1)
        calib = Calibration()
        rep = FleetRouter(_fleet_fc(), calib=calib).run(trace)
        # padded prompt + new tokens can't fit max_len=64
        assert rep["requests"]["rejected"] > 0


# ---------------------------------------------------------------------------
# the reference's cases: the colocated single-engine baseline
# ---------------------------------------------------------------------------

class TestColocatedBaseline:
    @pytest.fixture(scope="class")
    def run(self):
        trace, calib = _overload_trace(n=1500)
        fc = FleetConfig(prefill=baseline_config(ARCH, 8),
                         decode=baseline_config(ARCH, 8),
                         slo_ms=200.0, colocated=True,
                         decode_replicas=1)
        return FleetRouter(fc, calib=calib).run(trace)

    def test_transfer_is_free(self, run):
        """Colocated hand-offs are slot splices, not wire events: they
        are counted but carry zero bytes and zero joules."""
        x = run["transfer"]
        assert x["measured"]["migrations"] > 0
        assert x["measured"]["transfer_wire_bytes"] == 0
        assert x["measured"]["energy_j"] == 0.0
        assert run["j_per_token"]["transfer"] == 0.0

    def test_never_scales(self, run):
        assert run["scale_events"] == []
        assert run["pools"]["decode"]["replicas_peak"] == 1

    def test_prefill_runs_on_decode_replicas(self, run):
        pre = run["pools"]["prefill"]
        assert pre["replicas_final"] == 0      # counters only
        assert pre["steps"] > 0                # ...but work was billed
        assert pre["device_s"] == 0.0          # no devices of its own

    def test_executed_colocated_unsupported(self):
        fc = FleetConfig(prefill=_sc(), decode=_sc(), executed=True,
                         colocated=True)
        with pytest.raises(NotImplementedError):
            FleetRouter(fc, calib=Calibration())


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _same(a, b, path="report"):
    """Equal trees: numbers within ``REL`` relative, the port's extra
    ServeConfig fields left out."""
    if isinstance(a, dict):
        a = {k: v for k, v in a.items() if k not in PORT_ONLY}
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=0.0), path
    else:
        assert a == b, path


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_kv_bytes_and_transfer_prediction_equal_reference(arch, smoke):
    """Per-token and per-sequence cache bytes from the port's decls
    equal the reference's (the paper FFN, with no LM stack, migrates
    none), and so does the transfer prediction built on them."""
    from repro.configs.base import get_config as jax_get_config
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                              smoke=smoke)
    assert kv_cache_token_bytes(cfg) == jax_kv_bytes(jcfg)
    for tps, fits in (((1, 1), None), ((2, 4), {"collective_permute":
                                                (10.0, 1e-3)})):
        kw = dict(tp_src=tps[0], tp_dst=tps[1], fits=fits)
        _same(kv_transfer_prediction(cfg, 37, 29.5, **kw),
              jax_kv_prediction(jcfg, 37, 29.5, **kw))


@pytest.mark.parametrize("slo", [0.0, 5.0, 200.0])
@pytest.mark.parametrize("devices", [2, 8])
def test_plan_pools_equal_reference(devices, slo, tmp_path):
    kw = dict(n=64, prompt_len_range=(4, 48), new_tokens_range=(4, 16),
              seed=0)
    trace, jtrace = make_trace("poisson", **kw), jax_make_trace("poisson",
                                                               **kw)
    pre, dec, notes = plan_pools(ARCH, devices, Calibration(), trace,
                                 slo_ms=slo, max_len=128,
                                 peak_flops=TPU_PEAK_FLOPS)
    jpre, jdec, jnotes = jfleet.plan_pools(ARCH, devices, JCalibration(),
                                           jtrace, slo_ms=slo, max_len=128)
    assert (pre.name, dec.name) == (jpre.name, jdec.name)
    _same(notes, jnotes)
    # the same table read back from a route-table file written by the
    # reference plans the same pools
    winner, priced = jax_route(jtrace, devices, slo)
    path = str(tmp_path / "route.json")
    jfleet.write_route_table(path, ARCH, winner, priced, slo_ms=slo)
    table = load_route_table(path)
    a = plan_pools(ARCH, devices, Calibration(), trace, slo_ms=slo,
                   route_table=table)
    b = jfleet.plan_pools(ARCH, devices, JCalibration(), jtrace,
                          slo_ms=slo, route_table=table)
    assert (a[0].name, a[1].name) == (b[0].name, b[1].name)
    _same(a[2], b[2])


def jax_route(jtrace, devices, slo):
    from repro.serve.router import candidate_configs, route as jroute
    return jroute(candidate_configs(ARCH, devices, slots_options=(4,),
                                    max_len=128), JCalibration(), jtrace,
                  slo_ms=slo)


@pytest.mark.parametrize("utilization", [0.6, 0.9])
@pytest.mark.parametrize("impl,tp", [("tensor", 4), ("phantom", 2)])
def test_auto_rate_and_baseline_equal_reference(impl, tp, utilization):
    rate = auto_rate_rps(_sc(impl, tp), Calibration(), 11.5, replicas=3,
                         utilization=utilization, peak_flops=TPU_PEAK_FLOPS)
    jrate = jfleet.auto_rate_rps(_sc(impl, tp, cls=JServeConfig),
                                 JCalibration(), 11.5, replicas=3,
                                 utilization=utilization)
    assert rate == pytest.approx(jrate, rel=REL)
    for devices in (1, 2, 8, 16):
        for arch in (ARCH, "mamba2-370m", "olmoe-1b-7b"):
            assert baseline_config(arch, devices).name == \
                jfleet.baseline_config(arch, devices).name


def _fleets(kind):
    """(port FleetConfig, reference FleetConfig, trace kwargs) of one
    parity fleet."""
    if kind == "phantom_overload":
        return (_fleet_fc(), _fleet_fc(jfleet, JServeConfig),
                dict(kind="bursty", n=3000, util=0.9))
    if kind == "colocated":
        kw = dict(slo_ms=200.0, colocated=True, decode_replicas=2)
        return (FleetConfig(prefill=baseline_config(ARCH, 8),
                            decode=baseline_config(ARCH, 8), **kw),
                jfleet.FleetConfig(prefill=jfleet.baseline_config(ARCH, 8),
                                   decode=jfleet.baseline_config(ARCH, 8),
                                   **kw),
                dict(kind="bursty", n=1500, util=0.9))
    # mamba2-smoke: exact-length refill groups (prompts a multiple of
    # the page admit; the rest are rejected), tensor prefill at tp 2 and
    # phantom decode at tp 4
    def fc(mod, cls):
        pol = mod.AutoscalePolicy
        return mod.FleetConfig(
            prefill=cls("mamba2-370m", "tensor", 1, 2, 4, max_len=64,
                        page_size=4),
            decode=cls("mamba2-370m", "phantom", 1, 4, 4, max_len=64,
                       page_size=4),
            slo_ms=50.0, prefill_policy=pol(max_replicas=3),
            decode_policy=pol(max_replicas=3))
    from repro.serve import fleet as jmod
    from repro_torch.serve import fleet as mod
    return (fc(mod, ServeConfig), fc(jmod, JServeConfig),
            dict(kind="poisson", n=2000, util=1.5))


@pytest.mark.parametrize("kind", ["phantom_overload", "colocated",
                                  "mamba2_smoke"])
def test_modeled_report_and_ledger_equal_reference(kind, tmp_path):
    """The whole modeled report (SLO percentiles, scale events, pools,
    J/token, the transfer account) and the ledger rows it records equal
    the reference's on the same trace, within 1e-9 relative."""
    fc, jfc, tr = _fleets(kind)
    calib, jcalib = Calibration(), JCalibration()
    rate = auto_rate_rps(fc.decode, calib, 10.0, utilization=tr["util"],
                         peak_flops=TPU_PEAK_FLOPS)
    kw = dict(n=tr["n"], rate_rps=rate, prompt_len_range=(4, 48),
              new_tokens_range=(4, 16), seed=3)
    ledger, jledger = Ledger(), JLedger()
    rep = FleetRouter(fc, calib=calib, ledger=ledger,
                      peak_flops=TPU_PEAK_FLOPS).run(
                          make_trace(tr["kind"], **kw))
    jrep = jfleet.FleetRouter(jfc, calib=jcalib, ledger=jledger).run(
        jax_make_trace(tr["kind"], **kw))
    assert rep["requests"]["finished"] > 0
    if kind == "phantom_overload":
        assert rep["scale_ups"] >= 1
    _same(rep, jrep)
    _same([e.as_dict() for e in ledger.entries],
          [e.as_dict() for e in jledger.entries], "ledger")
