"""The port's executed serving fleet on the CPU: real engines behind the
fleet's discrete-event loop, KV pages migrated through
``ServeEngine.adopt``.

  * ``adopt`` leaves exactly the state ``_prefill_group`` leaves (the
    cache bit for bit, ``pos``, ``last_tok``, the page table, the first
    tokens) when the fleet's prefill pool made the bundles: at tp 1 here
    (chatglm3-smoke in bf16 and float32, mamba2-smoke's exact-length
    group) and at tp 2 on gloo ranks (the tp relayout of the prefill's
    sequence shards); each bundle's wire bytes are the request's global
    rows, as ``kv_cache_token_bytes`` counts them;
  * the reference's executed case (``tests/test_fleet.py``): the
    fleet's greedy streams equal a plain ``ServeEngine`` replay of the
    same trace on the same weights, here at dp 1 x tp 2 on gloo ranks
    (tensor sites in float32, and phantom MLP sites), and at tp 1;
  * the fleet against the reference's executed fleet at tp 1 on the
    reference's weights (carried with ``from_jax_params``), float32 on
    both sides: the same streams and the same measured wire bytes;
  * the engine skips its clock agreement at ``clock_scale = 0``;
    executed pools on different meshes raise, naming ROADMAP.md queue 1
    item 7; ``price_counted`` (the reference's ``price_hlo``) prices the
    executed pools' counted steps.

The 2 ranks run in a thread while the reference compiles and runs here.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.params import materialize as jax_materialize
from repro.planner.calibration import Calibration as JCalibration
from repro.serve import fleet as jfleet
from repro.serve.router import ServeConfig as JServeConfig
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, materialize,
                                         tree_map)
from repro_torch.planner.calibration import Calibration
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import (AutoscalePolicy, FleetConfig,
                                     FleetRouter)
from repro_torch.serve.router import ServeConfig
from repro_torch.serve.traffic import make_trace, replay, trace_requests
from repro_torch.telemetry import Ledger
from repro_torch.telemetry.predict import kv_cache_token_bytes

import torch_ranks

ARCH = "chatglm3-6b"
TP = 2
POLICY = AutoscalePolicy(min_replicas=1, max_replicas=1)
# the reference test's trace
TRACE = dict(kind="poisson", n=8, rate_rps=50.0, prompt_len_range=(4, 24),
             new_tokens_range=(3, 8), seed=0)
# one refill group of the bucket 16: exact-length and padded prompts
ADOPT_LENS, ADOPT_S = (16, 9, 12, 16), 16


def _sc(impl="tensor", tp=1, **kw):
    return ServeConfig(ARCH, impl, dp=1, tp=tp, slots=4, max_len=64, k=4,
                       **kw)


def _fc(sc, **kw):
    return FleetConfig(prefill=sc, decode=sc, slo_ms=200.0, executed=True,
                       prefill_policy=POLICY, decode_policy=POLICY, **kw)


def _draw(cfg, tp=1):
    """Global parameters of ``cfg`` declared for ``tp`` model ranks (a
    phantom site's factors depend on it) from the port's host draw, as
    numpy."""
    return tree_map(lambda t: t.numpy(), materialize(
        model_decls(cfg, MeshAxes(tp=tp)), torch.Generator().manual_seed(0),
        "cpu"))


def _prompts(cfg, lens):
    rng = np.random.RandomState(5)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _plain_streams(cfg, params, trace, sc):
    eng = ServeEngine(cfg, params, slots=sc.slots, max_len=sc.max_len,
                      page_size=sc.page_size, device="cpu")
    reqs = trace_requests(trace, cfg.vocab_size, seed=0)
    replay(eng, reqs)
    return {r.req_id: list(r.out_tokens) for r in reqs}


# ---------------------------------------------------------------------------
# the ranks: tp 2
# ---------------------------------------------------------------------------

def _rank_cases():
    trace = make_trace(**TRACE)
    cases = {}
    for impl in ("tensor", "phantom"):
        sc = _sc(impl, TP)
        cfg = sc.model_config().replace(dtype="float32")
        cases[impl] = {"cfg": cfg, "sc": sc, "trace": trace,
                       "params": _draw(cfg, TP),
                       "adopt": ((_prompts(cfg, ADOPT_LENS), ADOPT_S)
                                 if impl == "tensor" else None)}
    # bf16 (the config's dtype): the adopted cache as declared
    sc = _sc("tensor", TP)
    cases["bf16"] = {"cfg": sc.model_config(), "sc": sc, "trace": trace[:4],
                     "params": _draw(sc.model_config(), TP),
                     "adopt": (_prompts(sc.model_config(), ADOPT_LENS),
                               ADOPT_S)}
    return cases


@dataclasses.dataclass(frozen=True)
class _JServeConfig32(JServeConfig):
    """The reference's candidate in float32 activations (in bf16 its
    streams and the port's part at a near-tie: request 1's fifth
    token)."""

    def model_config(self):
        return super().model_config().replace(dtype="float32")


def _reference_fleet():
    """The reference's executed fleet at tp 1 in float32 (its own
    weights, drawn from seed 0), with those weights as numpy."""
    sc = _JServeConfig32(ARCH, "tensor", dp=1, tp=1, slots=4, max_len=64)
    fc = jfleet.FleetConfig(prefill=sc, decode=sc, slo_ms=200.0,
                            executed=True,
                            prefill_policy=jfleet.AutoscalePolicy(
                                min_replicas=1, max_replicas=1),
                            decode_policy=jfleet.AutoscalePolicy(
                                min_replicas=1, max_replicas=1))
    from repro.serve.traffic import make_trace as jax_make_trace
    router = jfleet.FleetRouter(fc, calib=JCalibration(), seed=0)
    rep = router.run(jax_make_trace(**TRACE))
    params = jax_materialize(jax_model_decls(
        sc.model_config(), JMeshAxes.from_mesh(jax_local_mesh(1, 1))), 0)
    return {"report": rep,
            "streams": {r.req_id: list(r.out_tokens)
                        for r in router.finished},
            "params": jax.tree.map(np.asarray, params)}


@pytest.fixture(scope="module")
def runs():
    cases = _rank_cases()
    errors, port = [], {}

    def ranks():
        try:
            port["ranks"] = spawn(torch_ranks.fleet_body, 1, TP, "cpu",
                                  args=(cases,), timeout_s=300)
        except Exception as e:       # re-raised below, in the fixture
            errors.append(e)
    th = threading.Thread(target=ranks)
    th.start()
    ref = _reference_fleet()
    th.join()
    if errors:
        raise errors[0]
    return {"cases": cases, "ranks": port["ranks"], "ref": ref}


# ---------------------------------------------------------------------------
# adopt
# ---------------------------------------------------------------------------

def _same_state(got):
    a, b = got["group"], got["adopt"]
    assert a["dtypes"] == b["dtypes"]
    for path in a["cache"]:
        np.testing.assert_array_equal(b["cache"][path], a["cache"][path],
                                      err_msg=path)
    for key in ("pos", "last_tok", "pages", "active", "tokens"):
        assert b[key] == a[key], key
    assert any(a["tokens"]) and not all(a["tokens"])   # exact and padded


@pytest.mark.parametrize("arch,dtype", [("chatglm3-6b", "bfloat16"),
                                        ("chatglm3-6b", "float32"),
                                        ("mamba2-370m", "bfloat16")])
def test_adopt_leaves_the_prefill_group_state_at_tp1(arch, dtype):
    sc = ServeConfig(arch, "tensor", 1, 1, 4, max_len=64)
    cfg = sc.model_config().replace(dtype=dtype)
    params = from_jax_params(_draw(cfg))
    # a recurrent family's group is exact-length: one length
    lens = ADOPT_LENS if arch == "chatglm3-6b" else (ADOPT_S,) * 3
    got = torch_ranks.adopt_states(cfg, params, MeshAxes(), "cpu",
                                   _prompts(cfg, lens), ADOPT_S, 4, 64)
    if arch == "chatglm3-6b":
        _same_state(got)
    else:
        a, b = got["group"], got["adopt"]
        for path in a["cache"]:
            np.testing.assert_array_equal(b["cache"][path], a["cache"][path])
        assert (b["pos"], b["last_tok"], b["pages"], b["tokens"]) == \
            (a["pos"], a["last_tok"], a["pages"], a["tokens"])
    per_tok, per_seq = kv_cache_token_bytes(cfg)
    if dtype == "bfloat16" and arch == "chatglm3-6b":
        assert got["wire"] == [per_seq + ADOPT_S * per_tok] * len(lens)
    else:
        # float32 rows (and the SSD's float32 state rows where the decl
        # says bf16 conv rows) carry more than the declared bytes
        assert all(w >= per_seq + ADOPT_S * per_tok for w in got["wire"])


def test_adopt_refuses_a_full_engine_and_a_finished_request():
    cfg = _sc().model_config()
    eng = ServeEngine(cfg, from_jax_params(_draw(cfg)), slots=1, max_len=64,
                      device="cpu")
    rows = tree_map(lambda t: t[:, :1, :16].clone(), eng.cache)
    done = Request(prompt=np.zeros(16, np.int32), done=True)
    with pytest.raises(RuntimeError, match="already done"):
        eng.adopt(done, rows, prefill_len=16, pos=16, last_tok=0)
    eng.adopt(Request(prompt=np.zeros(16, np.int32)), rows, prefill_len=16,
              pos=16, last_tok=0)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.adopt(Request(prompt=np.zeros(16, np.int32)), rows,
                  prefill_len=16, pos=16, last_tok=0)


@pytest.mark.parametrize("case", ["tensor", "bf16"])
def test_adopt_leaves_the_prefill_group_state_at_tp2(runs, case):
    """On each rank: the adopted cache's sequence chunks (the prefill's
    shards all-gathered over tp, as ``_splice`` relays them) bit for
    bit, and the same decode state; wire bytes are the global rows."""
    cfg = runs["cases"][case]["cfg"]
    per_tok, per_seq = kv_cache_token_bytes(cfg)
    scale = 2 if cfg.dtype == "float32" else 1
    for res in runs["ranks"]:
        _same_state(res[case]["adopt"])
        assert res[case]["adopt"]["wire"] == \
            [scale * (per_seq + ADOPT_S * per_tok)] * len(ADOPT_LENS)


# ---------------------------------------------------------------------------
# executed fleet: streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["tensor", "phantom", "bf16"])
def test_executed_fleet_matches_single_engine_tokens_at_tp2(runs, impl):
    """The reference's executed case at dp 1 x tp 2: the fleet's prefill
    -> migrate -> adopt -> decode path emits exactly the tokens of a
    plain engine replay of the same trace on the same weights, on every
    rank; the decode engine skips the clock agreement (``clock_scale =
    0``); in bf16 the migrated bytes are the prediction's."""
    n = len(runs["cases"][impl]["trace"])
    for res in runs["ranks"]:
        r = res[impl]
        assert r["finished"] == n
        assert r["fleet"] == r["replay"]
        assert r["agreement"]["clock"]["calls"] == 0
        if impl == "bf16":
            assert r["wire_ratio"] == pytest.approx(1.0, rel=1e-12)
    assert runs["ranks"][0][impl]["fleet"] == runs["ranks"][1][impl]["fleet"]


def test_executed_fleet_at_tp2_matches_tp1(runs):
    """Tensor sites in float32: the tp 2 fleet's streams equal the tp 1
    engine's on the same global weights, and its measured wire bytes
    (the rank's rows summed over tp) equal the tp 1 fleet's."""
    case = runs["cases"]["tensor"]
    cfg, trace = case["cfg"], case["trace"]
    params = from_jax_params(case["params"])
    tp1 = _plain_streams(cfg, params, trace, _sc())
    router = FleetRouter(_fc(_sc()), calib=Calibration(), seed=0,
                         device="cpu", cfg=cfg, params=params)
    rep = router.run(trace)
    assert {r.req_id: list(r.out_tokens) for r in router.finished} == tp1
    for res in runs["ranks"]:
        assert res["tensor"]["fleet"] == tp1
        assert res["tensor"]["wire"] == \
            rep["transfer"]["measured"]["transfer_wire_bytes"]
    # float32 rows: twice the declared (bf16) bytes
    assert rep["transfer"]["ratio_wire_bytes"] == pytest.approx(2.0)


def test_executed_fleet_matches_the_reference_at_tp1(runs):
    """On the reference's weights: the port's executed fleet gives the
    reference's executed fleet's greedy streams, and its measured wire
    bytes, request for request; and the port's plain replay the same
    streams."""
    ref = runs["ref"]
    sc = _sc()
    cfg = sc.model_config().replace(dtype="float32")
    params = from_jax_params(ref["params"])
    router = FleetRouter(_fc(sc), calib=Calibration(), seed=0, device="cpu",
                         cfg=cfg, params=params)
    rep = router.run(make_trace(**TRACE))
    streams = {r.req_id: list(r.out_tokens) for r in router.finished}
    assert rep["mode"] == "executed"
    assert rep["requests"]["finished"] == TRACE["n"]
    assert streams == ref["streams"]
    assert streams == _plain_streams(cfg, params, make_trace(**TRACE), sc)
    got, want = rep["transfer"]["measured"], \
        ref["report"]["transfer"]["measured"]
    assert got["transfer_wire_bytes"] == want["transfer_wire_bytes"]
    assert got["migrations"] == want["migrations"]
    # float32 rows: twice the declared bf16 bytes, on both sides
    assert rep["transfer"]["ratio_wire_bytes"] == pytest.approx(
        ref["report"]["transfer"]["ratio_wire_bytes"], rel=1e-12)


# ---------------------------------------------------------------------------
# meshes, pricing
# ---------------------------------------------------------------------------

def test_executed_pools_on_different_meshes_raise():
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        FleetRouter(FleetConfig(prefill=_sc("tensor", 2),
                                decode=_sc("phantom", 4), executed=True),
                    device="cpu")
    with pytest.raises(ValueError, match="not on dp=1 x tp=1"):
        FleetRouter(_fc(_sc("tensor", 2)), device="cpu")
    # the modeled fleet prices any pair
    rep = FleetRouter(FleetConfig(prefill=_sc("tensor", 2),
                                  decode=_sc("phantom", 4))).run(
        make_trace(**TRACE))
    assert rep["requests"]["finished"] == TRACE["n"]


def test_price_counted_prices_the_executed_steps():
    """The reference's ``price_hlo``, counted: each pool's ledger row
    joins a measured energy (its counted step) to the prediction."""
    with pytest.raises(ValueError, match="modeled fleet"):
        FleetRouter(FleetConfig(prefill=_sc(), decode=_sc()),
                    price_counted=True)
    sc = _sc()
    ledger = Ledger()
    router = FleetRouter(_fc(sc), calib=Calibration(), ledger=ledger,
                         seed=0, device="cpu", price_counted=True)
    rep = router.run(make_trace(**TRACE)[:4])
    rows = {e.name: e for e in ledger.entries}
    for phase in ("prefill", "decode"):
        e = rows[f"fleet_{phase}_{sc.name}"]
        assert e.measured["energy_j_per_iter"] > 0
        assert 0 < e.ratios()["energy_j_per_iter"] < 10
    assert rep["pools"]["decode"]["compute_j"] == pytest.approx(
        rows[f"fleet_decode_{sc.name}"].measured["energy_j"])


def test_launcher_route_table_round_trip_and_executed_fleet(tmp_path,
                                                            capsys):
    """``--route auto --route-out`` writes the priced table
    (``serve-route/v1``) after serving the winner; ``--fleet
    --route-table`` plans its pools from it; an executed fleet on one
    device prints the migrated bytes at the prediction."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve.fleet import load_route_table
    path = str(tmp_path / "route.json")
    assert launch.main(["--smoke", "--device", "cpu", "--tp", "2",
                        "--route", "auto", "--route-out", path,
                        "--requests", "2", "--new-tokens", "2"]) == 0
    table = load_route_table(path)
    assert table["arch"] == ARCH and len(table["candidates"]) == 2
    assert launch.main(["--smoke", "--tp", "2", "--fleet", "--route-table",
                        path, "--requests", "500", "--report-out", ""]) == 0
    out = capsys.readouterr().out
    assert "pool plan (route-table" in out and "mesh1x2" in out
    report = tmp_path / "fleet.json"
    assert launch.main(["--smoke", "--device", "cpu", "--fleet",
                        "--executed", "--requests", "6", "--trace",
                        "poisson", "--report-out", str(report)]) == 0
    out = capsys.readouterr().out
    assert "requests=6" in out and "wire ratio = 1.0000" in out
    assert report.exists()
