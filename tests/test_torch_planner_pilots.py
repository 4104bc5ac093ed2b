"""The planner's pilots (``train/trainer.py: pilot_ffn_run``,
``planner/isoloss.py: run_pilots``) on 4 gloo CPU ranks (dp 1 x tp 4)
against the reference's on its 1 x 4 CPU mesh: tensor_col and phantom at
k 4 and 8, width 512, depth 2, batch 64, 20 AdamW steps at 3e-3.

The port draws its own weights and batches (numpy, not ``jax.random``),
so each rank is first handed the reference's initial parameters
(``init_ffn``) and ``TeacherDataset`` batches as numpy arrays
(``tests/torch_ranks.py: install_pilot_draws``, a job of the same
``RankPool`` that then runs the pilots).  Held: every step's loss within
1e-3 relative of the reference's (20 AdamW steps amplify float32
rounding near eps: phantom k 8 differs by 2e-4 at most, the others by
3e-7); ``iters_to_target`` and ``steps_run`` equal at a target (0.25)
that no step's loss comes within that tolerance of; ``run_pilots``'s key
set, ν, k grid and curve (the reference's fit on the port's results, and
within 1e-2 of the reference's curve: what 1e-3 in the losses allows
through the log-log fit); ``stop_at_target``; the ledger rows."""
import jax
import numpy as np
import pytest

from repro.core.ffn import init_ffn as jax_init_ffn
from repro.data.synthetic import TeacherDataset as JTeacherDataset
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim import AdamW as JAdamW
from repro.planner import isoloss as jiso
from repro.planner.space import PlanCandidate as JPlanCandidate
from repro.telemetry import Ledger as JLedger
from repro_torch.launch.mesh import RankPool
from repro_torch.planner import run_pilots
from repro_torch.planner.isoloss import _pilot_rank
from repro_torch.planner.space import PlanCandidate
from repro_torch.telemetry import Ledger

import torch_ranks

WIDTH, DEPTH, BATCH, STEPS, TP, KS, LR = 512, 2, 64, 20, 4, (4, 8), 3e-3
STRATEGIES = ("tensor_col", "phantom")
PILOTS = [("tensor_col", 0)] + [("phantom", k) for k in KS]
TARGET = 0.25
LOSS_RTOL = 1e-3
CURVE_ATOL = 1e-2


def _plan(cls, strat, k):
    return cls(dp=1, tp=TP, strategy=strat, width=WIDTH, depth=DEPTH,
               batch=BATCH, k=k)


@pytest.fixture(scope="module")
def reference():
    mesh = jax_local_mesh(1, TP)
    ledger = JLedger(run="pilots")
    iso = jiso.run_pilots(STRATEGIES, mesh, width=WIDTH, depth=DEPTH,
                          batch=BATCH, steps=STEPS, target_loss=TARGET,
                          ks=KS, ledger=ledger)
    params = {}
    for strat, k in PILOTS:
        cfg = _plan(JPlanCandidate, strat, k).model_config()
        p, _ = jax_init_ffn(cfg, mesh, JAdamW(LR, weight_decay=0.0), seed=0)
        params[cfg.name] = jax.tree.map(np.array, p)
    ds = JTeacherDataset(WIDTH, BATCH, seed=0)
    batches = [tuple(np.array(a) for a in ds(s)) for s in range(STEPS)]
    return {"iso": iso, "ledger": ledger,
            "draws": {"params": params, "batches": batches}}


@pytest.fixture(scope="module")
def port(reference):
    ledger = Ledger(run="pilots")
    with RankPool(1, TP, "cpu") as pool:
        ranks = pool.run(torch_ranks.install_pilot_draws, 1, TP,
                         (reference["draws"],))
        assert ranks == list(range(TP))
        iso = run_pilots(STRATEGIES, TP, width=WIDTH, depth=DEPTH,
                         batch=BATCH, steps=STEPS, target_loss=TARGET,
                         ks=KS, ledger=ledger, device="cpu", pool=pool)
        cfg = _plan(PlanCandidate, "phantom", KS[0]).model_config()
        early = pool.run(_pilot_rank, 1, TP, (cfg, dict(
            steps=STEPS, batch=BATCH, target_loss=TARGET,
            stop_at_target=True)))
    return {"iso": iso, "ledger": ledger, "early": early}


def test_target_is_clear_of_every_reference_loss(reference):
    for p in reference["iso"].pilots:
        gap = min(abs(v - TARGET) for v in p.losses) / TARGET
        assert gap > LOSS_RTOL, (p.name, gap)
        assert p.iters_to_target is not None, p.name


@pytest.mark.parametrize("i", range(len(PILOTS)),
                         ids=[f"{s}_k{k}" for s, k in PILOTS])
def test_pilot_matches_the_reference(reference, port, i):
    want, got = reference["iso"].pilots[i], port["iso"].pilots[i]
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    assert got.iters_to_target == want.iters_to_target
    assert got.steps_run == want.steps_run == STEPS
    assert got.final_loss == pytest.approx(want.final_loss, rel=LOSS_RTOL)
    for key in ("name", "strategy", "width", "tp", "k", "target_loss"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.wall_us_median > 0
    assert got.losses[-1] < got.losses[0]


def test_run_pilots_keys_grid_and_curve(reference, port):
    want, got = reference["iso"], port["iso"]
    assert got.nu == want.nu
    assert set(got.final_loss) == set(want.final_loss)
    for key in ("target_loss", "width", "pilot_tp", "steps_budget"):
        assert getattr(got, key) == getattr(want, key), key
    assert set(got.curves) == set(want.curves) == {"phantom"}
    curve, jcurve = got.curves["phantom"], want.curves["phantom"]
    assert curve.ks == jcurve.ks == list(KS)
    refit = jiso.fit_loss_curve(
        "phantom", list(KS), [got.final_loss[f"phantom:k{k}"] for k in KS],
        WIDTH, TP)
    assert curve.as_dict() == refit.as_dict()
    assert curve.a == pytest.approx(jcurve.a, abs=CURVE_ATOL)
    assert curve.b == pytest.approx(jcurve.b, abs=CURVE_ATOL)
    assert [p["name"] for p in got.as_dict()["pilots"]] == \
        [p["name"] for p in want.as_dict()["pilots"]]


def test_stop_at_target_stops_every_rank_there(port):
    full = port["iso"].pilots[1]
    for res, summary in port["early"]:
        assert res.iters_to_target == res.steps_run == full.iters_to_target
        np.testing.assert_array_equal(res.losses,
                                      full.losses[:res.steps_run])
        assert summary["calls"] == res.steps_run and summary["warmup"] == 1


def test_pilot_ledger_rows_match_the_reference(reference, port):
    got = [e.as_dict() for e in port["ledger"].entries]
    want = [e.as_dict() for e in reference["ledger"].entries]
    assert len(got) == len(want) == len(PILOTS)
    for g, w in zip(got, want):
        for key in ("name", "suite", "kind", "arch", "impl", "p", "extra"):
            assert g[key] == w[key], key
        assert g["measured"]["iterations"] == w["measured"]["iterations"]
        assert g["measured"]["calls"] == STEPS
        assert g["measured"]["final_loss"] == pytest.approx(
            w["measured"]["final_loss"], rel=LOSS_RTOL)
        assert {"wall_us_median", "total_s", "warmup"} <= set(g["measured"])
