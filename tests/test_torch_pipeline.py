"""The port's 1F1B pipeline of the paper-FFN step against the JAX package.

* ``PipelineSchedule`` and the microbatch splitters equal the
  reference's over a grid of (stages, microbatches).
* The pipelined probe (loss, parameter gradients, input gradient) on
  gloo CPU ranks equals the reference's ``make_ffn_pipeline_probe_step``
  on its (pipe, data, model) mesh, from the same numpy parameters and
  batch: pipe 2 x dp 2 x tp 2 for tensor, phantom and mixed stages, and
  pipe 4 x dp 1 x tp 2 for phantom and mixed, with the reference's
  oracle tolerances (``tests/helpers.py: assert_pipeline_equivalence``:
  loss rtol 2e-4, gradients rtol 5e-4 / atol 1e-6).  The reference runs
  its phantom sites through XLA, the port through the kernels' plain
  versions (``kernel_backend="pallas"`` on CPU tensors).
* Three AdamW steps of the pipelined train step equal the reference's on
  pipe 2 x dp 2 x tp 2 (losses rtol 1e-5, parameters rtol 1e-4 / atol
  1e-5, as ``tests/test_torch_ffn.py`` holds the flat step).
* The predictions and the p2p pricing equal the reference's; the
  pipelined probe's ledger join holds each rank's boundary bytes to the
  stage-resolved figure exactly, and flops and layer wire bytes to the
  ``executed=False`` account within the reference's pins
  (``tests/test_telemetry.py``).
* ``make_local_mesh(dp, tp, pp)`` gives every rank its device's
  coordinates in the reference's mesh; the structure errors match.

Each mesh spawns its ranks once per module (``tests/torch_ranks.py:
pipeline_body``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import pipeline_cfg
from repro.core.energy import pipeline_p2p_time_us as jax_p2p_time_us
from repro.core.ffn import make_ffn_train_step as jax_make_ffn_train_step
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim.optimizers import AdamW as JAdamW
from repro.parallel.params import materialize as jax_materialize
from repro.telemetry.predict import \
    pipeline_ffn_step_events as jax_pipeline_events
from repro.telemetry.predict import \
    pipeline_ffn_step_prediction as jax_pipeline_prediction
from repro.telemetry.probe import \
    make_ffn_pipeline_probe_step as jax_pipeline_probe
from repro.train.pipeline import PipelineSchedule as JPipelineSchedule
from repro.train.pipeline import split_microbatches as jax_split
from repro_torch.core.energy import pipeline_p2p_time_us
from repro_torch.core.ffn import ffn_decls, make_ffn_train_step
from repro_torch.launch.mesh import spawn
from repro_torch.optim import SGD
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import gather_params, tree_leaves
from repro_torch.telemetry.predict import (pipeline_ffn_step_events,
                                           pipeline_ffn_step_prediction)
from repro_torch.train.pipeline import (PipelineSchedule,
                                        split_batch_microbatches,
                                        split_microbatches)

import torch_ranks
from torch_ranks import port_pipeline_cfg

LOSS_RTOL, GRAD_TOL = 2e-4, dict(rtol=5e-4, atol=1e-6)
BATCH = 16
# mesh name: (pp, dp, tp), the reference's fixture
MESHES = {"mesh222": (2, 2, 2), "mesh124": (4, 1, 2)}
# probe cases per mesh: name -> (kind, k, M, stages)
PROBES = {
    "mesh222": {"tensor": ("tensor", 2, 2, 2),
                "phantom": ("phantom", 4, 4, 2),
                "mixed": ("mixed", 2, 2, 2)},
    "mesh124": {"phantom": ("phantom", 4, 2, 4),
                "mixed": ("mixed", 2, 1, 4)},
}
# three AdamW steps on mesh222: name -> (kind, k, M, stages)
TRAIN = {"tensor": ("tensor", 2, 2, 2), "phantom": ("phantom", 4, 4, 2)}
TRAIN_N, TRAIN_STEPS, LR, WD = 64, 3, 3e-3, 0.1
# ledger join: name -> (kind, k, M); n 64, one layer a stage
LEDGER = {"mesh222": {"tensor": ("tensor", 4, 4),
                      "phantom": ("phantom", 4, 4)},
          "mesh124": {"phantom": ("phantom", 4, 2)}}
LEDGER_N, LEDGER_BATCH = 64, 32
# the reference's measured/predicted flops pins (tests/test_telemetry.py)
FLOPS_PIN = {"tensor": 0.05, "phantom": 0.25}


# ---------------------------------------------------------------------------
# the schedule and the splitters (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_schedule_equals_reference(S, M):
    ours, theirs = PipelineSchedule(S, M), JPipelineSchedule(S, M)
    for name in ("num_ticks", "bubble_fraction"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert ours.makespan_ticks() == theirs.makespan_ticks()
    assert ours.makespan_ticks(1.5, 2.5) == theirs.makespan_ticks(1.5, 2.5)
    for s in range(S):
        assert ours.table(s) == theirs.table(s)
        assert ours.warmup(s) == theirs.warmup(s)
        assert ours.max_in_flight(s) == theirs.max_in_flight(s)
    for layers in range(1, 11):       # uneven splits included
        assert ours.stage_bounds(layers) == theirs.stage_bounds(layers)
    for executed in (False, True):
        got = [(e.collective, e.m_floats, e.phase)
               for e in ours.p2p_events(96.0, executed=executed)]
        want = [(e.collective, e.m_floats, e.phase)
                for e in theirs.p2p_events(96.0, executed=executed)]
        assert got == want
        assert pipeline_p2p_time_us(ours, 96.0, executed=executed) == \
            pytest.approx(jax_p2p_time_us(theirs, 96.0, executed=executed),
                          rel=1e-12)


@pytest.mark.parametrize("shape,M,axis", [((8, 6), 4, 0), ((12, 5, 3), 3, 0),
                                          ((3, 8, 2), 2, 1), ((6, 4), 1, 0)])
def test_split_microbatches_equals_reference(shape, M, axis):
    a = np.random.RandomState(len(shape) + M).randn(*shape).astype(
        np.float32)
    got = split_microbatches(torch.from_numpy(a), M, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_split(a, M, axis)))


def test_split_batch_microbatches_and_errors():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    tok = torch.arange(4 * 5).reshape(4, 5)
    got = split_batch_microbatches({"tokens": tok, "positions": pos}, 2)
    assert torch.equal(got["tokens"], split_microbatches(tok, 2))
    assert torch.equal(got["positions"], split_microbatches(pos, 2, axis=1))
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(tok, 3)
    with pytest.raises(ValueError, match="stages >= 1"):
        PipelineSchedule(0, 2)


# ---------------------------------------------------------------------------
# predictions (no ranks)
# ---------------------------------------------------------------------------

PREDICTIONS = [("tensor", 2, 2, 2, 4), ("phantom", 2, 2, 2, 4),
               ("phantom", 4, 1, 2, 2), ("tensor", 4, 2, 1, 8),
               ("phantom", 2, 4, 1, 1)]


@pytest.mark.parametrize("executed", [False, True])
@pytest.mark.parametrize("kind,pp,dp,tp,M", PREDICTIONS)
def test_pipeline_predictions_equal_reference(kind, pp, dp, tp, M,
                                              executed):
    jcfg = pipeline_cfg(kind, 4, M, pp, n=64, layers=2 * pp)
    cfg = port_pipeline_cfg(kind, 4, M, pp, n=64, layers=2 * pp)
    peak = 67e12
    got = pipeline_ffn_step_prediction(cfg, pp, tp, dp, 32,
                                       executed=executed, peak_flops=peak)
    want = jax_pipeline_prediction(jcfg, pp, tp, dp, 32, executed=executed,
                                   peak_flops=peak)
    assert got.keys() == want.keys()
    for key, v in want.items():
        if isinstance(v, float):
            assert got[key] == pytest.approx(v, rel=1e-12), key
        else:
            assert got[key] == v, key
    ev, jev = (f(c, pp, tp, dp, 32, executed=executed)
               for f, c in ((pipeline_ffn_step_events, cfg),
                            (jax_pipeline_events, jcfg)))
    assert [(e.collective, e.m_floats, e.phase, g, n)
            for e, g, n in ev["events"]] == \
        [(e.collective, e.m_floats, e.phase, g, n)
         for e, g, n in jev["events"]]
    assert (ev["rows_mb"], ev["L_loc"], ev["reps"]) == \
        (jev["rows_mb"], jev["L_loc"], jev["reps"])


def test_mixed_prediction_raises():
    with pytest.raises(ValueError, match="homogeneous"):
        pipeline_ffn_step_prediction(port_pipeline_cfg("mixed", 2, 2, 2),
                                     2, 2, 2, 16)


# ---------------------------------------------------------------------------
# structure errors (tests/test_pipeline.py: test_pipeline_structure_errors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["single_stage_on_pipe", "indivisible",
                                  "stage_count"])
def test_pipeline_structure_errors(case):
    axes = MeshAxes(pp=2, dp=2, tp=2)
    if case == "single_stage_on_pipe":
        with pytest.raises(ValueError, match="pipe axis"):
            make_ffn_train_step(port_pipeline_cfg("tensor", 2, 1, 1), axes,
                                SGD(0.1), 8)
    elif case == "indivisible":
        with pytest.raises(ValueError, match="divide"):
            ffn_decls(port_pipeline_cfg("tensor", 2, 1, 2, layers=3), axes)
    else:
        with pytest.raises(ValueError, match="pipe axis"):
            make_ffn_train_step(port_pipeline_cfg("tensor", 2, 1, 4), axes,
                                SGD(0.1), 8)


def test_pipelined_config_refuses_the_flat_forward():
    from repro_torch.core.ffn import make_ffn_forward
    fwd, _ = make_ffn_forward(port_pipeline_cfg("tensor", 2, 2, 2),
                              MeshAxes())
    with pytest.raises(ValueError, match="single-stage"):
        fwd({}, torch.zeros(2, 32))


# ---------------------------------------------------------------------------
# the ranks: one spawn per mesh
# ---------------------------------------------------------------------------

def _batch(n, batch, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, n).astype(np.float32),
            rng.randn(batch, n).astype(np.float32))


def _jax_probe(mesh, kind, k, M, stages, seed):
    cfg = pipeline_cfg(kind, k, M, stages)
    fn, decls = jax_pipeline_probe(cfg, mesh, BATCH)
    params = jax.tree.map(np.array, jax_materialize(decls, seed % 7))
    x, y = _batch(cfg.ffn_width, BATCH, seed)
    loss, (gp, gx) = fn(params, x, y)
    return {"params": params, "x": x, "y": y, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, gp), "x_grad": np.asarray(gx)}


def _jax_train(mesh, kind, k, M, stages, batches):
    cfg = pipeline_cfg(kind, k, M, stages, n=TRAIN_N, layers=2 * stages)
    opt = JAdamW(LR, weight_decay=WD)
    step, decls, _ = jax_make_ffn_train_step(cfg, mesh, opt, BATCH)
    params = jax_materialize(decls, seed=5)
    start = jax.tree.map(np.array, params)
    state = opt.init(params)
    losses = []
    for s, (x, y) in enumerate(batches):
        params, state, loss = step(params, state, jnp.int32(s), x, y)
        losses.append(float(loss))
    return start, losses, jax.tree.map(np.array, params)


def _run(mesh_name):
    """The reference's results and the port's ranks on one mesh."""
    pp, dp, tp = MESHES[mesh_name]
    mesh = jax_local_mesh(dp, tp, pp)
    ref = {"probe": {}, "train": {}, "mesh": mesh}
    inputs = {"probe": {}, "train": {}, "ledger": {},
              "ledger_batch": LEDGER_BATCH}
    for i, (name, (kind, k, M, S)) in enumerate(PROBES[mesh_name].items()):
        r = ref["probe"][name] = _jax_probe(mesh, kind, k, M, S, seed=3 + i)
        inputs["probe"][name] = dict(
            cfg=port_pipeline_cfg(kind, k, M, S, backend="pallas"),
            params=r["params"], x=r["x"], y=r["y"], batch=BATCH)
    if mesh_name == "mesh222":
        batches = [_batch(TRAIN_N, BATCH, 20 + s) for s in range(TRAIN_STEPS)]
        for name, (kind, k, M, S) in TRAIN.items():
            r = ref["train"][name] = _jax_train(mesh, kind, k, M, S, batches)
            inputs["train"][name] = dict(
                cfg=port_pipeline_cfg(kind, k, M, S, n=TRAIN_N,
                                      layers=2 * S, backend="pallas"),
                params=r[0], batches=batches, lr=LR, weight_decay=WD,
                batch=BATCH)
    for name, (kind, k, M) in LEDGER[mesh_name].items():
        inputs["ledger"][name] = port_pipeline_cfg(
            kind, k, M, pp, n=LEDGER_N, backend="pallas")
    ranks = spawn(torch_ranks.pipeline_body, dp, tp, "cpu", args=(inputs,),
                  timeout_s=300, pp=pp)
    return {"name": mesh_name, "pp": pp, "dp": dp, "tp": tp,
            "ref": ref, "inputs": inputs, "ranks": ranks}


@pytest.fixture(scope="module")
def runs():
    """``runs(mesh_name)``: ``_run`` of that mesh, made once per module
    whatever order the tests take."""
    done = {}

    def get(mesh_name):
        if mesh_name not in done:
            done[mesh_name] = _run(mesh_name)
        return done[mesh_name]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_coordinates_match_reference(runs, mesh):
    """Rank r sits where the reference's mesh puts device r; each group
    joins the ranks that share the other two coordinates."""
    run = runs(mesh)
    devices = np.vectorize(lambda d: d.id)(run["ref"]["mesh"].devices)
    assert devices.shape == (run["pp"], run["dp"], run["tp"])
    for r, rank in enumerate(run["ranks"]):
        s, d, t, rr = rank["coords"]
        assert rr == r and devices[s, d, t] == r
        groups = rank["groups"]
        assert groups["pp"] == (tuple(devices[:, d, t])
                                if run["pp"] > 1 else ())
        assert groups["dp"] == (tuple(devices[s, :, t])
                                if run["dp"] > 1 else ())
        assert groups["tp"] == tuple(devices[s, d, :])


@pytest.mark.parametrize("mesh,name", [(m, n) for m in MESHES
                                       for n in PROBES[m]])
def test_pipeline_probe_matches_jax(runs, mesh, name):
    run = runs(mesh)
    pp, dp, tp = run["pp"], run["dp"], run["tp"]
    want = run["ref"]["probe"][name]
    got = [r["probe"][name] for r in run["ranks"]]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
    decls = ffn_decls(run["inputs"]["probe"][name]["cfg"],
                      MeshAxes(pp=pp, dp=dp, tp=tp))
    grads = gather_params([r["grads"] for r in got], decls, dp, tp, pp)
    for (path, g), (_, w) in zip(tree_leaves(grads),
                                 tree_leaves(want["grads"])):
        np.testing.assert_allclose(g, w, err_msg=path, **GRAD_TOL)
    # stage 0 reads the input: its ranks hold the input gradient's
    # (data, model) blocks; later stages return zeros
    B, n = want["x_grad"].shape
    x_grad = np.zeros_like(want["x_grad"])
    for r, res in zip(run["ranks"], got):
        s, d, t, _ = r["coords"]
        if s == 0:
            b, f = B // dp, n // tp
            x_grad[d * b:(d + 1) * b, t * f:(t + 1) * f] = res["x_grad"]
        else:
            assert not res["x_grad"].any()
    np.testing.assert_allclose(x_grad, want["x_grad"], **GRAD_TOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_pipeline_train_step_matches_jax(runs, name):
    run = runs("mesh222")
    pp, dp, tp = run["pp"], run["dp"], run["tp"]
    _, want_losses, want_params = run["ref"]["train"][name]
    case = run["inputs"]["train"][name]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["train"][name]["losses"], want_losses,
                                   rtol=1e-5)
    decls = ffn_decls(case["cfg"], MeshAxes(pp=pp, dp=dp, tp=tp))
    got = gather_params([r["train"][name]["params"] for r in run["ranks"]],
                        decls, dp, tp, pp)
    for (path, g), (_, w) in zip(tree_leaves(got),
                                 tree_leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("mesh,name", [(m, n) for m in MESHES
                                       for n in LEDGER[m]])
def test_pipeline_ledger_join(runs, mesh, name):
    """Each rank's boundary bytes are its stage's sends exactly:
    ``(M·[s < S-1] + M·[s > 0]) · m · 4``; flops and layer wire bytes
    (all but the boundary's) follow ``executed=False``."""
    run = runs(mesh)
    kind, _, M = LEDGER[run["name"]][name]
    pp, dp, tp = run["pp"], run["dp"], run["tp"]
    m = LEDGER_BATCH / (dp * M) * LEDGER_N / tp
    for r in run["ranks"]:
        measured, predicted = r["ledger"][name]
        s = r["coords"][0]
        assert measured["stage"] == s
        sends = M * (s < pp - 1) + M * (s > 0)
        assert measured["boundary_wire_bytes_per_device"] == sends * m * 4
        assert measured["collectives"]["collective_permute"]["count"] == \
            sends
        assert predicted["executed"] is False
        assert predicted["boundary_wire_bytes_per_device"] == 2 * M * m * 4
        rf = measured["flops_per_device"] / predicted["flops_per_device"]
        assert abs(rf - 1) <= FLOPS_PIN[kind] and rf >= 0.99, rf
        layer = (measured["collective_wire_bytes_per_device"]
                 - measured["boundary_wire_bytes_per_device"])
        want = (predicted["collective_wire_bytes_per_device"]
                - predicted["boundary_wire_bytes_per_device"])
        assert abs(layer / want - 1) <= 0.02, (layer, want)
    mean = np.mean([r["ledger"][name][0]["boundary_wire_bytes_per_device"]
                    for r in run["ranks"]])
    assert mean == pytest.approx(
        (pp - 1) / pp * run["ranks"][0]["ledger"][name][1][
            "boundary_wire_bytes_per_device"], rel=1e-12)
