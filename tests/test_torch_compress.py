"""The port's PowerSGD (``optim/compress.py``) against the JAX package, on
a dp 2 x tp 4 mesh of gloo CPU ranks (the reference on the 8 virtual CPU
devices of the same mesh).

* ``_orthonormalize``: orthonormal columns spanning the input's.
* The reference's ``tests/test_compress.py`` cases:
  - a rank-2 gradient reproduced exactly by rank-4 compression after
    three warm-up rounds of q: the approximation within rtol 1e-4 / atol
    1e-5 of the reference's and rtol 1e-3 / atol 1e-4 of the gradient
    (the reference's own tolerance);
  - error feedback at rank 1 over 30 steps (``q`` handed across:
    ``jax.random`` cannot be reproduced): the reduced gradient of the
    first 10 steps within atol 1e-5 of the reference's largest value, of
    the later ones within 1e-3 (the gap grows from 1.4e-7 at step 1 to
    1.3e-4 at step 29: each step's rank-1 subspace iteration starts from
    the last one's rounding, and error feedback keeps the residual's top
    two directions close), the final error and q within 1e-3; and
    ``sum(reduced) + err = 30 g`` within rtol / atol 1e-3, the
    reference's identity;
  - small and 1-D leaves averaged over dp exactly (rtol 1e-6).
* Gradients that differ between the dp ranks (a global gradient cut by
  rows), a 2-D leaf and a 1-D one, three steps at rank 2: held as above.
* ``q`` up to the sign of each column (``torch.linalg.qr`` and
  ``jnp.linalg.qr`` may pick other signs; ``P Q^T`` does not depend on
  them), within 1e-4 of its largest.
* Wire: each compressed leaf's two dp all-reduces carry k*n and k*m
  floats, each small leaf one all-reduce of its own size, nothing else.
* Three compressed SGD steps of the paper FFN (phantom, n 64, L 2, k 4,
  batch 16, lr 0.3, rank 2) against the reference's
  ``tests/test_ffn_pipeline.py: test_compressed_dp_training_converges``
  step: losses rtol 1e-5, parameters after each step rtol 1e-4 / atol
  1e-5.  The FFN's leaves are layer stacks (3-D and 4-D), so every one of
  them takes the exact dp mean there, in the reference as in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import PhantomConfig as JPhantomConfig
from repro.core.ffn import ffn_apply as jax_ffn_apply
from repro.core.ffn import ffn_decls as jax_ffn_decls
from repro.data.synthetic import TeacherDataset as JTeacherDataset
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim.compress import compress_grad as jax_compress_grad
from repro.optim.compress import compressed_dp_psum as jax_compressed
from repro.optim.compress import init_compress_state as jax_init_state
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.compat import shard_map
from repro.parallel.params import materialize as jax_materialize
from repro.parallel.params import specs as jax_specs
from repro_torch.configs.base import ModelConfig, PhantomConfig
from repro_torch.configs.base import phantom_projection_map
from repro_torch.core.ffn import ffn_decls
from repro_torch.launch.mesh import spawn
from repro_torch.optim.compress import (_orthonormalize,
                                        init_compress_state)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import gather_params, tree_leaves

import torch_ranks

DP, TP = 2, 4
N, LAYERS, KG, BATCH, LR, FFN_RANK = 64, 2, 4, 16, 0.3, 2
CASES = {"feedback": dict(rank=1, steps=30, per_rank=False),
         "per_rank": dict(rank=2, steps=3, per_rank=True)}


def _smap(fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=jax_local_mesh(DP, TP),
                             in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _rand(key, shape):
    return np.asarray(jax.random.normal(jax.random.key(key), shape))


def _ffn_cfgs():
    kw = dict(name="t-phantom-fused", family="ffn", num_layers=LAYERS,
              d_model=N, ffn_width=N, ffn_depth=LAYERS, mlp="relu")
    return (JModelConfig(ffn_impl="phantom",
                         phantom=JPhantomConfig(k=KG, variant="fused"), **kw),
            ModelConfig(phantom=PhantomConfig(k=KG),
                        projections=phantom_projection_map(
                            KG, ffn_layer=True), **kw))


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _ref_lowrank():
    """The reference's exact-when-low-rank test, its q and approximation."""
    g = _rand(0, (32, 2)) @ _rand(1, (2, 16))
    q0 = _rand(2, (16, 4))
    rep = (P(None, None), P(None, None))
    qf = _smap(lambda gg, qq: jax_compress_grad(gg, qq, ("data",))[1], rep,
               P(None, None))
    af = _smap(lambda gg, qq: jax_compress_grad(gg, qq, ("data",)), rep,
               rep)
    q = q0
    for _ in range(3):
        q = qf(g, q)
    approx, q_last = af(g, q)
    return ({"g": np.asarray(g, np.float32), "q0": q0, "rounds": 3},
            {"approx": np.asarray(approx), "q": np.asarray(q_last)})


def _ref_feedback(name):
    """``compressed_dp_psum`` over ``steps`` steps on the case's leaves:
    ``feedback`` the reference's error-feedback test (one 2-D leaf, the
    same on every rank), ``per_rank`` a 2-D and a 1-D leaf that differ
    between the dp ranks (each rank's rows of a global gradient)."""
    c = CASES[name]
    axes = JMeshAxes.from_mesh(jax_local_mesh(DP, TP))
    if name == "feedback":
        g = {"w": _rand(3, (16, 8))}
    else:
        g = {"w": _rand(4, (DP * 24, 12)), "b": _rand(5, (DP * 7,))}
    local = {k: (a[:a.shape[0] // DP] if c["per_rank"] else a)
             for k, a in g.items()}
    q0, err0 = jax_init_state(local, rank=c["rank"])
    gspec = {k: (P("data", *(None,) * (a.ndim - 1)) if c["per_rank"]
                 else P(*(None,) * a.ndim)) for k, a in g.items()}
    rspec = {k: P(*(None,) * a.ndim) for k, a in g.items()}
    qspec = jax.tree.map(lambda a: P(*(None,) * a.ndim), q0)
    full = {k: err0[k].shape == local[k].shape for k in g}
    espec = {k: gspec[k] if full[k] else P(None) for k in g}
    err_in = {k: np.zeros(g[k].shape, np.float32) if full[k] else err0[k]
              for k in g}

    def f(gg, qq, ee):
        return jax_compressed(gg, qq, ee, axes, rank=c["rank"])
    fn = _smap(f, (gspec, qspec, espec), (rspec, qspec, espec))
    q, err, reds = q0, err_in, []
    for _ in range(c["steps"]):
        red, q, err = fn(g, q, err)
        reds.append(jax.tree.map(np.asarray, red))
    port_case = {"g": {k: np.asarray(a) for k, a in g.items()},
                 "q0": jax.tree.map(np.asarray, q0),
                 "err0": jax.tree.map(np.asarray, err0), **c}
    return port_case, {"reduced": reds, "q": jax.tree.map(np.asarray, q),
                       "err": jax.tree.map(np.asarray, err)}


def _ref_ffn():
    """The reference's compressed FFN step (``tests/test_ffn_pipeline.py:
    test_compressed_dp_training_converges``), three steps: the start, the
    compression state, the batches, the losses and each step's
    parameters."""
    jcfg, cfg = _ffn_cfgs()
    mesh = jax_local_mesh(DP, TP)
    axes = JMeshAxes.from_mesh(mesh)
    decls = jax_ffn_decls(jcfg, axes)
    params = jax_materialize(decls, 0)
    q_state, err_state = jax_init_state(params, rank=FFN_RANK)
    pspecs = jax.tree.map(lambda s: resolve_spec(s, axes),
                          jax_specs(decls))
    qspecs = jax.tree.map(lambda qq: P(*((None,) * qq.ndim)), q_state)
    especs = jax.tree.map(lambda ee: P(*((None,) * ee.ndim)), err_state)
    bspec = resolve_spec(P("dp", "tp"), axes)

    def step(p, q, e, x, y):
        def loss_fn(pp):
            out = jax_ffn_apply(jcfg, axes, pp, x)
            return jnp.sum((out - y) ** 2) / (BATCH * jcfg.ffn_width)
        l, g = jax.value_and_grad(loss_fn)(p)
        g, q, e = jax_compressed(g, q, e, axes, rank=FFN_RANK)
        p = jax.tree.map(lambda w, gw: w - LR * gw, p, g)
        return p, q, e, jax.lax.psum(l, axes.all_names)

    fn = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(pspecs, qspecs, especs, bspec, bspec),
        out_specs=(pspecs, qspecs, especs, P()), check_vma=False))
    ds = JTeacherDataset(jcfg.ffn_width, BATCH)
    case = {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
            "q0": jax.tree.map(np.asarray, q_state),
            "err0": jax.tree.map(np.asarray, err_state), "lr": LR,
            "batches": []}
    losses, trail = [], []
    p, q, e = params, q_state, err_state
    for s in range(3):
        x, y = ds(s)
        case["batches"].append((np.asarray(x), np.asarray(y)))
        p, q, e, loss = fn(p, q, e, x, y)
        losses.append(float(loss))
        trail.append(jax.tree.map(np.asarray, p))
    return case, {"losses": losses, "params": trail}


@pytest.fixture(scope="module")
def runs():
    lowrank, want_lowrank = _ref_lowrank()
    cases = {name: _ref_feedback(name) for name in CASES}
    ffn, want_ffn = _ref_ffn()
    inputs = {"lowrank": lowrank, "ffn": ffn,
              **{name: c for name, (c, _) in cases.items()}}
    ranks = spawn(torch_ranks.compress_body, DP, TP, "cpu", timeout_s=300,
                  args=(inputs,))
    return {"ranks": ranks, "lowrank": want_lowrank, "ffn": (ffn, want_ffn),
            **{name: w for name, (_, w) in cases.items()}}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


def _same_up_to_column_signs(got, want, atol=1e-5, msg=""):
    signs = np.sign(np.sum(got * want, axis=0))
    assert (signs != 0).all(), msg
    _close(got * signs, want, atol=atol, msg=msg)


def test_orthonormalize_spans_the_columns():
    a = torch.from_numpy(_rand(6, (20, 3)))
    q = _orthonormalize(a)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(3), atol=1e-6)
    # the projection onto q's columns keeps a
    np.testing.assert_allclose((q @ (q.T @ a)).numpy(), a.numpy(),
                               atol=1e-5)


def test_exact_when_lowrank(runs):
    want = runs["lowrank"]
    g = runs["ranks"][0]["lowrank"]
    for r in runs["ranks"]:
        _close(r["lowrank"]["approx"], want["approx"])
        _same_up_to_column_signs(r["lowrank"]["q"], want["q"])
        np.testing.assert_allclose(r["lowrank"]["approx"],
                                   g["approx"], rtol=0, atol=0)
    # the reference's own check: the rank-2 gradient comes back
    grad = np.asarray(_rand(0, (32, 2)) @ _rand(1, (2, 16)))
    np.testing.assert_allclose(want["approx"], grad, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(g["approx"], grad, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_compressed_dp_psum_matches_reference(runs, name):
    want = runs[name]
    c = CASES[name]
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]
        d = rank // TP
        for s, (gs, ws) in enumerate(zip(got["reduced"], want["reduced"])):
            atol = 1e-5 if s < 10 else 1e-3
            for k in ws:
                _close(gs[k], ws[k], atol=atol,
                       msg=f"{name} step {s} {k} rank {rank}")
        atol = 1e-3 if name == "feedback" else 1e-5
        for k, w in want["err"].items():
            if w.shape != got["err"][k].shape:     # this dp rank's rows
                n = w.shape[0] // DP
                w = w[d * n:(d + 1) * n]
            _close(got["err"][k], w, atol=atol,
                   msg=f"{name} err {k} rank {rank}")
        for k, w in want["q"].items():
            if w.ndim == 2:
                _same_up_to_column_signs(got["q"][k], w, atol=atol,
                                         msg=f"{name} q {k} rank {rank}")
    if name == "feedback":
        # the reference's identity: nothing is lost, only delayed
        g_true = _rand(3, (16, 8))
        for r in runs["ranks"]:
            total = sum(s["w"] for s in r[name]["reduced"])
            np.testing.assert_allclose(total + r[name]["err"]["w"],
                                       c["steps"] * g_true, rtol=1e-3,
                                       atol=1e-3)
            assert np.linalg.norm(r[name]["err"]["w"]) < np.linalg.norm(
                c["steps"] * g_true)


def test_small_leaves_pass_through(runs):
    """The 1-D leaf of ``per_rank`` is the exact dp mean of the ranks'
    rows at every step."""
    b = _rand(5, (DP * 7,)).reshape(DP, 7).mean(0)
    for r in runs["ranks"]:
        for s in r["per_rank"]["reduced"]:
            np.testing.assert_allclose(s["b"], b, rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_wire_is_k_n_plus_m_floats(runs, name):
    """Per step and rank: k*n and k*m floats for each compressed [n, m]
    leaf, the leaf's own size for a small one, all over the dp group."""
    c = CASES[name]
    k = c["rank"]
    per_step = ([("all_reduce", k * 16.0, DP), ("all_reduce", k * 8.0, DP)]
                if name == "feedback" else
                [("all_reduce", 7.0, DP), ("all_reduce", k * 24.0, DP),
                 ("all_reduce", k * 12.0, DP)])
    for r in runs["ranks"]:
        assert r[name]["m_floats"] == per_step * c["steps"]


def test_compressed_ffn_steps_match_reference(runs):
    (case, want), ranks = runs["ffn"], runs["ranks"]
    decls = ffn_decls(case["cfg"], MeshAxes(tp=TP, dp=DP))
    for r in ranks:
        np.testing.assert_allclose(r["ffn"]["losses"], want["losses"],
                                   rtol=1e-5)
    for s, w in enumerate(want["params"]):
        got = dict(tree_leaves(gather_params(
            [r["ffn"]["params"][s] for r in ranks], decls, DP, TP)))
        for path, a in tree_leaves(w):
            np.testing.assert_allclose(got[path], a, rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {s} {path}")
    assert want["losses"][-1] < want["losses"][0]
    # every FFN leaf is a layer stack: no leaf is compressed
    assert all(a.shape == (1,) for _, a in tree_leaves(case["q0"]))


def test_init_compress_state_draws_from_the_generator():
    params = {"w": torch.zeros(16, 8), "b": torch.zeros(7),
              "thin": torch.zeros(16, 3)}
    q, e = init_compress_state(params, rank=2,
                               generator=torch.Generator().manual_seed(4))
    want = torch.randn((8, 2), generator=torch.Generator().manual_seed(4))
    assert torch.equal(q["w"], want)
    assert e["w"].shape == (16, 8) and not e["w"].any()
    for k in ("b", "thin"):
        assert q[k].shape == e[k].shape == (1,)
