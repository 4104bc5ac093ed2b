"""The port's LM trainer on a pipe axis, and Adafactor, against the JAX
package on the CPU.

* ``make_train_step`` at pp > 1: three steps in float32 on a
  pp x dp x tp mesh of gloo CPU ranks against the reference's trainer on
  ``make_local_mesh(dp, tp, pp)`` (the conftest's 8 CPU devices), on its
  token batches (8 sequences of 64 tokens).  Each step starts from the
  reference's parameters before it (``from_jax_params``, then each
  rank's ``shard_params`` of the ``[pp, G/pp, ...]`` stacks) and from
  the optimizer state its device held (zeros before the first): so each
  step's gradients are held to the tolerance below, where a run from
  the first step alone would carry AdamW's amplification of the
  float32 differences at near-zero ``sqrt(v^)`` into the later steps'
  parameters and gradients (stablelm-smoke at 4 layers: gradients
  within 1e-6 of their largest at the first step, 4e-4 at the third, and
  as much at pp 1, where the trainer does not pipeline):

  - phi3-smoke, phantom MLP sites (``fp``), pp 2 x dp 1 x tp 2, M = 2,
    AdamW;
  - phi3-smoke with ``dense_projection_map()`` (``sp``), pp 2 x dp 2 x
    tp 2, M = 4, AdamW;
  - stablelm-smoke at 4 layers, pp 4 x dp 1 x tp 1, M = 4, AdamW;
  - qwen2.5-smoke (ring attention, QKV bias), pp 2 x dp 1 x tp 2, M = 2,
    AdamW;
  - phi3-smoke phantom with Adafactor, pp 2 x dp 1 x tp 2, M = 2 (at
    G/pp = 1 the norm scales' local stacks ``[1, 1, d]`` are not
    factored; the other stacks are, their means over the rank's shard);
  - phi3-smoke phantom with Adafactor at pp 1 (one rank, in this
    process), the reference's unpipelined step.

  The reference's kernel backend resolves to XLA on the CPU; the port
  runs ``"auto"``, the kernels' plain versions on CPU tensors.
  Tolerances are ``tests/test_torch_trainer.py``'s: losses and gradient
  norms rtol 1e-5 on every rank; each step's clipped gradients, gathered
  (``gather_params``), within 1e-4 of their leaf's largest; each step's
  updated parameters rtol 1e-4 / atol 1e-5, AdamW's near-eps elements
  allowed what the two sides' gradients imply (``_adamw_step_implied``).
* ``Adafactor.update`` alone against the reference's, five steps on
  numpy-seeded trees of 0-d, 1-D, 2-D, ``[n, 1]`` and stacked leaves
  (float32 and bf16), with weight decay: parameters and both moments
  rtol 1e-5 / atol 1e-7 (the two sides' means and ``t^-0.8`` may round
  differently in the last bit).
* Every leaf's shape and spec of ``model_decls`` at pp 2 x tp 2, and of
  AdamW's and Adafactor's state decls, against the reference's
  ``PartitionSpec``s.
* One seed gives the same gathered global parameters at pp 1 x tp 1 and
  at pp 2 x tp 2 (``Trainer.init_state``), and ``record_to`` records the
  pp.

One spawn per mesh (2 x 1 x 2, 2 x 2 x 2 and 4 x 1 x 1), in threads of
their own while the reference compiles and runs here.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import LMDataset as JLMDataset
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models.model import model_decls as jax_model_decls
from repro.optim.optimizers import Adafactor as JAdafactor
from repro.optim.optimizers import AdamW as JAdamW
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.params import is_decl
from repro.parallel.params import materialize as jax_materialize
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import (dense_projection_map, get_config,
                                      with_kernel_backend)
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import model_decls
from repro_torch.optim import Adafactor, AdamW
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import gather_params, tree_leaves
from repro_torch.train.trainer import Trainer

import torch_ranks
from test_torch_trainer import _JRecordingAdamW

ARCHS = {"phi3": "phi3-mini-3.8b", "stablelm": "stablelm-3b",
         "qwen": "qwen2.5-14b"}
B, S, STEPS, LR, WD = 8, 64, 3, 1e-3, 0.1
SEED = 5
# name: (arch, projections, overrides, pp, dp, tp, microbatches, optimizer)
RUNS = {
    "phi3_phantom_pp2_tp2": ("phi3", "config", {}, 2, 1, 2, 2, "adamw"),
    "phi3_dense_pp2_dp2_tp2": ("phi3", "dense", {}, 2, 2, 2, 4, "adamw"),
    "stablelm_pp4": ("stablelm", "config", {"num_layers": 4}, 4, 1, 1, 4,
                     "adamw"),
    "qwen_ring_pp2_tp2": ("qwen", "config", {}, 2, 1, 2, 2, "adamw"),
    "phi3_adafactor_pp2_tp2": ("phi3", "config", {}, 2, 1, 2, 2,
                               "adafactor"),
    "phi3_adafactor_pp1": ("phi3", "config", {}, 1, 1, 1, 1, "adafactor"),
}
MESHES = ((2, 1, 2), (2, 2, 2), (4, 1, 1))
DRAW_MESH = (2, 1, 2)      # where Trainer.init_state's draw is held


class _JRecordingAdafactor(JAdafactor):
    """The reference's Adafactor, whose state also carries the (clipped)
    gradients of its last update."""

    def state_decls(self, param_decls):
        g = jax.tree.map(lambda d: dataclasses.replace(
            d, init="zeros", dtype=jnp.float32), param_decls,
            is_leaf=is_decl)
        return {**super().state_decls(param_decls), "g": g}

    def init(self, params):
        return {**super().init(params),
                "g": jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32),
                                  params)}

    def update(self, grads, state, params, step):
        params, s = super().update(
            grads, {"vr": state["vr"], "vc": state["vc"]}, params, step)
        return params, {**s, "g": grads}


def _configs(arch, proj, overrides):
    """The reference's config and the port's (kernel backend "auto"), in
    float32."""
    jcfg = jax_get_config(ARCHS[arch], smoke=True).replace(
        dtype="float32", **overrides)
    cfg = get_config(ARCHS[arch], smoke=True, dtype="float32", **overrides)
    if proj == "dense":
        jcfg = jcfg.replace(projections=jax_dense_map())
        cfg = cfg.replace(projections=dense_projection_map())
    return jcfg, with_kernel_backend(cfg, "auto")


def _jax_run(jcfg, pp, dp, tp, M, optimizer, steps=STEPS):
    """The reference's initial parameters and batches, and a call that
    runs its ``steps`` steps on them (compiling the step)."""
    mesh = jax_local_mesh(dp, tp, pp)
    assert dict(mesh.shape) == ({"pipe": pp, "data": dp, "model": tp}
                                if pp > 1 else {"data": dp, "model": tp})
    opt = {"adamw": _JRecordingAdamW,
           "adafactor": _JRecordingAdafactor}[optimizer](
        LR, weight_decay=WD)
    step, decls, _ = jax_make_train_step(jcfg, mesh, opt, microbatches=M)
    params = jax_materialize(decls, seed=3)
    ds = JLMDataset(jcfg.vocab_size, B, S + 1, seed=1)
    out = {"start": jax.tree.map(np.array, params),
           "batches": [jax.tree.map(np.array, ds(s)) for s in range(steps)]}

    def run():
        p, state = params, opt.init(params)
        for s, batch in enumerate(out["batches"]):
            p, state, m = step(p, state, jnp.int32(s), batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["grads"].append(jax.tree.map(np.array, state["g"]))
            out["params"].append(jax.tree.map(np.array, p))
            if s + 1 < steps:
                out["starts"].append(_start(p, state, mesh))
    out.update(starts=[_start(params, opt.init(params))], losses=[],
               grad_norms=[], grads=[], params=[])
    return out, run


def _start(params, state, mesh=None):
    """What a step starts from, as numpy: the global parameters and
    optimizer state (without the recorded gradients), and, after a step
    on ``mesh``, each rank's local optimizer state, read from its
    device's buffer (before the first step the state is zeros, and each
    rank starts from its own ``init``).  A moment the reference declares
    replicated may differ between devices (Adafactor's column means of a
    leaf sharded on its rows are each rank's own: its ``shard_map`` keeps
    them with ``check_vma=False``), so the ranks are handed their own."""
    state = {k: v for k, v in state.items() if k != "g"}
    out = {"params": jax.tree.map(np.array, params),
           "state": jax.tree.map(np.array, state), "local_state": None}
    if mesh is not None:
        def local(a, dev):
            return np.array(next(sh.data for sh in a.addressable_shards
                                 if sh.device == dev))
        # rank (s * dp + d) * tp + t holds mesh.devices[s, d, t]
        out["local_state"] = [jax.tree.map(lambda a, d=d: local(a, d),
                                           state)
                              for d in mesh.devices.flat]
    return out


@pytest.fixture(scope="module")
def runs():
    """Every case on the reference, the runs in threads of their own (XLA
    compiles outside the interpreter lock); then one spawn per mesh (its
    trainer cases, each step from the reference's state before it, and
    the seeded draw), in threads of their own, and the pp = 1 case in
    this process."""
    ref, todo = {}, []
    for name, (arch, proj, over, pp, dp, tp, M, opt) in RUNS.items():
        ref[name], run = _jax_run(_configs(arch, proj, over)[0], pp, dp, tp,
                                  M, opt)
        todo.append(run)
    with ThreadPoolExecutor(len(todo)) as pool:
        for f in [pool.submit(run) for run in todo]:
            f.result()
    port_cases = {m: {} for m in MESHES + ((1, 1, 1),)}
    for name, (arch, proj, over, pp, dp, tp, M, opt) in RUNS.items():
        port_cases[(pp, dp, tp)][name] = dict(
            cfg=_configs(arch, proj, over)[1], starts=ref[name]["starts"],
            batches=ref[name]["batches"], lr=LR, weight_decay=WD,
            microbatches=M, optimizer=opt)
    # dense sites: phantom decls differ with tp, dense ones do not
    draw_cfg = _configs("phi3", "dense", {})[1]
    out = {"ref": ref, "draw_cfg": draw_cfg}
    errors = []

    def ranks(pp, dp, tp):
        try:
            out[(pp, dp, tp)] = spawn(
                torch_ranks.lm_pipeline_body, dp, tp, "cpu", pp=pp,
                timeout_s=300,
                args=({"train": port_cases[(pp, dp, tp)],
                       "draw_cfg": draw_cfg if (pp, dp, tp) == DRAW_MESH
                       else None, "seed": SEED},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=m) for m in MESHES]
    for t in threads:
        t.start()
    out[(1, 1, 1)] = [torch_ranks.lm_pipeline_body(
        MeshAxes(), torch.device("cpu"),
        {"train": port_cases[(1, 1, 1)], "draw_cfg": None})]
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _adamw_step_implied(m, v, t, g_port, g_ref, eps=1e-8, b1=0.9,
                        b2=0.95):
    """AdamW's step ``t`` from the reference's moments ``m`` and ``v``
    (float64), given each side's gradient: where ``sqrt(v^)`` fell below
    10 eps, and not to 0, on either side, and ``lr * |u(port) -
    u(ref)|``, what the two gradients imply for the parameters
    (``tests/test_torch_trainer.py: _adamw_implied``, for one step)."""
    near, u = False, []
    for g in (g_port, g_ref):
        g = np.float64(g)
        mt = b1 * np.float64(m) + (1 - b1) * g
        vt = b2 * np.float64(v) + (1 - b2) * g ** 2
        root = np.sqrt(vt / (1 - b2 ** t))
        near = near | ((0 < root) & (root < 10 * eps))
        u.append(mt / (1 - b1 ** t) / (root + eps))
    return near, LR * np.abs(u[0] - u[1])


@pytest.mark.parametrize("name", list(RUNS))
def test_pipelined_train_step_matches_jax(runs, name):
    """Each of the three steps, from the reference's parameters and
    optimizer state before it: every rank's loss and gradient norm, and
    the gathered clipped gradients and updated parameters, against the
    reference's."""
    arch, proj, over, pp, dp, tp, _, opt = RUNS[name]
    hold_pipelined_steps(name, _configs(arch, proj, over)[1],
                         runs["ref"][name],
                         [r["train"][name] for r in runs[(pp, dp, tp)]],
                         pp, dp, tp, opt)


def hold_pipelined_steps(name, cfg, want, ranks, pp, dp, tp, opt):
    """``test_pipelined_train_step_matches_jax``'s checks of one case:
    ``want`` is ``_jax_run``'s result, ``ranks`` every rank's
    ``lm_pipeline_body`` result for the case."""
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-5, err_msg=name)
    decls = model_decls(cfg, MeshAxes(pp=pp, dp=dp, tp=tp))

    def gathered(key, s):
        return dict(tree_leaves(gather_params([r[key][s] for r in ranks],
                                              decls, dp, tp, pp)))
    n_near = n_all = 0
    for s in range(len(want["params"])):
        grads = gathered("grads", s)
        for path, w in tree_leaves(want["grads"][s]):
            assert grads[path].shape == w.shape, (name, path)
            np.testing.assert_allclose(
                grads[path], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                err_msg=f"{name} step {s} gradient {path}")
        params = gathered("params", s)
        state = {k: dict(tree_leaves(v))
                 for k, v in want["starts"][s]["state"].items()}
        wgrads = dict(tree_leaves(want["grads"][s]))
        for path, w in tree_leaves(want["params"][s]):
            tol = 1e-5 + 1e-4 * np.abs(w)
            if opt == "adamw":
                near, implied = _adamw_step_implied(
                    state["m"][path], state["v"][path], s + 1, grads[path],
                    wgrads[path])
                tol = tol + implied * near
                n_near += int(np.sum(near))
            diff = np.abs(np.float64(params[path]) - w)
            assert (diff <= tol).all(), (
                f"{name} step {s} {path}: {int((diff > tol).sum())} "
                f"elements outside, worst {diff.max():.3e}")
            n_all += w.size
    assert n_near <= 1e-3 * n_all, (name, n_near, n_all)


def test_pp_dp_ranks_agree(runs):
    """On pp 2 x dp 2 x tp 2 the two data ranks of each (stage, model)
    coordinate end every step with the same bits."""
    ranks = runs[(2, 2, 2)]
    name = "phi3_dense_pp2_dp2_tp2"
    for s in range(2):
        for t in range(2):
            a = ranks[(s * 2 + 0) * 2 + t]["train"][name]
            b = ranks[(s * 2 + 1) * 2 + t]["train"][name]
            assert a["losses"] == b["losses"]
            for pa, pb in zip(a["params"], b["params"]):
                for (path, x), (_, y) in zip(tree_leaves(pa),
                                             tree_leaves(pb)):
                    np.testing.assert_array_equal(x, y, err_msg=path)


def test_one_seed_same_global_params_at_pp1_and_pp2(runs):
    """``Trainer.init_state`` draws each global leaf and keeps the rank's
    shard; a pipe-sharded stack ``[pp, G/pp, ...]`` holds the values of
    the unsharded ``[G, ...]``: the gathered parameters at pp 2 x tp 2
    are the pp 1 x tp 1 draw, bit for bit (phi3-smoke with dense sites,
    whose global decls do not depend on tp)."""
    cfg = runs["draw_cfg"]
    want = dict(tree_leaves(Trainer(cfg, MeshAxes(), AdamW(1e-3), None,
                                    device="cpu").init_state(SEED).params))
    decls = model_decls(cfg, MeshAxes(pp=2, tp=2))
    got = gather_params([r["draw"] for r in runs[DRAW_MESH]], decls, 1, 2,
                        2)
    for path, g in tree_leaves(got):
        w = want[path].numpy()
        if path.startswith("layers/"):
            assert g.shape[:2] == (2, cfg.num_layers // 2)
            g = g.reshape(w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_record_to_records_the_pipe_axis():
    """A trainer's ledger entry names its pp and dp."""
    from repro_torch.telemetry import Ledger
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    trainer = Trainer(cfg, MeshAxes(pp=2, dp=2, tp=2), AdamW(1e-3), None,
                      device="cpu")
    entry = trainer.record_to(Ledger(run="test"))
    assert (entry.extra["pp"], entry.extra["dp"], entry.p) == (2, 2, 2)


# ---------------------------------------------------------------------------
# Adafactor alone, and the declarations
# ---------------------------------------------------------------------------

def _adafactor_tree(rng, scale=1.0):
    """Leaves of every kind the update branches on: 0-d, 1-D, 2-D, a
    [n, 1] column (not factored), a stacked [G, n, m] leaf and a bf16
    2-D one."""
    shapes = {"scalar": (), "vec": (11,), "mat": (6, 9), "col": (7, 1),
              "stack": (3, 5, 8), "half": (4, 6)}
    return {k: np.asarray(rng.randn(*s) * scale, np.float32)
            for k, s in shapes.items()}


def test_adafactor_update_matches_reference():
    """Five steps of ``Adafactor.update`` (weight decay 0.1, lr 1e-2,
    gradients of alternating scale) against the reference's on the same
    numpy trees: parameters (float32 and bf16) and both moments rtol
    1e-5 / atol 1e-7, in place in the port."""
    rng = np.random.RandomState(9)
    start = _adafactor_tree(rng)
    grads = [_adafactor_tree(rng, 1e-3 if s % 2 else 1.0) for s in range(5)]
    jopt = JAdafactor(1e-2, weight_decay=0.1)
    opt = Adafactor(1e-2, weight_decay=0.1)

    def jtree(t):
        return {k: jnp.asarray(v, jnp.bfloat16 if k == "half" else None)
                for k, v in t.items()}

    def ttree(t):
        return {k: torch.from_numpy(v.copy()).to(
            torch.bfloat16 if k == "half" else torch.float32)
            for k, v in t.items()}
    jp, tp_ = jtree(start), ttree(start)
    js, ts = jopt.init(jp), opt.init(tp_)
    assert {k: v.shape for k, v in ts["vc"].items()} == {
        k: tuple(v.shape) for k, v in js["vc"].items()}
    for step, g in enumerate(grads):
        jp, js = jopt.update(jtree(g), js, jp, jnp.int32(step))
        ids = {k: id(v) for k, v in tp_.items()}
        tp_, ts = opt.update(ttree(g), ts, tp_, step)
        assert {k: id(v) for k, v in tp_.items()} == ids
    for k in start:
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp_[k].float().numpy()
        if k == "half":      # one bf16 rounding apart at most
            np.testing.assert_allclose(got, want, rtol=2 ** -7, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for m in ("vr", "vc"):
            np.testing.assert_allclose(ts[m][k].numpy(),
                                       np.asarray(js[m][k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{m} {k}")


def _norm_spec(spec, ndim):
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(None if e is None else e for e in out)


def _shapes_and_specs(decls):
    """{path: (shape, spec)} of a decl tree of either package."""
    return {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(decls)}


DECL_CASES = ["phi3_phantom_pp2_tp2", "phi3_dense_pp2_dp2_tp2",
              "qwen_ring_pp2_tp2"]


@pytest.mark.parametrize("name", DECL_CASES)
def test_model_and_state_decls_match_reference_at_pp2_tp2(name):
    """Every leaf of ``model_decls`` at pp 2 x tp 2 has the reference's
    shape and PartitionSpec (the layer stacks ``[2, G/2, ...]`` with a
    leading ``"pp"``), and so has every leaf of AdamW's and Adafactor's
    state decls (Adafactor's moments dropping the last or the
    second-to-last axis and its spec entry)."""
    arch, proj, over = RUNS[name][:3]
    jcfg, cfg = _configs(arch, proj, over)
    jdecls = jax_model_decls(jcfg, JMeshAxes(tp=2, dp=1,
                                             dp_names=("data",), pp=2))
    decls = model_decls(cfg, MeshAxes(pp=2, tp=2))
    assert _shapes_and_specs(decls) == _shapes_and_specs(jdecls)
    assert all(d.spec[0] == "pp" for _, d in tree_leaves(decls["layers"]))
    for jopt, opt in ((JAdamW(1e-3), AdamW(1e-3)),
                      (JAdafactor(1e-3), Adafactor(1e-3))):
        assert (_shapes_and_specs(opt.state_decls(decls))
                == _shapes_and_specs(jopt.state_decls(jdecls)))
