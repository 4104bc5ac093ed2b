"""The port's LM trainer at tp > 1 against the JAX package, on the CPU.

* ``make_train_step``: three AdamW steps in float32 on a dp x tp mesh of
  gloo CPU ranks against the reference's trainer on
  ``make_local_mesh(dp, tp)`` (the conftest's 8 CPU devices), from the
  reference's initial parameters (``from_jax_params``, then each rank's
  ``shard_params``) and its token batches:

  - phi3-smoke, phantom MLP sites, dp 1 x tp 4 (the ``fp`` layout);
  - phi3-smoke with ``dense_projection_map()`` and 2 KV heads, dp 1 x
    tp 4 (``sp``, replicated KV, ``reduce_grads``' tp branch);
  - stablelm-smoke, phantom, dp 2 x tp 2 (LayerNorm's ``fp`` moments,
    partial RoPE);
  - phi3-smoke with ``phantom_projection_map(4, ffn=True, attn=True)``,
    dp 2 x tp 2 (phantom q/k/v/o, ``wo`` staying feature-sharded).

  The reference's kernel backend resolves to XLA on the CPU; the port
  runs ``"auto"``, the kernels' plain versions on CPU tensors.  The
  tolerances and the AdamW near-eps rule are
  ``tests/test_torch_trainer.py``'s; each rank's gradients and final
  parameters are gathered (``gather_params``) and held to the
  reference's global ones.
* The layers at tp = 2 against the reference's inside ``shard_map`` on a
  1 x 2 mesh, gradients taken inside as the trainer takes them:
  ``xent_loss`` vocab-sharded over 1 and 2 chunks; ``norm_apply`` and
  ``embed_apply`` in ``fp`` and ``sp``; ``mlp_apply`` with mixed sites
  (phantom gate and up, tensor_row down: each site shard to shard);
  head-mode attention, dense, with replicated KV, and phantom.  float32, the two sides summing in
  different orders: values rtol 1e-5 and atol 1e-6 of the array's
  largest magnitude; gradients rtol 1e-4 and atol 1e-5 of it.
* One seed gives the same gathered global parameters at tp = 1, 2 and 4
  (``Trainer.init_state``).
* Every leaf's spec in ``model_decls`` at tp = 4 equals the reference's
  ``PartitionSpec``; ``count_params`` equals the reference's at tp = 4.
* ``launch.train --tp 2`` on the CPU, phantom and ``--impl dense``.

One spawn per mesh (1 x 4 and 2 x 2); the 2 x 2 mesh's two dp groups
each run the layer cases, and dp group 0's ranks are compared.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import phantom_projection_map as jax_phantom_map
from repro.data.synthetic import LMDataset as JLMDataset
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models.model import count_params as jax_count_params
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.compat import shard_map
from repro.parallel.params import is_decl
from repro.parallel.params import materialize as jax_materialize
from repro.parallel.params import specs as jax_specs
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import (dense_projection_map, get_config,
                                      phantom_projection_map,
                                      with_kernel_backend)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import count_params, model_decls
from repro_torch.optim import AdamW
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import gather_params, tree_leaves
from repro_torch.train.trainer import Trainer

import torch_ranks
from test_torch_trainer import LR, WD, _adamw_implied, _JRecordingAdamW

ARCHS = {"phi3": "phi3-mini-3.8b", "stablelm": "stablelm-3b"}
B, S, STEPS = 4, 128, 3
SEED = 5
# name: (arch, projections, overrides, dp, tp)
RUNS = {
    "phi3_phantom_tp4": ("phi3", "config", {}, 1, 4),
    "phi3_dense_kv2_tp4": ("phi3", "dense", {"num_kv_heads": 2}, 1, 4),
    "stablelm_phantom_dp2_tp2": ("stablelm", "config", {}, 2, 2),
    "phi3_phantom_attn_dp2_tp2": ("phi3", "attn", {}, 2, 2),
}
MESHES = ((1, 4), (2, 2))


def _values_close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=msg)


def _grads_close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=msg)


def _configs(arch, proj, overrides):
    """The reference's config and the port's (kernel backend "auto"), in
    float32."""
    jcfg = jax_get_config(ARCHS[arch], smoke=True).replace(
        dtype="float32", **overrides)
    cfg = get_config(ARCHS[arch], smoke=True, dtype="float32", **overrides)
    if proj == "dense":
        jcfg = jcfg.replace(projections=jax_dense_map())
        cfg = cfg.replace(projections=dense_projection_map())
    elif proj == "attn":
        jcfg = jcfg.replace(projections=jax_phantom_map(4, ffn=True,
                                                        attn=True))
        cfg = cfg.replace(projections=phantom_projection_map(
            4, ffn=True, attn=True))
    return jcfg, with_kernel_backend(cfg, "auto")


def _jax_run(jcfg, dp, tp):
    """The reference's initial parameters and batches, and a call that
    runs its three steps on them (compiling the step)."""
    mesh = jax_local_mesh(dp, tp)
    opt = _JRecordingAdamW(LR, weight_decay=WD)
    step, decls, _ = jax_make_train_step(jcfg, mesh, opt)
    params = jax_materialize(decls, seed=3)
    ds = JLMDataset(jcfg.vocab_size, B, S + 1, seed=1)
    out = {"start": jax.tree.map(np.array, params),
           "batches": [jax.tree.map(np.array, ds(s)) for s in range(STEPS)]}

    def run():
        p, state = params, opt.init(params)
        losses, gnorms, grads = [], [], []
        for s, batch in enumerate(out["batches"]):
            p, state, m = step(p, state, jnp.int32(s), batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            grads.append(jax.tree.map(np.array, state["g"]))
        out.update(losses=losses, grad_norms=gnorms, grads=grads,
                   params=jax.tree.map(np.array, p))
    return out, run


# ---------------------------------------------------------------------------
# the layers at tp = 2, on the reference's side
# ---------------------------------------------------------------------------

def _jax_fn(body, in_specs, out_specs):
    mesh = jax_local_mesh(1, 2)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False))
    return lambda *a: jax.tree.map(np.asarray, f(*a))


def _tp_psum(grads, decls, axes):
    """The reference's reduce_grads over the model axis alone."""
    from repro.parallel.grads import _spec_axes
    return jax.tree.map(
        lambda g, d: g if "tp" in _spec_axes(d.spec)
        else lax.psum(g, axes.tp_name), grads, decls, is_leaf=is_decl)


LAYOUT_SPEC = {"sp": P(None, "model", None), "fp": P(None, None, "model")}


def _layer_cases(rng):
    """{name: (port case, a call that gives the reference's results)} of
    the layer tests."""
    axes = JMeshAxes.from_mesh(jax_local_mesh(1, 2))
    cases = {}

    for chunk in (64, 32):
        jcfg = jax_get_config("phi3-mini-3.8b", smoke=True).replace(
            vocab_size=200, loss_chunk=chunk)
        cfg = get_config("phi3-mini-3.8b", smoke=True, vocab_size=200,
                         loss_chunk=chunk)
        h = rng.randn(2, 64, 32).astype(np.float32)
        w = (rng.randn(32, 256) * 0.3).astype(np.float32)
        labels = rng.randint(0, 200, (2, 64)).astype(np.int32)

        def body(h, w, labels, jcfg=jcfg):
            def obj(h, w):
                sl, nv = jax_layers.xent_loss(jcfg, "sp", {"w": w}, h,
                                              labels, axes)
                return sl / axes.tp, (sl, nv)
            (_, (sl, nv)), g = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(h, w)
            return sl, nv, g[0], g[1]
        fn = _jax_fn(body, (LAYOUT_SPEC["sp"], P(None, "model"), P()),
                     (P(), P(), LAYOUT_SPEC["sp"], P(None, "model")))
        cases[f"xent_chunks{64 // chunk}"] = (
            {"kind": "xent", "cfg": cfg, "h": h, "w": w, "labels": labels},
            lambda fn=fn, a=(h, w, labels): dict(zip(("loss", "n", "h", "w"),
                                                     fn(*a))))

    for arch in ("phi3", "stablelm"):
        jcfg, cfg = _configs(arch, "config", {})
        for lay in ("fp", "sp"):
            x = (rng.randn(2, 8, 64) * 3 + 1).astype(np.float32)
            r = rng.randn(2, 8, 64).astype(np.float32)
            params = {"scale": (1 + 0.1 * rng.randn(64)).astype(np.float32)}
            if cfg.norm == "layernorm":
                params["bias"] = (0.1 * rng.randn(64)).astype(np.float32)
            decls = jax_layers.norm_decls(jcfg, lay, 64)

            def body(x, params, r, jcfg=jcfg, lay=lay, decls=decls):
                def obj(x, params):
                    y = jax_layers.norm_apply(jcfg, lay, params, x, axes)
                    return jnp.sum(y * r), y
                (_, y), (gx, gp) = jax.value_and_grad(
                    obj, argnums=(0, 1), has_aux=True)(x, params)
                return y, gx, _tp_psum(gp, decls, axes)
            pspec = {k: resolve_spec(d.spec, axes) for k, d in decls.items()}
            fn = _jax_fn(body, (LAYOUT_SPEC[lay], pspec, LAYOUT_SPEC[lay]),
                         (LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], pspec))
            cases[f"norm_{cfg.norm}_{lay}"] = (
                {"kind": "norm", "cfg": cfg, "layout": lay, "x": x, "r": r,
                 "params": params},
                lambda fn=fn, a=(x, params, r): dict(zip(
                    ("y", "x", "params"), fn(*a))))

    jcfg, cfg = _configs("phi3", "config", {})
    for lay in ("fp", "sp"):
        table = (rng.randn(256, 64) * 0.02).astype(np.float32)
        tokens = rng.randint(0, 256, (2, 16)).astype(np.int64)
        r = rng.randn(2, 16, 64).astype(np.float32)

        def body(table, tokens, r, lay=lay):
            def obj(table):
                h = jax_layers.embed_apply(jcfg, lay, {"table": table},
                                           tokens, axes)
                return jnp.sum(h * r), h
            (_, h), g = jax.value_and_grad(obj, has_aux=True)(table)
            return h, g
        fn = _jax_fn(body, (P("model", None), P(), LAYOUT_SPEC[lay]),
                     (LAYOUT_SPEC[lay], P("model", None)))
        cases[f"embed_{lay}"] = (
            {"kind": "embed", "cfg": cfg, "layout": lay, "table": table,
             "tokens": tokens, "r": r},
            lambda fn=fn, a=(table, tokens.astype(np.int32), r): dict(zip(
                ("y", "x", "params"), (lambda y, g: (y, None,
                                                     {"table": g}))(
                    *fn(*a)))))

    # the MLP with mixed sites: phantom gate and up, tensor_row down
    jcfg, cfg = _configs("phi3", "config", {})
    jcfg = jcfg.replace(projections=dataclasses.replace(
        jcfg.projections, ffn_down=None))
    cfg = cfg.replace(projections=dataclasses.replace(
        cfg.projections, ffn_down=None))
    decls = jax_layers.mlp_decls(jcfg, axes, 64, jcfg.d_ff)
    params = jax.tree.map(np.asarray, jax_materialize(decls, seed=6))
    x = rng.randn(2, 16, 64).astype(np.float32)
    r = rng.randn(2, 16, 64).astype(np.float32)

    def body(params, x, r, jcfg=jcfg, decls=decls):
        def obj(params, x):
            out = jax_layers.mlp_apply(jcfg, "fp", params, x, axes)
            return jnp.sum(out * r), out
        (_, out), (gp, gx) = jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True)(params, x)
        return out, gx, _tp_psum(gp, decls, axes)
    pspec = jax.tree.map(lambda s: resolve_spec(s, axes), jax_specs(decls))
    fn = _jax_fn(body, (pspec, LAYOUT_SPEC["fp"], LAYOUT_SPEC["fp"]),
                 (LAYOUT_SPEC["fp"], LAYOUT_SPEC["fp"], pspec))
    cases["mlp_mixed"] = (
        {"kind": "mlp", "cfg": cfg, "layout": "fp", "x": x, "r": r,
         "params": params},
        lambda fn=fn, a=(params, x, r): dict(zip(("y", "x", "params"),
                                                 fn(*a))))

    for name, proj, over in (("dense", "dense", {}),
                             ("replicated_kv", "dense", {"num_kv_heads": 1}),
                             ("phantom", "attn", {})):
        jcfg, cfg = _configs("phi3", proj, over)
        lay = jax_layers.residual_layout(jcfg, "train")
        decls = jax_attn.attn_decls(jcfg, axes)
        params = jax.tree.map(np.asarray, jax_materialize(decls, seed=4))
        x = rng.randn(2, 32, 64).astype(np.float32)
        r = rng.randn(2, 32, 64).astype(np.float32)
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))

        def body(params, x, r, pos, jcfg=jcfg, lay=lay, decls=decls):
            def obj(params, x):
                out, _ = jax_attn.attention(jcfg, lay, params, x, pos, axes,
                                            None, kind="train")
                return jnp.sum(out * r), out
            (_, out), (gp, gx) = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(params, x)
            return out, gx, _tp_psum(gp, decls, axes)
        pspec = jax.tree.map(lambda s: resolve_spec(s, axes),
                             jax_specs(decls))
        fn = _jax_fn(body, (pspec, LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], P()),
                     (LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], pspec))
        cases[f"attention_{name}"] = (
            {"kind": "attention", "cfg": cfg, "layout": lay, "x": x, "r": r,
             "params": params},
            lambda fn=fn, a=(params, x, r, pos): dict(zip(
                ("y", "x", "params"), fn(*a))))
    return cases


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs from the reference; then one spawn per mesh
    (each mesh's trainer cases, the layer cases on 2 x 2 only, the
    seeded draw), in threads of their own while the reference computes
    its results here."""
    ref, todo, port_cases = {}, [], {m: {} for m in MESHES}
    for name, (arch, proj, over, dp, tp) in RUNS.items():
        jcfg, cfg = _configs(arch, proj, over)
        ref[name], run = _jax_run(jcfg, dp, tp)
        todo.append(run)
        port_cases[(dp, tp)][name] = dict(
            cfg=cfg, params=ref[name]["start"], batches=ref[name]["batches"],
            lr=LR, weight_decay=WD, microbatches=1)
    layers = _layer_cases(np.random.RandomState(7))
    draw_cfg = _configs("phi3", "dense", {"num_kv_heads": 2})[1]
    out = {"ref": ref, "draw_cfg": draw_cfg}
    errors = []

    def ranks(dp, tp):
        try:
            out[(dp, tp)] = spawn(
                torch_ranks.trainer_tp_body, dp, tp, "cpu", timeout_s=300,
                args=({"train": port_cases[(dp, tp)],
                       "layers": ({k: c for k, (c, _) in layers.items()}
                                  if tp == 2 else {}),
                       "draw_cfg": draw_cfg, "seed": SEED},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=m) for m in MESHES]
    for t in threads:
        t.start()
    # XLA compiles outside the interpreter lock: the runs overlap
    with ThreadPoolExecutor(len(todo)) as pool:
        for f in [pool.submit(run) for run in todo]:
            f.result()
    out["layers"] = {k: (c, want()) for k, (c, want) in layers.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _gathered(ranks, key, cfg, dp, tp):
    decls = model_decls(cfg, MeshAxes(tp=tp, dp=dp))
    return gather_params([r[key] for r in ranks], decls, dp, tp)


@pytest.mark.parametrize("name", list(RUNS))
def test_train_step_at_tp_matches_jax(runs, name):
    arch, proj, over, dp, tp = RUNS[name]
    hold_train_steps(name, _configs(arch, proj, over)[1], runs["ref"][name],
                     [r["train"][name] for r in runs[(dp, tp)]], dp, tp)


def hold_train_steps(name, cfg, want, ranks, dp, tp):
    """Every rank's losses and gradient norms, and the gathered clipped
    gradients of each step and final parameters, against the
    reference's (``_jax_run``); AdamW's near-eps elements held to what
    their gradients imply."""
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-5, err_msg=name)
    decls = model_decls(cfg, MeshAxes(tp=tp, dp=dp))
    grads = [gather_params([r["grads"][s] for r in ranks], decls, dp, tp)
             for s in range(STEPS)]
    for s, (gp, gr) in enumerate(zip(grads, want["grads"])):
        got = dict(tree_leaves(gp))
        for path, w in tree_leaves(gr):
            np.testing.assert_allclose(
                got[path], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                err_msg=f"{name} step {s} gradient {path}")
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, dp, tp)))
    n_near = n_all = 0
    for path, w in tree_leaves(want["params"]):
        near, implied = _adamw_implied(
            [dict(tree_leaves(g))[path] for g in grads],
            [dict(tree_leaves(g))[path] for g in want["grads"]])
        diff = np.abs(np.float64(got[path]) - w)
        tol = 1e-5 + 1e-4 * np.abs(w) + implied * near
        assert (diff <= tol).all(), (
            f"{name} {path}: {int((diff > tol).sum())} elements outside, "
            f"worst {diff.max():.3e}")
        n_near += int(np.sum(near))
        n_all += w.size
    assert n_near <= 1e-3 * n_all, (name, n_near, n_all)


def _assemble(parts, layout_dim):
    """Model ranks 0 and 1's local arrays -> the global one (``None``:
    replicated, rank 0's)."""
    if layout_dim is None:
        return parts[0]
    return np.concatenate(parts, axis=layout_dim)


LAYER_NAMES = ["xent_chunks1", "xent_chunks2", "norm_rmsnorm_fp",
               "norm_rmsnorm_sp", "norm_layernorm_fp", "norm_layernorm_sp",
               "embed_fp", "embed_sp", "mlp_mixed", "attention_dense",
               "attention_replicated_kv", "attention_phantom"]


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_layer_at_tp2_matches_reference(runs, name):
    from repro_torch.models.attention import attn_decls
    from repro_torch.models.layers import (embed_decls, mlp_decls,
                                           norm_decls)
    case, want = runs["layers"][name]
    ranks = [r["layers"][name] for r in runs[(2, 2)][:2]]  # dp group 0
    if case["kind"] == "xent":
        for r in ranks:
            assert r["n"] == int(want["n"]) == 2 * 64
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        _grads_close(_assemble([r["h"] for r in ranks], 1), want["h"])
        _grads_close(_assemble([r["w"] for r in ranks], 1), want["w"])
        assert not _assemble([r["w"] for r in ranks], 1)[:, 200:].any()
        return
    dim = {"sp": 1, "fp": 2}[case["layout"]]
    _values_close(_assemble([r["y"] for r in ranks], dim), want["y"], name)
    if want["x"] is not None:
        _grads_close(_assemble([r["x"] for r in ranks], dim), want["x"],
                     name)
    cfg, lay = case["cfg"], case["layout"]
    decls = {"norm": lambda: norm_decls(cfg, lay, 64),
             "embed": lambda: embed_decls(cfg),
             "mlp": lambda: mlp_decls(cfg, MeshAxes(tp=2), 64, cfg.d_ff),
             "attention": lambda: attn_decls(cfg, MeshAxes(tp=2))}[
        case["kind"]]()
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, 1, 2)))
    for path, w in tree_leaves(want["params"]):
        _grads_close(got[path], w, f"{name} {path}")


def test_one_seed_same_global_params_at_every_tp(runs):
    """``Trainer.init_state`` draws each global leaf from one generator
    seeded alike on every rank and keeps the rank's shard: the gathered
    parameters at tp = 2 and 4 are the tp = 1 draw, bit for bit."""
    cfg = runs["draw_cfg"]
    want = Trainer(cfg, MeshAxes(), AdamW(1e-3), None,
                   device="cpu").init_state(SEED).params
    want = dict(tree_leaves(want))
    for dp, tp in MESHES:
        got = _gathered(runs[(dp, tp)], "draw", cfg, dp, tp)
        for path, g in tree_leaves(got):
            np.testing.assert_array_equal(g, want[path].numpy(),
                                          err_msg=f"tp={tp} {path}")


def test_dp_ranks_agree_at_tp(runs):
    """On dp 2 x tp 2 the two data ranks of each model rank end with the
    same bits."""
    ranks = runs[(2, 2)]
    for name, (*_, dp, tp) in RUNS.items():
        if (dp, tp) != (2, 2):
            continue
        for t in range(2):
            a, b = ranks[t]["train"][name], ranks[2 + t]["train"][name]
            assert a["losses"] == b["losses"]
            for (path, x), (_, y) in zip(tree_leaves(a["params"]),
                                         tree_leaves(b["params"])):
                np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------------------
# declarations and counts
# ---------------------------------------------------------------------------

DECL_CASES = {"phi3_phantom": ("phi3", "config", {}),
              "phi3_dense": ("phi3", "dense", {}),
              "phi3_dense_kv2": ("phi3", "dense", {"num_kv_heads": 2}),
              "phi3_phantom_attn": ("phi3", "attn", {}),
              "stablelm_phantom": ("stablelm", "config", {}),
              "stablelm_dense": ("stablelm", "dense", {})}


def _norm_spec(spec, ndim):
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(None if e is None else e for e in out)


@pytest.mark.parametrize("name", list(DECL_CASES))
def test_model_decl_specs_match_reference_at_tp4(name):
    """Every leaf of ``model_decls`` at tp = 4 has the reference's shape
    and PartitionSpec: norm scales sharded in ``fp`` and replicated in
    ``sp``, replicated KV projections where 4 does not divide the KV
    heads."""
    jcfg, cfg = _configs(*DECL_CASES[name])
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=4, dp=1, dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=4)))}
    assert ours == theirs


@pytest.mark.parametrize("name", ["phi3_phantom", "phi3_dense",
                                  "stablelm_phantom"])
@pytest.mark.parametrize("smoke", [True, False])
def test_count_params_matches_reference_at_tp4(name, smoke):
    arch, proj, over = DECL_CASES[name]
    jcfg, cfg = _configs(arch, proj, over)
    if not smoke:
        full = (jax_get_config(ARCHS[arch]), get_config(ARCHS[arch]))
        if proj == "dense":
            full = (full[0].replace(projections=jax_dense_map()),
                    full[1].replace(projections=dense_projection_map()))
        jcfg, cfg = full
    assert count_params(cfg, 4) == jax_count_params(jcfg, tp=4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["phantom", "dense"])
def test_launch_train_at_tp2_runs_on_the_cpu(capfd, impl):
    assert launch_train.main(["--smoke", "--device", "cpu", "--tp", "2",
                              "--steps", "2", "--batch", "4", "--seq", "32",
                              "--impl", impl]) == 0
    out = capfd.readouterr().out
    assert f"# phi3-smoke impl={impl} dp=1 on cpu (tp=2," in out
    assert "[trainer] step 2 loss " in out and " ms/it" in out
