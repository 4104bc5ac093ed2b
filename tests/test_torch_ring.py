"""Ring attention, the collectives it runs on, the phantom layer's ring
neighbours and qwen2.5-14b's training step in the port, against the JAX
package on the CPU.

* ``ppermute`` (a ring shift each way and a partial permutation) and the
  two all-to-alls (``seq_to_feature``, ``feature_to_seq``) with their
  gradients, on gloo ranks at tp 4 (mesh 1 x 4) and tp 2 (mesh 2 x 2),
  against ``lax.ppermute`` / the reference's layout helpers inside
  ``shard_map``; each logged as the reference prices it (a ppermute hop
  as ``collective_permute`` on the sending rank only).
* Ring attention at tp = 4 with 6 heads (4 does not divide them, as in
  ``tests/test_attention.py``), 2 KV heads, QKV bias, RoPE, causal: the
  ppermute hops and ``attn_ring_gather_kv``, each in the ``fp`` and the
  ``sp`` layout, against the reference's ``_attention_ring``: outputs,
  input gradients and parameter gradients (summed over tp where the
  decl replicates them).
* Three AdamW steps of ``qwen2.5-smoke`` from the reference's initial
  parameters (``from_jax_params``) and batches, against its trainer:
  phantom MLP sites at dp 1 x tp 4 (``fp``), ``dense_projection_map()``
  at dp 1 x tp 4 (``sp``), and phantom at dp 2 x tp 2.
* ``model_decls`` specs and ``count_params`` of qwen2.5-14b at tp = 4
  equal the reference's; ``launch.train --arch qwen2.5-14b --tp 2``
  runs on the CPU.

Tolerances (``tests/test_torch_trainer_tp.py``'s): float32, values rtol
1e-5 / atol 1e-6 of the array's largest magnitude, gradients rtol 1e-4 /
atol 1e-5 of it, AdamW's near-eps elements as their gradients imply.
One spawn per mesh (1 x 4 and 2 x 2) runs every case of this module
(``torch_ranks.ring_body``).
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
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
from repro_torch.configs.base import (ModelConfig, dense_projection_map,
                                      get_config, with_kernel_backend)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models.attention import attn_decls
from repro_torch.models.model import count_params, model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import gather_params, tree_leaves

import torch_ranks
from test_torch_trainer import LR, WD
from test_torch_trainer_tp import (LAYOUT_SPEC, _grads_close, _jax_run,
                                   _norm_spec, _tp_psum, _values_close,
                                   hold_train_steps)

MESHES = ((1, 4), (2, 2))
ARCH = "qwen2.5-14b"
# name: (projections, dp, tp)
RUNS = {"qwen_phantom_tp4": ("config", 1, 4),
        "qwen_dense_tp4": ("dense", 1, 4),
        "qwen_phantom_dp2_tp2": ("config", 2, 2)}
# ring attention: 6 heads over tp = 4, d 24, B 2, S 16
D, H, KV, B, S = 24, 6, 2, 2, 16
ATTN = {f"ring_{kvmode}_{lay}": (kvmode == "gather", lay)
        for kvmode in ("ppermute", "gather") for lay in ("fp", "sp")}
COLLECTIVES = ("ppermute_shift", "ppermute_back", "ppermute_partial",
               "seq_to_feature", "feature_to_seq")


def _qwen(proj):
    """The reference's qwen2.5-smoke and the port's (kernel backend
    "auto"), in float32; ``"dense"``: every site at its dense
    strategy."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True, dtype="float32")
    if proj == "dense":
        jcfg = jcfg.replace(projections=jax_dense_map())
        cfg = cfg.replace(projections=dense_projection_map())
    return jcfg, with_kernel_backend(cfg, "auto")


def _perm(name, tp):
    return {"ppermute_shift": [(s, (s + 1) % tp) for s in range(tp)],
            "ppermute_back": [(s, (s - 1) % tp) for s in range(tp)],
            # ranks that receive nothing get zeros; (2, 2) keeps its own
            "ppermute_partial": ([(0, 1), (1, 3), (2, 2)] if tp == 4
                                 else [(1, 0)])}.get(name)


def _collective_cases(rng, tp):
    """{name: (port case, a call that gives the reference's (y, dx))}:
    rank t's block of ``x`` is ``x[t]`` [2, 8, 8], of the cotangent
    ``r[t]``, shaped like its output."""
    axes = JMeshAxes.from_mesh(jax_local_mesh(1, tp))
    out_shape = {"seq_to_feature": (2, 8 * tp, 8 // tp),
                 "feature_to_seq": (2, 8 // tp, 8 * tp)}
    cases = {}
    for name in COLLECTIVES:
        perm = _perm(name, tp)
        x = rng.randn(tp, 2, 8, 8).astype(np.float32)
        r = rng.randn(tp, *out_shape.get(name, (2, 8, 8))).astype(
            np.float32)

        def op(xl, name=name, perm=perm):
            if perm is not None:
                return lax.ppermute(xl, "model", perm)
            return getattr(jax_layers, name)(xl, axes)

        def body(x, r, op=op):
            (_, y), dx = jax.value_and_grad(
                lambda xl: (lambda y: (jnp.sum(y * r[0]), y))(op(xl)),
                has_aux=True)(x[0])
            return y[None], dx[None]
        fn = jax.jit(shard_map(body, mesh=jax_local_mesh(1, tp),
                               in_specs=(P("model"), P("model")),
                               out_specs=(P("model"), P("model")),
                               check_vma=False))
        cases[name] = (
            {"kind": "ppermute" if perm else name, "perm": perm, "x": x,
             "r": r},
            lambda fn=fn, x=x, r=r: tuple(np.asarray(a) for a in fn(x, r)))
    return cases


def _attn_configs(gather_kv):
    kw = dict(name="ring-t", family="dense", num_layers=1, d_model=D,
              num_heads=H, num_kv_heads=KV, d_ff=D, vocab_size=128,
              attn_shard="ring", rope="full", qkv_bias=True,
              dtype="float32", attn_ring_gather_kv=gather_kv)
    return JModelConfig(**kw), ModelConfig(**kw)


def _attention_cases(rng):
    """{name: (port case, a call that gives the reference's results)} of
    ring attention at tp = 4 (the objective sum(out * r))."""
    mesh = jax_local_mesh(1, 4)
    axes = JMeshAxes.from_mesh(mesh)
    cases = {}
    for name, (gather_kv, lay) in ATTN.items():
        jcfg, cfg = _attn_configs(gather_kv)
        decls = jax_attn.attn_decls(jcfg, axes)
        params = jax.tree.map(np.asarray, jax_materialize(decls, seed=9))
        for site in ("wq", "wk", "wv"):     # the biases draw as zeros
            params[site]["b"] = (0.3 * rng.randn(
                *params[site]["b"].shape)).astype(np.float32)
        x = rng.randn(B, S, D).astype(np.float32)
        r = rng.randn(B, S, D).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

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
        fn = jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(pspec, LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], P()),
            out_specs=(LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], pspec),
            check_vma=False))
        cases[name] = (
            {"kind": "attention", "cfg": cfg, "layout": lay, "x": x,
             "r": r, "params": params},
            lambda fn=fn, a=(params, x, r, pos): dict(zip(
                ("y", "x", "params"),
                jax.tree.map(np.asarray, fn(*a)))))
    return cases


@pytest.fixture(scope="module")
def runs():
    """Every case's inputs from the reference; then one spawn per mesh
    in a thread of its own while the reference computes its results
    here."""
    rng = np.random.RandomState(11)
    ref, todo, train = {}, [], {m: {} for m in MESHES}
    for name, (proj, dp, tp) in RUNS.items():
        jcfg, cfg = _qwen(proj)
        ref[name], run = _jax_run(jcfg, dp, tp)
        todo.append(run)
        train[(dp, tp)][name] = dict(
            cfg=cfg, params=ref[name]["start"], batches=ref[name]["batches"],
            lr=LR, weight_decay=WD, microbatches=1)
    coll = {m: _collective_cases(rng, m[1]) for m in MESHES}
    attn = _attention_cases(rng)
    out = {"ref": ref}
    errors = []

    def ranks(dp, tp):
        try:
            out[(dp, tp)] = spawn(
                torch_ranks.ring_body, dp, tp, "cpu", timeout_s=300,
                args=({"collectives": {k: c for k, (c, _)
                                       in coll[(dp, tp)].items()},
                       "layers": ({k: c for k, (c, _) in attn.items()}
                                  if (dp, tp) == (1, 4) else {}),
                       "train": train[(dp, tp)]},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=m) for m in MESHES]
    for t in threads:
        t.start()
    # XLA compiles outside the interpreter lock: the runs overlap
    with ThreadPoolExecutor(len(todo)) as pool:
        for f in [pool.submit(run) for run in todo]:
            f.result()
    out["collectives"] = {m: {k: (c, want()) for k, (c, want) in
                              coll[m].items()} for m in MESHES}
    out["attention"] = {k: (c, want()) for k, (c, want) in attn.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=["tp4", "tp2"])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_jax(runs, mesh, name):
    """Each rank's output and input gradient against the reference's, on
    every dp group; a ppermute hop is logged on its sender only, as one
    ``collective_permute`` of its message, an all-to-all as one
    ``all_to_all`` of the rank's whole block."""
    case, (want_y, want_x) = runs["collectives"][mesh][name]
    tp = mesh[1]
    for r, rank in enumerate(runs[mesh]):
        t = r % tp
        got = rank["collectives"][name]
        np.testing.assert_array_equal(got["y"], want_y[t],
                                      err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(got["x"], want_x[t],
                                      err_msg=f"{name} rank {r}")
        floats = case["x"][t].size
        if case["perm"] is None:
            want = [("all_to_all", floats, "all_to_all_single")] * 2
        else:
            # forward: t sends; backward (the inverse): t received
            hops = [(s, d) for s, d in case["perm"] if s != d]
            n = sum(s == t for s, _ in hops) + sum(d == t for _, d in hops)
            want = [("collective_permute", floats, "isend")] * n
        assert got["log"] == want, (name, r, got["log"])


@pytest.mark.parametrize("name", list(ATTN))
def test_ring_attention_matches_reference(runs, name):
    case, want = runs["attention"][name]
    ranks = [r["layers"][name] for r in runs[(1, 4)]]
    dim = {"sp": 1, "fp": 2}[case["layout"]]
    _values_close(np.concatenate([r["y"] for r in ranks], dim), want["y"],
                  name)
    _grads_close(np.concatenate([r["x"] for r in ranks], dim), want["x"],
                 name)
    decls = attn_decls(case["cfg"], MeshAxes(tp=4))
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, 1, 4)))
    for path, w in tree_leaves(want["params"]):
        _grads_close(got[path], w, f"{name} {path}")


@pytest.mark.parametrize("name", list(RUNS))
def test_qwen_train_step_matches_jax(runs, name):
    proj, dp, tp = RUNS[name]
    hold_train_steps(name, _qwen(proj)[1], runs["ref"][name],
                     [r["train"][name] for r in runs[(dp, tp)]], dp, tp)


@pytest.mark.parametrize("proj", ["config", "dense"])
@pytest.mark.parametrize("smoke", [True, False])
def test_qwen_decls_and_count_match_reference_at_tp4(proj, smoke):
    """Every leaf's shape and spec at tp = 4 (ring attention's weights
    sharded on their input dim, its biases replicated) and the
    parameter count equal the reference's."""
    jcfg, cfg = _qwen(proj)
    if not smoke:
        jcfg = jax_get_config(ARCH).replace(projections=jcfg.projections)
        cfg = get_config(ARCH).replace(projections=cfg.projections)
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=4, dp=1, dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=4)))}
    assert ours == theirs
    assert ours["layers/mixer/wq/w"][1] == (None, "tp", None)
    assert ours["layers/mixer/wq/b"][1] == (None, None)
    assert count_params(cfg, 4) == jax_count_params(jcfg, tp=4)


def test_launch_train_qwen_at_tp2_runs_on_the_cpu(capfd):
    assert launch_train.main(["--arch", ARCH, "--tp", "2", "--device",
                              "cpu", "--steps", "2", "--batch", "4",
                              "--seq", "32"]) == 0
    out = capfd.readouterr().out
    assert "# qwen2.5-smoke impl=phantom dp=1 on cpu (tp=2," in out
    assert "[trainer] step 2 loss " in out and " ms/it" in out
