"""The port's MoE family against the JAX package, on the CPU.

* ``route`` and ``moe_capacity``: the dispatch tables (``disp_tok``,
  ``disp_ok``, ``combine_slot``) equal, gates within 1e-6, on random
  logits with ample capacity and with overflow drops, and on logits that
  send every token to one expert; ``_aux_loss`` within 1e-6.
* ``moe_apply`` at tp = 4 on gloo CPU ranks (mesh 1 x 4) against the
  reference's ``moe_apply`` inside ``shard_map`` on the same mesh: the
  reference's ``tests/test_moe.py`` cases (expert partition in ``fp``,
  ``sp`` and ``rep``, tensor partition in ``sp`` and ``rep``; E 8, top-2,
  d 32, d_ff 16) at its ample capacity factor 8 and at 1 (drops), and
  phantom experts (tensor partition, ``moe_experts`` phantom, ``fp``):
  outputs, aux, input and parameter gradients of sum(y * r) + aux.
* Three AdamW steps of olmoe-smoke at tp 1 and tp 2 and of
  granite-smoke (ring attention, tensor-partitioned experts) at tp 2
  against the reference's trainer (``tests/test_torch_trainer_tp.py:
  hold_train_steps``); one AdamW step of olmoe-smoke at pp 2 x tp 2
  over 2 microbatches, from the reference's initial parameters
  (``tests/test_torch_lm_pipeline.py: hold_pipelined_steps``), the aux
  loss entering over dp x M.
* Greedy token streams of the two ``ServeEngine``s on olmoe-smoke and
  granite-smoke, prompts of mixed lengths (bucket pads are tokens too:
  routed, taking capacity), both kernel backends.
* Decls (shapes and specs at tp = 4) and parameter counts (total and
  active) against the reference's; the launchers on the CPU.

Tolerances: float32 values rtol 1e-5 / atol 1e-6 of the array's largest
magnitude, gradients rtol 1e-4 / atol 1e-5 of it; the trainer runs
``tests/test_torch_trainer.py``'s (AdamW's near-eps elements held to
what their gradients imply).  The routing is discrete: both sides pick
the same experts on these inputs, so the tolerances hold the arithmetic
around it.  One spawn per mesh (1 x 4, 1 x 2, pp 2 x 1 x 2), in threads
of their own while the reference compiles and runs here.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ProjectionSpec as JProjectionSpec
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import phantom_projection_map as jax_phantom_map
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import moe as jax_moe
from repro.models.model import count_params as jax_count_params
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.compat import shard_map
from repro.parallel.params import is_decl
from repro.parallel.params import materialize as jax_materialize
from repro.parallel.params import specs as jax_specs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import (ModelConfig, MoEConfig, ProjectionSpec,
                                      dense_projection_map, get_config,
                                      phantom_projection_map,
                                      with_kernel_backend)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe
from repro_torch.models.model import count_params, model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_trainer import LR, WD
from test_torch_trainer_tp import (_grads_close, _jax_run, _norm_spec,
                                   _tp_psum, _values_close,
                                   hold_train_steps)

ARCHS = {"olmoe": "olmoe-1b-7b", "granite": "granite-moe-3b-a800m"}
# the layer cases: E 8, top-2, d 32, d_ff 16, B 2, S 16 at tp 4
E, K, D, FF, B, S, TP = 8, 2, 32, 16, 2, 16, 4
# name: (partition, layout, capacity factor, phantom experts)
LAYERS = {f"{part}_{lay}_cf{cf:g}": (part, lay, cf, False)
          for cf in (8.0, 1.0)
          for part, lay in (("expert", "fp"), ("expert", "sp"),
                            ("expert", "rep"), ("tensor", "sp"),
                            ("tensor", "rep"))}
LAYERS["phantom_experts_fp_cf1.25"] = ("tensor", "fp", 1.25, True)
# name: (arch, tp); dp 1
TRAIN = {"olmoe_tp1": ("olmoe", 1), "olmoe_tp2": ("olmoe", 2),
         "granite_tp2": ("granite", 2)}
PIPE = ("olmoe_pp2_tp2", "olmoe", 2, 1, 2, 2)   # name, arch, pp, dp, tp, M
LAYOUT_SPEC = {"fp": P(None, None, "model"), "sp": P(None, "model", None),
               "rep": P()}


# ---------------------------------------------------------------------------
# routing, capacity, aux
# ---------------------------------------------------------------------------

def _route_logits(case):
    rng = np.random.RandomState(3)
    if case == "one_expert":           # every token to expert 0
        logits = np.zeros((32, 2), np.float32)
        logits[:, 0] = 10.0
        return logits, 1, 4
    T, E_, C = {"ample": (64, 4, 64), "overflow": (64, 4, 8)}[case]
    return rng.randn(T, E_).astype(np.float32), 2, C


@pytest.mark.parametrize("case", ["ample", "overflow", "one_expert"])
def test_route_matches_reference(case):
    logits, k, C = _route_logits(case)
    want = [np.asarray(a) for a in jax_moe.route(jnp.asarray(logits), k, C)]
    got = [t.numpy() for t in moe.route(torch.from_numpy(logits), k, C)]
    for name, g, w in zip(("disp_tok", "disp_ok", "gates", "combine_slot"),
                          got, want):
        if name == "gates":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
    kept = int((got[3] >= 0).sum())
    assert int(got[1].sum()) == kept
    if case != "ample":
        assert kept < logits.shape[0] * k          # drops happened
    if case == "one_expert":
        assert kept == C


@pytest.mark.parametrize("tokens,E_,k,cf", [
    (4, 64, 8, 1.25), (192, 64, 8, 1.25), (2048, 64, 8, 1.25),
    (8192, 40, 8, 1.25), (32, 8, 2, 8.0), (512, 8, 2, 1.0), (3, 8, 2, 1.25)])
def test_moe_capacity_matches_reference(tokens, E_, k, cf):
    assert moe.moe_capacity(tokens, E_, k, cf) == \
        jax_moe.moe_capacity(tokens, E_, k, cf)
    assert moe.moe_capacity(2048, 64, 8, 1.25) == 320   # olmoe, B 4 x S 512


@pytest.mark.parametrize("case", ["balanced", "skewed"])
def test_aux_loss_matches_reference(case):
    rng = np.random.RandomState(2)
    logits = (rng.randn(512, 8) * 0.01).astype(np.float32)
    if case == "skewed":
        logits[:, 0] += 10.0
    got = float(moe._aux_loss(torch.from_numpy(logits), 8))
    want = float(jax_moe._aux_loss(jnp.asarray(logits), 8))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got > 7.9) == (case == "skewed")


# ---------------------------------------------------------------------------
# the layer at tp = 4, the trainer, the pipeline
# ---------------------------------------------------------------------------

def _layer_cfgs(partition, layout, cf, phantom_experts):
    """The reference's and the port's one-layer MoE config, float32: the
    ``fp`` layout where a site is phantom (the attention sites, or the
    phantom experts)."""
    kw = dict(name="moe-t", family="moe", num_layers=1, d_model=D,
              num_heads=4, num_kv_heads=4, d_ff=FF, vocab_size=128,
              dtype="float32")
    m = dict(num_experts=E, top_k=K, d_ff_expert=FF, partition=partition,
             capacity_factor=cf)
    if phantom_experts:
        jproj = dataclasses.replace(
            jax_phantom_map(4), moe_experts=JProjectionSpec("phantom", k=4))
        proj = dataclasses.replace(
            phantom_projection_map(4), moe_experts=ProjectionSpec(
                "phantom", k=4, kernel_backend="auto"))
    elif layout == "fp":
        jproj, proj = jax_phantom_map(4, attn=True), \
            phantom_projection_map(4, attn=True)
    else:
        jproj, proj = jax_dense_map(), dense_projection_map()
    return (JModelConfig(**kw, moe=JMoEConfig(**m), projections=jproj),
            ModelConfig(**kw, moe=MoEConfig(**m), projections=proj))


def _layer_cases(rng):
    """{name: (port case, a call that gives the reference's results)}:
    each rank's y, aux, input gradient (stacked over the model axis) and
    the parameter gradients (summed over it where replicated)."""
    mesh = jax_local_mesh(1, TP)
    axes = JMeshAxes.from_mesh(mesh)
    cases = {}
    for name, (part, lay, cf, ph) in LAYERS.items():
        jcfg, cfg = _layer_cfgs(part, lay, cf, ph)
        assert cfg.uses_phantom_sites() == (lay == "fp")
        decls = jax_moe.moe_decls(jcfg, axes)
        params = jax.tree.map(np.asarray, jax_materialize(decls, seed=5))
        x = (rng.randn(B, S, D) * 0.5).astype(np.float32)
        r = rng.randn(B, S, D).astype(np.float32)

        def body(params, x, r, jcfg=jcfg, lay=lay, decls=decls):
            def obj(params, x):
                y, aux = jax_moe.moe_apply(jcfg, lay, params, x, axes)
                return jnp.sum(y * r) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(params, x)
            return y[None], aux[None], gx[None], _tp_psum(gp, decls, axes)
        pspec = jax.tree.map(lambda s: resolve_spec(s, axes),
                             jax_specs(decls))
        xs = LAYOUT_SPEC[lay]
        fn = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(pspec, xs, xs),
            out_specs=(P("model"), P("model"), P("model"), pspec),
            check_vma=False))
        cases[name] = (
            {"cfg": with_kernel_backend(cfg, "auto"), "layout": lay,
             "x": x, "r": r, "params": params},
            lambda fn=fn, a=(params, x, r): dict(zip(
                ("y", "aux", "x", "params"),
                jax.tree.map(np.asarray, fn(*a)))))
    return cases


def _train_cfgs(arch):
    """The reference's smoke config and the port's (kernel backend
    "auto"), in float32."""
    jcfg = jax_get_config(ARCHS[arch], smoke=True).replace(dtype="float32")
    cfg = get_config(ARCHS[arch], smoke=True, dtype="float32")
    return jcfg, with_kernel_backend(cfg, "auto")


@pytest.fixture(scope="module")
def runs():
    """The reference's set-ups, layer cases, trainer runs and pipelined
    run (in threads: XLA compiles outside the interpreter lock), beside
    one spawn per mesh in threads of their own; tp = 1 in this
    process."""
    pname, parch, pp, dp, tp, M = PIPE
    with ThreadPoolExecutor(8) as pool:
        made = {name: pool.submit(_jax_run, _train_cfgs(arch)[0], 1, tp_)
                for name, (arch, tp_) in TRAIN.items()}
        made[pname] = pool.submit(
            lm_pipeline._jax_run, _train_cfgs(parch)[0], pp, dp, tp, M,
            "adamw", steps=1)
        made_layers = pool.submit(_layer_cases, np.random.RandomState(7))
        ref, todo = {}, []
        for name, f in made.items():
            ref[name], run = f.result()
            todo.append(run)
        layers = made_layers.result()
    train = {1: {}, 2: {}}
    for name, (arch, tp_) in TRAIN.items():
        train[tp_][name] = dict(
            cfg=_train_cfgs(arch)[1], params=ref[name]["start"],
            batches=ref[name]["batches"], lr=LR, weight_decay=WD,
            microbatches=1)
    out = {"ref": ref}
    errors = []

    def ranks(key, body, inputs, dp, tp, pp=1):
        try:
            out[key] = spawn(body, dp, tp, "cpu", pp=pp, timeout_s=300,
                             args=(inputs,))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    # one step, from the reference's initial parameters and state
    pipe_case = dict(cfg=_train_cfgs(parch)[1], lr=lm_pipeline.LR,
                     weight_decay=lm_pipeline.WD, microbatches=M,
                     optimizer="adamw", starts=ref[pname]["starts"],
                     batches=ref[pname]["batches"])
    threads = [
        threading.Thread(target=ranks, args=(
            "layers", torch_ranks.moe_body,
            {"layers": {k: c for k, (c, _) in layers.items()},
             "train": {}}, 1, TP)),
        threading.Thread(target=ranks, args=(
            "tp2", torch_ranks.moe_body, {"layers": {}, "train": train[2]},
            1, 2)),
        threading.Thread(target=ranks, args=(
            "pipe", torch_ranks.lm_pipeline_body,
            {"train": {pname: pipe_case}, "draw_cfg": None}, dp, tp, pp))]
    with ThreadPoolExecutor(len(todo) + len(layers)) as pool:
        futures = [pool.submit(run) for run in todo]
        wants = {k: pool.submit(want) for k, (_, want) in layers.items()}
        for t in threads:
            t.start()
        out["tp1"] = [{"train": torch_ranks.trainer_body(
            MeshAxes(), torch.device("cpu"), train[1])}]
        for f in futures:
            f.result()
        out["layers_ref"] = {k: (layers[k][0], f.result())
                             for k, f in wants.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_apply_at_tp4_matches_reference(runs, name):
    """Each rank's output, aux and input gradient, and the gathered
    parameter gradients, against the reference's inside ``shard_map``."""
    case, want = runs["layers_ref"][name]
    ranks = [r["layers"][name] for r in runs["layers"]]
    for t, r in enumerate(ranks):
        _values_close(r["y"], want["y"][t], f"{name} y rank {t}")
        np.testing.assert_allclose(r["aux"], want["aux"][t], rtol=1e-5,
                                   err_msg=f"{name} aux rank {t}")
        _grads_close(r["x"], want["x"][t], f"{name} dx rank {t}")
    decls = moe.moe_decls(case["cfg"], MeshAxes(tp=TP))
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, 1, TP)))
    for path, w in tree_leaves(want["params"]):
        assert got[path].shape == w.shape, (name, path)
        _grads_close(got[path], w, f"{name} {path}")


@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_train_step_matches_jax(runs, name):
    arch, tp = TRAIN[name]
    ranks = runs["tp1"] if tp == 1 else runs["tp2"]
    hold_train_steps(name, _train_cfgs(arch)[1], runs["ref"][name],
                     [r["train"][name] for r in ranks], 1, tp)


def test_moe_pipelined_train_step_matches_jax(runs):
    """olmoe-smoke at pp 2 x tp 2, one layer a stage, 2 microbatches:
    each stage's balance loss enters the objective over dp x M."""
    name, arch, pp, dp, tp, _ = PIPE
    lm_pipeline.hold_pipelined_steps(
        name, _train_cfgs(arch)[1], runs["ref"][name],
        [r["train"][name] for r in runs["pipe"]], pp, dp, tp, "adamw")


def test_forward_train_pipeline_returns_the_stage_aux():
    """At pp 1 the 'pipeline' is every layer in turn: its aux over M
    microbatches is the sum of ``forward_train``'s aux on each."""
    from repro_torch.models.model import forward_train, forward_train_pipeline
    from repro_torch.parallel.params import materialize, tree_map
    cfg = get_config(ARCHS["olmoe"], smoke=True, dtype="float32")
    params = tree_map(lambda t: t.requires_grad_(True), materialize(
        model_decls(cfg, MeshAxes()), torch.Generator().manual_seed(0),
        "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    _, aux = forward_train_pipeline(cfg, MeshAxes(), params, batch, 2,
                                    lambda sl: sl, aux_weight=0.01)
    want = sum(float(forward_train(cfg, MeshAxes(), params, {
        "tokens": toks[i:i + 2], "labels": toks[i:i + 2]})[2].detach())
        for i in (0, 2))
    np.testing.assert_allclose(float(aux), want, rtol=1e-6)
    assert float(aux) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN = 2, 64


@pytest.fixture(scope="module")
def serve_ref():
    """Per arch: the reference's smoke params (1 x 1 mesh) and the greedy
    streams of its engine on mixed-length prompts."""
    out = {}
    mesh = jax_local_mesh(1, 1)
    for arch in ARCHS:
        cfg = jax_get_config(ARCHS[arch], smoke=True)
        params = jax_materialize(jax_model_decls(
            cfg, JMeshAxes.from_mesh(mesh)), 5)
        eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN)
        reqs = [JRequest(prompt=p.copy(), max_new_tokens=4)
                for p in _prompts()]
        eng.run(reqs, max_steps=100)
        out[arch] = (jax.tree.map(np.asarray, params),
                     [list(r.out_tokens) for r in reqs])
    return out


def _prompts():
    """Buckets 16 and 32, padded rows among them."""
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32) for n in (5, 17, 16, 9)]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_greedy_streams_match_reference(serve_ref, arch, backend):
    params, want = serve_ref[arch]
    cfg = with_kernel_backend(get_config(ARCHS[arch], smoke=True), backend)
    eng = ServeEngine(cfg, from_jax_params(params), slots=SLOTS,
                      max_len=MAX_LEN, device="cpu")
    assert eng.params["layers"]["ffn"]["router"]["w"].dtype == \
        torch.float32
    reqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.pages.allocated_pages == 0


def test_engine_serves_float32_activations():
    """With float32 activations the engine starts from its declared bf16
    cache (the reference's cache dtype), splices prefill's float32 K/V
    into it (promoting it, as the reference's merge does), and both
    backends give the same greedy streams."""
    from repro_torch.parallel.params import materialize
    cfg = get_config(ARCHS["olmoe"], smoke=True, dtype="float32")
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    streams = []
    for backend in ("pallas", "xla"):
        eng = ServeEngine(with_kernel_backend(cfg, backend), params,
                          slots=SLOTS, max_len=MAX_LEN, device="cpu")
        assert eng.cache["k"].dtype == torch.bfloat16
        reqs = [Request(prompt=p.copy(), max_new_tokens=4)
                for p in _prompts()]
        eng.run(reqs, max_steps=100)
        assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
        streams.append([list(r.out_tokens) for r in reqs])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# decls, counts, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_decls_and_counts_match_reference(arch, smoke):
    """Every leaf's shape and spec at tp = 4, and the parameter count at
    tp 1 and 4, total and active, equal the reference's."""
    jcfg = jax_get_config(ARCHS[arch], smoke=smoke)
    cfg = get_config(ARCHS[arch], smoke=smoke)
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=4, dp=1, dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=4)))}
    assert ours == theirs
    for tp in (1, 4):
        for active in (False, True):
            assert count_params(cfg, tp, active_only=active) == \
                jax_count_params(jcfg, active_only=active, tp=tp)
    if not smoke and arch == "olmoe":
        assert count_params(cfg) == 6_921_193_472


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launch_train_at_tp2_runs_on_the_cpu(arch, capfd):
    """Both MoE configs' smoke geometry trains on 2 gloo ranks."""
    assert launch_train.main(["--arch", ARCHS[arch], "--tp", "2",
                              "--device", "cpu", "--steps", "2",
                              "--batch", "4", "--seq", "32"]) == 0
    out = capfd.readouterr().out
    cfg = get_config(ARCHS[arch], smoke=True)
    assert (f"impl=phantom dp=1 on cpu (tp=2, kernel_backend=config): "
            f"{count_params(cfg, 2):,} params") in out
    assert "[trainer] step 2 loss " in out


def test_launch_serve_olmoe_smoke_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCHS["olmoe"], "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "# served olmoe-smoke on cpu" in out
    assert "requests=3 tokens=9" in out
