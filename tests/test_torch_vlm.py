"""The port's vision-language family (qwen2-vl-72b) against the JAX package,
on the CPU.

* M-RoPE: ``mrope_sections`` at head dims 16 to 128, and ``apply_mrope``
  with three distinct position rows at hd 16, 64 and 128, float32, rtol
  1e-5 / atol 1e-5; at t = h = w the reference's per-section ladder is
  not the whole head's rotary (the published M-RoPE reduces to it
  there): the difference that ROADMAP.md queue 3 records.
* The vision splice (``models/model.py: _embed``) at tp 4 in the ``fp``
  (phantom MLP sites) and ``sp`` (dense sites) layouts against the
  reference's ``_embed`` under ``shard_map``, float32, rtol 1e-6; the
  ``rep`` layout (tp 1) through prefill below.
* Decls (every leaf's shape and spec at 1 x 4 and, FSDP, 2 x 2) and
  ``count_params`` at tp 1, 4 and 16, full and smoke.
* Training, float32, Adafactor (the full config's optimizer), two steps
  from the reference's parameters and optimizer state before each
  (``hold_steps``), on ``tests/helpers.py: make_batch`` batches whose
  three position rows differ (so that a cut of ``positions`` on the
  wrong axis shows): at tp 1, tp 4, dp 2 x tp 2 with ``fsdp=True``
  (``local_rows`` cuts ``positions`` on axis 1) and dp 2 x tp 2 in ring
  mode (``attn_shard="ring"``: the chunk's positions sliced on axis 2).
  Losses rtol 1e-5; gradient norms rtol 1e-3; the clipped gradients
  within 1e-3 of their norm and each leaf within 1e-2 of its largest;
  parameters rtol 1e-4 / atol 1e-5.
* Prefill's last logits and K/V cache with random vision embeddings,
  and one decode step on the cache padded to twice the prompt (M-RoPE
  at ``pos`` broadcast to ``[3, B, 1]``), against the reference's,
  float32, within 1e-4 of the largest.
* Both ``ServeEngine``s' greedy streams in float32 (mixed-length
  buckets: the vlm family is not recurrent), both kernel backends.
* ``chip_smoke.py: fsdp_wire_bytes`` (the dense head-mode count) against
  the bytes one bf16 step of qwen2-vl-smoke with FSDP logs at tp 4, to
  the byte: the splice is local in ``fp``.
* The launchers: serving runs on the CPU; training raises (the
  reference's launcher feeds no ``positions``).

One spawn per mesh (1 x 4 and 2 x 2), in threads of their own while the
reference compiles and runs here.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from helpers import make_batch
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.launch.specs import input_specs as jax_input_specs
from repro.models import model as jax_model
from repro.models import rope as jax_rope
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
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import (dense_projection_map, get_config,
                                      with_kernel_backend)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import rope
from repro_torch.models.model import (count_params, forward_decode,
                                      forward_prefill, model_decls)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_trainer_tp import _norm_spec

ARCH = "qwen2-vl-72b"
B, S, STEPS = 8, 64, 2
# name: (overrides, dp, tp); tp 1 runs in this process
TRAIN = {"vlm_tp1": ({}, 1, 1),
         "vlm_tp4": ({}, 1, 4),
         "vlm_fsdp_dp2_tp2": ({"fsdp": True}, 2, 2),
         "vlm_ring_dp2_tp2": ({"attn_shard": "ring"}, 2, 2)}
MESHES = ((1, 4), (2, 2))
WIRE = {"B": 4, "S": 64}
LAYOUT_SPEC = {"sp": P(None, "model", None), "fp": P(None, None, "model")}

chip_smoke = torch_ranks.load_chip_smoke()


def cfgs(arch, overrides=None, dtype="float32"):
    """The reference's smoke config and the port's (kernel backend
    "auto"), Adafactor, in ``dtype``."""
    kw = dict(dtype=dtype, optimizer="adafactor", **(overrides or {}))
    return (jax_get_config(arch, smoke=True).replace(**kw),
            with_kernel_backend(get_config(arch, smoke=True, **kw), "auto"))


def redrawn(params, seed):
    """The reference's parameters as numpy, with every norm and bias leaf
    redrawn non-zero (scales 1 + 0.2 N(0, 1), shifts and biases
    0.2 N(0, 1)): at their zero init the encoder's memory of zero frames
    and a biased site's shift would be invisible."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        a = np.array(tree)
        if path.endswith("/scale"):
            return (1 + 0.2 * rng.randn(*a.shape)).astype(a.dtype)
        if path.endswith("/bias") or path.endswith("/b"):
            return (0.2 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return walk(jax.tree.map(np.asarray, params), "")


def jax_train_run(jcfg, dp, tp, batches, redraw_seed=None):
    """The reference's trainer on ``batches`` (its input specs as the batch
    spec), Adafactor, from its seeded parameters (norm and bias leaves
    redrawn with ``redraw_seed``): the state before each step and each
    step's results, as ``tests/test_torch_lm_pipeline.py: _jax_run``
    records them."""
    mesh = jax_local_mesh(dp, tp)
    axes = JMeshAxes.from_mesh(mesh)
    opt = lm_pipeline._JRecordingAdafactor(lm_pipeline.LR,
                                           weight_decay=lm_pipeline.WD)
    _, bspec = jax_input_specs(jcfg, JShapeConfig("t", S, B, "train"), axes)
    step, decls, _ = jax_make_train_step(jcfg, mesh, opt, batch_spec=bspec)
    params = jax_materialize(decls, seed=3)
    if redraw_seed is not None:
        params = jax.tree.map(jnp.asarray, redrawn(params, redraw_seed))
    out = {"batches": batches, "starts": [lm_pipeline._start(
        params, opt.init(params))], "losses": [], "grad_norms": [],
        "grads": [], "params": []}

    def run():
        p, state = params, opt.init(params)
        for s, batch in enumerate(batches):
            p, state, m = step(p, state, jnp.int32(s), batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["grads"].append(jax.tree.map(np.array, state["g"]))
            out["params"].append(jax.tree.map(np.array, p))
            if s + 1 < len(batches):
                out["starts"].append(lm_pipeline._start(p, state, mesh))
    return out, run


def hold_steps(name, cfg, want, ranks, dp, tp):
    """Every rank's steps of one case against the reference's, with the
    tolerances of the module's docstring."""
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-3, err_msg=name)
    decls = model_decls(cfg, MeshAxes(dp=dp, tp=tp))

    def gathered(key, s):
        return dict(tree_leaves(gather_params([r[key][s] for r in ranks],
                                              decls, dp, tp)))
    for s in range(len(want["params"])):
        grads, num, den = gathered("grads", s), 0.0, 0.0
        for path, w in tree_leaves(want["grads"][s]):
            d = np.float64(grads[path]) - w
            num, den = num + np.sum(d * d), den + np.sum(np.float64(w) ** 2)
            assert np.abs(d).max() <= 1e-2 * np.abs(w).max() + 1e-7, (
                f"{name} step {s} gradient {path}: {np.abs(d).max():.3e} "
                f"of {np.abs(w).max():.3e}")
        assert np.sqrt(num) <= 1e-3 * np.sqrt(den), (
            name, s, np.sqrt(num / den))
        params = gathered("params", s)
        for path, w in tree_leaves(want["params"][s]):
            diff = np.abs(np.float64(params[path]) - w)
            tol = 1e-5 + 1e-4 * np.abs(w)
            assert (diff <= tol).all(), (
                f"{name} step {s} {path}: {int((diff > tol).sum())} "
                f"elements outside, worst {diff.max():.3e}")


def run_families(cases, meshes, body_inputs):
    """The reference's runs of ``cases`` ({name: (jcfg, cfg, dp, tp,
    batches, redraw_seed)}) in threads; then one spawn per mesh of
    ``torch_ranks.family_body`` with the mesh's trainer cases and
    ``body_inputs[mesh]`` (its layer, splice and wire cases), in threads
    of their own, and the tp 1 cases in this process.  Returns {"ref":
    {name: results}, mesh: the ranks' results, (1, 1): this process's}."""
    with ThreadPoolExecutor(8) as pool:
        made = {name: pool.submit(jax_train_run, jc, dp, tp, batches, seed)
                for name, (jc, _, dp, tp, batches, seed) in cases.items()}
        ref = {}
        for name, f in made.items():
            ref[name], run = f.result()
            made[name] = pool.submit(run)
        for f in made.values():
            f.result()
    port = {m: {} for m in meshes + ((1, 1),)}
    for name, (_, cfg, dp, tp, _, _) in cases.items():
        port[(dp, tp)][name] = dict(
            cfg=cfg, starts=ref[name]["starts"],
            batches=ref[name]["batches"], lr=lm_pipeline.LR,
            weight_decay=lm_pipeline.WD, microbatches=1,
            optimizer="adafactor")
    out, errors = {"ref": ref}, []

    def ranks(dp, tp):
        try:
            out[(dp, tp)] = spawn(torch_ranks.family_body, dp, tp, "cpu",
                                  timeout_s=300, args=(
                                      {"train": port[(dp, tp)],
                                       **body_inputs.get((dp, tp), {})},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=m) for m in meshes]
    for t in threads:
        t.start()
    out[(1, 1)] = [torch_ranks.family_body(MeshAxes(), "cpu",
                                           {"train": port[(1, 1)]})]
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def reference_fn(mesh_shape, body, in_specs, out_specs):
    mesh = jax_local_mesh(*mesh_shape)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False))
    return lambda *a: jax.tree.map(np.asarray, f(*a))


def decl_table(decls):
    return {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(decls)}


def reference_decl_table(jcfg, dp, tp):
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=tp, dp=dp,
                                             dp_names=("data",)))
    return dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 64, 80, 96, 128])
def test_mrope_sections_match_reference(hd):
    assert rope.mrope_sections(hd) == jax_rope.mrope_sections(hd)
    assert sum(rope.mrope_sections(hd)) == hd


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_apply_mrope_matches_reference(hd):
    """Three distinct position rows (t, h, w), each row's ids drawn per
    batch row."""
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 12, 3, hd).astype(np.float32)
    pos = rng.randint(0, 500, (3, 2, 12)).astype(np.int32)
    want = np.asarray(jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                           theta=1e6))
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta=1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # each section moves with its own row only
    moved = pos.copy()
    moved[2] += 7
    other = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved),
                             theta=1e6).numpy()
    s0, s1, _ = rope.mrope_sections(hd)
    np.testing.assert_array_equal(other[..., :s0 + s1],
                                  got[..., :s0 + s1])
    assert not np.allclose(other[..., s0 + s1:], got[..., s0 + s1:])


def test_mrope_ladder_is_per_section_in_the_reference():
    """At t = h = w Qwen2-VL's published M-RoPE is the whole head's rotary
    (one frequency ladder); the reference's, which the port follows,
    rotates each section over its own ladder and is not (ROADMAP.md
    queue 3)."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 16, 2, 128).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (1, 16))
    same = np.stack([pos, pos, pos])
    theirs = np.asarray(jax_rope.apply_mrope(jnp.asarray(x),
                                             jnp.asarray(same)))
    whole = np.asarray(jax_rope.apply_rope(jnp.asarray(x),
                                           jnp.asarray(pos)))
    assert np.abs(theirs - whole).max() > 0.1
    ours = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(same))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decls and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("smoke", [True, False])
def test_decls_and_counts_match_reference(smoke, mesh):
    """Every leaf's shape and spec (the full config's FSDP dims at dp 2)
    and the parameter counts at tp 1, 4 and 16 (the full config's inside
    the reference's 55-90 G, ``tests/test_models_smoke.py``)."""
    dp, tp = mesh
    jcfg, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                              smoke=smoke)
    assert decl_table(model_decls(cfg, MeshAxes(tp=tp, dp=dp))) == \
        reference_decl_table(jcfg, dp, tp)
    for t in (1, 4, 16) if not smoke else (1, 4):
        assert count_params(cfg, t) == jax_count_params(jcfg, tp=t)
    if not smoke:
        dense = cfg.replace(projections=dense_projection_map())
        assert 55e9 < count_params(dense, 16) < 90e9
        assert count_params(cfg, 1) == 72_996_200_448
        assert count_params(cfg, 4) == 29_913_489_408


# ---------------------------------------------------------------------------
# the splice, training, wire bytes
# ---------------------------------------------------------------------------

def _batches(jcfg):
    """``make_batch``'s batches (seeds 1, 2, ...), their three position
    rows made distinct and different per batch row."""
    out = []
    for s in range(STEPS):
        b = {k: np.asarray(v) for k, v in
             make_batch(jcfg, B, S, seed=s + 1).items()}
        ar = np.arange(S, dtype=np.int32)
        rows = np.arange(B, dtype=np.int32)[:, None]
        b["positions"] = np.stack([ar + 3 * rows, ar // 2 + rows + s,
                                   np.broadcast_to((ar * 5) % S, (B, S))])
        out.append(b)
    return out


def _splice_cases(rng):
    """{name: (port case, the reference's local streams)} of ``_embed`` at
    tp 4 in ``fp`` and ``sp``."""
    mesh = jax_local_mesh(1, 4)
    axes = JMeshAxes.from_mesh(mesh)
    cases = {}
    for lay, dense in (("fp", False), ("sp", True)):
        jcfg, cfg = cfgs(ARCH)
        if dense:
            jcfg = jcfg.replace(projections=jax_dense_map())
            cfg = cfg.replace(projections=dense_projection_map())
        table = (rng.randn(256, 64) * 0.02).astype(np.float32)
        tokens = rng.randint(0, 256, (2, 32)).astype(np.int32)
        vision = rng.randn(2, 8, 64).astype(np.float32)

        def body(table, tokens, vision, jcfg=jcfg, lay=lay):
            return jax_model._embed(jcfg, lay, {"embed": {"table": table}},
                                    {}, {"tokens": tokens,
                                         "vision_embeds": vision}, axes)
        fn = reference_fn((1, 4), body, (P("model", None), P(), P()),
                          LAYOUT_SPEC[lay])
        cases[f"splice_{lay}"] = (
            {"cfg": cfg, "layout": lay, "table": table, "tokens": tokens,
             "vision": vision}, fn(table, tokens, vision))
    return cases


@pytest.fixture(scope="module")
def runs():
    cases = {}
    for name, (ov, dp, tp) in TRAIN.items():
        jcfg, cfg = cfgs(ARCH, ov)
        cases[name] = (jcfg, cfg, dp, tp, _batches(jcfg), None)
    splice = _splice_cases(np.random.RandomState(7))
    wire_cfg = cfgs(ARCH, {"fsdp": True}, dtype="bfloat16")[1]
    body = {(1, 4): {"splice": {k: c for k, (c, _) in splice.items()},
                     "wire": {"vlm_bf16": dict(cfg=wire_cfg,
                                               batch=WIRE["B"],
                                               seq=WIRE["S"])}}}
    out = run_families(cases, MESHES, body)
    out["splice"] = {k: w for k, (_, w) in splice.items()}
    out["wire_cfg"] = wire_cfg
    return out


@pytest.mark.parametrize("layout", ["fp", "sp"])
def test_vision_splice_matches_reference(runs, layout):
    """Each rank's stream after the splice, assembled over the model axis
    (its feature shard in ``fp``, its sequence chunk in ``sp``)."""
    name = f"splice_{layout}"
    got = np.concatenate([r["splice"][name] for r in runs[(1, 4)]],
                         axis={"fp": 2, "sp": 1}[layout])
    want = runs["splice"][name]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.shape == (2, 32, 64)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(runs, name):
    ov, dp, tp = TRAIN[name]
    ranks = [r["train"][name] for r in runs[(dp, tp)]]
    assert all(len(r["losses"]) == STEPS for r in ranks)
    hold_steps(name, cfgs(ARCH, ov)[1], runs["ref"][name], ranks, dp, tp)


def test_wire_bytes_equal_the_dense_head_mode_count(runs):
    """Every rank's logged wire bytes of one bf16 step of qwen2-vl-smoke
    with FSDP at dp 1 x tp 4 (its replicated KV projection: 2 KV heads
    over 4 ranks) equal ``chip_smoke.py: fsdp_wire_bytes``, the count
    phase 15 holds on the card."""
    want = chip_smoke.fsdp_wire_bytes(runs["wire_cfg"], WIRE["B"],
                                      WIRE["S"], 4, 1)
    for r in runs[(1, 4)]:
        assert r["wire"]["vlm_bf16"]["wire_bytes"] == want, r["wire"]


# ---------------------------------------------------------------------------
# prefill, decode, serving
# ---------------------------------------------------------------------------

def _reference_prefill_decode(jcfg, params, batch, tok, pad_to):
    """The reference's prefill of ``batch`` and one decode step of ``tok``
    at position S on its cache padded to ``pad_to`` rows, on a 1 x 1
    mesh: (prefill logits, cache, decode logits, new cache)."""
    mesh = jax_local_mesh(1, 1)
    axes = JMeshAxes.from_mesh(mesh)
    decls = jax_model_decls(jcfg, axes)
    pspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes),
                          jax_specs(decls))
    pre = jax.jit(shard_map(
        lambda p, b: jax_model.forward_prefill(jcfg, axes, p, b), mesh=mesh,
        in_specs=(pspecs, P()), out_specs=P(), check_vma=False))
    dec = jax.jit(shard_map(
        lambda p, c, t, pos: jax_model.forward_decode(jcfg, axes, p, c, t,
                                                      pos),
        mesh=mesh, in_specs=(pspecs, P(), P(), P()), out_specs=P(),
        check_vma=False))
    lg, cache = pre(params, batch)
    padded = jax.tree.map(lambda c: jnp.pad(c, [(0, 0), (0, 0),
                                                (0, pad_to - c.shape[2]),
                                                (0, 0), (0, 0)]), cache)
    Bt, S_ = batch["tokens"].shape
    lg2, cache2 = dec(params, padded, jnp.asarray(tok),
                      jnp.full((Bt,), S_, jnp.int32))
    return tuple(jax.tree.map(np.asarray, x)
                 for x in (lg, padded, lg2, cache2))


def port_prefill_decode(cfg, params, batch, tok, pad_to):
    """The port's counterpart of ``_reference_prefill_decode``."""
    one = MeshAxes()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        lg, cache = forward_prefill(cfg, one, params, tb)
        padded = {}
        for path, c in tree_leaves(cache):
            z = torch.zeros(c.shape[:2] + (pad_to,) + c.shape[3:])
            z[:, :, :c.shape[2]] = c
            padded[path] = z
        nested = {}
        for path, c in padded.items():
            *outer, name = path.split("/")
            node = nested
            for k in outer:
                node = node.setdefault(k, {})
            node[name] = c.clone()       # decode writes in place
        n = tb["tokens"].shape[0]
        lg2, cache2 = forward_decode(
            cfg, one, params, nested, torch.from_numpy(tok).long(),
            torch.full((n,), tb["tokens"].shape[1]))
    return lg, padded, lg2, cache2


def hold_logits(got, want, V, msg=""):
    w = np.asarray(want)[..., :V]
    np.testing.assert_allclose(got.numpy()[..., :V], w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max(), err_msg=msg)


def hold_cache(got_flat, want_tree, msg=""):
    for path, w in tree_leaves(want_tree):
        g = got_flat[path].float().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{msg} {path}")


def test_prefill_and_decode_match_reference():
    """Prefill 32 tokens with random vision embeddings over the first 8
    positions (the ``rep`` layout's splice: a concatenate) and M-RoPE
    positions ``arange`` on each row, then decode the 33rd token at
    ``pos`` 32 on the cache padded to 64: prefill logits and K/V, decode
    logits and the written cache, float32."""
    Bt, St = 4, 32
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True, dtype="float32")
    params = redrawn(jax_materialize(jax_model_decls(
        jcfg, JMeshAxes.from_mesh(jax_local_mesh(1, 1))), 3), 9)
    batch = {k: np.asarray(v) for k, v in
             make_batch(jcfg, Bt, St, seed=4).items() if k != "labels"}
    tok = np.random.RandomState(5).randint(0, 256, (Bt, 1)).astype(np.int32)
    want = _reference_prefill_decode(jcfg, jax.tree.map(jnp.asarray, params),
                                     batch, tok, 2 * St)
    got = port_prefill_decode(cfg, from_jax_params(params), batch, tok,
                              2 * St)
    V = cfg.vocab_size
    hold_logits(got[0], want[0], V, "prefill")
    hold_cache(got[1], want[1], "prefill")
    hold_logits(got[2], want[2], V, "decode")
    hold_cache(dict(tree_leaves(got[3])), want[3], "decode")


def _prompts():
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32)
            for n in (5, 17, 16, 9, 12, 24)]


SLOTS, MAX_LEN, PAGE = 2, 64, 8


@pytest.fixture(scope="module")
def serve_ref():
    """The reference's smoke params (1 x 1 mesh) and its engine's greedy
    streams (mixed-length buckets of ``PAGE``)."""
    mesh = jax_local_mesh(1, 1)
    cfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    params = jax_materialize(jax_model_decls(
        cfg, JMeshAxes.from_mesh(mesh)), 5)
    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PAGE)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=5) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    return (jax.tree.map(np.asarray, params),
            [list(r.out_tokens) for r in reqs])


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_engine_greedy_streams_match_reference(serve_ref, backend):
    params, want = serve_ref
    cfg = with_kernel_backend(get_config(ARCH, smoke=True, dtype="float32"),
                              backend)
    eng = ServeEngine(cfg, from_jax_params(params), slots=SLOTS,
                      max_len=MAX_LEN, page_size=PAGE, device="cpu")
    assert eng.scheduler.mixed_lengths
    reqs = [Request(prompt=p.copy(), max_new_tokens=5) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.pages.allocated_pages == 0


def test_launch_serve_vlm_smoke_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "# served qwen2-vl-smoke on cpu" in out
    assert "requests=3 tokens=9" in out


def test_launch_train_raises_for_the_vlm_family():
    """The reference's launcher feeds ``LMDataset`` batches, which carry
    no M-RoPE ``positions`` (its ``models/model.py: _positions`` reads
    ``batch["positions"]``): the port's raises instead."""
    from repro.data.synthetic import LMDataset as JLMDataset
    assert "positions" not in JLMDataset(256, 2, 9)(0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 3"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1"])
