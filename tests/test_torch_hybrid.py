"""The port's hybrid family (jamba-1.5-large-398b) against the JAX package,
on the CPU.

* ``layer_plan`` and ``plan_period``, full (72 layers, period 8) and
  smoke (one 8-layer superblock), equal the reference's.
* Decls: every leaf's shape and spec (the ``{"sub0": ..., "sub7": ...}``
  superblock stack) at tp 4 and, with FSDP, at dp 2 x tp 2, full and
  smoke; ``count_params`` total and active at tp 1 and 4, and the full
  config's at tp 16 too (inside the reference's 300-480 G range).
* Training, float32, from the reference's parameters and optimizer
  state before each step (``hold_hybrid_steps``): 3 Adafactor steps of
  jamba-smoke at dp 1 x tp 4, its loss and gradients among them;
  ``tests/test_torch_hybrid_mesh.py`` holds dp 2 x tp 2 with FSDP and
  pp 2 x tp 2.  Losses rtol 1e-5; gradient norms rtol 1e-3; the
  clipped gradients within 2e-3 of their norm (the difference's norm
  over all leaves) and each leaf within 1e-2 of its largest; parameters
  rtol 1e-4 / atol 1e-5.  The float32 gradients of this random 8-layer
  stack (7 SSD blocks; gradient norm 175 before clipping) are
  ill-conditioned: at tp 1 the port's and the reference's differ from
  the port's float64 gradients by 9.1e-4 and 5.9e-4 of the clipped norm,
  and from each other by 4e-4 (at 2 layers, 1.1e-5).
* Decode against prefill (the reference's ``tests/test_serve.py:
  test_decode_consistent_with_prefill``, capacity factor 16 so that no
  token is dropped): prefill 32 tokens, pad the cache, decode the 33rd,
  against the reference's ``forward_logits`` over 33 tokens, float32,
  within 1e-4 of the largest logit; the prefill's last logits likewise.
* Both ``ServeEngine``s' greedy streams on exact-length groups (page size
  1), both kernel backends, in float32 activations (in bf16 the two
  engines' streams part at near ties of this random stack, as olmoe's
  did between the port's backends).
* Adafactor's sliced update (``optim/optimizers.py: _sliced_update``)
  against the whole leaf's on an expert-shaped leaf, float32 and bf16:
  moments and parameters after 3 steps within rtol 1e-6 (only the RMS's
  sum of squares adds in another order; on this input they agree bit for
  bit).
* ``chip_smoke.py: hybrid_wire_bytes`` against the bytes one bf16 step
  logs at tp 4, to the byte, at 2, 3 and 8 layers.
* The launchers on the CPU.

One spawn (1 x 4), in a thread of its own while the reference compiles
and runs here.
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

from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import blocks as jax_blocks
from repro.models.model import count_params as jax_count_params
from repro.models.model import forward_logits as jax_forward_logits
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.compat import shard_map
from repro.parallel.params import is_decl
from repro.parallel.params import materialize as jax_materialize
from repro.parallel.params import specs as jax_specs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models.blocks import layer_plan, plan_period
from repro_torch.models.model import (cache_decls, count_params,
                                      forward_decode, forward_prefill,
                                      model_decls)
from repro_torch.optim.optimizers import Adafactor
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_trainer_tp import _norm_spec

ARCH = "jamba-1.5-large-398b"
# name: (overrides, pp, dp, tp, microbatches, steps); the FSDP and
# pipelined cases are in tests/test_torch_hybrid_mesh.py
TRAIN = {"jamba_tp4": ({}, 1, 1, 4, 1, 3)}
# the wire-byte cases at tp 4, bf16: layers of the smoke plan
WIRE = {"B": 4, "S": 64, "layers": (2, 3, 8)}

# the script's wire-byte count, which its phase 14 holds on the card
chip_smoke = torch_ranks.load_chip_smoke()


def _cfgs(overrides=None, dtype="float32"):
    """The reference's smoke config and the port's (kernel backend
    "auto"), Adafactor, in ``dtype``."""
    kw = dict(dtype=dtype, optimizer="adafactor", **(overrides or {}))
    return (jax_get_config(ARCH, smoke=True).replace(**kw),
            with_kernel_backend(get_config(ARCH, smoke=True, **kw), "auto"))


# ---------------------------------------------------------------------------
# plan, decls, counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_layer_plan_and_period_match_reference(smoke):
    jcfg, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                              smoke=smoke)
    assert layer_plan(cfg) == jax_blocks.layer_plan(jcfg)
    assert plan_period(cfg) == jax_blocks.plan_period(jcfg) == 8
    plan = layer_plan(cfg)[:8]
    assert plan[0] == ("attn", "mlp") and plan[1] == ("mamba", "moe")
    assert [mx for mx, _ in plan].count("attn") == 1
    assert [ff for _, ff in plan].count("moe") == 4


def _decl_table(decls):
    return {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(decls)}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("smoke", [True, False])
def test_decls_and_counts_match_reference(smoke, mesh):
    """Every leaf's shape and spec (the full config sets ``fsdp=True``:
    its dp dims at dp 2), and the parameter counts, total and active."""
    dp, tp = mesh
    jcfg, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                              smoke=smoke)
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=tp, dp=dp,
                                             dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = model_decls(cfg, MeshAxes(tp=tp, dp=dp))
    assert _decl_table(ours) == theirs
    assert sorted(ours["layers"]) == [f"sub{i}" for i in range(8)]
    for t in ((1, 4) if smoke else (1, 4, 16)):
        for active in (False, True):
            assert count_params(cfg, t, active_only=active) == \
                jax_count_params(jcfg, active_only=active, tp=t)
    if not smoke:
        assert 300e9 < count_params(cfg, 16) < 480e9
        assert count_params(cfg, 16) == 378_430_659_840


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The reference's trainer runs (threads: XLA compiles outside the
    interpreter lock), then one spawn per mesh in threads of their own,
    each step from the reference's state before it, with the wire-byte
    cases."""
    with ThreadPoolExecutor(8) as pool:
        made = {name: pool.submit(lm_pipeline._jax_run, _cfgs(ov)[0], pp, dp,
                                  tp, M, "adafactor", steps=steps)
                for name, (ov, pp, dp, tp, M, steps) in TRAIN.items()}
        ref = {}
        for name, f in made.items():
            ref[name], run = f.result()
            made[name] = pool.submit(run)
        for f in made.values():
            f.result()
    cases = {name: dict(cfg=_cfgs(ov)[1], starts=ref[name]["starts"],
                        batches=ref[name]["batches"], lr=lm_pipeline.LR,
                        weight_decay=lm_pipeline.WD, microbatches=M,
                        optimizer="adafactor")
             for name, (ov, pp, dp, tp, M, _) in TRAIN.items()}
    out = {"ref": ref}
    errors = []

    wire = {f"jamba_bf16_{n}": dict(cfg=_cfgs({"num_layers": n},
                                                dtype="bfloat16")[1],
                                     batch=WIRE["B"], seq=WIRE["S"])
            for n in WIRE["layers"]}

    def ranks(name):
        _, pp, dp, tp, _, _ = TRAIN[name]
        try:
            out[name] = spawn(torch_ranks.hybrid_body, dp, tp, "cpu",
                              pp=pp, timeout_s=300, args=({
                                  "train": {name: cases[name]},
                                  "wire": wire},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=(name,))
               for name in TRAIN]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def hold_hybrid_steps(name, cfg, want, ranks, pp, dp, tp):
    """Every rank's steps of one case against ``want``, the reference's
    (``tests/test_torch_lm_pipeline.py: _jax_run``), with the tolerances
    of the module's docstring."""
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-3, err_msg=name)
    decls = model_decls(cfg, MeshAxes(pp=pp, dp=dp, tp=tp))

    def gathered(key, s):
        return dict(tree_leaves(gather_params([r[key][s] for r in ranks],
                                              decls, dp, tp, pp)))
    for s in range(len(want["params"])):
        grads, num, den = gathered("grads", s), 0.0, 0.0
        for path, w in tree_leaves(want["grads"][s]):
            d = np.float64(grads[path]) - w
            num, den = num + np.sum(d * d), den + np.sum(np.float64(w) ** 2)
            assert np.abs(d).max() <= 1e-2 * np.abs(w).max() + 1e-7, (
                f"{name} step {s} gradient {path}: {np.abs(d).max():.3e} "
                f"of {np.abs(w).max():.3e}")
        assert np.sqrt(num) <= 2e-3 * np.sqrt(den), (
            name, s, np.sqrt(num / den))
        params = gathered("params", s)
        for path, w in tree_leaves(want["params"][s]):
            diff = np.abs(np.float64(params[path]) - w)
            tol = 1e-5 + 1e-4 * np.abs(w)
            assert (diff <= tol).all(), (
                f"{name} step {s} {path}: {int((diff > tol).sum())} "
                f"elements outside, worst {diff.max():.3e}")


@pytest.mark.parametrize("layers", WIRE["layers"])
def test_hybrid_wire_bytes_equal_the_count(runs, layers):
    """Every rank's logged wire bytes of one bf16 step of jamba-smoke at
    tp 4, at 2, 3 and 8 layers (superblocks of period 2, 3 and 8), equal
    ``chip_smoke.py: hybrid_wire_bytes`` to the byte (the count phase 14
    holds on the card)."""
    cfg = _cfgs({"num_layers": layers}, dtype="bfloat16")[1]
    want = chip_smoke.hybrid_wire_bytes(cfg, WIRE["B"], WIRE["S"], 4)
    for r in runs["jamba_tp4"]:
        got = r["wire"][f"jamba_bf16_{layers}"]
        assert got["wire_bytes"] == want, got


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(runs, name):
    ov, pp, dp, tp, _, steps = TRAIN[name]
    ranks = [r["train"][name] for r in runs[name]]
    assert all(len(r["losses"]) == steps for r in ranks)
    hold_hybrid_steps(name, _cfgs(ov)[1], runs["ref"][name], ranks, pp, dp,
                      tp)


# ---------------------------------------------------------------------------
# decode against prefill, serving
# ---------------------------------------------------------------------------

def _ample(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=16.0))


def test_decode_consistent_with_prefill():
    """Prefill 32 tokens, pad the cache to 64, decode the 33rd token: its
    logits, and the prefill's last, against the reference's per-position
    logits over 33 tokens (``forward_logits``), float32, every block
    kind's cache path (attention K/V, the SSD's conv and state, MoE
    routing) end to end."""
    B, S = 4, 32
    jcfg = _ample(jax_get_config(ARCH, smoke=True).replace(dtype="float32"))
    cfg = _ample(get_config(ARCH, smoke=True, dtype="float32"))
    mesh = jax_local_mesh(1, 1)
    axes = JMeshAxes.from_mesh(mesh)
    decls = jax_model_decls(jcfg, axes)
    params = jax_materialize(decls, 3)
    toks = np.random.RandomState(4).randint(0, 256, (B, S + 1))
    pspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes),
                          jax_specs(decls))
    fn = jax.jit(shard_map(
        lambda p, t: jax_forward_logits(jcfg, axes, p, {"tokens": t}),
        mesh=mesh, in_specs=(pspecs, P()), out_specs=P(), check_vma=False))
    want = np.asarray(fn(params, jnp.asarray(toks, jnp.int32)))
    ours = from_jax_params(jax.tree.map(np.asarray, params))
    one = MeshAxes()
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        lg_pre, pre = forward_prefill(cfg, one, ours, {"tokens": t[:, :S]})
        cache = {}
        for path, spec in tree_leaves(cache_decls(cfg, one, B, 2 * S)):
            c = torch.zeros(spec.shape, dtype=torch.float32)
            src = dict(tree_leaves(pre))[path]
            c[tuple(slice(0, n) for n in src.shape)] = src
            cache[path] = c
        nested = {}
        for path, c in cache.items():
            sub, name = path.split("/")
            nested.setdefault(sub, {})[name] = c
        lg_dec, _ = forward_decode(cfg, one, ours, nested, t[:, S:S + 1],
                                   torch.full((B,), S))
    V = cfg.vocab_size
    for got, at in ((lg_pre, S - 1), (lg_dec, S)):
        w = want[:, at:at + 1, :V]
        np.testing.assert_allclose(got.numpy()[..., :V], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def _prompts():
    """Exact-length groups: every prompt its own length."""
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32)
            for n in (5, 17, 16, 9, 12)]


SLOTS, MAX_LEN, PAGE = 2, 64, 1


@pytest.fixture(scope="module")
def serve_ref():
    """The reference's smoke params (1 x 1 mesh) and the greedy streams
    of its engine (page size 1: any prompt length is its own group)."""
    mesh = jax_local_mesh(1, 1)
    cfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    params = jax_materialize(jax_model_decls(
        cfg, JMeshAxes.from_mesh(mesh)), 5)
    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PAGE)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
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
    assert not eng.scheduler.mixed_lengths
    assert sorted(eng.cache) == [f"sub{i}" for i in range(8)]
    assert sorted(eng.cache["sub0"]) == ["k", "v"]
    assert eng.cache["sub0"]["k"].shape[2] == MAX_LEN
    assert eng.cache["sub1"]["ssm"].dtype == torch.float32
    reqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.pages.allocated_pages == 0


# ---------------------------------------------------------------------------
# Adafactor in slices, the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_adafactor_matches_the_unsliced_update(dtype, monkeypatch):
    """A ``[1, 4, 16, 8]`` expert-shaped leaf updated one matrix at a time
    (``SLICE`` set to 200 elements) against the whole leaf at once, 3
    steps, weight decay 0.1, with a small leaf beside it that neither
    slices."""
    from repro_torch.optim import optimizers
    shapes = {"e": (1, 4, 16, 8), "w": (16, 8)}
    gen = torch.Generator().manual_seed(0)
    start = {k: torch.randn(s, generator=gen).to(dtype)
             for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen).to(dtype)
              for k, s in shapes.items()} for _ in range(3)]
    out = []
    for slice_elems in (optimizers.SLICE, 200):
        monkeypatch.setattr(optimizers, "SLICE", slice_elems)
        opt = Adafactor(1e-2, weight_decay=0.1)
        p = {k: v.clone() for k, v in start.items()}
        state = opt.init(p)
        for s, g in enumerate(grads):
            p, state = opt.update(g, state, p, s)
        out.append((p, state))
    (pa, sa), (pb, sb) = out
    for k in shapes:
        np.testing.assert_allclose(pb[k].float().numpy(),
                                   pa[k].float().numpy(), rtol=1e-6,
                                   err_msg=k)
        for m in ("vr", "vc"):
            np.testing.assert_allclose(sb[m][k].numpy(), sa[m][k].numpy(),
                                       rtol=1e-6, err_msg=f"{m} {k}")
    assert not torch.equal(pa["e"], start["e"])


def test_launch_train_jamba_at_tp2_runs_on_the_cpu(capfd):
    assert launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--tp", "2", "--steps", "2", "--batch", "4",
                              "--seq", "32"]) == 0
    out = capfd.readouterr().out
    cfg = get_config(ARCH, smoke=True)
    assert (f"impl=phantom dp=1 on cpu (tp=2, kernel_backend=config): "
            f"{count_params(cfg, 2):,} params") in out
    assert "[trainer] step 2 loss " in out


def test_launch_serve_jamba_smoke_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "# served jamba-smoke on cpu" in out
    assert "requests=3 tokens=9" in out
