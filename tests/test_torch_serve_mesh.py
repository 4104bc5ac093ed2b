"""Serving over a dp 2 x tp 4 mesh: the port's engine on 8 gloo CPU ranks
against the reference's on its ``mesh24``, chatglm3-6b's smoke config
with tensor sites and with phantom MLP sites (k = 4), both as the
router's candidates build them, and the tensor one with 4 KV heads (tp
divides them: the K/V all-to-all and gathers), in float32 activations.

One numpy draw gives the global parameters (``_draw``); the reference
takes them whole and each rank its shards (``shard_params``).  Held:

  * the logits of a prefill of 16 tokens and of one decode step at
    position 16 after it (through the engine's splice: the relayout of
    the prefill's sequence shards onto the decode cache's chunks) equal
    the reference's ``prefill_fn`` / ``decode_fn`` and its full forward
    (``forward_logits``) at position 16, within rtol/atol 1e-4 (float32
    on both sides, summed in different orders);
  * each rank's cache after submitting a group of mixed-length prompts
    (buckets 16 and 32: a chunk of max_len / tp = 16 positions, so a
    16-token bucket lands wholly on rank 0 and a 32-token one spans two
    ranks) equals the reference engine's global cache cut to that
    rank's rows and positions, within 1e-4;
  * (tensor and phantom) the greedy streams of six mixed-length prompts
    (the reference's
    ``tests/test_serve_runtime.py`` lengths) through a poisson
    ``replay`` equal the reference engine's and the port's tp = 1
    engine's, token for token (the phantom model's tp = 1 twin serves
    the dense matrices its sites compute,
    ``phantom_dense_equivalent``);
  * each rank's counted wire bytes of the prefill and of the decode step
    equal ``chip_smoke.py: serve_wire_bytes``, to the byte.

The 8 ranks run in a thread while the reference compiles and runs here.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from helpers import smap
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.specs import input_specs as jax_input_specs
from repro.models.model import forward_logits as jax_forward_logits
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.params import specs as jax_specs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import make_serve_fns
from repro.serve.router import ServeConfig as JServeConfig
from repro.serve.traffic import make_trace as jax_make_trace
from repro.serve.traffic import replay as jax_replay
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, tree_leaves,
                                         tree_unflatten)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import ServeConfig
from repro_torch.serve.traffic import replay

import torch_ranks
from serve_families import dense_twin

DP, TP, SLOTS, MAX_LEN, S, NEW = 2, 4, 4, 64, 16, 5
TOL = dict(rtol=1e-4, atol=1e-4)
# "kv4": the tensor candidate with 4 KV heads, which tp 4 divides (one a
# rank): the prefill's all-to-all onto sequence shards and decode's K/V
# head gathers, where chatglm3's 2 KV heads are replicated
CASES = ("tensor", "phantom", "kv4")
STREAM_CASES = ("tensor", "phantom")
GROUP_LENS = (12, 16, 23, 8)
STREAM_LENS = (12, 16, 23, 8, 32, 17)


def _cfgs(impl):
    """(reference, port) configs of the router's candidate, float32."""
    kw = dict(arch="chatglm3-6b", impl="tensor" if impl == "kv4" else impl,
              dp=DP, tp=TP, slots=SLOTS, max_len=MAX_LEN)
    over = dict(dtype="float32", **({"num_kv_heads": 4} if impl == "kv4"
                                    else {}))
    return (JServeConfig(**kw).model_config().replace(**over),
            ServeConfig(**kw).model_config().replace(**over))


def _draw(impl):
    """Global float32 parameters of a case, drawn with numpy leaf by leaf
    from the port's decls (the reference's keys and shapes) as the
    reference's ``materialize`` recipes them (normal at the decl's scale,
    the embedding at 0.02, zeros and ones as declared): the same numbers
    reach both packages, and no JAX RNG compiles."""
    rng = np.random.RandomState(7)
    flat = {}
    for path, d in tree_leaves(model_decls(_cfgs(impl)[1],
                                           MeshAxes(tp=TP, dp=DP))):
        if d.init in ("zeros", "ones"):
            flat[path] = np.full(d.shape, float(d.init == "ones"),
                                 np.float32)
        else:
            std = 0.02 if d.init == "embed" else d.fan_in_scale()
            flat[path] = (rng.standard_normal(d.shape) * std).astype(
                np.float32)
    return tree_unflatten(model_decls(_cfgs(impl)[1],
                                      MeshAxes(tp=TP, dp=DP)), flat)


def _inputs():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 256, (SLOTS, S + 4)).astype(np.int32)
    group = [rng.randint(0, 256, n).astype(np.int32) for n in GROUP_LENS]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, n).astype(np.int32)
               for n in STREAM_LENS]
    arrivals = [t.arrival_s for t in jax_make_trace(
        "poisson", n=len(STREAM_LENS), rate_rps=100.0, seed=1)]
    return toks, group, {"prompts": prompts, "arrivals": arrivals,
                         "new": NEW}


def _reference(mesh, impl, params, toks, group, stream):
    cfg = _cfgs(impl)[0]
    axes = JMeshAxes.from_mesh(mesh)
    decls = jax_model_decls(cfg, axes)
    fns = make_serve_fns(cfg, mesh, JShapeConfig("serve", MAX_LEN, SLOTS,
                                                 "decode"))
    prefill_fn, decode_fn, cache_sds, _ = fns
    out = {}
    logits, cache = prefill_fn(params, {"tokens": jnp.asarray(toks[:, :S])})
    out["prefill_logits"] = np.asarray(logits, np.float32)
    cache = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, t - g) for g, t in zip(c.shape, s.shape)]), cache, cache_sds)
    dlogits, _ = decode_fn(params, cache, jnp.asarray(toks[:, S:S + 1]),
                           jnp.full((SLOTS,), S, jnp.int32))
    out["decode_logits"] = np.asarray(dlogits, np.float32)
    # the full forward over 20 tokens (a multiple of tp): causal, so its
    # position S sees exactly the prefill's S tokens and the decoded one
    _, in_spec = jax_input_specs(cfg, JShapeConfig("t", S + 4, SLOTS,
                                                   "prefill"), axes)
    bspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes), in_spec,
                          is_leaf=lambda x: isinstance(x, P))
    pspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes),
                          jax_specs(decls))
    full = smap(lambda p, b: jax_forward_logits(cfg, axes, p, b), mesh,
                (pspecs, bspecs), P(("data",), None, None))
    out["full_logits"] = np.asarray(
        full(params, {"tokens": jnp.asarray(toks)})[:, S:S + 1], np.float32)

    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       serve_fns=fns)
    eng.submit([JRequest(prompt=p.copy(), max_new_tokens=NEW)
                for p in group])
    out["cache"] = jax.tree.map(lambda c: np.asarray(c, np.float32),
                                eng.cache)
    if stream is None:
        return out
    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       serve_fns=fns)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=stream["new"],
                     arrival_s=a)
            for p, a in zip(stream["prompts"], stream["arrivals"])]
    jax_replay(eng, reqs)
    assert all(r.done for r in reqs)
    out["streams"] = [list(r.out_tokens) for r in reqs]
    return out


@pytest.fixture(scope="module")
def runs(mesh24):
    toks, group, stream = _inputs()
    errors, port = [], {}
    np_params = {impl: _draw(impl) for impl in CASES}
    params = {impl: jax.tree.map(jnp.asarray, p)
              for impl, p in np_params.items()}
    cases = {impl: {"cfg": _cfgs(impl)[1], "params": np_params[impl],
                    "toks": toks, "S": S, "group": group,
                    "stream": stream if impl in STREAM_CASES else None,
                    "slots": SLOTS, "max_len": MAX_LEN} for impl in CASES}

    def ranks():
        try:
            port["ranks"] = spawn(torch_ranks.serve_mesh_body, DP, TP, "cpu",
                                  args=(cases,), timeout_s=300)
        except Exception as e:       # re-raised below, in the fixture
            errors.append(e)
    th = threading.Thread(target=ranks)
    th.start()
    ref = {impl: _reference(mesh24, impl, params[impl], toks, group,
                            cases[impl]["stream"]) for impl in CASES}
    # the port's tp = 1 engine on the same weights (a phantom model's as
    # the dense matrices its sites compute)
    for impl in STREAM_CASES:
        eng = ServeEngine(_cfgs("tensor")[1],
                          dense_twin(from_jax_params(np_params[impl])),
                          slots=SLOTS, max_len=MAX_LEN, device="cpu")
        reqs = [Request(prompt=p.copy(), max_new_tokens=NEW, arrival_s=a)
                for p, a in zip(stream["prompts"], stream["arrivals"])]
        replay(eng, reqs)
        ref[impl]["tp1_streams"] = [list(r.out_tokens) for r in reqs]
    th.join()
    if errors:
        raise errors[0]
    return {"ref": ref, "ranks": port["ranks"]}


def _vocab(x):
    return x[..., :256]


def _rows(a, d):
    n = a.shape[0] // DP
    return a[d * n:(d + 1) * n]


@pytest.mark.parametrize("impl", CASES)
def test_prefill_and_decode_logits_match_reference(runs, impl):
    ref = runs["ref"][impl]
    for r, res in enumerate(runs["ranks"]):
        d = r // TP
        got_pre, got_dec = res[impl]["prefill_logits"], \
            res[impl]["decode_logits"]
        np.testing.assert_allclose(_vocab(got_pre),
                                   _vocab(_rows(ref["prefill_logits"], d)),
                                   **TOL)
        np.testing.assert_allclose(_vocab(got_dec),
                                   _vocab(_rows(ref["decode_logits"], d)),
                                   **TOL)
        np.testing.assert_allclose(_vocab(got_dec),
                                   _vocab(_rows(ref["full_logits"], d)),
                                   **TOL)


@pytest.mark.parametrize("impl", CASES)
def test_rank_cache_chunks_match_reference(runs, impl):
    ref = runs["ref"][impl]["cache"]
    chunk = MAX_LEN // TP
    for r, res in enumerate(runs["ranks"]):
        d, j = divmod(r, TP)
        for name in ("k", "v"):
            want = _rows(np.moveaxis(ref[name], 1, 0), d)
            want = np.moveaxis(want, 0, 1)[:, :, j * chunk:(j + 1) * chunk]
            got = res[impl]["cache"][name]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", STREAM_CASES)
def test_replay_streams_match_reference_and_tp1(runs, impl):
    ref = runs["ref"][impl]
    for res in runs["ranks"]:
        assert res[impl]["done"]
        assert res[impl]["streams"] == ref["streams"]
        # the ranks agreed their clocks and tokens (on unrecorded groups)
        agree = res[impl]["agreement"]
        assert agree["clock"]["calls"] > 0 and agree["tokens"]["calls"] > 0
    assert ref["tp1_streams"] == ref["streams"]
    assert all(len(s) == NEW for s in ref["streams"])


@pytest.mark.parametrize("impl", CASES)
def test_wire_bytes_match_the_count_from_shapes(runs, impl):
    chip = torch_ranks.load_chip_smoke()
    cfg = _cfgs(impl)[1]
    rows = SLOTS // DP
    for res in runs["ranks"]:
        wire = res[impl]["wire"]
        assert wire["prefill"] == chip.serve_wire_bytes(cfg, rows, S, TP,
                                                        "prefill")
        assert wire["decode"] == chip.serve_wire_bytes(cfg, rows, S, TP,
                                                       "decode")
