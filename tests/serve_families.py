"""The reference side of ``tests/test_torch_serve_mesh_moe_ssm.py`` and
``tests/test_torch_serve_mesh_ring_vlm_encdec.py``: each family's
smoke config served on the reference's ``mesh24`` (dp 2 x tp 4) and by
the port's tp = 1 engine, against the port's engine on 8 gloo CPU ranks
(``torch_ranks.serve_mesh_body``), in float32.

A case is one arch with one projection map: ``"own"``, the config's
own (the sites the reference's tests serve: olmoe's phantom q/k/v/o,
mamba2's phantom in/out, the phantom MLP sites of the others), or
``"tensor"``, the router's tensor candidate (``ServeConfig.model_config``:
every site tensor, the ``sp`` / ``rep`` layouts).  MoE configs serve at
capacity factor 16, as the reference's ``test_decode_consistent_with_prefill``
does: a token dropped at one batch composition and kept at another would
part the decode from the full forward for a reason that is not the cache.

The frontends' stubs are drawn non-zero on both sides: each prefill row's
frames and vision embeddings from its own tokens
(``repro_torch.serve.engine.drawn_stubs``, ``stub_rows``); the
reference's engine gets the same rows through its
``_add_modality_stubs``, patched for the run.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

import repro.serve.engine as jax_engine
from helpers import smap
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
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
from repro_torch.configs.base import get_config
from repro_torch.core.phantom import phantom_dense_equivalent
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import model_decls, n_vision_tokens
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, tree_leaves,
                                         tree_unflatten)
from repro_torch.serve.engine import (RECURRENT_FAMILIES, Request,
                                      ServeEngine, drawn_stubs, stub_rows)
from repro_torch.serve.router import ServeConfig
from repro_torch.serve.traffic import replay

import torch_ranks

DP, TP, SLOTS, MAX_LEN, S, NEW = 2, 4, 4, 32, 16, 5
TOL = dict(rtol=1e-4, atol=1e-4)
MAPS = ("own", "tensor")
# one prefill length, so that the reference compiles one prefill a case:
# mixed lengths bucketed to 16 for the families that pad, exactly the
# page (16) for the recurrent ones.  A chunk of the cache is max_len / tp
# = 8 positions, so a 16-token prefill spans ranks 0 and 1 and the decode
# at position 16 writes on rank 2.
GROUP_LENS = {False: (12, 16, 9, 8), True: (16, 16, 16, 16)}
STREAM_LENS = {False: (12, 16, 9, 8, 16, 5), True: (16,) * 6}
# the layer-stacked cache leaves' specs after the layer dim
_CACHE_SPECS = {"k": ("dp", "tp", None, None), "v": ("dp", "tp", None, None),
                "conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None, None)}


def cfgs(arch, impl):
    """(reference, port) configs of a case, float32."""
    if impl == "own":
        pair = (jax_get_config(arch, smoke=True), get_config(arch, smoke=True))
    else:
        kw = dict(arch=arch, impl="tensor", dp=DP, tp=TP, slots=SLOTS,
                  max_len=MAX_LEN)
        pair = (JServeConfig(**kw).model_config(),
                ServeConfig(**kw).model_config())
    out = []
    for c in pair:
        c = c.replace(dtype="float32")
        if c.moe is not None:
            c = c.replace(moe=dataclasses.replace(c.moe,
                                                  capacity_factor=16.0))
        out.append(c)
    return tuple(out)


def draw(cfg):
    """Global float32 parameters drawn with numpy leaf by leaf from the
    port's decls at tp 4 (the reference's keys and shapes): normal at the
    decl's scale, the embedding at 0.02, and the leaves declared ones or
    zeros (norm scales, biases, the SSD decay, skip and dt bias) redrawn
    about their value (1 + 0.1 N, 0.1 N), so that none is left out."""
    rng = np.random.RandomState(7)
    decls = model_decls(cfg, MeshAxes(tp=TP, dp=DP))
    flat = {}
    for path, d in tree_leaves(decls):
        if d.init in ("zeros", "ones"):
            flat[path] = (float(d.init == "ones")
                          + 0.1 * rng.standard_normal(d.shape)
                          ).astype(np.float32)
        else:
            std = 0.02 if d.init == "embed" else d.fan_in_scale()
            flat[path] = (rng.standard_normal(d.shape) * std).astype(
                np.float32)
    return tree_unflatten(decls, flat)


def dense_twin(tree):
    """The tensor config's tree computing what ``tree`` computes: each
    phantom site's factors ``{L, C, D}`` replaced by the dense matrix
    (``core/phantom.py: phantom_dense_equivalent``), layer by layer,
    its bias kept."""
    if not isinstance(tree, dict):
        return tree
    if "L" not in tree:
        return {k: dense_twin(v) for k, v in tree.items()}
    rest = {k: v for k, v in tree.items() if k not in ("L", "C", "D")}
    if tree["L"].ndim == 3:
        return {**rest, "w": phantom_dense_equivalent(tree)}
    return {**rest, "w": torch.stack([
        phantom_dense_equivalent({f: tree[f][i] for f in ("L", "C", "D")})
        for i in range(tree["L"].shape[0])])}


def inputs(cfg):
    recurrent = cfg.family in RECURRENT_FAMILIES
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (SLOTS, S + 4)).astype(np.int32)
    group = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
             for n in GROUP_LENS[recurrent]]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in STREAM_LENS[recurrent]]
    arrivals = [t.arrival_s for t in jax_make_trace(
        "poisson", n=len(prompts), rate_rps=100.0, seed=1)]
    return toks, group, {"prompts": prompts, "arrivals": arrivals,
                         "new": NEW}


def _jax_stubs(cfg, batch, B, S):
    """The reference engine's stubs with the port's ``drawn_stubs`` rows."""
    toks = np.asarray(batch["tokens"])
    batch = _ORIGINAL_STUBS(cfg, batch, B, S)
    for key in ("frames", "vision_embeds"):
        if key in batch:
            batch[key] = jnp.asarray(np.stack([
                stub_rows(t, batch[key].shape[1], cfg.d_model)
                for t in toks]))
    return batch


_ORIGINAL_STUBS = jax_engine._add_modality_stubs


def _prefill_batch(cfg, toks):
    """The batch of a prefill of ``toks`` [B, S'] as the port's
    ``drawn_stubs`` makes it, in numpy."""
    B, n = toks.shape
    out = {"tokens": toks}
    if cfg.family == "encdec":
        out["frames"] = np.stack([stub_rows(t, n, cfg.d_model)
                                  for t in toks])
    if cfg.frontend == "vision":
        out["vision_embeds"] = np.stack([
            stub_rows(t, n_vision_tokens(cfg, n), cfg.d_model)
            for t in toks])
    if cfg.rope == "mrope":
        out["positions"] = np.broadcast_to(np.arange(n, dtype=np.int32),
                                           (3, B, n)).copy()
    return out


def reference(mesh, cfg, params, toks, group, stream):
    """The reference on ``mesh``: prefill and decode logits (and, but for
    the encoder-decoder, the full forward's at position S), the engine's
    cache after ``group``, and the greedy streams of ``stream``."""
    axes = JMeshAxes.from_mesh(mesh)
    decls = jax_model_decls(cfg, axes)
    fns = make_serve_fns(cfg, mesh, JShapeConfig("serve", MAX_LEN, SLOTS,
                                                 "decode"))
    prefill_fn, decode_fn, cache_sds, _ = fns
    out = {}
    pre = _prefill_batch(cfg, toks[:, :S])
    logits, cache = prefill_fn(params, jax.tree.map(jnp.asarray, pre))
    out["prefill_logits"] = np.asarray(logits, np.float32)
    cache = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, t - g) for g, t in zip(c.shape, s.shape)]), cache, cache_sds)
    dlogits, _ = decode_fn(params, cache, jnp.asarray(toks[:, S:S + 1]),
                           jnp.full((SLOTS,), S, jnp.int32))
    out["decode_logits"] = np.asarray(dlogits, np.float32)
    if cfg.family != "encdec":
        # the full forward over S + 4 tokens (a multiple of tp), causal:
        # its position S sees the prefill's S tokens (and stubs) and the
        # decoded one
        full_batch = {"tokens": toks}
        if "vision_embeds" in pre:
            full_batch["vision_embeds"] = pre["vision_embeds"]
        if cfg.rope == "mrope":
            full_batch["positions"] = np.broadcast_to(
                np.arange(S + 4, dtype=np.int32), (3, SLOTS, S + 4)).copy()
        _, in_spec = jax_input_specs(cfg, JShapeConfig("t", S + 4, SLOTS,
                                                       "prefill"), axes)
        in_spec = {k: v for k, v in in_spec.items() if k in full_batch}
        bspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes), in_spec,
                              is_leaf=lambda x: isinstance(x, P))
        pspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes),
                              jax_specs(decls))
        full = smap(lambda p, b: jax_forward_logits(cfg, axes, p, b), mesh,
                    (pspecs, bspecs), P(("data",), None, None))
        out["full_logits"] = np.asarray(full(params, jax.tree.map(
            jnp.asarray, full_batch))[:, S:S + 1], np.float32)

    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       serve_fns=fns)
    eng.submit([JRequest(prompt=p.copy(), max_new_tokens=NEW)
                for p in group])
    out["cache"] = {path: np.asarray(c, np.float32)
                    for path, c in tree_leaves(eng.cache)}
    eng = JServeEngine(cfg, mesh, params, slots=SLOTS, max_len=MAX_LEN,
                       serve_fns=fns)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=stream["new"],
                     arrival_s=a)
            for p, a in zip(stream["prompts"], stream["arrivals"])]
    jax_replay(eng, reqs)
    assert all(r.done and r.error is None for r in reqs)
    out["streams"] = [list(r.out_tokens) for r in reqs]
    return out


def tp1_streams(arch, glob, stream):
    """The port's tp = 1 engine's greedy streams on the global weights,
    as the tensor config's tree (a phantom model's as its dense twin)."""
    eng = ServeEngine(cfgs(arch, "tensor")[1],
                      dense_twin(from_jax_params(glob)), slots=SLOTS,
                      max_len=MAX_LEN, device="cpu", stubs=drawn_stubs)
    reqs = [Request(prompt=p.copy(), max_new_tokens=stream["new"],
                    arrival_s=a)
            for p, a in zip(stream["prompts"], stream["arrivals"])]
    replay(eng, reqs)
    return [list(r.out_tokens) for r in reqs]


def run(mesh24, archs):
    """Every case of ``archs`` x ``MAPS``: the port's 8 ranks in a thread
    while the reference and the port's tp = 1 engine run here.
    Returns {"ref": {case: ...}, "ranks": [rank results], "cfgs": {case:
    port config}}."""
    cases, ref_in, errors, port = {}, {}, [], {}
    for arch in archs:
        for impl in MAPS:
            jcfg, cfg = cfgs(arch, impl)
            glob = draw(cfg)
            toks, group, stream = inputs(cfg)
            name = f"{arch}/{impl}"
            cases[name] = {"cfg": cfg, "params": glob, "toks": toks, "S": S,
                           "group": group, "stream": stream,
                           "slots": SLOTS, "max_len": MAX_LEN, "new": NEW}
            ref_in[name] = (jcfg, glob, toks, group, stream)

    def ranks():
        try:
            port["ranks"] = spawn(torch_ranks.serve_mesh_body, DP, TP, "cpu",
                                  args=(cases,), timeout_s=300)
        except Exception as e:       # re-raised below, in the caller
            errors.append(e)
    def one(name):
        jcfg, glob, toks, group, stream = ref_in[name]
        out = reference(mesh24, jcfg, jax.tree.map(jnp.asarray, glob), toks,
                        group, stream)
        out["tp1_streams"] = tp1_streams(name.split("/")[0], glob, stream)
        return out

    th = threading.Thread(target=ranks)
    th.start()
    # the reference engine's stubs are the port's rows for the whole run;
    # two cases at a time overlap one's tracing with the other's compile
    jax_engine._add_modality_stubs = _jax_stubs
    try:
        with ThreadPoolExecutor(2) as pool:
            ref = dict(zip(ref_in, pool.map(one, ref_in)))
    finally:
        jax_engine._add_modality_stubs = _ORIGINAL_STUBS
        th.join()
    if errors:
        raise errors[0]
    return {"ref": ref, "ranks": port["ranks"],
            "cfgs": {name: c["cfg"] for name, c in cases.items()}}


def _vocab(x):
    return x[..., :256]


def _rows(a, d, axis=0):
    n = a.shape[axis] // DP
    return np.take(a, range(d * n, (d + 1) * n), axis=axis)


def check_logits(runs, name):
    """Each rank's prefill and decode logits against its rows of the
    reference's (and of the full forward at position S)."""
    ref = runs["ref"][name]
    for r, res in enumerate(runs["ranks"]):
        d = r // TP
        got = res[name]
        np.testing.assert_allclose(_vocab(got["prefill_logits"]),
                                   _vocab(_rows(ref["prefill_logits"], d)),
                                   **TOL)
        np.testing.assert_allclose(_vocab(got["decode_logits"]),
                                   _vocab(_rows(ref["decode_logits"], d)),
                                   **TOL)
        if "full_logits" in ref:
            np.testing.assert_allclose(_vocab(got["decode_logits"]),
                                       _vocab(_rows(ref["full_logits"], d)),
                                       **TOL)


def check_cache(runs, name):
    """Each rank's cache leaves against the reference engine's global
    cache cut along the leaf's spec: the rank's rows, and its positions
    (K/V), channels (conv) or heads (SSD state)."""
    ref = runs["ref"][name]["cache"]
    for r, res in enumerate(runs["ranks"]):
        d, j = divmod(r, TP)
        got = res[name]["cache"]
        assert sorted(got) == sorted(ref)
        for path, want in ref.items():
            spec = (None,) + _CACHE_SPECS[path.split("/")[-1]]
            for axis, name_ in enumerate(spec):
                if name_ == "dp":
                    want = _rows(want, d, axis)
                elif name_ == "tp":
                    n = want.shape[axis] // TP
                    want = np.take(want, range(j * n, (j + 1) * n), axis=axis)
            assert got[path].shape == want.shape, path
            np.testing.assert_allclose(got[path], want, err_msg=path, **TOL)


def check_streams(runs, name):
    ref = runs["ref"][name]
    for res in runs["ranks"]:
        assert res[name]["done"]
        assert res[name]["streams"] == ref["streams"]
        agree = res[name]["agreement"]
        assert agree["clock"]["calls"] > 0 and agree["tokens"]["calls"] > 0
    assert ref["tp1_streams"] == ref["streams"]
    assert all(len(s) == NEW for s in ref["streams"])


def check_wire(runs, name):
    chip = torch_ranks.load_chip_smoke()
    cfg = runs["cfgs"][name]
    rows = SLOTS // DP
    for res in runs["ranks"]:
        wire = res[name]["wire"]
        for phase in ("prefill", "decode"):
            assert wire[phase] == chip.serve_wire_bytes(cfg, rows, S, TP,
                                                        phase), phase
