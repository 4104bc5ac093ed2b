"""The port's serving slice against the JAX reference, on the CPU, with
chatglm3-6b's smoke config (2 layers).

The reference builds the parameters (``repro.parallel.params.
materialize`` on a 1x1 mesh) and hands them over as numpy arrays through
``from_jax_params``.  The reference runs ``kernel_backend="xla"``; the
port runs ``"pallas"`` (its flash wrapper, which on CPU tensors is the
plain version) and ``"xla"`` (its blockwise core).  Logits and caches
agree within rtol/atol 5e-2, the bf16 tolerance of the reference's own
serve tests (both sides run bf16 projections, summed in different
orders); greedy token streams agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh
from repro.models.model import count_params as jax_count_params
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.params import materialize as jax_materialize
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import make_serve_fns
from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import (count_params, forward_decode,
                                      forward_prefill, model_decls,
                                      serving_params)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, materialize,
                                         tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=5e-2, atol=5e-2)
SLOTS, MAX_LEN = 2, 64


@pytest.fixture(scope="module")
def ref():
    """Reference config, 1x1 mesh, params and its serving engine (whose
    jitted prefill/decode steps the logit tests reuse)."""
    cfg = jax_get_config("chatglm3-6b", smoke=True)
    mesh = make_local_mesh(1, 1)
    params = jax_materialize(jax_model_decls(cfg, JMeshAxes.from_mesh(mesh)),
                             5)
    fns = make_serve_fns(cfg, mesh, JShapeConfig("serve", MAX_LEN, SLOTS,
                                                 "decode"))
    return {"cfg": cfg, "mesh": mesh, "params": params, "fns": fns,
            "np_params": jax.tree.map(np.asarray, params)}


def _port_cfg(backend):
    return with_kernel_backend(get_config("chatglm3-6b", smoke=True),
                               backend)


def _vocab(x, cfg):
    return np.asarray(x, np.float32)[..., :cfg.vocab_size]


def test_decls_match_reference_tree(ref):
    """Same keys and shapes as the reference's tree on a 1x1 mesh, so
    its weights carry across unchanged."""
    ours = {p: tuple(d.shape) for p, d in
            tree_leaves(model_decls(_port_cfg("pallas"), MeshAxes()))}
    theirs = {p: tuple(a.shape) for p, a in tree_leaves(ref["np_params"])}
    assert ours == theirs


def test_full_size_param_count_matches_reference():
    full = get_config("chatglm3-6b")
    assert count_params(full, tp=1) == \
        jax_count_params(jax_get_config("chatglm3-6b"), tp=1) == \
        6_267_496_448


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_prefill_and_decode_match_reference(ref, backend):
    cfg = _port_cfg(backend)
    jcfg = ref["cfg"]
    prefill_fn, decode_fn, cache_sds, _ = ref["fns"]
    rng = np.random.RandomState(11)
    S = 16
    toks = rng.randint(0, cfg.vocab_size, (SLOTS, S + 1)).astype(np.int32)

    jlog, jcache = prefill_fn(ref["params"], {"tokens": jnp.asarray(
        toks[:, :S])})
    params = serving_params(cfg, from_jax_params(ref["np_params"]), "cpu")
    with torch.no_grad():
        tlog, tcache = forward_prefill(cfg, MeshAxes(), params, {
            "tokens": torch.from_numpy(toks[:, :S]).long()})
    np.testing.assert_allclose(_vocab(tlog, jcfg), _vocab(jlog, jcfg),
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   **TOL)

    # one decode step at position S on the max_len cache
    jpad = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, t - g) for g, t in zip(c.shape, s.shape)]), jcache,
        cache_sds)
    pos = np.full((SLOTS,), S, np.int32)
    jlog2, jcache2 = decode_fn(ref["params"], jpad, jnp.asarray(
        toks[:, S:]), jnp.asarray(pos))
    tpad = {n: torch.nn.functional.pad(
        c, (0, 0, 0, 0, 0, MAX_LEN - S)) for n, c in tcache.items()}
    with torch.no_grad():
        tlog2, tcache2 = forward_decode(
            cfg, MeshAxes(), params, tpad,
            torch.from_numpy(toks[:, S:]).long(),
            torch.from_numpy(pos).long())
    np.testing.assert_allclose(_vocab(tlog2, jcfg), _vocab(jlog2, jcfg),
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache2[name].float().numpy(),
                                   np.asarray(jcache2[name], np.float32),
                                   **TOL)


@pytest.fixture(scope="module")
def ref_streams(ref):
    """Greedy streams of the reference engine for a mixed-length batch
    (5 and 17 tokens: buckets 16 and 32, both decode paths)."""
    prompts = _prompts()
    eng = JServeEngine(ref["cfg"], ref["mesh"], ref["params"], slots=SLOTS,
                       max_len=MAX_LEN)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    eng.run(reqs, max_steps=100)
    return [list(r.out_tokens) for r in reqs]


def _prompts():
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32) for n in (5, 17)]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_engine_greedy_streams_match_reference(ref, ref_streams, backend):
    eng = ServeEngine(_port_cfg(backend), from_jax_params(ref["np_params"]),
                      slots=SLOTS, max_len=MAX_LEN, device="cpu")
    reqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == ref_streams
    assert eng.pages.allocated_pages == 0
    eng.pages.check()


def test_engine_refills_slots_and_meters_steps():
    """More requests than slots: finished slots are refilled, every
    request gets its tokens, and both meters recorded their steps."""
    cfg = _port_cfg("pallas")
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=MAX_LEN, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=3)
            for n in (16, 16, 9, 20, 3)]
    eng.run(reqs, max_steps=100)
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    tel = eng.telemetry()
    assert tel["prefill"]["calls"] >= 3 and tel["decode"]["calls"] > 0
    assert tel["pages"]["allocated_pages"] == 0


def test_launcher_smoke_on_cpu(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--requests",
                              "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "ttft_ms" in out and "tpot_ms" in out


def test_launcher_refuses_multi_device_mesh(capsys, tmp_path):
    """What the launcher does not serve refuses before any rank starts:
    a model axis that does not divide the heads the layers shard
    (olmoe-smoke's 4 query heads at tp = 8), and a route table or report
    in the repo root, whose records are the JAX package's.  The fleet
    refused here (ROADMAP.md queue 1 item 7) until it was ported: a
    modeled ``--fleet`` and an executed ``--fleet --executed`` now run
    on the CPU.  Every family serves on a dp x tp mesh since each was
    ported (a family that served at tp = 1 only refused here until
    then): mamba2-smoke serves through the launcher at tp = 2."""
    with pytest.raises(ValueError, match="4 attention heads"):
        launch_serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                           "cpu", "--tp", "8"])
    for flag in ("--route-out", "--report-out"):
        with pytest.raises(ValueError, match="repo root"):
            launch_serve.main(["--smoke", "--device", "cpu", "--fleet",
                               flag, "SERVE_route.json"])
    report = str(tmp_path / "fleet.json")
    assert launch_serve.main(["--smoke", "--fleet", "--requests", "300",
                              "--report-out", report]) == 0
    out = capsys.readouterr().out
    assert "mode=modeled" in out and "requests=300" in out
    assert launch_serve.main(["--smoke", "--device", "cpu", "--fleet",
                              "--executed", "--requests", "4",
                              "--report-out", report]) == 0
    out = capsys.readouterr().out
    assert "mode=executed" in out and "requests=4" in out
    assert "measured/predicted wire ratio = 1.0000" in out
    assert launch_serve.main(["--arch", "mamba2-370m", "--smoke", "--device",
                              "cpu", "--tp", "2", "--requests", "2",
                              "--new-tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh 1x2" in out and "requests=2 tokens=4" in out


def test_strategy_resolution_matches_reference():
    """Under the pallas backend at tp = 1, chatglm3's q/k/v/o sites are
    tensor_col/row with backend pallas (so the attention gate opens) and
    gate/up/down are phantom, as in the reference, full and smoke."""
    from repro.models.attention import \
        attn_site_strategies as jax_attn_sites
    from repro.models.layers import mlp_strategies as jax_mlp
    from repro.configs.base import with_kernel_backend as jax_wkb
    from repro_torch.models.attention import (_attn_kernel_backend,
                                              attn_site_strategies)
    from repro_torch.models.layers import mlp_strategies
    jaxes = JMeshAxes(tp=1, dp=1, dp_names=("data",))
    for smoke in (False, True):
        cfg = with_kernel_backend(get_config("chatglm3-6b", smoke=smoke),
                                  "pallas")
        jcfg = jax_wkb(jax_get_config("chatglm3-6b", smoke=smoke), "pallas")
        ours = {**attn_site_strategies(cfg, MeshAxes()),
                **mlp_strategies(cfg, MeshAxes(), cfg.d_model, cfg.d_ff)}
        theirs = {**jax_attn_sites(jcfg, jaxes),
                  **jax_mlp(jcfg, jaxes, jcfg.d_model, jcfg.d_ff)}
        assert {n: (s.kind, dataclasses.astuple(s.spec))
                for n, s in ours.items()} == \
            {n: (s.kind, dataclasses.astuple(s.spec))
             for n, s in theirs.items()}
        assert _attn_kernel_backend(attn_site_strategies(cfg, MeshAxes())) \
            == "pallas"
