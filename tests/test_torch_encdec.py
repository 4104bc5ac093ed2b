"""The port's encoder-decoder family (seamless-m4t-large-v2) against the JAX
package, on the CPU.

The serving path feeds zero frames, and norm shifts and biases start at
zero, so there the encoder's memory is exactly zero and so is every
cross-attention output: greedy streams cannot see the encoder.  The
encoder and the cross-attention are therefore held with
``tests/helpers.py: make_batch``'s random frames on the reference's
parameters with every norm and bias leaf redrawn non-zero
(``test_torch_vlm.py: redrawn``):

* the gelu MLP (jax's default tanh form, a bias on ``up`` only) at tp 4,
  phantom sites in ``fp`` and tensor sites in ``sp``, and cross-attention
  at tp 4 in both layouts (K/V of the full memory, never phantom), each
  against the reference's layer under ``shard_map``: outputs rtol 1e-5,
  input, memory and parameter gradients rtol 1e-4 (atol a share of the
  largest, as ``tests/test_torch_trainer_tp.py``);
* training, float32, Adafactor, two steps from the reference's state
  before each at tp 1 and tp 4 (``test_torch_vlm.py: hold_steps``'
  tolerances);
* prefill's last logits and its ``{"self", "cross"}`` cache, and one
  decode step on the cache padded to twice the prompt, the cross K/V
  padded with zeros as the engine pads it, within 1e-4 of the largest;
  decode reads those zero rows unmasked, as the reference's does: on an
  unpadded cross cache its logits differ (ROADMAP.md queue 3).

Also: decls and ``count_params`` at tp 1, 4 and 16; both ``ServeEngine``s'
greedy streams in float32 (exact-length groups, page size 1);
``chip_smoke.py: encdec_wire_bytes`` against one logged bf16 step at
tp 4, to the byte; the launchers (serving runs, training raises: the
reference's launcher feeds no ``frames``).

One spawn (1 x 4), in a thread of its own while the reference compiles
and runs here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from helpers import make_batch
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models.model import count_params as jax_count_params
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.params import materialize as jax_materialize
from repro.parallel.params import specs as jax_specs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import (dense_projection_map, get_config,
                                      with_kernel_backend)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.attention import attn_decls
from repro_torch.models.layers import mlp_decls
from repro_torch.models.model import count_params, model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

import torch_ranks
from test_torch_trainer_tp import _grads_close, _tp_psum, _values_close
from test_torch_vlm import (LAYOUT_SPEC, _reference_prefill_decode, cfgs,
                            decl_table, hold_cache, hold_logits, hold_steps,
                            port_prefill_decode, redrawn,
                            reference_decl_table, reference_fn,
                            run_families)

ARCH = "seamless-m4t-large-v2"
B, S, STEPS = 8, 64, 2
# name: (dp, tp); tp 1 runs in this process
TRAIN = {"encdec_tp1": (1, 1), "encdec_tp4": (1, 4)}
WIRE = {"B": 4, "S": 64}

chip_smoke = torch_ranks.load_chip_smoke()


def _configs(dense=False, dtype="float32"):
    jcfg, cfg = cfgs(ARCH, dtype=dtype)
    if dense:
        jcfg = jcfg.replace(projections=jax_dense_map())
        cfg = cfg.replace(projections=dense_projection_map())
    return jcfg, cfg


# ---------------------------------------------------------------------------
# decls and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("smoke", [True, False])
def test_decls_and_counts_match_reference(smoke, mesh):
    """Every leaf's shape and spec (``enc_layers``, ``dec_layers`` with
    their ``norm_x`` and ``cross``, ``enc_final_norm``, the ``up`` bias)
    and the parameter counts at tp 1, 4 and 16 (the full config's inside
    the reference's 1-4 G, ``tests/test_models_smoke.py``)."""
    dp, tp = mesh
    jcfg, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                              smoke=smoke)
    ours = model_decls(cfg, MeshAxes(tp=tp, dp=dp))
    assert decl_table(ours) == reference_decl_table(jcfg, dp, tp)
    assert sorted(ours) == ["dec_layers", "embed", "enc_final_norm",
                            "enc_layers", "final_norm", "head"]
    assert sorted(ours["dec_layers"]) == ["cross", "ffn", "mixer", "norm1",
                                          "norm2", "norm_x"]
    assert "b" in ours["dec_layers"]["ffn"]["up"]
    assert "b" not in ours["dec_layers"]["ffn"]["down"]
    for t in (1, 4, 16) if not smoke else (1, 4):
        assert count_params(cfg, t) == jax_count_params(jcfg, tp=t)
    if not smoke:
        dense = cfg.replace(projections=dense_projection_map())
        assert 1e9 < count_params(dense, 16) < 4e9
        assert count_params(cfg, 1) == 1_639_829_504
        assert count_params(cfg, 4) == 1_046_466_560


def test_pipeline_parallelism_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        model_decls(get_config(ARCH, smoke=True), MeshAxes(pp=2, tp=1))


# ---------------------------------------------------------------------------
# layers, training, wire bytes
# ---------------------------------------------------------------------------

def _layer_cases(rng):
    """{name: (port case, the reference's results)} of the gelu MLP and
    cross-attention at tp 4, phantom (``fp``) and dense (``sp``)."""
    axes = JMeshAxes.from_mesh(jax_local_mesh(1, 4))
    cases = {}
    for lay, dense in (("fp", False), ("sp", True)):
        jcfg, cfg = _configs(dense)
        decls = jax_layers.mlp_decls(jcfg, axes, 64, jcfg.d_ff)
        params = redrawn(jax_materialize(decls, seed=6), 11)
        x = rng.randn(2, 16, 64).astype(np.float32)
        r = rng.randn(2, 16, 64).astype(np.float32)

        def body(params, x, r, jcfg=jcfg, decls=decls, lay=lay):
            def obj(params, x):
                out = jax_layers.mlp_apply(jcfg, lay, params, x, axes)
                return jnp.sum(out * r), out
            (_, out), (gp, gx) = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(params, x)
            return out, gx, _tp_psum(gp, decls, axes)
        pspec = jax.tree.map(lambda s: resolve_spec(s, axes),
                             jax_specs(decls))
        fn = reference_fn((1, 4), body,
                          (pspec, LAYOUT_SPEC[lay], LAYOUT_SPEC[lay]),
                          (LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], pspec))
        cases[f"gelu_mlp_{lay}"] = (
            {"kind": "mlp", "cfg": cfg, "layout": lay, "x": x, "r": r,
             "params": params},
            dict(zip(("y", "x", "params"), fn(params, x, r))))

        decls = jax_attn.attn_decls(jcfg, axes, cross=True)
        params = redrawn(jax_materialize(decls, seed=7), 12)
        x = rng.randn(2, 16, 64).astype(np.float32)
        r = rng.randn(2, 16, 64).astype(np.float32)
        memory = rng.randn(2, 24, 64).astype(np.float32)

        def body(params, x, r, memory, jcfg=jcfg, decls=decls, lay=lay):
            def obj(params, x, memory):
                out, _ = jax_attn.attention(jcfg, lay, params, x, None,
                                            axes, None, kind="train",
                                            memory=memory, cross=True)
                return jnp.sum(out * r), out
            (_, out), (gp, gx, gm) = jax.value_and_grad(
                obj, argnums=(0, 1, 2), has_aux=True)(params, x, memory)
            return (out, gx, _tp_psum(gp, decls, axes),
                    jax.lax.psum(gm, axes.tp_name))
        pspec = jax.tree.map(lambda s: resolve_spec(s, axes),
                             jax_specs(decls))
        fn = reference_fn((1, 4), body,
                          (pspec, LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], P()),
                          (LAYOUT_SPEC[lay], LAYOUT_SPEC[lay], pspec, P()))
        cases[f"cross_{lay}"] = (
            {"kind": "cross", "cfg": cfg, "layout": lay, "x": x, "r": r,
             "params": params, "memory": memory},
            dict(zip(("y", "x", "params", "memory"),
                     fn(params, x, r, memory))))
    return cases


def _batches(jcfg):
    return [{k: np.asarray(v) for k, v in
             make_batch(jcfg, B, S, seed=s + 1).items()}
            for s in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    cases = {}
    for name, (dp, tp) in TRAIN.items():
        jcfg, cfg = _configs()
        cases[name] = (jcfg, cfg, dp, tp, _batches(jcfg), 13)
    layers = _layer_cases(np.random.RandomState(8))
    wire_cfg = _configs(dtype="bfloat16")[1]
    body = {(1, 4): {"layers": {k: c for k, (c, _) in layers.items()},
                     "wire": {"encdec_bf16": dict(cfg=wire_cfg,
                                                  batch=WIRE["B"],
                                                  seq=WIRE["S"])}}}
    out = run_families(cases, ((1, 4),), body)
    out["layers"] = layers
    out["wire_cfg"] = wire_cfg
    return out


@pytest.mark.parametrize("name", ["gelu_mlp_fp", "gelu_mlp_sp", "cross_fp",
                                  "cross_sp"])
def test_layer_at_tp4_matches_reference(runs, name):
    case, want = runs["layers"][name]
    ranks = [r["layers"][name] for r in runs[(1, 4)]]
    dim = {"sp": 1, "fp": 2}[case["layout"]]
    _values_close(np.concatenate([r["y"] for r in ranks], dim), want["y"],
                  name)
    _grads_close(np.concatenate([r["x"] for r in ranks], dim), want["x"],
                 name)
    if case["kind"] == "cross":
        _grads_close(sum(r["memory"] for r in ranks), want["memory"],
                     f"{name} memory")
    cfg, tp4 = case["cfg"], MeshAxes(tp=4)
    decls = (mlp_decls(cfg, tp4, 64, cfg.d_ff) if case["kind"] == "mlp"
             else attn_decls(cfg, tp4, cross=True))
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, 1, 4)))
    for path, w in tree_leaves(want["params"]):
        _grads_close(got[path], w, f"{name} {path}")
    if case["kind"] == "mlp":
        assert sorted(want["params"]) == ["down", "up"]
        assert np.abs(got["up/b"]).max() > 0
    else:
        # cross K/V are never phantom: the memory is not feature-sharded
        assert sorted(want["params"]["wk"]) == ["w"]


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(runs, name):
    dp, tp = TRAIN[name]
    ranks = [r["train"][name] for r in runs[(dp, tp)]]
    assert all(len(r["losses"]) == STEPS for r in ranks)
    hold_steps(name, _configs()[1], runs["ref"][name], ranks, dp, tp)


def test_wire_bytes_equal_the_count(runs):
    """Every rank's logged wire bytes of one bf16 step of seamless-smoke at
    tp 4 equal ``chip_smoke.py: encdec_wire_bytes``, the count phase 16
    holds on the card."""
    want = chip_smoke.encdec_wire_bytes(runs["wire_cfg"], WIRE["B"],
                                        WIRE["S"], 4)
    for r in runs[(1, 4)]:
        assert r["wire"]["encdec_bf16"]["wire_bytes"] == want, r["wire"]


# ---------------------------------------------------------------------------
# prefill, decode, serving
# ---------------------------------------------------------------------------

def _prefill_decode_case():
    Bt, St = 4, 32
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True, dtype="float32")
    params = redrawn(jax_materialize(jax_model_decls(
        jcfg, JMeshAxes.from_mesh(jax_local_mesh(1, 1))), 3), 9)
    batch = {k: np.asarray(v) for k, v in
             make_batch(jcfg, Bt, St, seed=4).items() if k != "labels"}
    tok = np.random.RandomState(5).randint(0, 256, (Bt, 1)).astype(np.int32)
    return jcfg, cfg, params, batch, tok, St


def test_prefill_and_decode_match_reference():
    """Random frames, redrawn norm and bias leaves: prefill's last logits,
    self and cross K/V, then one decode step on the cache padded to 64
    rows (the cross K/V's 32 zero rows included), float32."""
    jcfg, cfg, params, batch, tok, St = _prefill_decode_case()
    want = _reference_prefill_decode(jcfg, jax.tree.map(jnp.asarray, params),
                                     batch, tok, 2 * St)
    got = port_prefill_decode(cfg, from_jax_params(params), batch, tok,
                              2 * St)
    V = cfg.vocab_size
    hold_logits(got[0], want[0], V, "prefill")
    hold_cache(got[1], want[1], "prefill")
    assert np.abs(want[1]["cross"]["k"][:, :, :St]).max() > 0.1
    assert not want[1]["cross"]["k"][:, :, St:].any()
    hold_logits(got[2], want[2], V, "decode")
    hold_cache(dict(tree_leaves(got[3])), want[3], "decode")


def test_decode_weighs_the_zero_padded_cross_rows():
    """The quirk the port reproduces: decode's cross-attention reads the
    cross cache with no ``kv_limit``, so the zero rows the engine pads it
    with past the encoder's length take softmax weight.  The reference's
    decode logits on the padded cache differ from those on the cross
    K/V of the encoder's length alone; the port's follow the padded
    ones (``test_prefill_and_decode_match_reference``)."""
    jcfg, _, params, batch, tok, St = _prefill_decode_case()
    jp = jax.tree.map(jnp.asarray, params)
    padded = _reference_prefill_decode(jcfg, jp, batch, tok, 2 * St)[2]
    exact = _reference_prefill_decode(jcfg, jp, batch, tok, St + 1)
    # at St + 1 rows the cross K/V carry one zero row; cut it away
    mesh = jax_local_mesh(1, 1)
    axes = JMeshAxes.from_mesh(mesh)
    from repro.models import model as jax_model
    from repro.parallel.compat import shard_map
    pspecs = jax.tree.map(lambda sp: resolve_spec(sp, axes), jax_specs(
        jax_model_decls(jcfg, axes)))
    dec = jax.jit(shard_map(
        lambda p, c, t, pos: jax_model.forward_decode(jcfg, axes, p, c, t,
                                                      pos),
        mesh=mesh, in_specs=(pspecs, P(), P(), P()), out_specs=P(),
        check_vma=False))
    cache = exact[1]
    cache = {"self": cache["self"],
             "cross": {k: v[:, :, :St] for k, v in cache["cross"].items()}}
    unpadded = np.asarray(dec(jp, cache, jnp.asarray(tok),
                              jnp.full((tok.shape[0],), St, jnp.int32))[0])
    V = jcfg.vocab_size
    gap = np.abs(padded[..., :V] - unpadded[..., :V]).max()
    assert gap > 1e-2 * np.abs(unpadded[..., :V]).max(), gap


def _prompts():
    """Exact-length groups: every prompt its own length."""
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32)
            for n in (5, 17, 16, 9, 12)]


SLOTS, MAX_LEN, PAGE = 2, 64, 1


@pytest.fixture(scope="module")
def serve_ref():
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
    assert sorted(eng.cache) == ["cross", "self"]
    assert eng.cache["cross"]["k"].shape[2] == MAX_LEN
    reqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.pages.allocated_pages == 0


def test_launch_serve_encdec_smoke_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "# served seamless-smoke on cpu" in out
    assert "requests=3 tokens=9" in out


def test_launch_train_raises_for_the_encdec_family():
    """The reference's launcher feeds ``LMDataset`` batches, which carry
    no ``frames`` (its encoder reads ``batch["frames"]``): the port's
    raises instead."""
    from repro.data.synthetic import LMDataset as JLMDataset
    assert "frames" not in JLMDataset(256, 2, 9)(0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 3"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1"])
