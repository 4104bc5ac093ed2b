"""The port's SSM family (mamba2) against the JAX package, on the CPU.

* ``_ssd_chunked`` (several chunk lengths, a ragged sequence whose chunk
  ``_pick_chunk`` cuts to 1, an initial state) and ``_ssd_decode_step``
  against the reference's: values rtol 1e-5 / atol 1e-6 of the array's
  largest magnitude, gradients of every input rtol 1e-4 / atol 1e-5 of
  it, at dt where the reference's exponents stay finite.
* The overflow of the reference's masked triangle: at Q = 128, dt = 1
  and A = -1 its dt gradient is not finite (``exp`` of exponents up to
  127 overflows, and its backward computes 0 * inf); the port's
  (exponent masked before the ``exp``) is finite and equals the
  reference's evaluated in float64, where nothing overflows.
* ``ssm_apply`` in train, prefill and decode at tp 1 and tp 2 (gloo CPU
  ranks, mesh 1 x 2) against the reference's inside ``shard_map``, with
  phantom in/out sites (``fp``) and dense ones (``sp``; ``rep`` in
  decode): outputs, caches, input and parameter gradients.
* The prefill's final ``{"conv", "ssm"}`` state and last logits against
  decoding the prompt token by token from a zero state (mamba2-smoke,
  float32, within 1e-4), at a prompt longer and one shorter than the
  conv window.
* Three AdamW steps of mamba2-smoke at 1 x 1 and 1 x 2 (phantom, and
  dense at 1 x 2) against the reference's trainer, each step from the
  reference's parameters and optimizer state before it
  (``tests/test_torch_lm_pipeline.py: hold_pipelined_steps``: at tp 2 a
  run from the first step alone carries AdamW's amplification of float32
  differences at near-zero ``sqrt(v^)`` into the later steps' gradient
  norms, 5e-5 of them by the third step where the first agree to 1e-6).
* The wire bytes of one bf16 step at tp 2 equal ``chip_smoke.py:
  ssm_wire_bytes`` to the byte.
* Greedy token streams of the two ``ServeEngine``s on mamba2-smoke,
  prompts of mixed lengths, each an exact-length group.
* Decls at tp 4 and parameter counts at tp 1, 4 and 16 against the
  reference's; the launchers on the CPU.

One spawn (1 x 2), in a thread of its own while the reference compiles
and runs here.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import ssm as jax_ssm
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
from repro_torch.configs.base import (dense_projection_map, get_config,
                                      with_kernel_backend)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import ssm
from repro_torch.models.model import (cache_decls, count_params,
                                      forward_decode, forward_prefill,
                                      model_decls)
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         materialize, tree_leaves)
from repro_torch.serve.engine import Request, ServeEngine

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_trainer_tp import (_grads_close, _norm_spec, _tp_psum,
                                   _values_close)

# the script's wire-byte counts, which its phase 13 holds on the card
chip_smoke = torch_ranks.load_chip_smoke()

ARCH = "mamba2-370m"
B, S = 2, 64
# name: (projections, tp); dp 1
TRAIN = {"mamba2_tp1": ("config", 1), "mamba2_tp2": ("config", 2),
         "mamba2_dense_tp2": ("dense", 2)}
LAYOUT_SPEC = {"fp": P(None, None, "model"), "sp": P(None, "model", None),
               "rep": P()}
CACHE_SPEC = {"conv": P(None, None, "model"),
              "ssm": P(None, "model", None, None)}
WIRE = {"B": 4, "S": 64}


def _cfgs(proj="config", dtype="float32"):
    """The reference's smoke config and the port's (kernel backend
    "auto"), phantom in/out sites or dense ones."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=dtype)
    cfg = get_config(ARCH, smoke=True, dtype=dtype)
    if proj == "dense":
        jcfg = jcfg.replace(projections=jax_dense_map())
        cfg = cfg.replace(projections=dense_projection_map())
    return jcfg, with_kernel_backend(cfg, "auto")


# ---------------------------------------------------------------------------
# the chunked scan and the one-token step
# ---------------------------------------------------------------------------

def _scan_inputs(rng, Bsz, S_, H, hd, N, dt=None):
    x = rng.randn(Bsz, S_, H, hd).astype(np.float32)
    if dt is None:
        dt = np.log1p(np.exp(rng.randn(Bsz, S_, H))).astype(np.float32)
    A = -np.exp(0.5 * rng.randn(H)).astype(np.float32)
    Bm = rng.randn(Bsz, S_, N).astype(np.float32) * 0.5
    Cm = rng.randn(Bsz, S_, N).astype(np.float32) * 0.5
    return [x, np.asarray(dt, np.float32), A, Bm, Cm]


def _jax_scan(args, chunk, r, rs, s0=None):
    """The reference's (y, state) and the gradients of
    sum(y * r) + sum(state * rs) with respect to every input."""
    def obj(*a):
        y, st = jax_ssm._ssd_chunked(*a[:5], chunk, initial_state=(
            a[5] if len(a) > 5 else None))
        return jnp.sum(y * r) + jnp.sum(st * rs), (y, st)
    a = [jnp.asarray(v) for v in args + ([] if s0 is None else [s0])]
    (_, (y, st)), g = jax.value_and_grad(
        obj, argnums=tuple(range(len(a))), has_aux=True)(*a)
    return np.asarray(y), np.asarray(st), [np.asarray(v) for v in g]


def _port_scan(args, chunk, r, rs, s0=None, dtype=torch.float32):
    a = [torch.from_numpy(np.asarray(v)).to(dtype).requires_grad_(True)
         for v in args + ([] if s0 is None else [s0])]
    y, st = ssm._ssd_chunked(*a[:5], chunk, initial_state=(
        a[5] if len(a) > 5 else None))
    ((y * torch.from_numpy(r).to(dtype)).sum()
     + (st * torch.from_numpy(rs).to(dtype)).sum()).backward()
    return (y.detach().numpy(), st.detach().numpy(),
            [t.grad.numpy() for t in a])


@pytest.mark.parametrize("S_,chunk,init", [(64, 16, False), (48, 32, True),
                                            (37, 16, False), (32, 32, True)])
def test_ssd_chunked_matches_reference(S_, chunk, init):
    rng = np.random.RandomState(S_ + chunk)
    Bsz, H, hd, N = 2, 3, 4, 5
    args = _scan_inputs(rng, Bsz, S_, H, hd, N)
    r = rng.randn(Bsz, S_, H, hd).astype(np.float32)
    rs = rng.randn(Bsz, H, hd, N).astype(np.float32)
    s0 = rng.randn(Bsz, H, hd, N).astype(np.float32) if init else None
    assert ssm._pick_chunk(S_, chunk) == jax_ssm._pick_chunk(S_, chunk)
    if S_ == 37:
        assert ssm._pick_chunk(37, 16) == 1       # prime: one-token chunks
    want = _jax_scan(args, chunk, r, rs, s0)
    got = _port_scan(args, chunk, r, rs, s0)
    _values_close(got[0], want[0], "y")
    _values_close(got[1], want[1], "state")
    names = ["x", "dt", "A", "Bm", "Cm", "initial_state"]
    for n, g, w in zip(names, got[2], want[2]):
        _grads_close(g, w, f"d{n}")


def test_pick_chunk_matches_reference():
    for S_ in (1, 5, 16, 17, 29, 37, 48, 64, 96, 128, 512):
        for chunk in (16, 32, 128):
            assert ssm._pick_chunk(S_, chunk) == \
                jax_ssm._pick_chunk(S_, chunk)


def test_ssd_decode_step_matches_reference():
    rng = np.random.RandomState(4)
    Bsz, H, hd, N = 3, 4, 5, 6
    state = rng.randn(Bsz, H, hd, N).astype(np.float32)
    x = rng.randn(Bsz, H, hd).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(Bsz, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    Bm, Cm = (rng.randn(Bsz, N).astype(np.float32) for _ in range(2))
    r = rng.randn(Bsz, H, hd).astype(np.float32)
    rs = rng.randn(Bsz, H, hd, N).astype(np.float32)
    args = [state, x, dt, A, Bm, Cm]

    def obj(*a):
        y, s = jax_ssm._ssd_decode_step(*a)
        return jnp.sum(y * r) + jnp.sum(s * rs), (y, s)
    (_, (wy, ws)), wg = jax.value_and_grad(
        obj, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(v) for v in args])
    t = [torch.from_numpy(v).requires_grad_(True) for v in args]
    y, s = ssm._ssd_decode_step(*t)
    ((y * torch.from_numpy(r)).sum()
     + (s * torch.from_numpy(rs)).sum()).backward()
    _values_close(y.detach().numpy(), np.asarray(wy))
    _values_close(s.detach().numpy(), np.asarray(ws))
    for a, w in zip(t, wg):
        _grads_close(a.grad.numpy(), np.asarray(w))


def test_masked_exponent_keeps_the_dt_gradient_finite():
    """Q = 128, dt = 1, A = -1 (``A_log`` zero-initialised): the masked
    triangle's exponents reach 127.  The reference's dt gradient is not
    finite; the port's is.  The port's gradients equal the reference's
    evaluated in float64, where nothing overflows: the port's own
    float64 run to 1e-9, its float32 run within 1e-4 of each gradient's
    largest magnitude (float32 rounds cumulative decays of up to 127).
    The outputs and the x gradients agree in float32."""
    rng = np.random.RandomState(0)
    Bsz, S_, H, hd, N = 1, 128, 2, 4, 8
    args = _scan_inputs(rng, Bsz, S_, H, hd, N,
                        dt=np.ones((Bsz, S_, H)))
    args[2] = -np.ones(H, np.float32)
    r = rng.randn(Bsz, S_, H, hd).astype(np.float32)
    rs = rng.randn(Bsz, H, hd, N).astype(np.float32)
    want = _jax_scan(args, 128, r, rs)
    assert not np.isfinite(want[2][1]).all()        # the reference's dt
    assert np.isfinite(want[2][0]).all()            # its x stays finite
    got = _port_scan(args, 128, r, rs)
    assert all(np.isfinite(g).all() for g in got[2])
    _values_close(got[0], want[0], "y")
    _grads_close(got[2][0], want[2][0], "dx")
    zero = np.zeros((Bsz, H, hd, N))     # a float64 state: the default
    with jax.enable_x64(True):           # one is float32 on both sides
        f64 = _jax_scan([a.astype(np.float64) for a in args], 128,
                        r.astype(np.float64), rs.astype(np.float64), zero)
    got64 = _port_scan(args, 128, r, rs, zero, dtype=torch.float64)
    for n, g, g64, w in zip(["x", "dt", "A", "Bm", "Cm"], got[2], got64[2],
                            f64[2]):
        assert np.isfinite(w).all(), n
        np.testing.assert_allclose(g64, w, rtol=1e-9, atol=0,
                                   err_msg=f"d{n} float64")
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"d{n} float32 vs float64")


# ---------------------------------------------------------------------------
# ssm_apply at tp 1 and 2, the trainer, the wire bytes
# ---------------------------------------------------------------------------

def _layer_names():
    return [f"{proj}_{kind}_tp{tp}" for tp in (1, 2)
            for proj in ("phantom", "dense")
            for kind in ("train", "prefill", "decode")]


def _layout(proj, kind):
    if proj == "phantom":
        return "fp"
    return "rep" if kind == "decode" else "sp"


def _layer_cases(rng, tp):
    """{name: (port case, a call that gives the reference's results)}
    at tp on a 1 x tp mesh."""
    mesh = jax_local_mesh(1, tp)
    axes = JMeshAxes.from_mesh(mesh)
    cases = {}
    for name in _layer_names():
        proj, kind, t = name.split("_")
        if int(t[2:]) != tp:
            continue
        jcfg, cfg = _cfgs("config" if proj == "phantom" else "dense")
        lay = _layout(proj, kind)
        decls = jax_ssm.ssm_decls(jcfg, axes)
        params = jax.tree.map(np.asarray, jax_materialize(decls, seed=5))
        # non-trivial decay and skip: A_log and Dskip are 0 and 1 at init
        _, H, N, hd = jax_ssm.ssm_dims(jcfg)
        params["A_log"] = (0.3 * rng.randn(H)).astype(np.float32)
        params["Dskip"] = (1 + 0.3 * rng.randn(H)).astype(np.float32)
        params["norm_scale"] = (1 + 0.1 * rng.randn(
            params["norm_scale"].shape[0])).astype(np.float32)
        Sx = 1 if kind == "decode" else S
        d = jcfg.d_model
        x = (rng.randn(B, Sx, d) * 0.5).astype(np.float32)
        r = rng.randn(B, Sx, d).astype(np.float32)
        d_inner = jcfg.ssm.expand * d
        cache = {"conv": (rng.randn(B, jcfg.ssm.conv_width - 1, d_inner)
                          * 0.5).astype(np.float32),
                 "ssm": (rng.randn(B, H, hd, N) * 0.5).astype(np.float32)}
        pspec = jax.tree.map(lambda sp: resolve_spec(sp, axes),
                             jax_specs(decls))
        xs = LAYOUT_SPEC[lay]

        if kind == "train":
            def body(params, x, r, jcfg=jcfg, lay=lay, decls=decls):
                def obj(params, x):
                    y, _ = jax_ssm.ssm_apply(jcfg, lay, params, x, axes,
                                             kind="train")
                    return jnp.sum(y * r), y
                (_, y), (gp, gx) = jax.value_and_grad(
                    obj, argnums=(0, 1), has_aux=True)(params, x)
                return y, gx, _tp_psum(gp, decls, axes)
            fn = jax.jit(shard_map(body, mesh=mesh,
                                   in_specs=(pspec, xs, xs),
                                   out_specs=(xs, xs, pspec),
                                   check_vma=False))
            args = (params, x, r)
            keys = ("y", "x", "params")
        elif kind == "prefill":
            def body(params, x, jcfg=jcfg, lay=lay):
                return jax_ssm.ssm_apply(jcfg, lay, params, x, axes,
                                         kind="prefill")
            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(pspec, xs),
                                   out_specs=(xs, CACHE_SPEC),
                                   check_vma=False))
            args = (params, x)
            keys = ("y", "cache")
        else:
            def body(params, x, cache, jcfg=jcfg, lay=lay):
                return jax_ssm.ssm_apply(jcfg, lay, params, x, axes,
                                         kind="decode", cache=cache)
            fn = jax.jit(shard_map(body, mesh=mesh,
                                   in_specs=(pspec, xs, CACHE_SPEC),
                                   out_specs=(xs, CACHE_SPEC),
                                   check_vma=False))
            args = (params, x, cache)
            keys = ("y", "cache")
        cases[name] = (
            {"cfg": cfg, "layout": lay, "kind": kind, "x": x, "r": r,
             "params": params, "cache": cache},
            lambda fn=fn, a=args, keys=keys: dict(zip(
                keys, jax.tree.map(np.asarray, fn(*a)))))
    return cases


@pytest.fixture(scope="module")
def runs():
    """The reference's trainer runs first (the port's steps start from
    its states; threads: XLA compiles outside the interpreter lock), then
    one 1 x 2 spawn in a thread of its own while the reference's layer
    cases run here; tp = 1 in this process."""
    rng = np.random.RandomState(7)
    with ThreadPoolExecutor(8) as pool:
        made = {name: pool.submit(lm_pipeline._jax_run, _cfgs(proj)[0], 1,
                                  1, tp, 1, "adamw")
                for name, (proj, tp) in TRAIN.items()}
        ref = {}
        for name, f in made.items():
            ref[name], run = f.result()
            made[name] = pool.submit(run)
        for f in made.values():
            f.result()
    layers = {tp: _layer_cases(rng, tp) for tp in (1, 2)}
    train = {1: {}, 2: {}}
    for name, (proj, tp) in TRAIN.items():
        train[tp][name] = dict(
            cfg=_cfgs(proj)[1], starts=ref[name]["starts"],
            batches=ref[name]["batches"], lr=lm_pipeline.LR,
            weight_decay=lm_pipeline.WD, microbatches=1, optimizer="adamw")
    wire = {"mamba2_bf16_tp2": dict(cfg=_cfgs(dtype="bfloat16")[1],
                                    batch=WIRE["B"], seq=WIRE["S"])}
    out = {"ref": ref}
    errors = []

    def ranks():
        try:
            out["tp2"] = spawn(torch_ranks.ssm_body, 1, 2, "cpu",
                               timeout_s=300, args=({
                                   "layers": {k: c for k, (c, _) in
                                              layers[2].items()},
                                   "train": train[2], "wire": wire},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()
    with ThreadPoolExecutor(16) as pool:
        wants = {k: pool.submit(want) for tp in (1, 2)
                 for k, (_, want) in layers[tp].items()}
        one = MeshAxes(), torch.device("cpu")
        out["tp1"] = [{
            "train": torch_ranks.lm_pipeline_body(
                *one, {"train": train[1], "draw_cfg": None})["train"],
            "layers": torch_ranks.ssm_layers_body(
                *one, {k: c for k, (c, _) in layers[1].items()})}]
        out["layers_ref"] = {
            k: (c, wants[k].result()) for tp in (1, 2)
            for k, (c, _) in layers[tp].items()}
    thread.join()
    if errors:
        raise errors[0]
    return out


def _assemble(parts, dim):
    return parts[0] if dim is None else np.concatenate(parts, axis=dim)


@pytest.mark.parametrize("name", _layer_names())
def test_ssm_apply_matches_reference(runs, name):
    """Each case's output (and cache, or input and parameter gradients)
    assembled over the model ranks, against the reference's inside
    ``shard_map``."""
    case, want = runs["layers_ref"][name]
    tp = int(name.split("_")[-1][2:])
    ranks = [r["layers"][name] for r in runs["tp1" if tp == 1 else "tp2"]]
    dim = {"fp": 2, "sp": 1, "rep": None}[case["layout"]]
    _values_close(_assemble([r["y"] for r in ranks], dim), want["y"],
                  f"{name} y")
    if case["kind"] != "train":
        for key, cdim in (("conv", 2), ("ssm", 1)):
            _values_close(_assemble([r["cache"][key] for r in ranks], cdim),
                          want["cache"][key], f"{name} cache {key}")
        return
    _grads_close(_assemble([r["x"] for r in ranks], dim), want["x"],
                 f"{name} dx")
    decls = ssm.ssm_decls(case["cfg"], MeshAxes(tp=tp))
    got = dict(tree_leaves(gather_params([r["params"] for r in ranks],
                                         decls, 1, tp)))
    for path, w in tree_leaves(want["params"]):
        assert got[path].shape == w.shape, (name, path)
        _grads_close(got[path], w, f"{name} {path}")


@pytest.mark.parametrize("name", list(TRAIN))
def test_ssm_train_step_matches_jax(runs, name):
    proj, tp = TRAIN[name]
    ranks = runs["tp1"] if tp == 1 else runs["tp2"]
    lm_pipeline.hold_pipelined_steps(
        name, _cfgs(proj)[1], runs["ref"][name],
        [r["train"][name] for r in ranks], 1, 1, tp, "adamw")


def test_ssm_wire_bytes_equal_the_count(runs):
    """Every rank's logged wire bytes of one bf16 step at tp 2 equal
    ``ssm_wire_bytes`` to the byte (the count phase 13 of
    ``chip_smoke.py`` holds on the card)."""
    cfg = _cfgs(dtype="bfloat16")[1]
    want = chip_smoke.ssm_wire_bytes(cfg, WIRE["B"], WIRE["S"], 2)
    for r in runs["tp2"]:
        got = r["wire"]["mamba2_bf16_tp2"]
        assert got["wire_bytes"] == want, got


# ---------------------------------------------------------------------------
# prefill against decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_", [19, 2])
def test_prefill_state_equals_token_by_token_decode(S_):
    """The prefill's final state and last logits equal decoding the
    prompt one token at a time from a zero state (float32, within 1e-4
    of the largest magnitude): the chunked scan against the recurrence,
    the conv window's state against the rolling buffer (also for a
    prompt shorter than the window)."""
    cfg = get_config(ARCH, smoke=True, dtype="float32")
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(1), "cpu")
    params["layers"]["mixer"]["A_log"].normal_(0, 0.3)
    toks = torch.randint(0, cfg.vocab_size, (3, S_),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        lg_pre, pre = forward_prefill(cfg, MeshAxes(), params,
                                      {"tokens": toks})
        cache = {k: torch.zeros(s.shape, dtype=torch.float32) for k, s in
                 cache_decls(cfg, MeshAxes(), 3, S_).items()}
        for t in range(S_):
            lg, cache = forward_decode(cfg, MeshAxes(), params, cache,
                                       toks[:, t:t + 1],
                                       torch.full((3,), t))
    for got, want in ((lg, lg_pre), (cache["conv"], pre["conv"]),
                      (cache["ssm"], pre["ssm"])):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=1e-4,
            atol=1e-4 * want.abs().max().item())


def _prompts():
    """Exact-length groups: every prompt its own length (5 to 17)."""
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, n).astype(np.int32)
            for n in (5, 17, 16, 9, 12)]


SLOTS, MAX_LEN, PAGE = 2, 64, 1


@pytest.fixture(scope="module")
def serve_ref():
    """The reference's smoke params (1 x 1 mesh) and the greedy streams
    of its engine (page size 1: any prompt length is its own group)."""
    mesh = jax_local_mesh(1, 1)
    cfg = jax_get_config(ARCH, smoke=True)
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
    cfg = with_kernel_backend(get_config(ARCH, smoke=True), backend)
    eng = ServeEngine(cfg, from_jax_params(params), slots=SLOTS,
                      max_len=MAX_LEN, page_size=PAGE, device="cpu")
    assert not eng.scheduler.mixed_lengths
    assert eng.cache["ssm"].dtype == torch.float32
    assert eng.params["layers"]["mixer"]["conv_w"].dtype == torch.float32
    reqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in _prompts()]
    eng.run(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.pages.allocated_pages == 0


def test_engine_rejects_unaligned_prompts_at_page16():
    """An exact-length family at the default page size admits prompts of
    a multiple of it only, as the reference's scheduler does: another
    length is rejected at admission, and the rest are served."""
    cfg = get_config(ARCH, smoke=True)
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    bad = Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=2)
    good = Request(prompt=np.arange(16, dtype=np.int32), max_new_tokens=2)
    eng.run([bad, good])
    assert bad.done and "multiple of 16" in bad.error
    assert good.done and len(good.out_tokens) == 2 and good.error is None


# ---------------------------------------------------------------------------
# decls, counts, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proj", ["config", "dense"])
@pytest.mark.parametrize("smoke", [True, False])
def test_ssm_decls_and_counts_match_reference(proj, smoke):
    """Every leaf's shape and spec at tp = 4 and the parameter count at
    tp 1 and 4 (and 16 at full size) equal the reference's."""
    jcfg, cfg = _cfgs(proj)
    if not smoke:
        jcfg = jax_get_config(ARCH)
        cfg = get_config(ARCH)
        if proj == "dense":
            jcfg = jcfg.replace(projections=jax_dense_map())
            cfg = cfg.replace(projections=dense_projection_map())
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=4, dp=1, dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=4)))}
    assert ours == theirs
    for tp in (1, 4) + (() if smoke else (16,)):
        assert count_params(cfg, tp) == jax_count_params(jcfg, tp=tp)
    if not smoke and proj == "config":
        assert count_params(cfg, 4) == 202_659_328
        assert count_params(cfg, 16) == 169_629_184


def test_launch_train_mamba2_at_tp2_runs_on_the_cpu(capfd):
    assert launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--tp", "2", "--steps", "2", "--batch", "4",
                              "--seq", "32"]) == 0
    out = capfd.readouterr().out
    cfg = get_config(ARCH, smoke=True)
    assert (f"# mamba2-smoke impl=phantom dp=1 on cpu (tp=2, "
            f"kernel_backend=config): {count_params(cfg, 2):,} params") in out
    assert "[trainer] step 2 loss " in out


def test_launch_serve_mamba2_smoke_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "# served mamba2-smoke on cpu" in out
    assert "requests=3 tokens=9" in out
