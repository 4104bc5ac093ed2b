"""The port's LM trainer against the JAX package, on the CPU.

* ``make_train_step``: three AdamW steps of ``phi3-smoke`` and
  ``stablelm-smoke`` (2 layers, d = 64) in float32, at microbatches 1
  and 2, and of ``phi3-smoke`` on dp = 2 (gloo CPU ranks against the
  reference's 2-device mesh), from the reference's initial parameters
  (``from_jax_params``) and its ``LMDataset``'s token batches (4
  sequences of 128 tokens: two loss chunks of 64).  The reference runs
  ``kernel_backend="xla"`` (its blockwise attention core); the port runs
  ``"auto"``, which on CPU tensors is the flash path's plain version,
  differentiated through ``kernels/ops.py: flash_attention_vjp``.
  Tolerances, float32 (the two sides sum in different orders): losses
  and gradient norms rtol 1e-5; each step's clipped gradients within
  1e-4 of their leaf's largest; final parameters rtol 1e-4 / atol 1e-5
  (PR 12's FFN tolerance).  AdamW's update ``m^ / (sqrt(v^) + eps)``
  has slope ~1 / eps where ``sqrt(v^)`` is within a few eps of zero, so
  there a float32 gradient difference of 1e-11 moves a parameter by
  ~1e-4: an element whose ``sqrt(v^)`` fell below 10 eps on either side
  at some step is held to the tolerance plus what the two sides'
  gradients imply, ``sum_t lr * |u_t(port) - u_t(ref)|`` in float64
  (``_adamw_implied``), as ``chip_smoke.py: _step1_diff`` does for
  step 1.  Such elements must stay under 0.1% of the parameters.  (A
  ``sqrt(v^)`` of exactly 0 is no such point: a gradient that is 0 on
  both sides so far, as for an embedding row no token has used yet,
  gives the update 0 on both.)
* ``xent_loss`` (several chunks, padded vocab columns) and LayerNorm
  against the reference's, values and gradients.
* The in-place SGD and AdamW updates give the same bits as the
  out-of-place formulas they replaced; ``make_optimizer``.
* ``LMDataset``'s construction; ``launch.train`` on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import LMDataset as JLMDataset
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import layers as jax_layers
from repro.optim.optimizers import AdamW as JAdamW
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.compat import shard_map
from repro.parallel.params import materialize as jax_materialize
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.data.synthetic import LMDataset, lm_token_batch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import layers
from repro_torch.optim import SGD, Adafactor, AdamW, make_optimizer
from repro_torch.optim import optimizers
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import tree_leaves

import torch_ranks

ARCHS = {"phi3": "phi3-mini-3.8b", "stablelm": "stablelm-3b"}
B, S, STEPS, LR, WD = 4, 128, 3, 1e-3, 0.1
# (arch, microbatches, dp)
RUNS = {"phi3_mb1": ("phi3", 1, 1), "phi3_mb2": ("phi3", 2, 1),
        "stablelm_mb1": ("stablelm", 1, 1),
        "stablelm_mb2": ("stablelm", 2, 1), "phi3_dp2": ("phi3", 1, 2)}


class _JRecordingAdamW(JAdamW):
    """The reference's AdamW, whose state also carries the (clipped)
    gradients of its last update, so the test can read them."""

    def state_decls(self, param_decls):
        s = super().state_decls(param_decls)
        return {**s, "g": s["m"]}

    def init(self, params):
        s = super().init(params)
        return {**s, "g": jax.tree.map(jnp.zeros_like, s["m"])}

    def update(self, grads, state, params, step):
        params, s = super().update(
            grads, {"m": state["m"], "v": state["v"]}, params, step)
        return params, {**s, "g": grads}


def _jax_run(arch, microbatches, dp):
    cfg = jax_get_config(ARCHS[arch], smoke=True).replace(dtype="float32")
    mesh = jax_local_mesh(dp, 1)
    opt = _JRecordingAdamW(LR, weight_decay=WD)
    step, decls, _ = jax_make_train_step(cfg, mesh, opt,
                                         microbatches=microbatches)
    params = jax_materialize(decls, seed=3)
    start = jax.tree.map(np.array, params)
    ds = JLMDataset(cfg.vocab_size, B, S + 1, seed=1)
    batches = [jax.tree.map(np.array, ds(s)) for s in range(STEPS)]
    state = opt.init(params)
    losses, gnorms, grads = [], [], []
    for s, batch in enumerate(batches):
        params, state, m = step(params, state, jnp.int32(s), batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        grads.append(jax.tree.map(np.array, state["g"]))
    return {"start": start, "batches": batches, "losses": losses,
            "grad_norms": gnorms, "grads": grads,
            "params": jax.tree.map(np.array, params)}


def _port_case(arch, microbatches, ref):
    cfg = with_kernel_backend(
        get_config(ARCHS[arch], smoke=True, dtype="float32"), "auto")
    return dict(cfg=cfg, params=ref["start"], batches=ref["batches"],
                lr=LR, weight_decay=WD, microbatches=microbatches)


@pytest.fixture(scope="module")
def runs():
    """Every run on the reference, then the port's: the dp = 1 cases in
    this process, the dp = 2 case on two gloo ranks."""
    ref = {name: _jax_run(*spec) for name, spec in RUNS.items()}
    one = {name: _port_case(a, m, ref[name])
           for name, (a, m, dp) in RUNS.items() if dp == 1}
    two = {name: _port_case(a, m, ref[name])
           for name, (a, m, dp) in RUNS.items() if dp == 2}
    port = {name: [res] for name, res in torch_ranks.trainer_body(
        MeshAxes(), torch.device("cpu"), one).items()}
    ranks = spawn(torch_ranks.trainer_body, 2, 1, "cpu", args=(two,),
                  timeout_s=300)
    for name in two:
        port[name] = [r[name] for r in ranks]
    return ref, port


def _adamw_implied(gs_port, gs_ref, eps=1e-8, b1=0.9, b2=0.95):
    """From each side's gradients of every step (float64): where
    ``sqrt(v^)`` fell below 10 eps, and not to 0, on either side at some
    step, and
    ``sum_t lr * |u_t(port) - u_t(ref)|``, what the two sides' gradients
    imply for the parameters."""
    mp = vp = mr = vr = 0.0
    near, implied = False, 0.0
    for t, (gp, gr) in enumerate(zip(gs_port, gs_ref), start=1):
        gp, gr = np.float64(gp), np.float64(gr)
        mp, mr = b1 * mp + (1 - b1) * gp, b1 * mr + (1 - b1) * gr
        vp, vr = b2 * vp + (1 - b2) * gp ** 2, b2 * vr + (1 - b2) * gr ** 2
        sp, sr = (np.sqrt(v / (1 - b2 ** t)) for v in (vp, vr))
        up, ur = (m / (1 - b1 ** t) / (s + eps)
                  for m, s in ((mp, sp), (mr, sr)))
        near = near | ((0 < sp) & (sp < 10 * eps)) \
            | ((0 < sr) & (sr < 10 * eps))
        implied = implied + LR * np.abs(up - ur)
    return near, implied


@pytest.mark.parametrize("name", list(RUNS))
def test_train_step_matches_jax(runs, name):
    ref, port = runs
    want = ref[name]
    for rank in port[name]:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-5, err_msg=name)
        for s, (gp, gr) in enumerate(zip(rank["grads"], want["grads"])):
            got = dict(tree_leaves(gp))
            for path, w in tree_leaves(gr):
                np.testing.assert_allclose(
                    got[path], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                    err_msg=f"{name} step {s} gradient {path}")
        got = dict(tree_leaves(rank["params"]))
        n_near = n_all = 0
        for path, w in tree_leaves(want["params"]):
            near, implied = _adamw_implied(
                [dict(tree_leaves(g))[path] for g in rank["grads"]],
                [dict(tree_leaves(g))[path] for g in want["grads"]])
            diff = np.abs(np.float64(got[path]) - w)
            tol = 1e-5 + 1e-4 * np.abs(w) + implied * near
            assert (diff <= tol).all(), (
                f"{name} {path}: {int((diff > tol).sum())} elements "
                f"outside, worst {diff.max():.3e}")
            n_near += int(np.sum(near))
            n_all += w.size
        assert n_near <= 1e-3 * n_all, (name, n_near, n_all)


def test_dp_ranks_agree(runs):
    """The two dp ranks end with the same bits."""
    a, b = runs[1]["phi3_dp2"]
    assert a["losses"] == b["losses"]
    for (path, x), (_, y) in zip(tree_leaves(a["params"]),
                                 tree_leaves(b["params"])):
        np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------------------
# the loss and the norms
# ---------------------------------------------------------------------------

def _jax_xent(cfg, h, w, labels):
    """The reference's xent_loss on a 1x1 mesh: (sum_loss, n_valid) and
    the gradients of sum_loss w.r.t. h and w."""
    mesh = jax_local_mesh(1, 1)
    axes = JMeshAxes.from_mesh(mesh)

    def body(h, w, labels):
        return jax_layers.xent_loss(cfg, "sp", {"w": w}, h, labels, axes)
    f = shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                  out_specs=(P(), P()), check_vma=False)
    loss, grads = jax.value_and_grad(lambda h, w: f(h, w, labels)[0],
                                     argnums=(0, 1))(h, w)
    return float(loss), int(f(h, w, labels)[1]), [np.asarray(g)
                                                  for g in grads]


@pytest.mark.parametrize("loss_chunk", [16, 64])
def test_xent_loss_matches_reference(loss_chunk):
    """S = 64 in 4 chunks or 1, vocab 200 padded to 256 (56 masked
    columns), float32: loss rtol 1e-5, gradients rtol 1e-4 / atol
    1e-7."""
    rng = np.random.RandomState(5)
    h = rng.randn(2, 64, 32).astype(np.float32)
    w = (rng.randn(32, 256) * 0.3).astype(np.float32)
    labels = rng.randint(0, 200, (2, 64)).astype(np.int32)
    jcfg = jax_get_config("phi3-mini-3.8b", smoke=True).replace(
        vocab_size=200, loss_chunk=loss_chunk)
    cfg = get_config("phi3-mini-3.8b", smoke=True, vocab_size=200,
                     loss_chunk=loss_chunk)
    want_loss, want_n, want_grads = _jax_xent(jcfg, jnp.asarray(h),
                                              jnp.asarray(w),
                                              jnp.asarray(labels))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    loss, n = layers.xent_loss(cfg, "sp", {"w": tw}, th,
                               torch.from_numpy(labels), MeshAxes())
    loss.backward()
    loss = loss.detach()
    assert int(n) == want_n == 2 * 64
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for got, want in zip((th.grad, tw.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)
    assert not tw.grad[:, 200:].any()     # the masked columns


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_layernorm_matches_reference(dtype, tol):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, 64) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    jcfg = jax_get_config("stablelm-3b", smoke=True)
    cfg = get_config("stablelm-3b", smoke=True)
    assert set(layers.norm_decls(cfg, "sp", 64)) == {"scale", "bias"}
    want = jax_layers.norm_apply(
        jcfg, "sp", {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x).astype(getattr(jnp, dtype)), None)
    got = layers.norm_apply(
        cfg, "sp", {"scale": torch.from_numpy(scale),
                    "bias": torch.from_numpy(bias)},
        torch.from_numpy(x).to(getattr(torch, dtype)), MeshAxes())
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# optimizers: in place, the same bits as before
# ---------------------------------------------------------------------------

def _old_adamw(opt, grads, state, params, step):
    """The out-of-place AdamW update the in-place one replaced."""
    t, lr, b1, b2 = step + 1, opt.lr(step), opt.b1, opt.b2
    m = {k: b1 * state["m"][k] + (1 - b1) * g.float()
         for k, g in grads.items()}
    v = {k: b2 * state["v"][k] + (1 - b2) * g.float().square()
         for k, g in grads.items()}
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    out = {}
    for k, p in params.items():
        u = (m[k] / bc1) / ((v[k] / bc2).sqrt() + opt.eps)
        pf = p.float()
        out[k] = (pf - lr * (u + opt.weight_decay * pf)).to(p.dtype)
    return out, {"m": m, "v": v}


def _old_sgd(opt, grads, state, params, step):
    """The out-of-place SGD update the in-place one replaced."""
    lr = opt.lr(step)
    if opt.momentum:
        m = {k: opt.momentum * state["m"][k] + g.float()
             for k, g in grads.items()}
        upd, state = m, {"m": m}
    else:
        upd = {k: g.float() for k, g in grads.items()}
    return {k: (p.float() - lr * (upd[k] + opt.weight_decay * p.float())
                ).to(p.dtype) for k, p in params.items()}, state


def _tree(rng, scale=1.0):
    return {"a": torch.from_numpy((rng.randn(5, 7) * scale).astype(
                np.float32)),
            "b": torch.from_numpy((rng.randn(11) * scale).astype(
                np.float32)).to(torch.bfloat16),
            "c": torch.from_numpy(np.array(rng.randn() * scale,
                                           np.float32))}


@pytest.mark.parametrize("chunk", [optimizers.CHUNK, 4])
@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_inplace_update_equals_the_old_formula(monkeypatch, name, chunk):
    """Five steps, leaves of float32, bfloat16 and 0-d, whole and in
    chunks of 4 elements: the same bits as the out-of-place formula,
    into the same tensors, with the gradients untouched."""
    monkeypatch.setattr(optimizers, "CHUNK", chunk)
    opt, old = {"adamw": (AdamW(0.01, weight_decay=0.1), _old_adamw),
                "sgd": (SGD(0.05, weight_decay=0.01), _old_sgd),
                "sgd_momentum": (SGD(0.05, momentum=0.9,
                                     weight_decay=0.01), _old_sgd)}[name]
    rng = np.random.RandomState(4)
    params = _tree(rng)
    state = opt.init(params)
    ref_p = {k: t.clone() for k, t in params.items()}
    ref_s = {k: {j: t.clone() for j, t in s.items()}
             for k, s in state.items()}
    for step in range(5):
        grads = _tree(rng, 1e-3 if step % 2 else 1.0)
        before = {k: g.clone() for k, g in grads.items()}
        ref_p, ref_s = old(opt, grads, ref_s, ref_p, step)
        ids = {k: id(t) for k, t in params.items()}
        params, state = opt.update(grads, state, params, step)
        assert {k: id(t) for k, t in params.items()} == ids
        for k in params:
            assert torch.equal(params[k], ref_p[k]), (name, step, k)
            assert params[k].dtype == ref_p[k].dtype
            assert torch.equal(grads[k], before[k])
        for key in state:
            for k in state[key]:
                assert torch.equal(state[key][k], ref_s[key][k])


def test_make_optimizer_matches_reference_names():
    assert isinstance(make_optimizer("adamw", 1e-3, weight_decay=0.1),
                      AdamW)
    sgd = make_optimizer("sgd", 1e-3, momentum=0.9)
    assert isinstance(sgd, SGD) and sgd.momentum == 0.9
    ada = make_optimizer("adafactor", 1e-3, weight_decay=0.1)
    assert isinstance(ada, Adafactor) and ada.weight_decay == 0.1
    with pytest.raises(KeyError):
        make_optimizer("lion", 1e-3)


# ---------------------------------------------------------------------------
# data and launcher
# ---------------------------------------------------------------------------

def test_lm_dataset_construction():
    """The reference's construction: uniform tokens, and at every 17th
    position the uniform draw 17 positions back (cyclically, as
    ``jnp.roll``); labels the next tokens; the same batch for the same
    step and seed."""
    toks = lm_token_batch(100, 3, 60, seed=4)
    assert toks.shape == (3, 60) and toks.dtype == torch.int64
    gen = torch.Generator().manual_seed((29 << 32) + 4)
    base = torch.randint(0, 100, (3, 60), generator=gen)
    want = base.clone()
    for pos in (0, 17, 34, 51):
        want[:, pos] = base[:, (pos - 17) % 60]
    assert torch.equal(toks, want)
    assert int(toks.min()) >= 0 and int(toks.max()) < 100
    ds = LMDataset(100, 3, 61, seed=2)
    a, b, c = ds(0), ds(0), ds(1)
    assert a["tokens"].shape == a["labels"].shape == (3, 60)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])


def test_trainer_runs_logs_and_records(capsys):
    """``Trainer`` on the CPU: the log line every ``log_every`` steps, a
    metric of every step, and ``record_to`` a ledger entry of the metered
    steps that resets the meter for the next window."""
    from repro_torch.telemetry import Ledger
    from repro_torch.train.trainer import Trainer
    cfg = get_config("stablelm-3b", smoke=True)
    trainer = Trainer(cfg, MeshAxes(), AdamW(1e-3),
                      LMDataset(cfg.vocab_size, 2, 33), log_every=2,
                      device="cpu")
    state = trainer.run(trainer.init_state(1), 4)
    assert state.step == 4 and len(trainer.history) == 4
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[trainer]")]
    assert [l.split()[2] for l in lines] == ["2", "4"]
    ledger = Ledger(run="test")
    entry = trainer.record_to(ledger)
    assert (entry.kind, entry.impl, entry.arch) == ("train", "phantom",
                                                    cfg.name)
    assert entry.measured["calls"] == 4 and trainer.meter.calls == 0
    assert trainer.record_to(ledger).extra["window"] == 1


def test_launch_train_runs_on_the_cpu(capsys):
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--batch", "4", "--seq", "32"]) == 0
    out = capsys.readouterr().out
    assert "# phi3-smoke impl=phantom dp=1 on cpu" in out
    assert "[trainer] step 2 loss " in out and " ms/it" in out


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_launch_train_names_the_roadmap_item(flag, capfd):
    """``--tp`` over ring attention (qwen2.5-14b's) and ``--pp`` above 1
    (the full-model pipeline), which raised here and named item 6 until
    their slices were ported, now train: ``--pp 2 --tp 2`` on 4 gloo
    ranks, 1F1B over 2 microbatches, printing the reference's pipeline
    line."""
    if flag == "--tp":
        assert launch_train.main(["--arch", "qwen2.5-14b", "--device",
                                  "cpu", "--tp", "4", "--steps", "1",
                                  "--batch", "2", "--seq", "16"]) == 0
        assert "[trainer] step 1 loss " in capfd.readouterr().out
        return
    assert launch_train.main(["--smoke", "--device", "cpu", flag, "2",
                              "--tp", "2", "--microbatches", "2",
                              "--steps", "2", "--batch", "4",
                              "--seq", "32"]) == 0
    out = capfd.readouterr().out
    assert ("[train] 1F1B pipeline: pp=2 stages x dp=1 x tp=2, 2 "
            "microbatch(es)") in out
    assert "[trainer] step 2 loss " in out and " ms/it" in out
