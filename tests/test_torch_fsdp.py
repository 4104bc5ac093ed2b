"""FSDP in the port against the JAX package, on the CPU.

* ``gather_fsdp`` on a dp 2 x tp 2 mesh of gloo CPU ranks against the
  reference's inside ``shard_map`` on the same mesh: plain and int8,
  along a weight's rows, its columns and a phantom L's local rows.  The
  forward bit for bit (the int8 path's bf16 product too), and the
  gradient of sum(gathered * r) at each rank's shard (rtol 1e-4 / atol
  1e-5 of the largest): plain, the dp-sum of every rank's gradient; int8,
  nonzero only at each column's largest-magnitude element (the scale's
  ``max|w|`` is the one path that carries a gradient), as the
  reference's.  The int8 cases take r in {-1, 0, 1} and two elements a
  column of a shard, so the bf16 products and their sums are exact on
  both sides.  At dp = 1 the int8 path still quantises, as the
  reference's does.
* ``reduce_grads`` issues no collective for a leaf sharded over both
  dp and tp (FSDP's leaves receive their dp sum from the gather's
  reduce-scatter alone).
* Every leaf's shape and spec with ``fsdp=True`` at dp 2 x tp 2 against
  the reference's ``PartitionSpec``s: phi3-mini, olmoe-1b-7b,
  granite-moe-3b-a800m (the tensor partition; FSDP turns its phantom
  experts off), qwen2.5-14b (ring attention, whose weights FSDP leaves
  alone) and mamba2-370m, full and smoke.
* One Adafactor step each of chatglm3-smoke, mamba2-smoke and
  olmoe-smoke with ``fsdp=True`` at dp 2 x tp 2 against the reference's
  trainer on the same mesh (its ``tests/test_models_smoke.py:
  test_arch_fsdp_variant``), float32: losses and gradient norms rtol
  1e-5, the gathered gradients within 1e-4 of their leaf's largest, and
  each rank's updated shards rtol 1e-4 / atol 1e-5 plus what the two
  sides' gradients imply through the port's Adafactor on that shard
  (``_adafactor_implied``).  Adafactor scales a leaf's update to unit
  RMS whatever its gradient's size: the gradient of chatglm3's key bias
  is zero but for rounding (a bias on every key of a query leaves its
  softmax unchanged), and the two sides' roundings give it different
  O(lr) steps.  Such elements must stay under 1% of the parameters.
* Three AdamW steps of phi3-smoke with ``fsdp=True`` at dp 2 x tp 2
  against the reference's trainer with ``fsdp=True``
  (``tests/test_torch_trainer_tp.py: hold_train_steps``), and against
  the port's own run with ``fsdp=False`` on the same mesh, held the same
  way.
* The wire bytes of one bf16 step of phi3-smoke at dp 2 x tp 2, with and
  without FSDP, equal ``chip_smoke.py: fsdp_wire_bytes`` to the byte.

One spawn (dp 2 x tp 2) in a thread of its own while the reference
compiles and runs here.
"""
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
from repro.models import layers as jax_layers
from repro.models.model import model_decls as jax_model_decls
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.axes import resolve_spec
from repro.parallel.compat import shard_map
from repro.parallel.params import is_decl
from repro_torch.configs.base import get_config, with_kernel_backend
from repro_torch.launch.mesh import spawn
from repro_torch.models.layers import gather_fsdp
from repro_torch.models.model import model_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.grads import reduce_grads
from repro_torch.parallel.params import (ParamDecl, gather_params,
                                         tree_leaves)

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_trainer import LR, WD
from test_torch_trainer_tp import (_grads_close, _jax_run, _norm_spec,
                                   hold_train_steps)

# the script's wire-byte counts, which its phase 13 holds on the card
chip_smoke = torch_ranks.load_chip_smoke()

DP, TP = 2, 2
ARCHS = {"chatglm3": "chatglm3-6b", "mamba2": "mamba2-370m",
         "olmoe": "olmoe-1b-7b", "phi3": "phi3-mini-3.8b",
         "granite": "granite-moe-3b-a800m", "qwen": "qwen2.5-14b"}
ADAFACTOR = ("chatglm3", "mamba2", "olmoe")
# name: (global shape, spec, int8, the gathered weight's tp-sharded dim)
GATHER = {
    "plain_rows": ((8, 6), ("dp", None), False, None),
    "plain_phantom_L": ((2, 8, 6), ("tp", "dp", None), False, 0),
    "int8_rows": ((4, 6), ("dp", None), True, None),
    "int8_cols_tp_rows": ((8, 4), ("tp", "dp"), True, 0),
    "int8_phantom_L": ((2, 4, 6), ("tp", "dp", None), True, 0),
}
WIRE = {"B": 4, "S": 64}


def _cfgs(arch, fsdp=True, dtype="float32"):
    jcfg = jax_get_config(ARCHS[arch], smoke=True).replace(
        dtype=dtype, fsdp=fsdp)
    cfg = get_config(ARCHS[arch], smoke=True, dtype=dtype, fsdp=fsdp)
    return jcfg, with_kernel_backend(cfg, "auto")


# ---------------------------------------------------------------------------
# gather_fsdp
# ---------------------------------------------------------------------------

def _gather_cases(rng):
    """{name: (port case, a call that gives the reference's gathered
    weight per rank and gradient at each rank's shard)}."""
    mesh = jax_local_mesh(DP, TP)
    axes = JMeshAxes.from_mesh(mesh)
    cases = {}
    for name, (shape, spec, quant, tp_dim) in GATHER.items():
        w = rng.randn(*shape).astype(np.float32)
        out_spec = tuple(None if e == "dp" else e for e in spec)
        rshape = [n // TP if e == "tp" else n for n, e in
                  zip(shape, out_spec)]
        r = (rng.randint(-1, 2, rshape) if quant
             else rng.randn(*rshape)).astype(np.float32)
        r_global = (np.concatenate([r] * TP, axis=tp_dim)
                    if tp_dim is not None else r)
        wspec = resolve_spec(P(*spec), axes)
        ospec = resolve_spec(P(*out_spec), axes)

        def body(w, r, spec=spec, quant=quant):
            full, vjp = jax.vjp(lambda w: jax_layers.gather_fsdp(
                w, P(*spec), axes, quant=quant), w)
            return full, vjp(r.astype(full.dtype))[0]
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(wspec, ospec),
                               out_specs=(ospec, wspec), check_vma=False))
        cases[name] = (
            {"w": w, "spec": spec, "quant": quant, "r": r_global,
             "tp_dim": tp_dim},
            lambda fn=fn, a=(w, r_global): [np.asarray(v, np.float32)
                                            for v in fn(*a)])
    return cases


def _local(a, spec, rank):
    """Rank ``rank``'s block of global ``a`` (rank = d * TP + t)."""
    d, t = divmod(rank, TP)
    idx = []
    for n, e in zip(a.shape, tuple(spec) + (None,) * a.ndim):
        ways, at = {"dp": (DP, d), "tp": (TP, t)}.get(e, (1, 0))
        idx.append(slice(at * n // ways, (at + 1) * n // ways))
    return a[tuple(idx)]


@pytest.fixture(scope="module")
def runs():
    """The reference's trainer runs first (the Adafactor steps start from
    its states), then one dp 2 x tp 2 spawn in a thread of its own while
    the reference's gathers and AdamW runs compile and run here."""
    rng = np.random.RandomState(11)
    with ThreadPoolExecutor(8) as pool:
        made = {a: pool.submit(lm_pipeline._jax_run, _cfgs(a)[0], 1, DP,
                               TP, 1, "adafactor", steps=1)
                for a in ADAFACTOR}
        made["phi3_adamw"] = pool.submit(_jax_run, _cfgs("phi3")[0], DP, TP)
        ref, todo = {}, []
        for name, f in made.items():
            ref[name], run = f.result()
            if name in ADAFACTOR:
                made[name] = pool.submit(run)
            else:
                todo.append(run)
        for name in ADAFACTOR:
            made[name].result()
    gathers = _gather_cases(rng)
    adafactor = {a: dict(cfg=_cfgs(a)[1], starts=ref[a]["starts"],
                         batches=ref[a]["batches"], lr=lm_pipeline.LR,
                         weight_decay=lm_pipeline.WD, microbatches=1,
                         optimizer="adafactor") for a in ADAFACTOR}
    train = {f"phi3_fsdp_{on}": dict(
        cfg=_cfgs("phi3", fsdp=on)[1], params=ref["phi3_adamw"]["start"],
        batches=ref["phi3_adamw"]["batches"], lr=LR, weight_decay=WD,
        microbatches=1) for on in (True, False)}
    wire = {f"phi3_bf16_fsdp_{on}": dict(
        cfg=_cfgs("phi3", fsdp=on, dtype="bfloat16")[1], batch=WIRE["B"],
        seq=WIRE["S"]) for on in (True, False)}
    out = {"ref": ref}
    errors = []

    def ranks():
        try:
            out["ranks"] = spawn(torch_ranks.fsdp_body, DP, TP, "cpu",
                                 timeout_s=300, args=({
                                     "gather": {k: c for k, (c, _) in
                                                gathers.items()},
                                     "train": train, "adafactor": adafactor,
                                     "wire": wire},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()
    with ThreadPoolExecutor(len(todo) + len(gathers)) as pool:
        futures = [pool.submit(run) for run in todo]
        wants = {k: pool.submit(want) for k, (_, want) in gathers.items()}
        for f in futures:
            f.result()
        out["gather_ref"] = {k: (gathers[k][0], f.result())
                             for k, f in wants.items()}
    thread.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", list(GATHER))
def test_gather_fsdp_matches_reference(runs, name):
    case, (full, grad) = runs["gather_ref"][name]
    spec, quant = case["spec"], case["quant"]
    out_spec = tuple(None if e == "dp" else e for e in spec)
    for rank, r in enumerate(runs["ranks"]):
        got = r["gather"][name]
        assert got["dtype"] == ("torch.bfloat16" if quant
                                else "torch.float32")
        np.testing.assert_array_equal(got["w"], _local(full, out_spec, rank),
                                      err_msg=f"{name} rank {rank}")
        want = _local(grad, spec, rank)
        _grads_close(got["grad"], want, f"{name} grad rank {rank}")
        if quant:
            # only each column's largest |w| (along the gathered dim)
            # receives a gradient
            w = _local(case["w"], spec, rank)
            dim = spec.index("dp")
            top = np.abs(w) == np.abs(w).max(axis=dim, keepdims=True)
            for g in (got["grad"], want):
                assert not (g != 0)[~top].any(), (name, rank)
            assert (got["grad"] != 0).sum() > top.sum() // 2, (name, rank)
        else:
            # the dp sum of every rank's equal share
            np.testing.assert_allclose(
                got["grad"], DP * _local(case["r"], spec, rank), rtol=1e-6)


def test_int8_gather_quantises_at_dp1():
    """With one data rank the gather is the identity, but the int8 path
    still quantises, as the reference's (spec-driven) does: the same bf16
    weight and the same column-max gradient."""
    rng = np.random.RandomState(3)
    w = rng.randn(2, 6).astype(np.float32)
    r = rng.randint(-1, 2, (2, 6)).astype(np.float32)
    mesh = jax_local_mesh(1, 1)
    axes = JMeshAxes.from_mesh(mesh)

    def body(w, r):
        full, vjp = jax.vjp(lambda w: jax_layers.gather_fsdp(
            w, P("dp", None), axes, quant=True), w)
        return full, vjp(r.astype(full.dtype))[0]
    full, want_grad = (np.asarray(v, np.float32) for v in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False))(w, r))
    t = torch.from_numpy(w).requires_grad_(True)
    got = gather_fsdp(t, ("dp", None), MeshAxes(), quant=True)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(r)).sum().backward()
    got = got.detach().float().numpy()
    np.testing.assert_array_equal(got, full)
    assert not np.array_equal(got, w)                         # quantised
    _grads_close(t.grad.numpy(), want_grad)
    assert int((t.grad != 0).sum()) <= 6                      # one a column


def test_reduce_grads_leaves_fsdp_leaves_to_the_reduce_scatter():
    """A leaf sharded over dp and tp (FSDP's phantom L) needs no sum:
    ``reduce_grads`` returns it as it is and issues no collective (a
    collective on these group-less axes would raise); a leaf replicated
    over dp would be all-reduced."""
    axes = MeshAxes(tp=2, dp=2)
    g = torch.ones(1, 4, 3)
    decls = {"L": ParamDecl((2, 8, 3), ("tp", "dp", None)),
             "w": ParamDecl((8, 6), ("dp", "tp"))}
    out = reduce_grads({"L": g, "w": torch.ones(4, 3)}, decls, axes)
    assert out["L"] is g
    with pytest.raises(RuntimeError, match="make_local_mesh"):
        reduce_grads({"C": g}, {"C": ParamDecl((4, 3), ("tp", None))},
                     axes)


# ---------------------------------------------------------------------------
# decls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ["phi3", "olmoe", "granite", "qwen",
                                  "mamba2", "chatglm3"])
def test_fsdp_decl_specs_match_reference(arch, smoke):
    jcfg = jax_get_config(ARCHS[arch], smoke=smoke).replace(fsdp=True)
    cfg = get_config(ARCHS[arch], smoke=smoke, fsdp=True)
    theirs = jax_model_decls(jcfg, JMeshAxes(tp=TP, dp=DP,
                                             dp_names=("data",)))
    theirs = dict(tree_leaves(jax.tree.map(
        lambda d: (tuple(d.shape), _norm_spec(d.spec, len(d.shape))),
        theirs, is_leaf=is_decl)))
    ours = {path: (tuple(d.shape), _norm_spec(d.spec, len(d.shape)))
            for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=TP,
                                                                 dp=DP)))}
    assert ours == theirs
    assert any("dp" in spec for _, spec in ours.values())


# ---------------------------------------------------------------------------
# the trainer, the wire bytes
# ---------------------------------------------------------------------------

def _adafactor_implied(start, g_port, g_ref, axes):
    """This rank's shard after one step of the port's Adafactor from
    ``start`` with each side's gradient: |difference|, what the two
    gradients imply for the parameters."""
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.params import tree_map
    out = []
    for g in (g_port, g_ref):
        opt = make_optimizer("adafactor", lm_pipeline.LR,
                             weight_decay=lm_pipeline.WD)
        p = tree_map(torch.clone, start)
        p, _ = opt.update(g, opt.init(p), p, 0)
        out.append(dict(tree_leaves(p)))
    return {k: (out[0][k] - out[1][k]).abs().numpy() for k in out[0]}


@pytest.mark.parametrize("arch", ADAFACTOR)
def test_fsdp_adafactor_step_matches_jax(runs, arch):
    from repro_torch.parallel.params import from_jax_params, shard_params
    name, cfg, want = f"{arch}_fsdp_adafactor", _cfgs(arch)[1], \
        runs["ref"][arch]
    ranks = [r["adafactor"][arch] for r in runs["ranks"]]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=1e-5, err_msg=name)
    decls = model_decls(cfg, MeshAxes(tp=TP, dp=DP))
    grads = dict(tree_leaves(gather_params(
        [r["grads"][0] for r in ranks], decls, DP, TP)))
    for path, w in tree_leaves(want["grads"][0]):
        np.testing.assert_allclose(grads[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{name} gradient {path}")
    start = from_jax_params(want["starts"][0]["params"])
    g_ref, p_ref = (from_jax_params(want[k][0]) for k in ("grads",
                                                           "params"))
    n_near = n_all = 0
    for r, rank in enumerate(ranks):
        axes = MeshAxes(tp=TP, dp=DP, tp_rank=r % TP, dp_rank=r // TP)
        implied = _adafactor_implied(
            shard_params(start, decls, axes),
            from_jax_params(rank["grads"][0]),
            shard_params(g_ref, decls, axes), axes)
        wants = dict(tree_leaves(shard_params(p_ref, decls, axes)))
        for path, got in tree_leaves(rank["params"][0]):
            w = wants[path].numpy()
            tol = 1e-5 + 1e-4 * np.abs(w)
            diff = np.abs(np.float64(got) - w)
            assert (diff <= tol + implied[path]).all(), (
                f"{name} rank {r} {path}: "
                f"{int((diff > tol + implied[path]).sum())} elements "
                f"outside, worst {diff.max():.3e}")
            n_near += int((implied[path] > tol).sum())
            n_all += w.size
    assert n_near <= 1e-2 * n_all, (name, n_near, n_all)


def test_fsdp_adamw_steps_match_jax(runs):
    hold_train_steps("phi3_fsdp", _cfgs("phi3")[1],
                     runs["ref"]["phi3_adamw"],
                     [r["train"]["phi3_fsdp_True"] for r in runs["ranks"]],
                     DP, TP)


def test_fsdp_adamw_steps_match_the_unsharded_run(runs):
    """The same three steps with ``fsdp=False`` on the same mesh: the
    same function, held as the reference's run is."""
    ranks = [r["train"]["phi3_fsdp_False"] for r in runs["ranks"]]
    decls = model_decls(_cfgs("phi3", fsdp=False)[1],
                        MeshAxes(tp=TP, dp=DP))
    want = {"losses": ranks[0]["losses"],
            "grad_norms": ranks[0]["grad_norms"],
            "grads": [gather_params([r["grads"][s] for r in ranks], decls,
                                    DP, TP) for s in range(3)],
            "params": gather_params([r["params"] for r in ranks], decls,
                                    DP, TP)}
    hold_train_steps("phi3_fsdp_vs_unsharded", _cfgs("phi3")[1], want,
                     [r["train"]["phi3_fsdp_True"] for r in runs["ranks"]],
                     DP, TP)


@pytest.mark.parametrize("fsdp", [True, False])
def test_fsdp_wire_bytes_equal_the_count(runs, fsdp):
    """Every rank's logged wire bytes of one bf16 step equal
    ``fsdp_wire_bytes`` to the byte (the count phase 13 of
    ``chip_smoke.py`` holds on the card)."""
    cfg = _cfgs("phi3", fsdp=fsdp, dtype="bfloat16")[1]
    want = chip_smoke.fsdp_wire_bytes(cfg, WIRE["B"], WIRE["S"], TP, DP)
    for r in runs["ranks"]:
        got = r["wire"][f"phi3_bf16_fsdp_{fsdp}"]
        assert got["wire_bytes"] == want, got
