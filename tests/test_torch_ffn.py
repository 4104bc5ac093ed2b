"""The port's paper-FFN training path against the JAX package.

* ``make_ffn_train_step``: three AdamW steps on gloo ranks (one spawn per
  mesh, ``(1, 8)`` and ``(2, 4)``) against the reference's ``shard_map``
  step on the 8 virtual CPU devices, from the same numpy parameters
  (``from_jax_params`` then ``shard_params``) and the same batches.
  Phantom runs through the kernel backend (the kernels' plain versions
  on the CPU) and through plain torch ops; ``tensor_col`` is the
  baseline.  The reference side runs its XLA path.  Losses are held to
  rtol 1e-5, final parameters to rtol 1e-4 / atol 1e-5.
* SGD and AdamW updates and the schedules, against the reference's.
* ``gaussian_teacher`` bit for bit; ``ffn_model_params`` exactly.
* ``init_ffn``: each rank's shard of one global draw on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import PhantomConfig as JPhantomConfig
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import phantom_projection_map as jax_phantom_map
from repro.core.ffn import ffn_model_params as jax_ffn_model_params
from repro.core.ffn import make_ffn_forward as jax_make_ffn_forward
from repro.core.ffn import make_ffn_train_step as jax_make_ffn_train_step
from repro.data.synthetic import gaussian_teacher as jax_gaussian_teacher
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.optim import schedules as jax_schedules
from repro.optim.optimizers import SGD as JSGD
from repro.optim.optimizers import AdamW as JAdamW
from repro.parallel.params import materialize as jax_materialize
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      PipelineConfig, dense_projection_map,
                                      get_config, phantom_projection_map)
from repro_torch.core.ffn import (ffn_decls, ffn_model_params, init_ffn,
                                  make_ffn_forward, make_ffn_train_step)
from repro_torch.data.synthetic import (TeacherDataset, gaussian_teacher,
                                        teacher_batch)
from repro_torch.launch.mesh import spawn
from repro_torch.optim import SGD, AdamW
from repro_torch.optim import schedules
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (from_jax_params, gather_params,
                                         materialize, shard_params,
                                         tree_leaves)

import torch_ranks

MESHES = {"1x8": (1, 8), "2x4": (2, 4)}
# name: (impl, the port's kernel_backend)
CASES = {"phantom_kernel": ("phantom", "pallas"),
         "phantom_plain": ("phantom", "xla"),
         "tensor_col": ("tensor", "xla")}
N, LAYERS, KG, BATCH, STEPS, LR, WD = 64, 2, 4, 16, 3, 3e-3, 0.1


def _configs(impl, backend, n=N, k=KG):
    kw = dict(name=f"ffn-{impl}", family="ffn", num_layers=LAYERS,
              d_model=n, ffn_width=n, ffn_depth=LAYERS, mlp="relu")
    if impl == "phantom":
        return (JModelConfig(phantom=JPhantomConfig(k=k),
                             projections=jax_phantom_map(k, ffn_layer=True),
                             **kw),
                ModelConfig(phantom=PhantomConfig(k=k),
                            projections=phantom_projection_map(
                                k, ffn_layer=True, kernel_backend=backend),
                            **kw))
    return (JModelConfig(phantom=JPhantomConfig(k=k),
                         projections=jax_dense_map(), **kw),
            ModelConfig(phantom=PhantomConfig(k=k),
                        projections=dense_projection_map(), **kw))


def _batches():
    W = np.asarray(jax_gaussian_teacher(N, seed=3))
    rng = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        x = rng.randn(BATCH, N).astype(np.float32)
        out.append((x, np.maximum(np.maximum(x, 0) @ W, 0)))
    return out


def _jax_run(cfg, mesh, batches):
    opt = JAdamW(LR, weight_decay=WD)
    step, decls, _ = jax_make_ffn_train_step(cfg, mesh, opt, BATCH)
    params = jax_materialize(decls, seed=5)
    start = jax.tree.map(np.array, params)
    state = opt.init(params)
    losses = []
    for s, (x, y) in enumerate(batches):
        params, state, loss = step(params, state, jnp.int32(s), x, y)
        losses.append(float(loss))
    return start, losses, jax.tree.map(np.array, params)


@pytest.fixture(scope="module", params=list(MESHES))
def run(request):
    dp, tp = MESHES[request.param]
    mesh = request.getfixturevalue("mesh18" if tp == 8 else "mesh24")
    batches = _batches()
    ref, inputs = {}, {}
    for impl in ("phantom", "tensor"):
        ref[impl] = _jax_run(_configs(impl, "xla")[0], mesh, batches)
    for name, (impl, backend) in CASES.items():
        inputs[name] = dict(cfg=_configs(impl, backend)[1],
                            params=ref[impl][0], batches=batches, lr=LR,
                            weight_decay=WD, batch=BATCH)
    ranks = spawn(torch_ranks.ffn_body, dp, tp, "cpu", args=(inputs,),
                  timeout_s=300)
    return {"dp": dp, "tp": tp, "ref": ref, "inputs": inputs,
            "ranks": ranks}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(run, case):
    dp, tp, ranks = run["dp"], run["tp"], run["ranks"]
    impl = CASES[case][0]
    _, want_losses, want_params = run["ref"][impl]
    for r in ranks:     # the loss is global: every rank holds the same
        np.testing.assert_allclose(r[case]["losses"], want_losses,
                                   rtol=1e-5)
    decls = ffn_decls(run["inputs"][case]["cfg"], MeshAxes(tp=tp, dp=dp))
    got = gather_params([r[case]["params"] for r in ranks], decls, dp, tp)
    for key, want in want_params["layers"].items():
        np.testing.assert_allclose(got["layers"][key], want, rtol=1e-4,
                                   atol=1e-5, err_msg=f"{case} {key}")


def test_losses_fall_over_the_three_steps(run):
    for case in CASES:
        losses = run["ranks"][0][case]["losses"]
        assert losses[-1] < losses[0], (case, losses)


def _opt_tree(rng):
    return {"a": rng.randn(4, 3).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adamw_schedule", "sgd",
                                  "sgd_momentum"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.RandomState(3)
    sched = (0.01, jax_schedules.warmup_cosine(0.01, 2, 6),
             schedules.warmup_cosine(0.01, 2, 6))
    make = {
        "adamw": (lambda: JAdamW(0.01), lambda: AdamW(0.01)),
        "adamw_schedule": (lambda: JAdamW(sched[1], weight_decay=0.0),
                           lambda: AdamW(sched[2], weight_decay=0.0)),
        "sgd": (lambda: JSGD(0.05, weight_decay=0.01),
                lambda: SGD(0.05, weight_decay=0.01)),
        "sgd_momentum": (lambda: JSGD(0.05, momentum=0.9),
                         lambda: SGD(0.05, momentum=0.9)),
    }[name]
    jopt, topt = make[0](), make[1]()
    p0 = _opt_tree(rng)
    jp, tp_ = jax.tree.map(jnp.asarray, p0), from_jax_params(p0)
    js, ts = jopt.init(jp), topt.init(tp_)
    for step in range(5):
        g = _opt_tree(rng)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.int32(step))
        tp_, ts = topt.update(from_jax_params(g), ts, tp_, step)
    for key, want in (("a", jp["a"]), ("c", jp["b"]["c"])):
        got = tp_["a"] if key == "a" else tp_["b"]["c"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("warmup_linear", (1e-2, 10, 100)),
    ("warmup_linear", (1e-2, 10, 100, 1e-3)),
    ("warmup_cosine", (1e-2, 10, 100)),
    ("warmup_cosine", (1e-2, 0, 50, 0.0)),
])
def test_schedules_match_jax(name, args):
    """The port computes in Python floats, the reference in float32: atol
    1e-9 is about one float32 rounding of a 1e-2 learning rate."""
    ours, theirs = getattr(schedules, name)(*args), \
        getattr(jax_schedules, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            ours(step), float(theirs(jnp.int32(step))), rtol=1e-6,
            atol=1e-9, err_msg=f"{name}{args} at step {step}")


@pytest.mark.parametrize("n,seed,scale", [(64, 0, None), (96, 3, None),
                                          (32, 1, 0.5)])
def test_gaussian_teacher_is_bit_identical(n, seed, scale):
    ours = gaussian_teacher(n, seed, scale)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_gaussian_teacher(n, seed, scale)))


def test_teacher_batches_are_deterministic_per_step():
    ds = TeacherDataset(32, 8, seed=2)
    (x0, y0), (x0b, _), (x1, _) = ds(0), ds(0), ds(1)
    assert torch.equal(x0, x0b) and not torch.equal(x0, x1)
    assert torch.equal(y0, torch.relu(torch.relu(x0) @ ds.W))
    x, y = teacher_batch(ds.W, 4, 0)
    assert torch.equal(x, x0[:4]) and x.dtype == y.dtype == torch.float32


@pytest.mark.parametrize("impl", ["phantom", "tensor"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_ffn_model_params_equal_reference(impl, tp):
    jcfg, tcfg = _configs(impl, "pallas", n=1024, k=8)
    assert ffn_model_params(tcfg, tp) == jax_ffn_model_params(jcfg, tp)


def test_paper_ffn_16k_model_size():
    from repro.configs.base import get_config as jax_get_config
    ours, theirs = get_config("paper-ffn-16k"), jax_get_config(
        "paper-ffn-16k")
    for tp in (1, 8):
        assert ffn_model_params(ours, tp) == jax_ffn_model_params(theirs,
                                                                  tp)


@pytest.mark.parametrize("impl", ["phantom", "tensor"])
def test_forward_on_one_rank_matches_jax(impl):
    """``make_ffn_forward`` at dp = tp = 1 (no collectives) against the
    reference on a one-device mesh."""
    jcfg, tcfg = _configs(impl, "pallas")
    mesh = jax_local_mesh(1, 1)
    jfwd, jdecls = jax_make_ffn_forward(jcfg, mesh)
    params = jax.tree.map(np.array, jax_materialize(jdecls, seed=9))
    x = np.random.RandomState(4).randn(BATCH, N).astype(np.float32)
    fwd, _ = make_ffn_forward(tcfg, MeshAxes())
    got = fwd(from_jax_params(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfwd(params, x)),
                               rtol=1e-5, atol=1e-6)


# (pp, dp, tp) meshes of the host-draw check: flat, and a pipeline whose
# stage stack is cut over the pipe axis
DRAW_MESHES = [(1, 2, 4), (2, 2, 2)]


@pytest.mark.parametrize("impl", ["phantom", "tensor"])
@pytest.mark.parametrize("pp,dp,tp", DRAW_MESHES)
def test_init_ffn_shards_one_host_draw(pp, dp, tp, impl):
    """On the CPU, every rank's ``init_ffn`` parameters are exactly its
    shard of ONE global draw from a CPU generator seeded ``seed``
    (``materialize`` in sorted path order), and the ranks' shards
    together give that draw back."""
    _, cfg = _configs(impl, "pallas")
    cfg = cfg.replace(pipeline=PipelineConfig(stages=pp), microbatches=2)
    decls = ffn_decls(cfg, MeshAxes(pp=pp, dp=dp, tp=tp))
    want = materialize(decls, torch.Generator().manual_seed(7), "cpu")
    ranks = []
    for r in range(pp * dp * tp):
        s, rest = divmod(r, dp * tp)
        axes = MeshAxes(pp=pp, dp=dp, tp=tp, pp_rank=s, dp_rank=rest // tp,
                        tp_rank=rest % tp)
        params, _ = init_ffn(cfg, axes, AdamW(LR), seed=7, device="cpu")
        local = shard_params(want, decls, axes)
        for (path, got), (_, w) in zip(tree_leaves(params),
                                       tree_leaves(local)):
            assert got.device.type == "cpu"
            assert torch.equal(got, w), path
        ranks.append(params)
    back = gather_params(ranks, decls, dp, tp, pp)
    for (path, got), (_, w) in zip(tree_leaves(back), tree_leaves(want)):
        assert np.array_equal(got, w.numpy()), path
