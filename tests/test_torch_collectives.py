"""The port's collectives and phantom layer on gloo ranks against the JAX
package inside ``shard_map``.

One spawn per mesh (``(1, 8)`` and ``(2, 4)``): eight CPU ranks run every
case of this module (``torch_ranks.collectives_body``) on the same numpy
inputs the reference gets, and return their local outputs and gradients.
The JAX side runs as the reference's own tests run it (``tests/
test_phantom.py``): ``shard_map`` over the 8 virtual CPU devices, XLA
backend.  The port's ``fused`` variant runs both ways: through
``phantom_fused_linear`` (the kernel backend, whose CPU path is the
kernels' plain versions) and through plain torch ops; the ``ring``
variant (ppermute hops) through plain torch ops, as the reference runs
it.

Tolerances: outputs rtol 1e-5 / atol 1e-6 (float32, sums in another
order), parameter gradients rtol 1e-4 / atol 1e-5 (the reference's pin
for kernel against XLA, ``tests/test_kernels.py:268-275``).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from helpers import resolved_param_specs, smap
from repro.configs.base import PhantomConfig as JPhantomConfig
from repro.core.autograd import all_gather_ghosts as jax_all_gather_ghosts
from repro.core.phantom import phantom_apply as jax_phantom_apply
from repro.core.phantom import phantom_decls as jax_phantom_decls
from repro.core.tp import gather_features as jax_gather_features
from repro.core.tp import scatter_features as jax_scatter_features
from repro.parallel.axes import MeshAxes as JMeshAxes
from repro.parallel.params import materialize as jax_materialize
from repro_torch.core.phantom import phantom_decls
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.params import gather_params

import torch_ranks

MESHES = {"1x8": (1, 8), "2x4": (2, 4)}
# name: (variant, include_self_term, the port's kernel_backend)
VARIANTS = {
    "fused_kernel": ("fused", False, "pallas"),
    "fused_kernel_self": ("fused", True, "pallas"),
    "fused_plain": ("fused", False, "xla"),
    "faithful": ("faithful", False, "xla"),
    "faithful_self": ("faithful", True, "xla"),
    "ring": ("ring", False, "xla"),
    "ring_self": ("ring", True, "xla"),
}
N_IN, N_OUT, K, B = 32, 48, 3, 8
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(dp, tp):
    rng = np.random.RandomState(dp * 10 + tp)
    params = jax_materialize(jax_phantom_decls(N_IN, N_OUT, K, tp), seed=1)
    return {
        "ghosts": rng.randn(32, 8).astype(np.float32),
        "features": rng.randn(B, 32).astype(np.float32),
        "partials": rng.randn(B, 2 * tp * tp).astype(np.float32),
        "phantom_x": rng.randn(B, N_IN).astype(np.float32),
        "phantom_y": rng.randn(B, N_OUT).astype(np.float32),
        "phantom_params": {k: np.asarray(v) for k, v in params.items()},
        "variants": VARIANTS,
    }


def _blocks(ranks, key, dp, tp, row_axis=0):
    """Assemble rank-local [rows, cols] blocks (rank r = d*tp + t) into
    the global array, rows split over dp, columns over tp."""
    rows = [np.concatenate([ranks[d * tp + t][key] for t in range(tp)],
                           axis=-1) for d in range(dp)]
    return np.concatenate(rows, axis=row_axis)


@pytest.fixture(scope="module", params=list(MESHES))
def run(request):
    dp, tp = MESHES[request.param]
    mesh = request.getfixturevalue("mesh18" if tp == 8 else "mesh24")
    inputs = _inputs(dp, tp)
    ranks = spawn(torch_ranks.collectives_body, dp, tp, "cpu",
                  args=(inputs,), timeout_s=240)
    return {"dp": dp, "tp": tp, "mesh": mesh, "inputs": inputs,
            "ranks": ranks}


def test_all_gather_ghosts_matches_jax(run):
    """Paper Algorithm 1: the forward stacks every rank's ghosts, the
    gradient equals the reference's custom_vjp (and so its native
    all-gather, tests/test_phantom.py:97-112)."""
    dp, tp, ranks = run["dp"], run["tp"], run["ranks"]
    ghosts = run["inputs"]["ghosts"]

    def f(xx):
        g = jax_all_gather_ghosts(xx, "model")
        return jnp.sum(g * g * jnp.arange(tp).reshape(tp, 1, 1))

    want = smap(jax.grad(f), run["mesh"], P(None, "model"),
                P(None, "model"))(ghosts)
    stacked = np.stack(np.split(ghosts, tp, axis=1))
    for r in ranks:
        np.testing.assert_array_equal(r["ghosts_fwd"], stacked)
    for d in range(dp):
        got = np.concatenate([ranks[d * tp + t]["ghosts_grad"]
                              for t in range(tp)], axis=1)
        np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)


def test_gather_features_matches_jax(run):
    dp, tp, ranks = run["dp"], run["tp"], run["ranks"]
    axes = JMeshAxes.from_mesh(run["mesh"])
    x = run["inputs"]["features"]

    def loss(xx):
        full = jax_gather_features(xx, axes)
        return jnp.sum(full * full * (1.0 + lax.axis_index("model")))

    spec = P("data", "model")
    fwd = smap(lambda xx: jax_gather_features(xx, axes), run["mesh"], spec,
               P("data", None))(x)
    grad = smap(jax.grad(loss), run["mesh"], spec, spec)(x)
    for d in range(dp):
        for t in range(tp):
            np.testing.assert_array_equal(
                ranks[d * tp + t]["gather_fwd"],
                np.asarray(fwd)[d * B // dp:(d + 1) * B // dp])
    np.testing.assert_allclose(_blocks(ranks, "gather_grad", dp, tp),
                               np.asarray(grad), **OUT_TOL)


def test_scatter_features_matches_jax(run):
    dp, tp, ranks = run["dp"], run["tp"], run["ranks"]
    axes = JMeshAxes.from_mesh(run["mesh"])
    z = run["inputs"]["partials"]

    def loss(zz):
        red = jax_scatter_features(zz, axes)
        return jnp.sum(red * red * (1.0 + lax.axis_index("model")))

    spec = P("data", "model")
    fwd = smap(lambda zz: jax_scatter_features(zz, axes), run["mesh"], spec,
               spec)(z)
    grad = smap(jax.grad(loss), run["mesh"], spec, spec)(z)
    np.testing.assert_allclose(_blocks(ranks, "scatter_fwd", dp, tp),
                               np.asarray(fwd), **OUT_TOL)
    np.testing.assert_allclose(_blocks(ranks, "scatter_grad", dp, tp),
                               np.asarray(grad), **OUT_TOL)


def test_timed_record_times_every_collective(run):
    """``record_collectives(timed=True)`` counts and times each
    collective the feature gather and scatter run, forward and backward,
    and logs the same ones as an untimed log open beside it, which times
    none."""
    want = ["all_gather", "reduce_scatter", "reduce_scatter", "all_gather"]
    for r in run["ranks"]:
        untimed, timed = r["timed"]["untimed"], r["timed"]["timed"]
        assert untimed["collectives"] == timed["collectives"] == want
        assert timed["calls"] == len(want)
        assert timed["collective_ms"] > 0.0
        assert untimed["calls"] == 0
        assert untimed["collective_ms"] == untimed["device_wait_ms"] == 0.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_phantom_apply_matches_jax(run, variant):
    """Each variant's per-rank output and dp-summed parameter gradients
    against the reference's ``phantom_apply`` on the same global
    parameters (the reference side runs its XLA path, which its own
    suite pins to its Pallas kernels)."""
    dp, tp, ranks, mesh = run["dp"], run["tp"], run["ranks"], run["mesh"]
    inputs = run["inputs"]
    kind, self_term, _ = VARIANTS[variant]
    pp = JPhantomConfig(k=K, variant=kind, include_self_term=self_term)
    axes = JMeshAxes.from_mesh(mesh)
    pspecs = resolved_param_specs(jax_phantom_decls(N_IN, N_OUT, K, tp),
                                  mesh)
    params = {k: jnp.asarray(v) for k, v in inputs["phantom_params"].items()}
    x, y = inputs["phantom_x"], inputs["phantom_y"]
    spec = P("data", "model")
    out = smap(lambda p, xx: jax_phantom_apply(pp, p, xx, axes), mesh,
               (pspecs, spec), spec)(params, x)

    def local_loss(p, xx, yy):
        return jnp.sum((jax_phantom_apply(pp, p, xx, axes) - yy) ** 2)

    grads = smap(lambda p, xx, yy: jax.tree.map(
        lambda g: lax.psum(g, ("data",)), jax.grad(local_loss)(p, xx, yy)),
        mesh, (pspecs, spec, spec), pspecs)(params, x, y)

    np.testing.assert_allclose(_blocks(ranks, f"{variant}_out", dp, tp),
                               np.asarray(out), **OUT_TOL)
    got = gather_params([r[f"{variant}_grads"] for r in ranks],
                        phantom_decls(N_IN, N_OUT, K, tp), dp, tp)
    for key in ("L", "C", "D", "b"):
        np.testing.assert_allclose(got[key], np.asarray(grads[key]),
                                   err_msg=f"grad {key}", **GRAD_TOL)


def test_mismatched_collective_fails_within_the_timeout():
    """One rank enters a collective the other never joins: the spawn
    raises within its timeout instead of hanging the suite."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(torch_ranks.mismatch_body, 1, 2, "cpu", timeout_s=10)
    assert time.monotonic() - t0 < 60


def test_failing_rank_is_reported():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(torch_ranks.failing_body, 1, 2, "cpu", timeout_s=60)


# ---------------------------------------------------------------------------
# one-process checks of the phantom layer: accounting, the dense matrix it
# computes, and the ring variant at tp = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["phantom", "phantom_self", "tensor_col",
                                  "tensor_row"])
@pytest.mark.parametrize("tp", [2, 4])
def test_strategy_accounting_matches_jax(kind, tp):
    """``param_count`` and ``dense_equivalent`` of each ported strategy
    against the reference's, from the same global parameters."""
    import torch
    from repro.configs.base import ProjectionSpec as JSpec
    from repro.parallel.strategies import make_strategy as jax_make
    from repro_torch.configs.base import ProjectionSpec
    from repro_torch.parallel.params import from_jax_params
    from repro_torch.parallel.strategies import make_strategy
    name = kind.replace("_self", "")
    kw = dict(kind=name, k=K, include_self_term=kind.endswith("_self")) \
        if name == "phantom" else dict(kind=name)
    theirs = jax_make(JSpec(**kw), N_IN, N_OUT, tp)
    ours = make_strategy(ProjectionSpec(**kw), N_IN, N_OUT, tp)
    assert ours.param_count() == theirs.param_count()
    params = jax.tree.map(np.asarray, jax_materialize(theirs.decls(), seed=4))
    W_want, b_want = theirs.dense_equivalent(params)
    W_got, b_got = ours.dense_equivalent(from_jax_params(params))
    assert isinstance(W_got, torch.Tensor)
    np.testing.assert_allclose(W_got.numpy(), np.asarray(W_want), **OUT_TOL)
    np.testing.assert_array_equal(b_got.numpy(), np.asarray(b_want))


def test_phantom_param_count_matches_jax():
    from repro.core.phantom import phantom_param_count as jax_count
    from repro_torch.core.phantom import phantom_param_count
    for args in ((16384, 16384, 16, 8), (1024, 1024, 4, 8), (96, 64, 3, 2)):
        for bias in (True, False):
            assert phantom_param_count(*args, bias=bias) == \
                jax_count(*args, bias=bias)


def test_ring_variant_names_the_roadmap_item():
    """The ring variant, which raised and named its ROADMAP item until it
    was ported, runs; at tp = 1 it makes no hop and equals the fused
    variant, with and without the self term."""
    import torch
    from repro_torch.configs.base import PhantomConfig
    from repro_torch.core.phantom import phantom_apply
    from repro_torch.parallel.axes import MeshAxes
    gen = torch.Generator().manual_seed(0)
    params = {"L": torch.randn(1, 4, 6, generator=gen),
              "C": torch.randn(4, 2, generator=gen),
              "D": torch.randn(1, 2, 6, generator=gen)}
    x = torch.randn(3, 4, generator=gen)
    for self_term in (False, True):
        ring, fused = (phantom_apply(PhantomConfig(
            k=2, variant=v, include_self_term=self_term), params, x,
            MeshAxes()) for v in ("ring", "fused"))
        torch.testing.assert_close(ring, fused, rtol=0, atol=0)
