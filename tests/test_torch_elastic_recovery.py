"""Recovery equivalence on the port (the reference's
``tests/test_elastic_hypothesis.py``), its cross-class conversion against
the reference's, and the elastic runs of two more fault scripts
(``tests/test_elastic.py``).

  * kill -> checkpoint -> restore on a DIFFERENT mesh -> finish equals
    the uninterrupted run (rtol 2e-4 / atol 1e-6, the reference's), for
    the reference's six same-class mesh pairs (dense on any mesh,
    phantom at fixed (k, tp)) and for hypothesis's draws; mixed
    per-stage strategies restore on the same mesh exactly (1e-6).  Each
    side of a pair is a world of gloo ranks of its own mesh's size, the
    conversion in between on the host, as ``run_elastic`` does it;
  * A -> B -> A layout conversion of a global host tree is bitwise,
    moments included; a class change flags ``distilled``, drops the
    moments and reproduces each layer's diagonal blocks;
  * ``convert_ffn_params`` against the reference's on the same numpy
    input: bit for bit where it reshapes, 1e-5 where it goes through
    the dense equivalent or the truncated SVD;
  * ``run_elastic``: two separate host losses, both survived; a loss
    detected while the step-10 save is still being written (every write
    slowed 0.25 s on the ranks): the flush commits it, and the run
    restores it.
"""
import numpy as np
import pytest
import torch

from repro.planner.space import PlanCandidate as JPlanCandidate
from repro.train.elastic import convert_ffn_params as jax_convert
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import materialize, tree_leaves, tree_map
from repro_torch.planner.space import PlanCandidate
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import (ElasticConfig, _nest,
                                       convert_ffn_params, run_elastic)
from repro_torch.train.fault import FaultScript

import torch_ranks

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

WIDTH, DEPTH, BATCH = 32, 2, 16
MESH_PAIRS = (
    ("tensor_col", (1, 8, 1), (2, 2, 2)),
    ("tensor_col", (2, 4, 1), (4, 2, 1)),
    ("tensor_col", (4, 2, 1), (1, 2, 1)),
    ("phantom", (1, 2, 1), (2, 2, 1)),
    ("phantom", (2, 2, 1), (4, 2, 1)),
    ("phantom", (4, 2, 1), (1, 2, 1)),
)
KS = (2, 4)
_SEEDED = [(s, a, b, (KS[i % len(KS)] if s == "phantom" else 0),
            2 + i % 3, 6 + i % 3, i)
           for i, (s, a, b) in enumerate(MESH_PAIRS)]
_IDS = [f"{s}-{'x'.join(map(str, a))}->{'x'.join(map(str, b))}-k{k}"
        for s, a, b, k, _, _, _ in _SEEDED]


def _plan(strategy, shape, k=0, cls=PlanCandidate):
    dp, tp, pp = shape
    return cls(dp=dp, tp=tp, strategy=strategy, width=WIDTH, depth=DEPTH,
               batch=BATCH, k=k, pp=pp)


def _case(side, strategy, shape, k, kill, total, seed, root):
    dp, tp, pp = shape
    return {"side": side, "dp": dp, "tp": tp, "pp": pp, "kill": kill,
            "total": total, "seed": seed, "width": WIDTH, "batch": BATCH,
            "dir": root, "plan": dict(dp=dp, tp=tp, pp=pp, k=k,
                                      strategy=strategy, width=WIDTH,
                                      depth=DEPTH, batch=BATCH)}


def _by_world(cases):
    """Run ``{name: case}`` in one world of gloo ranks per mesh size;
    rank 0's results."""
    out = {}
    for n in sorted({c["dp"] * c["tp"] * c["pp"] for c in cases.values()}):
        mine = {k: c for k, c in cases.items()
                if c["dp"] * c["tp"] * c["pp"] == n}
        out.update(spawn(torch_ranks.recovery_body, 1, n, "cpu",
                         timeout_s=300, args=(mine,))[0])
    return out


def _recover(draws, tmp_path_factory, extra=None):
    """The oracle over ``draws`` (strategy, A, B, k, kill, total, seed):
    side A on its mesh, the checkpoint converted on the host, side B on
    its mesh.  Returns {i: (ref, pre, post)} and the results of the
    ``extra`` cases, run with the A sides."""
    roots = {i: str(tmp_path_factory.mktemp(f"rec{i}"))
             for i in range(len(draws))}
    a_side = {i: _case("A", s, a, k, kill, total, seed, roots[i])
              for i, (s, a, b, k, kill, total, seed) in enumerate(draws)}
    first = _by_world(dict(a_side, **(extra or {})))
    b_side = {}
    for i, (s, a, b, k, kill, total, seed) in enumerate(draws):
        index, flat = CheckpointManager(roots[i]).load_host(kill)
        nested = _nest(flat)
        params, opt, distilled = convert_ffn_params(
            _plan(s, a, k), _plan(s, b, k), nested["params"], nested["opt"])
        assert not distilled and opt is not None
        b_side[i] = dict(_case("B", s, b, k, kill, total, seed, roots[i]),
                         params=params, opt=opt)
    second = _by_world(b_side)
    return dict({i: (first[i]["ref"], first[i]["pre"], second[i]["post"])
                 for i in range(len(draws))},
                **{k: first[k] for k in extra or {}})


def _hold(ref, pre, post, kill):
    np.testing.assert_allclose(pre, ref[:kill], rtol=1e-6)
    np.testing.assert_allclose(post, ref[kill:], rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The seeded draws, and the mixed per-stage case on pipe 2 x dp 2 x
    tp 2 in the A sides' world of 8."""
    mixed = {"side": "mixed", "dp": 2, "tp": 2, "pp": 2, "seed": 3,
             "width": WIDTH, "batch": BATCH,
             "dir": str(tmp_path_factory.mktemp("mixed"))}
    return _recover(_SEEDED, tmp_path_factory, extra={"mixed": mixed})


@pytest.mark.parametrize("i", range(len(_SEEDED)), ids=_IDS)
def test_recovery_equivalence_seeded(seeded, i):
    _hold(*seeded[i], kill=_SEEDED[i][4])


def _global_state(strategy, shape, k, seed):
    """Global host params and random moments of the plan's decls."""
    from repro_torch.core.ffn import ffn_decls
    dp, tp, pp = shape
    decls = ffn_decls(_plan(strategy, shape, k).model_config(),
                      MeshAxes(dp=dp, tp=tp, pp=pp))
    gen = torch.Generator().manual_seed(seed)
    host = tree_map(lambda t: t.numpy(), materialize(decls, gen))
    opt = {m: tree_map(lambda a: np.random.default_rng(seed).standard_normal(
        a.shape).astype(np.float32), host) for m in ("m", "v")}
    return host, opt


def assert_roundtrip_exact(strategy, shape_a, shape_b, k, seed):
    host_p, host_o = _global_state(strategy, shape_a, k, seed)
    pa, pb = _plan(strategy, shape_a, k), _plan(strategy, shape_b, k)
    ab_p, ab_o, d1 = convert_ffn_params(pa, pb, host_p, host_o)
    back_p, back_o, d2 = convert_ffn_params(pb, pa, ab_p, ab_o)
    assert not d1 and not d2
    for x, y in zip(tree_leaves({"p": host_p, "o": host_o}),
                    tree_leaves({"p": back_p, "o": back_o})):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])


@pytest.mark.parametrize("i", range(len(_SEEDED)), ids=_IDS)
def test_roundtrip_exact_seeded(i):
    strategy, shape_a, shape_b, k, _, _, seed = _SEEDED[i]
    assert_roundtrip_exact(strategy, shape_a, shape_b, k, seed)


def test_mixed_restores_same_mesh(seeded):
    """Mixed per-stage strategies on pipe 2 x dp 2 x tp 2: kill at 3,
    restore on the SAME mesh, finish: exact."""
    r = seeded["mixed"]
    np.testing.assert_allclose(r["post"], r["ref"][3:], rtol=1e-6)


def test_class_change_requires_distill():
    from repro_torch.core.phantom import phantom_dense_equivalent
    rng = np.random.default_rng(0)
    host = {"layers": {
        "w": rng.standard_normal((DEPTH, WIDTH, WIDTH)).astype(np.float32),
        "b": rng.standard_normal((DEPTH, WIDTH)).astype(np.float32)}}
    t_plan = _plan("tensor_col", (2, 4, 1))
    p_plan = _plan("phantom", (1, 2, 1), k=4)
    conv, opt_h, distilled = convert_ffn_params(t_plan, p_plan, host,
                                                {"m": host, "v": host})
    assert distilled and opt_h is None
    lyr = {k: torch.from_numpy(v[0]) for k, v in conv["layers"].items()
           if k in ("L", "C", "D")}
    W_hat = phantom_dense_equivalent(lyr).numpy()
    W = host["layers"]["w"][0]
    blk = WIDTH // p_plan.tp
    for i in range(p_plan.tp):
        sl = slice(i * blk, (i + 1) * blk)
        np.testing.assert_allclose(W_hat[sl, sl], W[sl, sl], rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="width"):
        convert_ffn_params(t_plan, t_plan.with_width(64), host)


@pytest.mark.parametrize("old,new,exact", [
    (("tensor_col", (1, 8, 1), 0), ("tensor_col", (2, 2, 2), 0), True),
    (("phantom", (2, 2, 1), 4), ("phantom", (4, 2, 1), 4), True),
    (("tensor_col", (2, 4, 1), 0), ("phantom", (1, 2, 1), 4), False),
    (("phantom", (1, 4, 1), 2), ("tensor_col", (1, 8, 1), 0), False),
    (("phantom", (1, 2, 1), 4), ("phantom", (1, 4, 1), 2), False)])
def test_convert_matches_the_reference(old, new, exact):
    """The same numpy input through both packages' conversion."""
    host_p, host_o = _global_state(old[0], old[1], old[2], 7)
    got = convert_ffn_params(_plan(*old), _plan(*new), host_p, host_o)
    want = jax_convert(_plan(*old, cls=JPlanCandidate),
                       _plan(*new, cls=JPlanCandidate), host_p, host_o)
    assert got[2] == want[2] == (not exact)
    assert (got[1] is None) == (want[1] is None)
    for (kg, g), (kw, w) in zip(
            tree_leaves({"p": got[0], "o": got[1] or {}}),
            tree_leaves({"p": want[0], "o": want[1] or {}})):
        assert kg == kw
        if exact:
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_double_fault(tmp_path):
    res = run_elastic(
        ElasticConfig(workdir=str(tmp_path), devices=8, hosts=4,
                      width=WIDTH, depth=DEPTH, batch=BATCH,
                      target_loss=1e-9, max_steps=30, checkpoint_every=5,
                      ks=(4,), initial_strategy="tensor_col",
                      straggler_threshold=1e6),
        fault_script=FaultScript(kills=((7, "host1"), (18, "host2"))),
        log_fn=lambda *a: None, device="cpu")
    assert not res.aborted
    assert res.final_step == 30
    assert len(res.recoveries) == 2
    assert res.recoveries[0]["dead_hosts"] == ["host1"]
    assert res.recoveries[1]["dead_hosts"] == ["host1", "host2"]
    assert len(res.phases) == 3
    assert res.account["restarts"] == 2


def test_kill_during_async_save(tmp_path):
    """The step-10 save is still being written when its phase ends at
    the detection: the ranks flush it before they return, it commits,
    and the recovery restores it."""
    res = run_elastic(
        ElasticConfig(workdir=str(tmp_path), devices=8, hosts=4,
                      width=WIDTH, depth=DEPTH, batch=BATCH,
                      target_loss=1e-9, max_steps=18, checkpoint_every=5,
                      ks=(4,), initial_strategy="tensor_col",
                      straggler_threshold=1e6),
        fault_script=FaultScript(kills=((10, "host0"),)),
        log_fn=lambda *a: None, device="cpu",
        rank_fn=torch_ranks.slow_write_elastic_rank)
    assert not res.aborted
    rec = res.recoveries[0]
    assert rec["restored_step"] == 10
    assert not rec["from_scratch"]


if HAVE_HYPOTHESIS:
    @given(pair=st.sampled_from(MESH_PAIRS), k=st.sampled_from(KS),
           kill=st.integers(2, 5), seed=st.integers(0, 1000))
    @settings(max_examples=2, deadline=None, derandomize=True)
    def test_recovery_equivalence_property(tmp_path_factory, pair, k, kill,
                                           seed):
        strategy, shape_a, shape_b = pair
        if strategy != "phantom":
            k = 0
        draws = [(strategy, shape_a, shape_b, k, kill, kill + 3, seed)]
        _hold(*_recover(draws, tmp_path_factory)[0], kill=kill)

    @given(pair=st.sampled_from(MESH_PAIRS), k=st.sampled_from(KS),
           seed=st.integers(0, 1000))
    @settings(max_examples=10, deadline=None)
    def test_roundtrip_exact_property(pair, k, seed):
        strategy, shape_a, shape_b = pair
        if strategy != "phantom":
            k = 0
        assert_roundtrip_exact(strategy, shape_a, shape_b, k, seed)
