"""The port's ``train/checkpoint.py: CheckpointManager`` against the
reference's cases (``tests/test_checkpoint.py``) and the port's own
rules.

  * the asynchronous lifecycle on host trees: a non-blocking save, the
    writer's error raised at ``flush``, a torn write leaving ``latest``
    complete, the pointer repaired, the stale timeline truncated, the
    meta block, garbage collection, the context manager, the IO stats;
  * on dp 2 x tp 4 gloo ranks (stablelm-smoke, each rank writing its own
    blocks of the global arrays): a bitwise roundtrip, 4 steps straight
    equal to 2 + checkpoint + restore + 2, the fallback past a corrupt
    checkpoint, the bytes written over the ranks equal to the decls'
    global bytes, and a save restored on dp 1 x tp 4 whose next step's
    loss equals the uninterrupted one's to 1e-6;
  * an async save followed by an in-place optimizer step writes the
    pre-step values; Adafactor's moments, saved per rank, restore on
    their mesh and raise on another;
  * either package's checkpoint loads in the other, bitwise: the
    reference's (host tree, and its stablelm-smoke state on ``mesh24``)
    through the port's ``load_host`` and ``restore``; the ranks' through
    the reference's ``load_host`` and ``restore`` onto ``mesh24``.
"""
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel.params import materialize as jax_materialize
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import model_decls
from repro_torch.optim import AdamW, make_optimizer
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import (gather_params, param_count,
                                         tree_leaves)
from repro_torch.train.checkpoint import CheckpointManager

import torch_ranks


def _tiny_tree(scale=1.0):
    return {"layers": {"w": np.full((2, 4, 4), scale, np.float32),
                       "b": np.zeros((2, 4), np.float32)}}


# ---------------------------------------------------------------------------
# the asynchronous lifecycle (host trees)
# ---------------------------------------------------------------------------

def test_save_async_nonblocking(tmp_path, monkeypatch):
    """save_async returns while the write is in flight; flush joins it
    and the checkpoint is then complete."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    gate = threading.Event()
    orig = mgr._write

    def slow_write(step, host, meta):
        gate.wait(timeout=10.0)
        orig(step, host, meta)

    monkeypatch.setattr(mgr, "_write", slow_write)
    t0 = time.perf_counter()
    mgr.save_async(1, _tiny_tree(), {})
    assert time.perf_counter() - t0 < 1.0
    assert mgr.available_steps() == []
    gate.set()
    mgr.flush()
    assert mgr.available_steps() == [1]
    assert mgr.latest_step() == 1


def test_flush_raises_worker_error(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(step, host, meta):
        raise IOError("disk on fire")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save_async(1, _tiny_tree(), {})
    with pytest.raises(IOError, match="disk on fire"):
        mgr.flush()
    mgr.flush()


def test_torn_write_leaves_latest_complete(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tiny_tree(), {})
    torn = os.path.join(str(tmp_path), "step_0000000002.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
        f.write(b"partial")
    assert mgr.latest_step() == 1
    mgr2 = CheckpointManager(str(tmp_path))
    assert not os.path.exists(torn)
    assert mgr2.latest_step() == 1
    assert mgr2.available_steps() == [1]


def test_latest_pointer_repair(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tiny_tree(), {})
    with open(os.path.join(str(tmp_path), "latest"), "w") as f:
        f.write("99")
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


def test_invalidate_after_truncates_stale_timeline(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10)
    for s in (1, 2, 3):
        mgr.save(s, _tiny_tree(float(s)), {})
    mgr.invalidate_after(1)
    assert mgr.available_steps() == [1]
    assert mgr.latest_step() == 1
    _, flat = mgr.load_host(1)
    np.testing.assert_array_equal(flat["params/layers/w"],
                                  np.full((2, 4, 4), 1.0, np.float32))


def test_meta_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tiny_tree(), {}, meta={"plan": {"name": "t", "tp": 2}})
    assert mgr.meta(5) == {"plan": {"name": "t", "tp": 2}}
    index, _ = mgr.load_host(5)
    assert index["meta"]["plan"]["tp"] == 2


def test_gc_respects_keep_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tiny_tree(), {})
    assert mgr.available_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_context_manager_flushes(tmp_path):
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save_async(1, _tiny_tree(), {})
    assert mgr.available_steps() == [1]


def test_io_stats_accumulate(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.io_stats() == {"io_seconds": 0.0, "io_bytes": 0, "saves": 0}
    mgr.save(1, _tiny_tree(), {})
    st = mgr.io_stats()
    assert st["saves"] == 1
    assert st["io_bytes"] >= _tiny_tree()["layers"]["w"].nbytes
    assert st["io_seconds"] > 0


def test_async_save_then_in_place_step_writes_pre_step_values(tmp_path):
    """The port's optimizers update in place: the save copies to the host
    before it returns, so a step taken while the write is still gated
    does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    orig = mgr._write
    mgr._write = lambda *a: (gate.wait(timeout=10.0), orig(*a))
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 8, generator=g)}
    grads = {"w": torch.randn(4, 8, generator=g)}
    opt = AdamW(0.1)
    state = opt.init(params)
    before = params["w"].clone()
    mgr.save_async(1, params, state)
    opt.update(grads, state, params, 0)
    assert not torch.equal(params["w"], before)
    gate.set()
    mgr.flush()
    _, flat = mgr.load_host(1)
    np.testing.assert_array_equal(flat["params/w"], before.numpy())
    np.testing.assert_array_equal(flat["opt/m/w"], np.zeros((4, 8)))


def test_bfloat16_leaf_roundtrip(tmp_path):
    """numpy has no bfloat16: the port stores its bit patterns."""
    w = torch.randn(3, 5).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w}, {})
    from repro_torch.parallel.params import ParamDecl
    st = mgr.restore(1, {"w": ParamDecl((3, 5), dtype=torch.bfloat16)}, {},
                     device="cpu")
    assert st.params["w"].dtype == torch.bfloat16
    assert torch.equal(st.params["w"], w)


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_mesh"))
    dp24 = spawn(torch_ranks.checkpoint_body, 2, 4, "cpu", timeout_s=300,
                 args=(root,))
    dp14 = spawn(torch_ranks.checkpoint_other_mesh_body, 1, 4, "cpu",
                 timeout_s=300, args=(root,))
    return root, dp24, dp14


def _port_decls(arch=torch_ranks.CKPT_ARCH, opt="adamw"):
    """The global decls at tp 4 (a phantom site's factors depend on tp)."""
    cfg = get_config(arch, smoke=True)
    decls = model_decls(cfg, MeshAxes(dp=2, tp=4))
    return decls, make_optimizer(opt, 1e-3).state_decls(decls)


def test_roundtrip_bitwise(mesh_runs):
    _, dp24, _ = mesh_runs
    for r in dp24:
        assert r["roundtrip"]["step"] == 7
        assert r["roundtrip"]["equal"]


def test_bytes_written_equal_the_decls_global_bytes(mesh_runs):
    """One writer per distinct block: the ranks' bytes sum to the global
    parameters and both AdamW moments, float32, exactly."""
    _, dp24, _ = mesh_runs
    decls, _ = _port_decls()
    assert sum(r["roundtrip"]["io"]["io_bytes"] for r in dp24) \
        == 3 * 4 * param_count(decls)
    assert all(r["roundtrip"]["io"]["saves"] == 1 for r in dp24)


def test_elastic_restore_other_mesh(mesh_runs):
    """Saved on dp 2 x tp 4, restored on dp 1 x tp 4: the next step's
    loss equals the uninterrupted run's."""
    _, dp24, dp14 = mesh_runs
    np.testing.assert_allclose(dp14[0]["step3"], dp24[0]["other_mesh_step3"],
                               rtol=1e-6)
    assert len({r["step3"][0] for r in dp14}) == 1


def test_corrupt_checkpoint_fallback(mesh_runs):
    _, dp24, _ = mesh_runs
    assert [r["corrupt_fallback_step"] for r in dp24] == [1] * 8


def test_resume_equals_uninterrupted(mesh_runs):
    _, dp24, _ = mesh_runs
    for r in dp24:
        np.testing.assert_allclose(r["resume"]["resumed"],
                                   r["resume"]["straight"], rtol=1e-6)


def test_adafactor_moments_restore_on_their_mesh_only(mesh_runs):
    _, dp24, dp14 = mesh_runs
    assert all(r["adafactor_same_mesh"] for r in dp24)
    for r in dp14:
        assert r["adafactor_error"] is not None
        assert "saved per rank" in r["adafactor_error"]
        assert "[1, 2, 4]" in r["adafactor_error"]


# ---------------------------------------------------------------------------
# either package's checkpoint in the other
# ---------------------------------------------------------------------------

def test_reference_host_checkpoint_loads_in_port_and_back(tmp_path):
    tree = {"layers": {"w": np.arange(32, dtype=np.float32).reshape(2, 4, 4),
                       "b": np.ones((2, 4), np.float32)}}
    opt = {"m": _tiny_tree(0.5), "v": _tiny_tree(0.25)}
    JCheckpointManager(str(tmp_path / "ref")).save(3, tree, opt,
                                                   meta={"a": 1})
    index, flat = CheckpointManager(str(tmp_path / "ref")).load_host(3)
    want = dict(tree_leaves({"params": tree, "opt": opt}))
    assert set(flat) == set(want) and index["meta"] == {"a": 1}
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    CheckpointManager(str(tmp_path / "port")).save(3, tree, opt,
                                                   meta={"a": 1})
    jindex, jflat = JCheckpointManager(str(tmp_path / "port")).load_host(3)
    assert jindex["leaves"] == index["leaves"]
    for k in want:
        np.testing.assert_array_equal(jflat[k], want[k])


def test_reference_train_state_restores_in_port(mesh24, tmp_path):
    cfg = jax_get_config(torch_ranks.CKPT_ARCH, smoke=True)
    opt = jax_make_optimizer("adamw", 1e-3)
    _, decls, _ = jax_make_train_step(cfg, mesh24, opt)
    params = jax_materialize(decls, 0)
    state = jax.tree.map(lambda a: a + 0.5, opt.init(params))
    JCheckpointManager(str(tmp_path)).save(4, params, state)
    pdecls, podecls = _port_decls()
    st = CheckpointManager(str(tmp_path)).restore(4, pdecls, podecls,
                                                  device="cpu")
    assert st.step == 4
    got = dict(tree_leaves({"p": st.params, "o": st.opt_state}))
    want = dict(tree_leaves({"p": jax.tree.map(np.asarray, params),
                             "o": jax.tree.map(np.asarray, state)}))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_port_rank_checkpoint_loads_in_reference(mesh_runs, mesh24):
    """The dp 2 x tp 4 ranks' step-7 save: the reference's ``load_host``
    gives the ranks' shards gathered, bit for bit, and its ``restore``
    places them on ``mesh24``."""
    root, dp24, _ = mesh_runs
    decls, opt_decls = _port_decls()
    want = gather_params([r["roundtrip"]["local"] for r in dp24],
                         {"params": decls, "opt": opt_decls}, 2, 4)
    want = dict(tree_leaves(want))
    _, flat = JCheckpointManager(f"{root}/roundtrip").load_host(7)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    cfg = jax_get_config(torch_ranks.CKPT_ARCH, smoke=True)
    _, jdecls, jodecls = jax_make_train_step(
        cfg, mesh24, jax_make_optimizer("adamw", 1e-3))
    st = JCheckpointManager(f"{root}/roundtrip").restore(7, jdecls, jodecls,
                                                         mesh24)
    np.testing.assert_array_equal(
        np.asarray(st.params["embed"]["table"]), want["params/embed/table"])
