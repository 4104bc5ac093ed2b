"""The port's hybrid family (jamba-smoke) against the JAX package on two
more meshes of gloo CPU ranks, held as ``tests/test_torch_hybrid.py:
hold_hybrid_steps`` holds them: 3 Adafactor steps at dp 2 x tp 2 with
``fsdp=True`` (the reference's ``tests/test_models_smoke.py:
test_arch_fsdp_variant``), and one Adafactor step at pp 2 x tp 2 at 16
layers (two superblocks, one a stage) over 2 microbatches, each step from
the reference's parameters and optimizer state before it.  One spawn per
mesh, in threads of their own while the reference compiles and runs
here.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro_torch.launch.mesh import spawn

import test_torch_lm_pipeline as lm_pipeline
import torch_ranks
from test_torch_hybrid import _cfgs, hold_hybrid_steps

# name: (overrides, pp, dp, tp, microbatches, steps)
TRAIN = {"jamba_dp2_tp2_fsdp": ({"fsdp": True}, 1, 2, 2, 1, 3),
         "jamba_pp2_tp2": ({"num_layers": 16}, 2, 1, 2, 2, 1)}


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(4) as pool:
        made = {name: pool.submit(lm_pipeline._jax_run, _cfgs(ov)[0], pp, dp,
                                  tp, M, "adafactor", steps=steps)
                for name, (ov, pp, dp, tp, M, steps) in TRAIN.items()}
        ref = {}
        for name, f in made.items():
            ref[name], run = f.result()
            made[name] = pool.submit(run)
        for f in made.values():
            f.result()
    out = {"ref": ref}
    errors = []

    def ranks(name):
        ov, pp, dp, tp, M, _ = TRAIN[name]
        case = dict(cfg=_cfgs(ov)[1], starts=ref[name]["starts"],
                    batches=ref[name]["batches"], lr=lm_pipeline.LR,
                    weight_decay=lm_pipeline.WD, microbatches=M,
                    optimizer="adafactor")
        try:
            out[name] = spawn(torch_ranks.lm_pipeline_body, dp, tp, "cpu",
                              pp=pp, timeout_s=300, args=({
                                  "train": {name: case},
                                  "draw_cfg": None},))
        except Exception as e:       # re-raised below, in the test
            errors.append(e)
    threads = [threading.Thread(target=ranks, args=(name,))
               for name in TRAIN]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(runs, name):
    ov, pp, dp, tp, _, steps = TRAIN[name]
    ranks = [r["train"][name] for r in runs[name]]
    assert all(len(r["losses"]) == steps for r in ranks)
    hold_hybrid_steps(name, _cfgs(ov)[1], runs["ref"][name], ranks, pp, dp,
                      tp)
