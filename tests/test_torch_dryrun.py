"""The port's dry run (``repro_torch.launch.dryrun``) against executed
steps, and its CLI against the reference's.

The dry run runs rank 0's step of a cell on ``torch.device("meta")``,
its groups ``parallel/axes.py: DryGroup``s.  Held, on smoke cells whose
executed step runs on 4 gloo CPU ranks (one pool for the module: dp 1 x
tp 4 and dp 2 x tp 2): the dry step's flops equal ``count_step``'s on
rank 0 (the flash kernel's forward by its operator's formula on both
sides: on meta it is the plain version's count), its wire bytes and its
collectives equal the executed log's; its parameter and optimizer bytes
equal the decls' shards, and the decls' global count the reference's
``count_params``.  Every architecture's smoke config runs its train,
prefill and decode steps on meta; a cell that cannot run is recorded as
failed with its reason; the record has the reference's keys, its
``SKIP`` set is the reference's, and ``--cost-fix`` recounts a cell."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs.base import (ARCH_IDS, dense_projection_map,
                                      get_config, with_kernel_backend)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankPool

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 32


def _cases():
    phi = get_config("phi3-mini-3.8b", smoke=True)
    qwen = get_config("qwen2.5-14b", smoke=True)
    return {
        (1, 4): [("phi3 dense", phi.replace(
                     projections=dense_projection_map())),
                 ("phi3 phantom kernels", with_kernel_backend(phi, "auto")),
                 ("qwen2.5 ring", qwen)],
        (2, 2): [("phi3 phantom", phi),
                 ("olmoe", get_config("olmoe-1b-7b", smoke=True))],
    }


CASES = [(mesh, i, name) for mesh, cs in _cases().items()
         for i, (name, _) in enumerate(cs)]


@pytest.fixture(scope="module")
def executed():
    out = {}
    with RankPool(1, 4, "cpu") as pool:
        for (dp, tp), cs in _cases().items():
            ranks = pool.run(torch_ranks.dry_run_parity_body, dp, tp,
                             ([(cfg, B, S) for _, cfg in cs],))
            out[(dp, tp)] = ranks[0]
    return out


@pytest.mark.parametrize("mesh,i,name", CASES)
def test_dry_step_equals_the_executed_step(executed, mesh, i, name):
    cfg = _cases()[mesh][i][1]
    got = dryrun.dry_step(cfg, "train", B, S, *mesh)
    want = executed[mesh][i]
    assert got["flops_per_device"] == want["flops"], name
    assert got["collective_wire_bytes_per_device"] == want["wire"], name
    assert {k: (r["count"], r["m_floats"])
            for k, r in got["collectives"].items()} == want["collectives"]
    assert want["wire"] > 0
    assert got["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_counts_on_meta_as_the_plain_version(causal):
    """The flash forward, a dispatcher operator: on meta its formula
    counts what the plain version's two products count on the CPU, the
    backward (autograd through the plain version) counts as on the CPU,
    and the output gets its shape."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ops import flash_attention_vjp
    from repro_torch.kernels.ref import flash_attention_ref
    rng = np.random.default_rng(0)
    cpu = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                        requires_grad=True)
           for s in ((2, 16, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32))]
    meta = [torch.empty_like(t, device="meta").requires_grad_()
            for t in cpu]

    def flops(fn, args, backward):
        with FlopCounterMode(display=False) as c:
            out = fn(*args, causal=causal)
            if backward:
                out.sum().backward()
        assert out.shape == cpu[0].shape
        return c.get_total_flops()
    fwd = flops(flash_attention_ref, cpu, False)
    assert fwd == 4 * 2 * 4 * 16 * 16 * 32
    assert flops(flash_attention_vjp, meta, False) == fwd
    assert flops(flash_attention_vjp, meta, True) == \
        flops(flash_attention_vjp, cpu, True) > fwd


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b",
                                  "mamba2-370m", "jamba-1.5-large-398b",
                                  "qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_param_and_optimizer_bytes_equal_the_decls(arch):
    """Rank 0's parameter bytes are its decl shards' (each dim over the
    axis its spec names), the optimizer's its state's decls' (AdamW: two
    float32 moments; Adafactor: factored rows and columns), and the
    decls' global count is the reference's ``count_params``."""
    from repro.configs.base import get_config as jax_get_config
    from repro.models.model import count_params as jax_count_params
    from repro_torch.models.model import count_params, model_decls
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    cfg = get_config(arch, smoke=True)
    dp, tp = 2, 2
    rec = dryrun.dry_step(cfg, "train", B, S, dp, tp)
    ways = {"tp": tp, "dp": dp}

    def local(decls):
        return sum(int(np.prod([n // ways.get(a, 1) for n, a in zip(
            d.shape, tuple(d.spec) + (None,) * len(d.shape))]))
            * torch_dtype_bytes(d.dtype) for _, d in tree_leaves(decls))
    axes = MeshAxes(tp=tp, dp=dp)
    decls = model_decls(cfg, axes)
    opt = make_optimizer(cfg.optimizer, 3e-4, weight_decay=0.1)
    assert rec["memory"]["param_bytes"] == local(decls)
    assert rec["memory"]["optimizer_bytes"] == local(opt.state_decls(decls))
    assert rec["memory"]["argument_bytes"] == (
        rec["memory"]["param_bytes"] + rec["memory"]["optimizer_bytes"]
        + 2 * 8 * (B // dp) * S
        + sum(t.numel() * t.element_size() for t in _stubs(cfg)))
    for active in (False, True):
        assert count_params(cfg, tp=tp, active_only=active) == \
            jax_count_params(jax_get_config(arch, smoke=True),
                             active_only=active, tp=tp)


def _stubs(cfg):
    """The stubbed frontends' inputs of rank 0's rows (meta)."""
    import torch
    from repro_torch.serve.engine import _add_modality_stubs
    toks = torch.empty((B // 2, S), dtype=torch.long, device="meta")
    batch = _add_modality_stubs(cfg, {"tokens": toks}, B // 2, S)
    return [v for k, v in batch.items() if k != "tokens"]


def torch_dtype_bytes(dtype):
    import torch
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_on_meta(arch, kind):
    """Nothing in a model's step needs data on meta: no host sync, no
    data-dependent shape (the MoE dispatch's capacity is static)."""
    rec = dryrun.dry_step(get_config(arch, smoke=True), kind, 8, 64, 2, 2)
    assert rec["flops_per_device"] > 0
    assert rec["collective_wire_bytes_per_device"] > 0
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["batch_per_rank"] == 4


def test_cli_record_has_the_references_keys(tmp_path):
    """One production cell at 2 of its layers (``--set``): the record
    carries the reference's keys (and the port's ``hbm_method``, ...),
    on the 16 x 16 mesh,
    and ``--cost-fix`` recounts it to the same numbers."""
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "train_4k",
                        "--set", "num_layers=2", "--out", str(out)]) == 0
    rec = json.load(open(out))
    want = {"arch", "shape", "impl", "mesh", "devices", "flops_per_device",
            "hbm_bytes_per_device", "collective_wire_bytes_per_device",
            "collectives", "memory", "roofline", "params_total",
            "params_active", "model_flops_per_device", "useful_flops_ratio",
            "timings"}
    assert want <= set(rec)
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["devices"] == 256
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["batch_per_rank"] == 16
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "train_4k",
                        "--set", "num_layers=2", "--cost-fix",
                        str(out)]) == 0
    fixed = json.load(open(out))
    assert fixed["cost_method"] == "counted"
    for key in ("flops_per_device", "collective_wire_bytes_per_device",
                "hbm_bytes_per_device"):
        assert fixed[key] == rec[key]


def test_failed_cell_is_recorded_with_its_reason(tmp_path):
    """A cell whose step cannot run (a width that does not split over
    the 16 ranks of the model axis) is written as failed, its reason
    and traceback kept, and the error raised: never skipped quietly."""
    out = tmp_path / "bad.json"
    with pytest.raises(ValueError, match="does not split"):
        dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                     "--set", "d_model=100", "--set", "num_layers=1",
                     "--out", str(out)])
    rec = json.load(open(out))
    assert "does not split" in rec["failed"] and rec["traceback"]


def test_skip_set_and_cli_are_the_references():
    """The reference's ``SKIP`` set and flags, read from its source (its
    import would set XLA's device count for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    skip = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "SKIP")
    assert skip == dryrun.SKIP
    flags = {c.args[0].value for c in ast.walk(tree)
             if isinstance(c, ast.Call)
             and getattr(c.func, "attr", "") == "add_argument"}
    ours = {a for act in dryrun.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    assert flags <= ours
