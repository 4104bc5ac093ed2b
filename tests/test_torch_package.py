"""Package boundaries of the PyTorch port: it imports neither jax nor the
JAX package, its configs equal the reference's, and its entry points run
on the card unless told otherwise."""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro.configs.base import get_config as jax_get_config
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.model import model_decls
from repro_torch.parallel.axes import MeshAxes, resolve_device
from repro_torch.parallel.params import materialize, tree_leaves
from repro_torch.serve.engine import ServeEngine

PKG_DIR = Path(repro_torch.__file__).resolve().parent
SRC_DIR = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    """With ``jax`` made unimportable, every module of the port imports
    (the SSM family's ``models/ssm.py`` among them), and no module of the
    JAX package is loaded afterwards."""
    assert {"repro_torch.models.ssm", "repro_torch.obs",
            "repro_torch.obs.watchdog", "repro_torch.launch.obs",
            "repro_torch.analysis", "repro_torch.analysis.units",
            "repro_torch.analysis.rules", "repro_torch.analysis.lint",
            "repro_torch.analysis.engine", "repro_torch.analysis.findings",
            "repro_torch.launch.audit",
            "repro_torch.launch.dryrun"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n, m in sys.modules.items() if m is not None\n"
        "             and (n in ('repro', 'jax', 'jaxlib')\n"
        "                  or n.startswith(('repro.', 'jax.'))))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC_DIR))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) > 20


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG_DIR)) for p in PKG_DIR.rglob("*.py")))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse((PKG_DIR / path).read_text())
    for name in _imported_names(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_energy_model_carries_no_tpu_constant():
    """The port prices the card: no TPU constant in its energy model."""
    from repro_torch.core import energy
    assert not [n for n in vars(energy) if n.upper().startswith("TPU")]
    assert "TPU_" not in Path(energy.__file__).read_text()


def test_build_names_every_kernel_source():
    """``build.KERNELS`` names every CUDA source: the launchers build
    them all before spawning ranks, so no rank builds one itself."""
    from repro_torch.kernels import build
    assert sorted(build.KERNELS) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))


def _fields(cfg, names):
    d = dataclasses.asdict(cfg)
    return {n: d[n] for n in names}


@pytest.mark.parametrize("smoke", [False, True])
def test_chatglm3_config_equals_reference(smoke):
    """Every field the port keeps has the reference's value, nested
    projection specs included."""
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = get_config("chatglm3-6b", smoke=smoke)
    theirs = jax_get_config("chatglm3-6b", smoke=smoke)
    assert _fields(ours, names) == _fields(theirs, names)
    for site in ("ffn_gate", "ffn_up", "ffn_down", "attn_q", "attn_k",
                 "attn_v", "attn_o"):
        assert dataclasses.asdict(ours.projection_spec(site)) == \
            dataclasses.asdict(theirs.projection_spec(site))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "stablelm-3b",
                                  "qwen2.5-14b"])
def test_trained_dense_config_equals_reference(arch, smoke):
    """The dense configs the trainer runs: every field the port keeps
    (the training knobs ``remat``, ``optimizer``, ``loss_chunk`` among
    them), every site's projection spec, and the full-size parameter
    count."""
    from repro.models.model import count_params as jax_count_params
    from repro_torch.models.model import count_params
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = get_config(arch, smoke=smoke)
    theirs = jax_get_config(arch, smoke=smoke)
    assert _fields(ours, names) == _fields(theirs, names)
    for site in ("ffn_gate", "ffn_up", "ffn_down", "attn_q", "attn_k",
                 "attn_v", "attn_o"):
        assert dataclasses.asdict(ours.projection_spec(site)) == \
            dataclasses.asdict(theirs.projection_spec(site))
    assert ours.uses_phantom_sites() == theirs.uses_phantom_sites()
    assert count_params(ours) == jax_count_params(theirs, tp=1)


PORTED_ARCHS = ["chatglm3-6b", "phi3-mini-3.8b", "stablelm-3b",
                "qwen2.5-14b", "olmoe-1b-7b", "granite-moe-3b-a800m",
                "mamba2-370m", "jamba-1.5-large-398b", "qwen2-vl-72b",
                "seamless-m4t-large-v2", "paper-ffn-4k",
                "paper-ffn-16k", "paper-ffn-64k",
                "paper-ffn-131k", "paper-ffn-262k"]


def _default(f):
    return (f.default_factory() if f.default_factory is not
            dataclasses.MISSING else f.default)


def test_every_arch_of_the_port_is_held_to_the_reference():
    from repro_torch.configs.base import _MODULES
    assert sorted(_MODULES) == sorted(PORTED_ARCHS)


def test_arch_ids_equal_the_references():
    """The dry run's ``--all`` walks the reference's architectures, in
    its order."""
    from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs.base import ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    assert set(ARCH_IDS) <= set(PORTED_ARCHS)


@pytest.mark.parametrize("kw", [{"k": 4}, {"variant": "ring"},
                                {"k": 16, "include_self_term": True},
                                {"kernel_backend": "pallas"}])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2.5-14b",
                                  "olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_with_phantom_overrides_equals_reference(arch, kw):
    """``with_phantom_overrides`` (the dry run's ``--variant`` and
    ``--set phantom.*``) sets the legacy phantom sub-config and every
    phantom-family entry of the projection map as the reference's does:
    every field and every site's resolved spec."""
    from repro.configs.base import with_phantom_overrides as jax_over
    from repro_torch.configs.base import (PROJECTION_SITES,
                                          with_phantom_overrides)
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = with_phantom_overrides(get_config(arch), **kw)
    theirs = jax_over(jax_get_config(arch), **kw)
    assert _fields(ours, names) == _fields(theirs, names)
    for site in PROJECTION_SITES:
        assert dataclasses.asdict(ours.projection_spec(site)) == \
            dataclasses.asdict(theirs.projection_spec(site))


def test_reference_fields_the_port_lacks():
    """The port carries every field of the reference's ``ModelConfig``
    but two that no ported feature reads: the python-loop layer stack
    (a dry-run device of the reference) and tied embeddings (which no
    config sets)."""
    from repro.configs.base import ModelConfig as JModelConfig
    ours = {f.name for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name for f in dataclasses.fields(JModelConfig)}
    assert ours <= theirs
    assert theirs - ours == {"scan_layers", "tie_embeddings"}


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba2_config_equals_reference(smoke):
    """mamba2-370m field by field, ``SSMConfig`` read from the
    reference's fields with its defaults, every site's spec (the SSM's
    in and out sites among them) and the parameter count at tp 4."""
    from repro.configs.base import SSMConfig as JSSMConfig
    from repro.models.model import count_params as jax_count_params
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models.model import count_params
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = get_config("mamba2-370m", smoke=smoke)
    theirs = jax_get_config("mamba2-370m", smoke=smoke)
    assert _fields(ours, names) == _fields(theirs, names)
    assert [(f.name, _default(f)) for f in dataclasses.fields(SSMConfig)] \
        == [(f.name, _default(f)) for f in dataclasses.fields(JSSMConfig)]
    assert dataclasses.asdict(ours.ssm) == dataclasses.asdict(theirs.ssm)
    for site in ("ssm_in", "ssm_out", "attn_q", "ffn_gate"):
        assert dataclasses.asdict(ours.projection_spec(site)) == \
            dataclasses.asdict(theirs.projection_spec(site))
    assert ours.uses_phantom_sites() == theirs.uses_phantom_sites()
    assert count_params(ours, 4) == jax_count_params(theirs, tp=4)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_reference_fields_hold_in_every_ported_config(arch, smoke):
    """Read from the REFERENCE's ``ModelConfig``: every field the port
    keeps has the reference's value, and every field the port left out
    holds its default there (the port behaves as that default), nested
    configs included.  The port has no field the reference lacks."""
    from repro.configs.base import ModelConfig as JModelConfig
    ours = get_config(arch, smoke=smoke)
    theirs = jax_get_config(arch, smoke=smoke)
    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    ref_fields = dataclasses.fields(JModelConfig)
    assert kept <= {f.name for f in ref_fields}
    for f in ref_fields:
        value = getattr(theirs, f.name)
        if f.name in kept:
            mine = getattr(ours, f.name)
            if dataclasses.is_dataclass(value):
                value, mine = (dataclasses.asdict(value),
                               dataclasses.asdict(mine))
            assert mine == value, f.name
        else:
            assert value == _default(f), (
                f"{arch}: the reference sets {f.name}={value!r}, which the "
                f"port does not carry")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_config_equals_reference(arch, smoke):
    """The MoE configs field by field, ``MoEConfig`` read from the
    reference's fields with its defaults, and every site's spec, the
    ``moe_experts`` site among them."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = get_config(arch, smoke=smoke)
    theirs = jax_get_config(arch, smoke=smoke)
    assert _fields(ours, names) == _fields(theirs, names)
    assert [(f.name, _default(f)) for f in dataclasses.fields(MoEConfig)] \
        == [(f.name, _default(f)) for f in dataclasses.fields(JMoEConfig)]
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(theirs.moe)
    for site in ("ffn_gate", "ffn_up", "ffn_down", "attn_q", "attn_k",
                 "attn_v", "attn_o", "moe_experts"):
        assert dataclasses.asdict(ours.projection_spec(site)) == \
            dataclasses.asdict(theirs.projection_spec(site))
    assert ours.uses_phantom_sites() == theirs.uses_phantom_sites()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch.specs import input_specs as jax_input_specs
    from repro.launch.mesh import make_local_mesh
    from repro.parallel.axes import MeshAxes as JMeshAxes
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import input_specs
    ours = input_specs(get_config("phi3-mini-3.8b", smoke=True),
                       ShapeConfig("c", 64, 4, kind), MeshAxes())
    theirs, _ = jax_input_specs(
        jax_get_config("phi3-mini-3.8b", smoke=True),
        JShapeConfig("c", 64, 4, kind),
        JMeshAxes.from_mesh(make_local_mesh(1, 1)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert all(v.dtype == torch.int64 for v in ours.values())


def test_serve_engine_targets_the_card_by_default():
    """No ``device`` argument means the card; without one the engine
    raises instead of running on the CPU."""
    cfg = get_config("chatglm3-6b", smoke=True)
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert ServeEngine(cfg, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, params)
    assert resolve_device("cpu").type == "cpu"


PAPER_FFN = ["paper-ffn-4k", "paper-ffn-16k", "paper-ffn-64k",
             "paper-ffn-131k", "paper-ffn-262k"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PAPER_FFN)
def test_paper_ffn_config_equals_reference(arch, smoke):
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ours = get_config(arch, smoke=smoke)
    theirs = jax_get_config(arch, smoke=smoke)
    assert _fields(ours, names) == _fields(theirs, names)
    assert dataclasses.asdict(ours.projection_spec("ffn_layer")) == \
        dataclasses.asdict(theirs.projection_spec("ffn_layer"))


@pytest.mark.parametrize("case", ["tp_dp_accepted", "pp_accepted",
                                  "serving_tp", "ring"])
def test_multi_device_mesh_names_the_roadmap_item(case):
    """Model, data and pipe axes above 1 are meshes of the port (rank
    ``(s * dp + d) * tp + t``, the reference's (pipe, data, model)
    order), and the model declares itself at tp > 1.  Serving at tp > 1
    covers every family (it named ROADMAP.md queue 1 item 1 here until
    each was ported); what it refuses is a model axis that does not
    divide the heads the layers shard, before any rank computes (the
    engine, prefill, decode, the cache).  Ring attention, which named
    item 6 here until it was ported, declares its weights sharded on
    their input dim and its biases replicated, asked for or where tp
    does not divide the heads."""
    if case == "tp_dp_accepted":
        axes = MeshAxes(tp=2, dp=4, tp_rank=1, dp_rank=3)
        assert (axes.tp, axes.dp, axes.rank) == (2, 4, 7)
        with pytest.raises(RuntimeError, match="make_local_mesh"):
            axes.tp_comm
    elif case == "pp_accepted":
        axes = MeshAxes(pp=2, tp=2, dp=2, pp_rank=1, dp_rank=0, tp_rank=1)
        assert (axes.pp, axes.rank) == (2, 5)
        with pytest.raises(RuntimeError, match="make_local_mesh"):
            axes.pp_comm
    elif case == "serving_tp":
        from repro_torch.models.model import (forward_decode,
                                              forward_prefill,
                                              rank_cache_decls,
                                              require_serving_mesh)
        for arch in ("olmoe-1b-7b", "mamba2-370m", "jamba-1.5-large-398b",
                     "qwen2.5-14b", "qwen2-vl-72b",
                     "seamless-m4t-large-v2"):
            require_serving_mesh(get_config(arch, smoke=True),
                                 MeshAxes(tp=4, dp=2), "serving")
        # olmoe-smoke's 4 query heads (head mode) over 8 ranks
        cfg = get_config("olmoe-1b-7b", smoke=True)
        axes = MeshAxes(tp=8)
        toks = torch.zeros((1, 16), dtype=torch.long)
        with pytest.raises(ValueError, match="4 attention heads"):
            ServeEngine(cfg, {}, axes=axes, device="cpu")
        with pytest.raises(ValueError, match="4 attention heads"):
            forward_prefill(cfg, axes, {}, {"tokens": toks})
        with pytest.raises(ValueError, match="4 attention heads"):
            forward_decode(cfg, axes, {}, None, toks[:, :1],
                           torch.zeros(1, dtype=torch.long))
        # mamba2-smoke's 8 SSD heads over 3 ranks
        with pytest.raises(ValueError, match="8 SSD heads"):
            rank_cache_decls(get_config("mamba2-370m", smoke=True),
                             MeshAxes(tp=3), 4, 48)
    else:
        cfg = get_config("chatglm3-6b", smoke=True)
        for c, tp in ((cfg.replace(attn_shard="ring"), 2),
                      (cfg.replace(attn_shard="auto"), 3)):
            mixer = model_decls(c, MeshAxes(tp=tp))["layers"]["mixer"]
            assert {n: mixer[n]["w"].spec for n in mixer} == {
                n: (None, "tp", None) for n in ("wq", "wk", "wv", "wo")}
            assert mixer["wq"]["b"].spec == (None,)


@pytest.mark.parametrize("kind,stages", [("tensor", 2), ("phantom", 2),
                                         ("mixed", 2), ("mixed", 4)])
def test_pipeline_config_equals_reference(kind, stages):
    """The reference's pipelined test config and its port twin agree
    field by field, on ``pipeline.mixed`` and on every stage's
    ``stage_projection_spec``."""
    from helpers import pipeline_cfg
    from torch_ranks import port_pipeline_cfg
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    theirs = pipeline_cfg(kind, 4, 2, stages)
    ours = port_pipeline_cfg(kind, 4, 2, stages)
    assert _fields(ours, names) == _fields(theirs, names)
    assert ours.pipeline.mixed == theirs.pipeline.mixed == (kind == "mixed")
    for s in range(stages):
        assert dataclasses.asdict(ours.stage_projection_spec(s)) == \
            dataclasses.asdict(theirs.stage_projection_spec(s))


@pytest.mark.parametrize("entry", ["init_ffn", "measure_ffn_step",
                                   "count_step", "StepMeter",
                                   "make_train_step", "Trainer"])
def test_library_functions_target_the_card_by_default(entry):
    """``device=None`` means the card: on a machine without one these
    raise instead of running on the CPU."""
    from repro_torch.core.ffn import init_ffn
    from repro_torch.optim import AdamW
    from repro_torch.telemetry import StepMeter, count_step, measure_ffn_step
    from repro_torch.train.trainer import Trainer, make_train_step
    cfg = get_config("paper-ffn-16k", smoke=True)
    lm = get_config("phi3-mini-3.8b", smoke=True)
    calls = {
        "init_ffn": lambda: init_ffn(cfg, MeshAxes(), AdamW(1e-3)),
        "measure_ffn_step": lambda: measure_ffn_step(cfg, MeshAxes(), 8),
        "count_step": lambda: count_step(lambda: None),
        "StepMeter": lambda: StepMeter("step").device,
        "make_train_step": lambda: make_train_step(lm, MeshAxes(),
                                                   AdamW(1e-3)),
        "Trainer": lambda: Trainer(lm, MeshAxes(), AdamW(1e-3), None),
    }
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_unported_arch_and_family_raise():
    """An arch the reference lacks raises, and so does a family that is
    not an LM family of the reference's (the paper FFN's runs through
    ``core/ffn.py``); every LM family builds, the MoE, SSM, hybrid,
    vision-language and encoder-decoder families among them (each raised
    here until it was ported), and so does a layer plan that mixes MoE
    and MLP layers (the reference's superblock scan: a superblock of
    period 2)."""
    from repro_torch.configs.base import MoEConfig
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-4")
    cfg = get_config("chatglm3-6b", smoke=True).replace(family="ffn")
    with pytest.raises(NotImplementedError, match="family 'ffn'"):
        model_decls(cfg, MeshAxes())
    for arch in ("qwen2-vl-72b", "seamless-m4t-large-v2"):
        model_decls(get_config(arch, smoke=True), MeshAxes())
    model_decls(get_config("olmoe-1b-7b", smoke=True), MeshAxes())
    model_decls(get_config("mamba2-370m", smoke=True), MeshAxes())
    model_decls(get_config("jamba-1.5-large-398b", smoke=True), MeshAxes())
    mixed = get_config("olmoe-1b-7b", smoke=True).replace(
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, every_n=2))
    decls = model_decls(mixed, MeshAxes())
    assert sorted(decls["layers"]) == ["sub0", "sub1"]
    assert "router" in decls["layers"]["sub0"]["ffn"]
    assert "router" not in decls["layers"]["sub1"]["ffn"]


@pytest.mark.parametrize("what", ["model_tp", "train_pp", "norm",
                                  "remat", "trainer_ops"])
def test_unported_training_paths_raise(what, tmp_path):
    """What the trainer does not run yet raises and names its ROADMAP
    item, and what no mesh can shard raises before it computes: the
    serving forwards of a family on a model axis that does not divide its
    heads (they named ROADMAP.md queue 1 item 1 at any tp > 1 until the
    family was ported to serve there),
    an MLP kind no ported config uses, and remat policies other than
    full and none.  The energy-drift watchdog (item 8 part 3; like
    checkpoints, the straggler hook and restart policies it raised here
    until it was ported) now watches the trainer: a prediction every
    step exceeds trips it at the first step and the next is captured
    with ``torch.profiler``.  The full-model pipeline,
    which raised until it was ported, builds: its layer stacks are
    pipe-sharded ``[pp, G/pp, ...]``."""
    from repro_torch.models.layers import norm_decls
    from repro_torch.models.blocks import block_train
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import Trainer, make_train_step
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    if what == "model_tp":
        from repro_torch.models.model import forward_decode, forward_prefill
        axes = MeshAxes(tp=2)
        make_train_step(cfg, axes, AdamW(1e-3), device="cpu")
        # every family serves at tp > 1 since it was ported; a model axis
        # that does not divide the heads refuses
        with pytest.raises(ValueError, match="tp=8: 4 attention heads"):
            forward_prefill(get_config("olmoe-1b-7b", smoke=True),
                            MeshAxes(tp=8), {}, {"tokens": None})
        with pytest.raises(ValueError, match="tp=3: 8 SSD heads"):
            forward_decode(get_config("mamba2-370m", smoke=True),
                           MeshAxes(tp=3), {}, None, None, None)
    elif what == "train_pp":
        _, decls, _ = make_train_step(cfg, MeshAxes(pp=2), AdamW(1e-3),
                                      device="cpu")
        for _, d in tree_leaves(decls["layers"]):
            assert d.shape[:2] == (2, cfg.num_layers // 2)
            assert d.spec[0] == "pp"
    elif what == "norm":
        with pytest.raises(NotImplementedError, match="mlp='relu'"):
            norm_decls(cfg.replace(mlp="relu"), "fp", 64)
    elif what == "remat":
        with pytest.raises(NotImplementedError, match="remat"):
            block_train(cfg.replace(remat="dots"), "fp", {}, None, None,
                        MeshAxes(), "mlp")
    else:
        from repro_torch.data.synthetic import LMDataset
        from repro_torch.obs import EnergyDriftWatchdog
        wd = EnergyDriftWatchdog(predicted_s=1e-6,
                                 profile_dir=str(tmp_path))
        trainer = Trainer(cfg, MeshAxes(), AdamW(1e-3), LMDataset(
            cfg.vocab_size, 2, 17, device="cpu"), log_fn=lambda _m: None,
            watchdog=wd, device="cpu")
        trainer.run(trainer.init_state(0), 2)
        assert [(t.kind, t.step) for t in wd.trips] == [("spike", 0)]
        assert wd.captures == [str(tmp_path)]
        assert (tmp_path / "rank0.json").exists()
