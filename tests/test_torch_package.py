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
from repro_torch.parallel.params import materialize
from repro_torch.serve.engine import ServeEngine

PKG_DIR = Path(repro_torch.__file__).resolve().parent
SRC_DIR = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    """With ``jax`` made unimportable, every module of the port imports,
    and no module of the JAX package is loaded afterwards."""
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


@pytest.mark.parametrize("case", ["tp_dp_accepted", "pipeline",
                                  "serving_tp"])
def test_multi_device_mesh_names_the_roadmap_item(case):
    """Model and data axes above 1 are meshes of the port; the pipeline
    and serving at tp > 1 are not ported and name their ROADMAP items."""
    if case == "tp_dp_accepted":
        axes = MeshAxes(tp=2, dp=4, tp_rank=1, dp_rank=3)
        assert (axes.tp, axes.dp, axes.rank) == (2, 4, 7)
        with pytest.raises(RuntimeError, match="make_local_mesh"):
            axes.tp_comm
    elif case == "pipeline":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1, item 5"):
            MeshAxes(pp=2)
    else:
        cfg = get_config("chatglm3-6b", smoke=True)
        params = materialize(model_decls(cfg, MeshAxes()),
                             torch.Generator().manual_seed(0), "cpu")
        axes = MeshAxes(tp=2)
        with pytest.raises(NotImplementedError, match="serving at tp > 1"):
            model_decls(cfg, axes)
        with pytest.raises(NotImplementedError, match="serving at tp > 1"):
            ServeEngine(cfg, params, axes=axes, device="cpu")


def test_unported_arch_and_family_raise():
    with pytest.raises(KeyError, match="not ported"):
        get_config("mamba2-370m")
    cfg = get_config("chatglm3-6b", smoke=True).replace(family="moe")
    with pytest.raises(NotImplementedError):
        model_decls(cfg, MeshAxes())
