"""The port's source lint (``repro_torch.analysis.lint``) and the
deprecation shims it guards, as ``tests/test_audit_lint.py`` holds the
reference's.

The lint half plants each violation in a temporary source tree and
asserts ``lint_sources`` reports it, and that the port's own tree has no
error (its one warning, a start-up timer that records to no ledger, is
in the port's baseline).  The port's rules: ``raw-collective`` (a
``torch.distributed`` collective, send or receive outside
``parallel/axes.py`` and ``launch/mesh.py``, where ``record_collectives``
cannot see it) takes the place of the reference's ``raw-shard-map``;
``unseeded-prng`` also flags torch draws without ``generator=``.  The
deprecation half pins that the port's shims warn as the reference's do,
and that the shipped configs stay silent."""
import json
import os
import warnings

import pytest

from repro_torch.analysis.lint import lint_file, lint_sources

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


def test_each_lint_rule_fires(tmp_path):
    _write(tmp_path, "src/repro_torch/bad_collective.py",
           "import torch.distributed as dist\n"
           "from torch.distributed import all_gather\n"
           "def f(x, g):\n"
           "    dist.all_reduce(x, group=g)\n"
           "    torch.distributed.isend(x, 1)\n"
           "    dist.barrier()\n")
    _write(tmp_path, "src/repro_torch/bad_shim.py",
           "cfg = make(ffn_impl='phantom')\n"
           "c = pp_costs(1, 2)\n")
    _write(tmp_path, "src/repro_torch/bad_rng.py",
           "import numpy as np\n"
           "import torch\n"
           "x = np.random.rand(4)\n"
           "g = np.random.default_rng()\n"
           "t = torch.randn(4, 4)\n"
           "p = torch.randperm(8)\n")
    _write(tmp_path, "src/repro_torch/benchmarks/bad_bench.py",
           "def run(out_dir, smoke=True):\n    return []\n")
    found = _by_rule(lint_sources(str(tmp_path)))
    assert {f.key for f in found["raw-collective"]} == {
        "all_gather", "all_reduce", "isend"}
    assert {f.key for f in found["deprecated-shim"]} == {"kw:ffn_impl",
                                                         "pp_costs"}
    assert {f.key for f in found["unseeded-prng"]} == {
        "rand", "default_rng", "torch.randn", "torch.randperm"}
    assert len(found["ledger-missing"]) == 1
    assert {f.severity for f in found["raw-collective"]} == {"error"}
    # every finding names file:line and carries a stable fingerprint
    for fs in found.values():
        for f in fs:
            assert f.unit in f.message and ":" in f.message
            assert f.fingerprint.startswith(f.rule + ":")


def test_lint_allows_axes_mesh_and_seeded_rng(tmp_path):
    _write(tmp_path, "src/repro_torch/parallel/axes.py",
           "import torch.distributed as dist\n"
           "def f(x):\n    dist.all_reduce(x)\n")
    _write(tmp_path, "src/repro_torch/launch/mesh.py",
           "import torch.distributed as dist\n"
           "def g():\n    dist.new_group([0, 1])\n    dist.barrier()\n")
    _write(tmp_path, "src/repro_torch/good_rng.py",
           "import numpy as np\n"
           "import torch\n"
           "g = np.random.default_rng(0)\n"
           "t = torch.randn(4, generator=torch.Generator().manual_seed(0))\n")
    _write(tmp_path, "src/repro_torch/benchmarks/good_bench.py",
           "from repro_torch.benchmarks.common import emit\n"
           "def run(out_dir, smoke=True):\n    emit({})\n    return []\n")
    _write(tmp_path, "src/repro_torch/benchmarks/common.py",  # a helper
           "def run(out_dir):\n    return []\n")
    assert lint_sources(str(tmp_path)) == []


def test_unparseable_file_is_an_error(tmp_path):
    p = _write(tmp_path, "src/repro_torch/broken.py", "def f(:\n")
    fs = lint_file(str(p), "src/repro_torch/broken.py")
    assert len(fs) == 1 and fs[0].severity == "error"
    assert fs[0].key == "syntax"


def test_repo_tree_is_lint_clean(tmp_path):
    """No error in the port's source (its benchmarks included), and its
    warnings are all in the port's baseline: ``--source-only`` exits 0
    with nothing active and no stale suppression."""
    errors = [f for f in lint_sources(ROOT) if f.severity == "error"]
    assert errors == [], "\n".join(f.message for f in errors)
    from repro_torch.launch import audit as audit_cli
    out = tmp_path / "build" / "AUDIT_report.json"
    assert audit_cli.main(["--source-only", "--out", str(out)]) == 0
    rec = json.load(open(out))
    assert rec["schema"] == "audit-report/v1"
    assert rec["ok"] is True and rec["findings"] == []
    assert rec["stale_suppressions"] == []
    assert [f["rule"] for f in rec["suppressed"]] == ["ledger-missing"]
    with pytest.raises(ValueError, match="repo root"):
        audit_cli.main(["--source-only", "--out",
                        os.path.join(ROOT, "AUDIT_report.json")])


def test_update_baseline_keeps_reasons_and_drops_stale(tmp_path):
    """``--update-baseline`` accepts today's findings, keeps the reasons
    of the suppressions that still match and drops the stale ones."""
    from repro_torch.analysis import load_baseline
    from repro_torch.launch import audit as audit_cli
    from repro_torch.launch.audit import DEFAULT_BASELINE
    path = tmp_path / "AUDIT_baseline.json"
    base = json.load(open(DEFAULT_BASELINE))
    base["suppressions"].append({"fingerprint": "dtype-drift:u:gone",
                                 "reason": "stale"})
    path.write_text(json.dumps(base))
    assert audit_cli.main(["--source-only", "--baseline", str(path),
                           "--update-baseline", "--out",
                           str(tmp_path / "r.json")]) == 0
    got = load_baseline(str(path)).suppressions
    assert got == {s["fingerprint"]: s["reason"]
                   for s in json.load(open(DEFAULT_BASELINE))[
                       "suppressions"]}


# ---------------------------------------------------------------------------
# deprecation pins: the shims must keep warning for external callers
# ---------------------------------------------------------------------------

def test_legacy_projection_shim_warns_once_per_resolution():
    from repro_torch.configs.base import (PhantomConfig, ProjectionMap,
                                          get_config)
    legacy = get_config("paper-ffn-4k", smoke=True).replace(
        ffn_impl="phantom", phantom=PhantomConfig(k=4),
        projections=ProjectionMap())
    with pytest.warns(DeprecationWarning, match="ffn_impl|apply_"):
        spec = legacy.projection_spec("ffn_layer")
    assert spec.kind == "phantom"


def test_pp_costs_shim_warns():
    """The port's ``pp_costs`` warns as the reference's does and returns
    ``phantom_costs``' pair, which prices the same flops and collectives
    as the reference's at the same peak."""
    from repro.core.energy import pp_costs as jax_pp_costs
    from repro_torch.core.energy import phantom_costs, pp_costs
    with pytest.warns(DeprecationWarning, match="phantom_costs"):
        got = pp_costs(64, 4, 2, 4, 8, 1e12)
    assert got == phantom_costs(64, 4, 2, 4, 8, 1e12)
    with pytest.warns(DeprecationWarning):
        want = jax_pp_costs(64, 4, 2, 4, 8, 1e12)
    assert got == pytest.approx(want, rel=1e-12)


def test_shipped_configs_emit_no_deprecation_warnings():
    """Every registered arch resolves every projection site through its
    explicit ProjectionMap: the legacy shim path stays cold."""
    from repro_torch.configs.base import (PROJECTION_SITES, _MODULES,
                                          get_config)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for arch in sorted(_MODULES):
            for smoke in (False, True):
                cfg = get_config(arch, smoke=smoke)
                for site in PROJECTION_SITES:
                    cfg.projection_spec(site)
