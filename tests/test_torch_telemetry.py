"""The port's energy ledger against the JAX package's.

* Accounting: every strategy's ``flops`` / ``comm_events`` /
  ``param_count`` equals the ``strategies`` block of
  ``tests/fixtures/golden_costs.json`` exactly and the JAX strategies'
  over a sweep; the energy model (``comm_time_us``, ``tp_costs``,
  ``phantom_costs``, ``energy_to_loss``) and the predictions equal the
  golden blocks and ``repro``'s functions within rel 1e-12, with the same
  ``peak_flops`` passed to both sides.
* Ledger: reports of the two packages' ``Ledger`` read back equal.
* Measured: on 8 gloo CPU ranks (1 x 8, spawned once for the module) the
  port's ``measure_ffn_step`` at n = 512, L = 2, k = 8, batch 32 meets the
  reference's pins (``tests/test_telemetry.py``: wire bytes and message
  floats within 2% of the prediction; flops within 5% for tensor_col and
  25% for phantom, and at least 0.99 of it), its wire bytes and message
  floats are within 2% of the JAX ``measure_ffn_step``'s HLO reading on
  the CPU mesh, and the kernel-backend phantom step counts exactly the
  flops of the plain-torch step.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from make_golden_costs import FIXTURE
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import PhantomConfig as JPhantomConfig
from repro.configs.base import ProjectionSpec as JProjectionSpec
from repro.configs.base import dense_projection_map as jax_dense_map
from repro.configs.base import phantom_projection_map as jax_phantom_map
from repro.core import energy as jenergy
from repro.core.lowrank import block_lowrank_error as jax_lowrank_error
from repro.core.lowrank import svd_phantom_init as jax_svd_phantom_init
from repro.parallel.strategies import make_strategy as jax_make_strategy
from repro.telemetry import Ledger as JLedger
from repro.telemetry import LedgerEntry as JLedgerEntry
from repro.telemetry import load_report as jax_load_report
from repro.telemetry import measure_ffn_step as jax_measure_ffn_step
from repro.telemetry import predict as jpredict
from repro_torch.benchmarks import table1_energy, train_smoke
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      ProjectionSpec, dense_projection_map,
                                      phantom_projection_map)
from repro_torch.core import energy
from repro_torch.core.lowrank import block_lowrank_error, svd_phantom_init
from repro_torch.kernels import phantom_fused as pf
from repro_torch.kernels.ops import phantom_fused_linear
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.strategies import make_strategy
from repro_torch.telemetry import (Ledger, LedgerEntry, load_report,
                                   predict)

import torch_ranks

REL = 1e-12
KINDS = [("tensor_col", 0), ("tensor_row", 0), ("phantom", 8),
         ("lowrank_distill", 4)]
# (n, p, k, batch, include_self_term)
SWEEP = [(512, 4, 8, 32, False), (256, 8, 4, 16, True), (1024, 2, 16, 64,
                                                         False),
         (96, 3, 5, 7, True), (16384, 8, 16, 64, False), (64, 1, 4, 8, True)]
H100 = energy.H100_PEAK_FLOPS_FP32


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        return json.load(f)


def _events(st, batch):
    return [[e.collective, e.m_floats, e.phase] for e in st.comm_events(batch)]


# ---------------------------------------------------------------------------
# the strategies' accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,k", KINDS)
def test_strategy_costs_equal_golden(golden, kind, k):
    want = golden["strategies"][f"{kind}_k{k}"]
    st = make_strategy(ProjectionSpec(kind=kind, k=k or 64), want["n"],
                       want["n"], want["tp"], bias=True)
    assert st.flops(want["batch"]) == want["flops"]
    assert st.param_count() == want["param_count"]
    assert _events(st, want["batch"]) == want["comm_events"]


@pytest.mark.parametrize("n,p,k,batch,self_term", SWEEP)
def test_strategy_costs_equal_reference(n, p, k, batch, self_term):
    for kind, _ in KINDS:
        if kind.startswith("tensor") or n % p:
            spec_kw = dict(kind=kind)
        else:
            spec_kw = dict(kind=kind, k=k, include_self_term=self_term)
        ours = make_strategy(ProjectionSpec(**spec_kw), n, n, p, bias=True)
        theirs = jax_make_strategy(JProjectionSpec(**spec_kw), n, n, p,
                                   bias=True)
        assert ours.flops(batch) == theirs.flops(batch), kind
        assert ours.param_count() == theirs.param_count(), kind
        assert _events(ours, batch) == _events(theirs, batch), kind
        assert (ours.in_layout, ours.out_layout) == (theirs.in_layout,
                                                     theirs.out_layout)


def test_lowrank_distill_equals_reference():
    """svd_phantom_init's factors, the distilled strategy's params and its
    error equal the reference's on the same teacher."""
    W = np.random.RandomState(5).randn(96, 96)
    ours, theirs = svd_phantom_init(W, 4, 6), jax_svd_phantom_init(W, 4, 6)
    for key in ("L", "C", "D"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(
            theirs[key]), rtol=1e-6, atol=1e-6)
    assert block_lowrank_error(W, 4, 6) == pytest.approx(
        jax_lowrank_error(W, 4, 6), rel=1e-5)
    st = make_strategy(ProjectionSpec(kind="lowrank_distill", k=6), 96, 96,
                       4)
    params = st.init_from_dense(W)
    assert params["b"].shape == (96,)
    dense, _ = st.dense_equivalent(params)
    err = float(torch.linalg.norm(torch.from_numpy(W).float() - dense)
                / np.linalg.norm(W))
    assert err == pytest.approx(st.distill_error(W), rel=1e-5)


# ---------------------------------------------------------------------------
# the energy model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coll", ["broadcast", "all_reduce", "all_gather",
                                  "reduce_scatter", "collective_permute"])
def test_comm_time_equals_golden_and_reference(golden, coll):
    want = golden["comm_time_us"][f"{coll}_m4096_p4"]
    assert energy.comm_time_us(coll, 4096.0, 4) == pytest.approx(want,
                                                                 rel=REL)
    for m, p in ((1.0, 2), (4096.0, 8), (1e6, 256), (10.0, 1)):
        assert energy.comm_time_us(coll, m, p) == pytest.approx(
            jenergy.comm_time_us(coll, m, p), rel=REL, abs=0.0)


def test_closed_forms_equal_golden(golden):
    """The fixture was made at the reference's default peak, which the
    port does not carry: it is passed in from the reference."""
    peak = jenergy.TPU_PEAK_FLOPS
    cf = golden["closed_forms"]
    assert energy.tp_costs(512, 4, 2, 32, peak) == pytest.approx(
        tuple(cf["tp_costs_n512_p4_L2_b32"]), rel=REL)
    assert energy.phantom_costs(512, 4, 2, 8, 32, peak) == pytest.approx(
        tuple(cf["phantom_costs_n512_p4_L2_k8_b32"]), rel=REL)


@pytest.mark.parametrize("n,p,k,batch,self_term", SWEEP)
def test_closed_forms_equal_reference(n, p, k, batch, self_term):
    for fits in (None, energy.h100_collective_fits()):
        ours_t = energy.tp_costs(n, p, 2, batch, H100, fits)
        ours_p = energy.phantom_costs(n, p, 2, k, batch, H100, fits)
        assert ours_t == pytest.approx(
            jenergy.tp_costs(n, p, 2, batch, H100, fits), rel=REL)
        assert ours_p == pytest.approx(
            jenergy.phantom_costs(n, p, 2, k, batch, H100, fits), rel=REL)
        for a, b in (ours_t, ours_p):
            assert energy.energy_to_loss(a, b, p, 453) == pytest.approx(
                jenergy.energy_to_loss(a, b, p, 453), rel=REL)


def test_h100_constants_and_roofline():
    """The card's datasheet rates; NVLink-derived fits price an all-gather
    of m floats at c1 log2 p + 4 m / 450 GB/s."""
    assert (energy.H100_PEAK_FLOPS_FP32, energy.H100_PEAK_FLOPS_BF16,
            energy.H100_HBM_BW, energy.H100_NVLINK_BW) == (
        67e12, 989e12, 3.35e12, 450e9)
    fits = energy.h100_collective_fits()
    us = energy.comm_time_us("all_gather", 1e6, 8, fits)
    assert us == pytest.approx(3.0 + 4e6 / 450e9 * 1e6, rel=REL)
    assert fits["all_reduce"][1] == 2 * fits["all_gather"][1]
    rt = energy.roofline_terms(67e12, 3.35e12, 0.0)
    assert (rt.compute_s, rt.memory_s, rt.collective_s) == (1.0, 1.0, 0.0)
    assert rt.fraction_of_roofline() == 1.0


# ---------------------------------------------------------------------------
# the predictions
# ---------------------------------------------------------------------------

def _configs(impl, n=512, L=2, k=8, backend="xla"):
    kw = dict(name=f"ffn-{impl}", family="ffn", num_layers=L, d_model=n,
              ffn_width=n, ffn_depth=L, mlp="relu")
    if impl == "phantom":
        return (JModelConfig(phantom=JPhantomConfig(k=k),
                             projections=jax_phantom_map(
                                 k, ffn_layer=True, kernel_backend=backend),
                             **kw),
                ModelConfig(phantom=PhantomConfig(k=k),
                            projections=phantom_projection_map(
                                k, ffn_layer=True, kernel_backend=backend),
                            **kw))
    return (JModelConfig(phantom=JPhantomConfig(k=k),
                         projections=jax_dense_map(), **kw),
            ModelConfig(phantom=PhantomConfig(k=k),
                        projections=dense_projection_map(), **kw))


def _same_dict(ours, theirs):
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if isinstance(want, float):
            assert ours[key] == pytest.approx(want, rel=REL, abs=0.0), key
        else:
            assert ours[key] == want, key


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("impl", ["tensor", "phantom"])
def test_predictions_equal_reference(impl, training):
    """strategy_, ffn_step_ and fused_ffn_step_prediction give the
    reference's dicts key by key, same constants passed to both."""
    jcfg, cfg = _configs(impl, backend="pallas")
    const = dict(peak_flops=H100, fits=energy.h100_collective_fits(),
                 A=300.0, B=50.0)
    for p, batch in ((8, 32), (4, 64)):
        st = make_strategy(cfg.projection_spec("ffn_layer"), 512, 512, p)
        jst = jax_make_strategy(jcfg.projection_spec("ffn_layer"), 512,
                                512, p)
        _same_dict(predict.strategy_prediction([st], p, 2, batch,
                                               training=training, **const),
                   jpredict.strategy_prediction([jst], p, 2, batch,
                                                training=training, **const))
        _same_dict(predict.ffn_step_prediction(cfg, p, batch,
                                               training=training, **const),
                   jpredict.ffn_step_prediction(jcfg, p, batch,
                                                training=training, **const))
        _same_dict(predict.fused_ffn_step_prediction(
            cfg, p, batch, training=training, **const),
            jpredict.fused_ffn_step_prediction(
                jcfg, p, batch, training=training, **const))
        assert [(e.collective, e.m_floats, e.phase, r) for e, r in
                predict.fused_kernel_step_events(cfg, p, batch, training)] \
            == [(e.collective, e.m_floats, e.phase, r) for e, r in
                jpredict.fused_kernel_step_events(jcfg, p, batch, training)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fused_prediction_equals_golden(golden, backend):
    want = golden["fused_kernel_prediction"][backend]
    _, cfg = _configs("phantom", backend=backend)
    pred = predict.fused_ffn_step_prediction(
        cfg, 4, 32, peak_flops=jenergy.TPU_PEAK_FLOPS)
    base = predict.ffn_step_prediction(cfg, 4, 32,
                                       peak_flops=jenergy.TPU_PEAK_FLOPS)
    assert pred["kernel_backend"] == want["kernel_backend"]
    for key in ("hbm_bytes_saved_per_device", "flops_per_device",
                "collective_wire_bytes_per_device", "collective_m_floats",
                "energy_j_per_iter"):
        assert pred[key] == pytest.approx(want[key], rel=REL), key
        assert key not in base or pred[key] == base[key], key
    assert [[e.collective, e.m_floats, e.phase, r] for e, r in
            predict.fused_kernel_step_events(cfg, 4, 32)] == want["events"]


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def test_ledger_reports_interchange(tmp_path):
    """The same entries through either package's Ledger give reports that
    either package's load_report reads to equal dicts."""
    rows = [dict(name="a", suite="s", kind="train", arch="x",
                 impl="phantom", p=8,
                 measured={"flops_per_device": 2.0,
                           "collective_m_floats": 3.0, "wall_us_median": 1},
                 predicted={"flops_per_device": 1.0,
                            "collective_m_floats": 3.0},
                 extra={"k": 8}),
            dict(name="b", kind="analytic", predicted={"energy_j_tp": 5.0})]
    reports = {}
    for name, (led_cls, entry_cls) in {"torch": (Ledger, LedgerEntry),
                                       "jax": (JLedger, JLedgerEntry)}.items():
        led = led_cls(run="interchange", meta={"device": "cpu"})
        for row in rows:
            led.record(entry_cls(**row))
        led.suite_ok("s", 1.5)
        path = tmp_path / f"{name}.json"
        led.write_report(str(path))
        reports[name] = path
    loaded = [load(str(path)) for path in reports.values()
              for load in (load_report, jax_load_report)]
    for rep in loaded:
        rep.pop("generated_at")
    assert all(rep == loaded[0] for rep in loaded)
    assert loaded[0]["entries"][0]["ratios"] == {"flops_per_device": 2.0,
                                                 "collective_m_floats": 1.0}
    assert loaded[0]["counts"] == {"entries": 2, "joined": 1}


def test_ledger_refuses_the_reference_report():
    """The repo-root BENCH_report.json is the JAX package's: the port's
    Ledger refuses to write it, before opening it."""
    root_report = Path(__file__).resolve().parents[1] / "BENCH_report.json"
    before = root_report.read_bytes() if root_report.exists() else None
    with pytest.raises(ValueError, match="JAX package's report"):
        Ledger(run="t").write_report(root_report)
    after = root_report.read_bytes() if root_report.exists() else None
    assert after == before


# ---------------------------------------------------------------------------
# the counted side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,PK", [(16, 24, 40, 8), (7, 13, 9, 5)])
def test_kernel_operators_counted_by_formula(M, K, N, PK):
    """FlopCounterMode counts the three kernel operators (their plain
    versions on the CPU) by 2MN(K+PK), 2MJN and 2INM: a forward and
    backward through phantom_fused_linear counts what the same product
    through plain torch ops counts."""
    from torch.utils.flop_counter import FlopCounterMode
    rng = np.random.RandomState(M)
    ts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          .requires_grad_(True) for s in ((M, K), (K, N), (M, PK), (PK, N))]
    with FlopCounterMode(display=False) as kernel:
        phantom_fused_linear(*ts).sum().backward()
    x, L, g, D = (t.detach().requires_grad_(True) for t in ts)
    with FlopCounterMode(display=False) as plain:
        (x @ L + g @ D).sum().backward()
    counts = {str(op): n for op, n in
              kernel.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.phantom_fused_matmul": 2 * M * N * (K + PK),
                      "repro_torch.matmul_nt": 2 * M * (K + PK) * N,
                      "repro_torch.matmul_tn": 2 * (K + PK) * N * M}
    assert kernel.get_total_flops() == plain.get_total_flops()
    for name, t in zip("xLgD", ts):
        ref = {"x": x, "L": L, "g": g, "D": D}[name]
        torch.testing.assert_close(t.grad, ref.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(pf.KernelConfigError, match="L rows"):
        torch.ops.repro_torch.phantom_fused_matmul(x, L[1:], g, D)


@pytest.fixture(scope="module")
def rank_results():
    """One spawn of 8 gloo CPU ranks (1 x 8): every rank's
    (measured, predicted) per strategy, one metered step each."""
    return spawn(torch_ranks.telemetry_body, 1, 8, "cpu", args=(1,),
                 timeout_s=300)


PINS = {"tensor_col": 0.05, "phantom": 0.25}


@pytest.mark.parametrize("strategy", sorted(PINS))
def test_measured_matches_predicted(rank_results, strategy):
    """The reference's pins (tests/test_telemetry.py) on every rank."""
    for measured, predicted in (r[strategy] for r in rank_results):
        for key in ("collective_wire_bytes_per_device",
                    "collective_m_floats"):
            assert measured[key] == pytest.approx(predicted[key], rel=0.02)
        assert measured["flops_per_device"] == pytest.approx(
            predicted["flops_per_device"], rel=PINS[strategy])
        assert measured["flops_per_device"] \
            >= predicted["flops_per_device"] * 0.99
        assert measured["energy_j_per_iter"] > 0
        assert measured["calls"] == 2 and measured["wall_us_median"] > 0
    assert len({json.dumps(r[strategy][0]["collectives"], sort_keys=True)
                for r in rank_results}) == 1


@pytest.mark.parametrize("strategy", sorted(PINS))
def test_measured_matches_jax_hlo(rank_results, mesh18, strategy):
    """The port's collective log against the JAX probe's compiled HLO on
    the CPU mesh: wire bytes and message floats within 2%."""
    impl = "tensor" if strategy == "tensor_col" else "phantom"
    jcfg, _ = _configs(impl)
    jax_measured, _ = jax_measure_ffn_step(jcfg, mesh18, train_smoke.BATCH)
    measured = rank_results[0][strategy][0]
    for key in ("collective_wire_bytes_per_device", "collective_m_floats"):
        assert measured[key] == pytest.approx(jax_measured[key], rel=0.02)
    assert measured["collectives"]["all_gather"]["count"] == \
        jax_measured["collectives"]["all-gather"]["count"]
    assert measured["collectives"]["reduce_scatter"]["count"] == \
        jax_measured["collectives"]["reduce-scatter"]["count"]


def test_collective_log_names_what_ran(rank_results):
    """Gloo runs the reduce-scatter as an all-reduce: logged as the
    logical reduce_scatter, issued_as all_reduce, priced as the logical
    op; one scalar all-reduce per step sums the loss."""
    colls = rank_results[0]["tensor_col"][0]["collectives"]
    L, m = train_smoke.LAYERS, train_smoke.N // 8 * train_smoke.BATCH
    assert colls["all_gather"] == {"count": L, "m_floats": L * m,
                                   "wire_bytes": L * m * 4 * 7,
                                   "issued_as": {"all_gather": L}}
    assert colls["reduce_scatter"] == {"count": L, "m_floats": L * m,
                                       "wire_bytes": L * m * 4 * 7,
                                       "issued_as": {"all_reduce": L}}
    assert colls["all_reduce"] == {"count": 1, "m_floats": 1.0,
                                   "wire_bytes": 2 * 4 * 7 / 8,
                                   "issued_as": {"all_reduce": 1}}


def test_kernel_backend_counts_the_plain_flops(rank_results):
    """The phantom step through the kernel operators counts exactly the
    flops and collectives of the same step through plain torch ops."""
    for r in rank_results:
        kernel, plain = r["phantom"][0], r["phantom_plain"][0]
        assert kernel["flops_per_device"] == plain["flops_per_device"]
        assert kernel["collectives"] == plain["collectives"]
        assert "calls" not in plain


def test_table1_energy_prices_the_reference_rows():
    """The projection rows are the reference's formulas at the H100 fp32
    peak, the iterations scaled by the mini-run's k=4 / tensor ratio."""
    led = Ledger(run="t")
    iters = {"tensor": 168, 4: 154, 8: 154, 16: 180}
    rows = table1_energy.run(led, iters)
    assert [(r["p"], r["k"]) for r in rows] == list(table1_energy.PROJECTION)
    for r in rows:
        a_t, b_t = jenergy.tp_costs(16384, r["p"], 2, 64, H100)
        a_p, b_p = jenergy.phantom_costs(16384, r["p"], 2, r["k"], 64, H100)
        assert r["energy_j_tp"] == pytest.approx(
            jenergy.energy_to_loss(a_t, b_t, r["p"], 453), rel=REL)
        assert r["energy_j_pp"] == pytest.approx(
            jenergy.energy_to_loss(a_p, b_p, r["p"], int(453 * 154 / 168)),
            rel=REL)
    assert len(led) == 4 + len(rows)


@pytest.mark.parametrize("impl,strategy", [("phantom", "phantom"),
                                           ("tensor", "tensor_col")])
def test_train_ffn_ledger_out(tmp_path, impl, strategy):
    """``train_ffn --ledger-out``: two training steps of the smoke FFN on
    4 gloo CPU ranks, then the run's own step probed; the report holds
    the reference's pins and names the run."""
    from repro_torch.launch import train_ffn
    path = tmp_path / "sub" / "ledger.json"
    assert train_ffn.main(["--smoke", "--device", "cpu", "--tp", "4",
                           "--impl", impl, "--steps", "2",
                           "--ledger-out", str(path)]) == 0
    rep = load_report(str(path))
    assert rep["run"] == "train_ffn" and rep["counts"] == {"entries": 1,
                                                           "joined": 1}
    (entry,) = rep["entries"]
    assert entry["impl"] == strategy and entry["p"] == 4
    assert entry["extra"]["train_steps"] == 2
    # the metered probe steps and the meter's one warm-up call
    assert entry["measured"]["calls"] == train_ffn.PROBE_STEPS + 1
    ratios = entry["ratios"]
    for key in ("collective_wire_bytes_per_device", "collective_m_floats"):
        assert ratios[key] == pytest.approx(1.0, rel=0.02)
    assert 0.99 <= ratios["flops_per_device"] <= 1 + PINS[strategy]


@pytest.mark.parametrize("pp,dp,tp", [(1, 2, 4), (2, 2, 2)])
def test_probe_inputs_shard_one_host_draw(pp, dp, tp):
    """On the CPU, every rank's probe parameters are exactly its shard of
    ONE global draw from a CPU generator seeded ``seed``, and its batch
    its block of one global pair drawn from a CPU generator seeded
    ``seed + 1`` (the reference's ``PRNGKey(seed + 1)``)."""
    from repro_torch.configs.base import PipelineConfig
    from repro_torch.core.ffn import ffn_decls, local_batch
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import (materialize, shard_params,
                                             tree_leaves)
    from repro_torch.telemetry.probe import probe_inputs
    cfg = train_smoke.smoke_config("phantom").replace(
        pipeline=PipelineConfig(stages=pp), microbatches=2)
    decls = ffn_decls(cfg, MeshAxes(pp=pp, dp=dp, tp=tp))
    want = materialize(decls, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(4)
    xy = [torch.randn((16, cfg.ffn_width), generator=gen) for _ in range(2)]
    for r in range(pp * dp * tp):
        s, rest = divmod(r, dp * tp)
        axes = MeshAxes(pp=pp, dp=dp, tp=tp, pp_rank=s, dp_rank=rest // tp,
                        tp_rank=rest % tp)
        params, x, y = probe_inputs(cfg, axes, decls, 16, 3, "cpu")
        for (path, got), (_, w) in zip(
                tree_leaves(params),
                tree_leaves(shard_params(want, decls, axes))):
            assert torch.equal(got, w), path
        assert torch.equal(x, local_batch(xy[0], axes))
        assert torch.equal(y, local_batch(xy[1], axes))


def test_train_ffn_pipelined_ledger_out(tmp_path, capsys):
    """``train_ffn --pp 2 --dp 2 --tp 2 --microbatches 4 --ledger-out``
    on 8 gloo CPU ranks: the launcher prints the schedule, and rank 0's
    (stage 0's) probe sends M activations forward and nothing back —
    half the ``executed=False`` boundary bytes — while its flops and
    layer wire bytes follow that account."""
    from repro_torch.launch import train_ffn
    path = tmp_path / "ledger.json"
    assert train_ffn.main(["--smoke", "--device", "cpu", "--pp", "2",
                           "--dp", "2", "--tp", "2", "--microbatches", "4",
                           "--steps", "2", "--ledger-out", str(path)]) == 0
    assert ("1F1B over 2 stages x 4 microbatches, bubble fraction 0.200"
            in capsys.readouterr().out)
    (entry,) = load_report(str(path))["entries"]
    measured, predicted = entry["measured"], entry["predicted"]
    assert measured["stage"] == 0 and predicted["executed"] is False
    assert predicted["bubble_fraction"] == pytest.approx(0.2)
    cfg = train_ffn.train_config("paper-ffn-16k", smoke=True)
    m = train_ffn.BATCH / (2 * 4) * cfg.ffn_width / 2
    assert measured["boundary_wire_bytes_per_device"] == 4 * m * 4
    assert entry["ratios"]["boundary_wire_bytes_per_device"] == 0.5
    assert 0.99 <= entry["ratios"]["flops_per_device"] <= 1 + PINS["phantom"]
    layer = (measured["collective_wire_bytes_per_device"]
             - measured["boundary_wire_bytes_per_device"])
    want = (predicted["collective_wire_bytes_per_device"]
            - predicted["boundary_wire_bytes_per_device"])
    assert layer / want == pytest.approx(1.0, rel=0.02)


@pytest.mark.parametrize("suite", ["pipeline_smoke", "kernel_bench"])
def test_benchmark_suite_runs_on_the_cpu(tmp_path, suite):
    """The port's ``pipeline_smoke`` (pipe 2 x dp 2 x tp 2: each rank's
    boundary bytes its stage's sends, held inside the suite) and
    ``kernel_bench`` (wire ratio 1.00 under both kernel backends, held
    inside the suite) on gloo CPU ranks, one metered step each."""
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{suite}")
    path = tmp_path / "report.json"
    assert mod.main(["--device", "cpu", "--steps", "1",
                     "--report-out", str(path)]) == 0
    rep = load_report(str(path))
    assert rep["counts"] == {"entries": 2, "joined": 2}
    for entry in rep["entries"]:
        ratios = entry["ratios"]
        if suite == "pipeline_smoke":
            assert ratios["boundary_wire_bytes_per_device"] == 0.5
            assert entry["extra"]["bubble_fraction"] == pytest.approx(0.2)
        else:
            assert ratios["collective_wire_bytes_per_device"] == \
                pytest.approx(1.0, abs=mod.WIRE_TOL)
        assert 0.99 <= ratios["flops_per_device"] <= 1 + PINS[
            "tensor_col" if entry["impl"] == "tensor_col" else "phantom"]
