"""The port's planner enumeration, feasibility and pricing
(``planner/{space,constraints,score}.py``) against the reference's, field
by field on the same inputs: candidates and their names and records,
the HBM estimate and the rejections (at the reference's 16 GiB budget,
passed explicitly), every ``ScoredPlan`` field to 1e-9 (at the
reference's TPU peak, passed explicitly), the throughput floor and the
Pareto frontier.  The port's own defaults: the H100's 80 GB and its
float32 peak."""
import numpy as np
import pytest

from repro.core.energy import TPU_PEAK_FLOPS
from repro.planner import calibration as jcal
from repro.planner import constraints as jcons
from repro.planner import score as jscore
from repro.planner import space as jspace
from repro_torch.core.energy import H100_PEAK_FLOPS_FP32
from repro_torch.planner import (DEFAULT_HBM_BYTES, Calibration,
                                 Constraints, PlanCandidate,
                                 apply_throughput_floor, enumerate_plans,
                                 filter_feasible, hbm_bytes_estimate,
                                 mesh_shapes, pareto_frontier,
                                 paper_default_calibration, score_plan,
                                 score_plans)

REF_HBM = jcons.DEFAULT_HBM_BYTES
SPACES = [
    dict(max_devices=8, width=32, depth=2, batch=16, ks=(4,), pps=(1,)),
    dict(max_devices=6, width=32, depth=2, batch=16, ks=(4,), pps=(1,)),
    dict(max_devices=8, width=4096, depth=2, batch=64, ks=(4, 8, 16),
         pps=(1,)),
    dict(max_devices=6, width=4096, depth=2, batch=64, ks=(4, 8, 16),
         pps=(1,)),
    dict(max_devices=8, width=256, depth=4, batch=64, ks=(4, 8),
         pps=(1, 2), microbatch_options=(1, 2)),
    dict(max_devices=8, width=65536, depth=8, batch=256, ks=(64,),
         pps=(1, 2), microbatch_options=(1, 4),
         kernel_backends=("xla", "pallas")),
]
_CAL = dict(alpha_scale={"phantom": 1.17, "tensor_col": 1.02},
            beta_scale={"phantom": 0.93}, nu_scale={"phantom": 1.1},
            collective_fits={"all_gather": (2.0, 0.003),
                             "reduce_scatter": (1.5, 0.004),
                             "all_reduce": (3.0, 0.002),
                             "collective_permute": (1.0, 0.001)})


def _both(space):
    kw = dict(space)
    n = kw.pop("max_devices")
    return (enumerate_plans(n, **kw), jspace.enumerate_plans(n, **kw))


@pytest.mark.parametrize("space", SPACES)
def test_enumerate_plans_matches_the_reference(space):
    port, ref = _both(space)
    assert [p.as_dict() for p in port] == [p.as_dict() for p in ref]
    assert [p.name for p in port] == [p.name for p in ref]
    assert [p.kernel_backend for p in port] == [p.kernel_backend
                                                for p in ref]


@pytest.mark.parametrize("n", [1, 6, 8, 12])
def test_mesh_shapes_match_the_reference(n):
    assert mesh_shapes(n) == jspace.mesh_shapes(n)
    assert mesh_shapes(n, [2, 4]) == jspace.mesh_shapes(n, [2, 4])


@pytest.mark.parametrize("space", SPACES)
def test_filter_feasible_matches_the_reference(space):
    port, ref = _both(space)
    for budget in (REF_HBM, 2 ** 20, 2 ** 26):
        kept, rej = filter_feasible(port, Constraints(
            max_devices=space["max_devices"] // 2 or 1,
            hbm_bytes_per_device=budget))
        jkept, jrej = jcons.filter_feasible(ref, jcons.Constraints(
            max_devices=space["max_devices"] // 2 or 1,
            hbm_bytes_per_device=budget))
        assert [p.name for p in kept] == [p.name for p in jkept]
        assert [r.as_dict() for r in rej] == [r.as_dict() for r in jrej]
    for p, q in zip(port, ref):
        np.testing.assert_allclose(hbm_bytes_estimate(p),
                                   jcons.hbm_bytes_estimate(q), rtol=1e-12)


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("fitted", [False, True])
def test_score_plan_matches_the_reference_field_by_field(space, fitted):
    port, ref = _both(space)
    cal = Calibration(**_CAL) if fitted else paper_default_calibration()
    jc = (jcal.Calibration(**_CAL) if fitted
          else jcal.paper_default_calibration())
    for training in (True, False):
        got = score_plans(port, cal, iterations=300.0,
                          peak_flops=TPU_PEAK_FLOPS, training=training)
        want = jscore.score_plans(ref, jc, iterations=300.0,
                                  peak_flops=TPU_PEAK_FLOPS,
                                  training=training)
        for g, w in zip(got, want):
            gd, wd = g.as_dict(), w.as_dict()
            assert gd["plan"] == wd["plan"]
            assert set(gd) == set(wd)
            for key in wd:
                if key == "plan":
                    continue
                if key == "notes":
                    assert set(gd[key]) == set(wd[key])
                    for nk, nv in wd[key].items():
                        np.testing.assert_allclose(gd[key][nk], nv,
                                                   rtol=1e-9)
                    continue
                np.testing.assert_allclose(gd[key], wd[key], rtol=1e-9,
                                           err_msg=f"{g.plan.name} {key}")


def test_floor_and_frontier_match_the_reference():
    port, ref = _both(SPACES[4])
    got = score_plans(port, paper_default_calibration(), iterations=100.0,
                      peak_flops=TPU_PEAK_FLOPS)
    want = jscore.score_plans(ref, jcal.paper_default_calibration(),
                              iterations=100.0, peak_flops=TPU_PEAK_FLOPS)
    floor = sorted(s.throughput_rows_s for s in got)[len(got) // 2]
    k, r = apply_throughput_floor(got, floor)
    jk, jr = jscore.apply_throughput_floor(want, floor)
    assert [s.plan.name for s in k] == [s.plan.name for s in jk]
    assert [m for _, m in r] == [m for _, m in jr]
    for keys in (("energy_j_total", "step_time_s",
                  "hbm_bytes_per_device"),
                 ("energy_j_total", "step_time_s")):
        assert ([s.plan.name for s in pareto_frontier(got, keys)]
                == [s.plan.name for s in jscore.pareto_frontier(want,
                                                                keys)])


def test_the_port_prices_the_h100():
    """Defaults: the H100's 80 GB and its float32 peak; everything else
    the reference's model (alpha scales as the peak's ratio)."""
    assert DEFAULT_HBM_BYTES == 80e9
    assert Constraints(8).hbm_bytes_per_device == 80e9
    plan = PlanCandidate(dp=1, tp=8, strategy="tensor_col", width=4096,
                         depth=2, batch=64)
    cal = paper_default_calibration()
    h100 = score_plan(plan, cal)
    tpu = score_plan(plan, cal, peak_flops=TPU_PEAK_FLOPS)
    assert h100.notes["peak_flops"] == H100_PEAK_FLOPS_FP32
    np.testing.assert_allclose(h100.alpha_s / tpu.alpha_s,
                               TPU_PEAK_FLOPS / H100_PEAK_FLOPS_FP32,
                               rtol=1e-12)
    assert h100.beta_s == tpu.beta_s


def test_plan_candidate_model_config():
    plan = PlanCandidate(dp=2, tp=2, strategy="phantom", width=64, depth=4,
                         batch=16, k=4, pp=2, microbatches=2)
    ref = jspace.PlanCandidate(dp=2, tp=2, strategy="phantom", width=64,
                               depth=4, batch=16, k=4, pp=2,
                               microbatches=2)
    assert plan.name == ref.name == "phantom_n64_mesh2x2x2pp_k4_mb2"
    assert plan.devices == 8
    cfg, jcfg = plan.model_config(), ref.model_config()
    for f in ("name", "family", "num_layers", "d_model", "ffn_width",
              "ffn_depth", "mlp", "microbatches"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    assert cfg.pipeline.stages == 2
    spec = cfg.projection_spec("ffn_layer")
    assert (spec.kind, spec.k, spec.kernel_backend) == ("phantom", 4, "xla")
    assert plan.with_width(128).width == 128
    with pytest.raises(KeyError, match="site"):
        enumerate_plans(8, width=64, depth=2, batch=16, site="nowhere")
