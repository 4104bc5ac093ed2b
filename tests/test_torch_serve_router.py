"""The port's serving harness on the host against the reference's:
traces, SLO reports, candidates, serve-step predictions, routes, the
calibration's precedence and the launcher's parsers.  Pure arithmetic
on both sides: the predictions and prices are held within 1e-12
relative (the same formulas in the same order), everything else
exactly.  Last, the engine's ledger window (``record_to``, ``close``)
on one smoke engine on the CPU, as the reference's
``tests/test_serve.py: test_engine_close_flushes_tail_window`` holds
its own.

The port's predictions default to the H100's float32 peak where the
reference's take the TPU's: the comparisons hand both the reference's
peak (``repro.core.energy.TPU_PEAK_FLOPS``)."""
import argparse
import dataclasses
import json

import numpy as np
import pytest

from repro.core.energy import TPU_PEAK_FLOPS
from repro.launch import serve as jax_launch
from repro.planner.calibration import load_calibration as jax_load_calib
from repro.serve import router as jax_router
from repro.serve.engine import Request as JRequest
from repro.serve.traffic import SLOTracker as JSLOTracker
from repro.serve.traffic import make_trace as jax_make_trace
from repro.serve.traffic import trace_requests as jax_trace_requests
from repro.telemetry.predict import \
    serve_step_prediction as jax_serve_prediction
from repro_torch.launch import serve as launch
from repro_torch.planner.calibration import (LEDGER_SOURCE, PAPER_SOURCE,
                                             load_calibration)
from repro_torch.serve import router
from repro_torch.serve.engine import Request
from repro_torch.serve.traffic import SLOTracker, make_trace, trace_requests
from repro_torch.telemetry.predict import serve_step_prediction

REL = 1e-12
ARCH = "chatglm3-6b"


def _close(a, b):
    """Equal dicts, numbers within ``REL`` relative."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=REL, abs=0.0), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "closed"])
def test_trace_and_prompts_equal_reference(kind, seed):
    kw = dict(n=24, rate_rps=4.0, prompt_len_range=(4, 48),
              new_tokens_range=(4, 16), deadline_ms=300.0, seed=seed)
    ours, theirs = make_trace(kind, **kw), jax_make_trace(kind, **kw)
    assert [dataclasses.astuple(t) for t in ours] == \
        [dataclasses.astuple(t) for t in theirs]
    capped = make_trace(kind, max_requests=5, **kw)
    assert capped == ours[:5]
    a = trace_requests(ours, 256, seed=seed)
    b = jax_trace_requests(theirs, 256, seed=seed)
    assert [(r.prompt.tolist(), r.max_new_tokens, r.arrival_s, r.req_id)
            for r in a] == [(r.prompt.tolist(), r.max_new_tokens,
                             r.arrival_s, r.req_id) for r in b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_report_equals_reference(seed):
    """The same stamps on both sides' requests (drawn from the seed, some
    late against their deadline and the TTFT SLO) give the same report."""
    trace = make_trace("poisson", n=20, deadline_ms=900.0, seed=seed)
    rng = np.random.RandomState(seed)
    ours, theirs = SLOTracker(slo_ttft_ms=150.0), \
        JSLOTracker(slo_ttft_ms=150.0)
    for t in trace:
        ttft, tpot = rng.uniform(0.01, 0.3), rng.uniform(0.005, 0.08)
        n = t.max_new_tokens
        for cls, tracker in ((Request, ours), (JRequest, theirs)):
            r = cls(prompt=np.zeros(t.prompt_len, np.int32),
                    max_new_tokens=n, arrival_s=t.arrival_s,
                    deadline_ms=t.deadline_ms, out_tokens=list(range(n)))
            r.t_first_s = t.arrival_s + ttft
            r.t_done_s = r.t_first_s + tpot * (n - 1)
            tracker.observe(r)
    a, b = ours.report(), theirs.report()
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _close(a[key], b[key])
        else:
            assert a[key] == pytest.approx(b[key], rel=REL), key


@pytest.mark.parametrize("devices", [4, 8])
def test_candidates_equal_reference(devices):
    kw = dict(slots_options=(4, 8), max_len=128, page_size=16)
    ours = router.candidate_configs(ARCH, devices, **kw)
    theirs = jax_router.candidate_configs(ARCH, devices, **kw)
    assert [c.name for c in ours] == [c.name for c in theirs]
    assert all(c.smoke and c.kernel_backend == "auto" for c in ours)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("impl", ["tensor", "phantom"])
@pytest.mark.parametrize("p", [2, 4])
def test_serve_step_prediction_equals_reference(p, impl, phase):
    kw = dict(arch=ARCH, impl=impl, dp=2, tp=p, slots=4, max_len=128)
    ours = router.ServeConfig(**kw).model_config()
    theirs = jax_router.ServeConfig(**kw).model_config()
    rows, ctx, seqs = ((4 * 32, 32.0, 4) if phase == "prefill"
                       else (4, 128.0, 0))
    args = dict(phase=phase, ctx_tokens=ctx, sequences=seqs, dp=2,
                alpha_scale=1.3, beta_scale=0.9)
    a = serve_step_prediction(ours, p, rows, peak_flops=TPU_PEAK_FLOPS,
                              **args)
    b = jax_serve_prediction(theirs, p, rows, **args)
    _close(a, b)


@pytest.mark.parametrize("slo", [0.0, 3.0, 200.0])
def test_route_winner_and_prices_equal_reference(slo):
    trace = make_trace("poisson", n=16, prompt_len_range=(4, 48),
                       new_tokens_range=(4, 16), seed=0)
    calib = load_calibration()
    kw = dict(slots_options=(4,), max_len=128, page_size=16)
    win, priced = router.route(router.candidate_configs(ARCH, 8, **kw),
                               calib, trace, slo_ms=slo,
                               peak_flops=TPU_PEAK_FLOPS)
    jwin, jpriced = jax_router.route(
        jax_router.candidate_configs(ARCH, 8, **kw), jax_load_calib(),
        jax_make_trace("poisson", n=16, prompt_len_range=(4, 48),
                       new_tokens_range=(4, 16), seed=0), slo_ms=slo)
    assert win.config.name == jwin.config.name
    assert [pc.config.name for pc in priced] == \
        [pc.config.name for pc in jpriced]
    for a, b in zip(priced, jpriced):
        _close({k: v for k, v in a.as_dict().items() if k != "config"},
               {k: v for k, v in b.as_dict().items() if k != "config"})


def test_load_calibration_precedence(tmp_path):
    """A plan report's block > a ledger fit > the paper defaults, and an
    unreadable file falls through, as the reference's; the results
    equal the reference's on the same files."""
    plan, ledger, bad = (tmp_path / n for n in ("plan.json", "l.jsonl",
                                                "bad.json"))
    rows = [{"name": f"r{i}", "impl": impl, "kind": "train",
             "measured": {"flops_per_device": m,
                          "collective_wire_bytes_per_device": 2 * m},
             "predicted": {"flops_per_device": 1.0 + i,
                           "collective_wire_bytes_per_device": 1.5}}
            for i, (impl, m) in enumerate((("phantom", 2.5),
                                           ("tensor_col", 1.1),
                                           ("phantom", 3.5)))]
    rows.append({"name": "ag", "kind": "collective", "impl": "all_gather",
                 "measured": {"c1_us": 7.0, "c2_us_per_float": 1e-4}})
    ledger.write_text("".join(json.dumps(r) + "\n" for r in rows))
    block = {"alpha_scale": {"phantom": 1.7}, "beta_scale": {},
             "source": "plan"}
    plan.write_text(json.dumps({"calibration": block}))
    bad.write_text("{not json")
    for args, source in (((str(plan), str(ledger)), "plan"),
                         ((str(bad), str(ledger)), LEDGER_SOURCE),
                         ((None, str(ledger)), LEDGER_SOURCE),
                         ((str(bad), None), PAPER_SOURCE),
                         ((None, None), PAPER_SOURCE)):
        ours, theirs = load_calibration(*args), jax_load_calib(*args)
        assert ours.source == theirs.source == source
        assert ours.as_dict() == theirs.as_dict()
        for kind in ("phantom", "tensor_col", "lowrank_distill"):
            assert ours.scales_for(kind) == theirs.scales_for(kind)


def test_launcher_parsers_equal_reference():
    for text in ("200ms", "0.2s", "200", " 15 ms ", "", None):
        assert launch.parse_slo_ms(text) == jax_launch.parse_slo_ms(text)
    for text in ("t=0.8,k=40,p=0.95", "k=5", "seed=3,t=1.1", "", None):
        a, b = launch.parse_sampling(text), jax_launch.parse_sampling(text)
        assert (a is None and b is None) or \
            dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(argparse.ArgumentTypeError):
        launch.parse_slo_ms("fast")
    with pytest.raises(argparse.ArgumentTypeError):
        launch.parse_sampling("x=1")


def test_engine_close_records_the_tail_window(tmp_path):
    """A short session (a submit and a few steps, no ``run``) records its
    metered tail when the engine closes, once (``close`` is idempotent),
    and the context manager closes it; ``record_to`` resets the meters,
    so windows are disjoint."""
    import torch
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.telemetry import Ledger
    cfg = router.ServeConfig(ARCH, "tensor", 1, 1, 2).model_config()
    params = materialize(model_decls(cfg, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    ledger = Ledger(run="t", jsonl_path=str(tmp_path / "serve.jsonl"))
    prompt = np.arange(16, dtype=np.int32)
    with ServeEngine(cfg, params, slots=2, max_len=64, ledger=ledger,
                     device="cpu") as eng:
        eng.submit([Request(prompt=prompt, max_new_tokens=8)])
        for _ in range(3):
            eng.step()
        assert len(ledger) == 0
    kinds = [e.kind for e in ledger.entries]
    assert kinds == ["prefill", "decode"]
    assert ledger.entries[1].measured["calls"] == 3
    assert eng.prefill_meter.calls == eng.decode_meter.calls == 0
    eng.close()
    assert len(ledger) == 2
    ledger.close()
    lines = (tmp_path / "serve.jsonl").read_text().splitlines()
    assert [json.loads(line)["kind"] for line in lines] == kinds
