#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit; build every kernel of the
   serving path from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
   parallel) and report the build time and the compiler's register
   report; TF32 off for matmuls and convolutions.
2. kernels against their plain versions at chatglm3-6b's prefill
   geometry (H=32, KV=2, hd=128; B in {1, 4}; S in {16, 32, 48, 128,
   512}; causal and full; bf16 and fp32) plus one smoke-geometry case
   (hd=16).  Tolerances: fp32 rtol 2e-3 / atol 2e-4, bf16 3e-2 (the
   reference's kernel tests).  Per case: max error, the kernel's device
   time (``time_ms``), its bound (the larger of bytes over 3.35 TB/s
   and FLOPs over the peak of the input type: 989 TFLOP/s bf16 tensor,
   67 TFLOP/s fp32 non-tensor), the plain version's time and the time of
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   inputs as a yardstick (the port never calls it).
3. serve: chatglm3-6b at full width and depth (28 layers), random
   weights from a seeded generator, ``kernel_backend="pallas"``,
   through ``ServeEngine`` (4 slots, max_len 128, page 16): 8
   closed-batch 16-token prompts, then 8 mixed-length prompts (5 to 48
   tokens: buckets 16, 32, 48), 16 greedy tokens each.  Checks that
   every request finishes with 16 tokens and that the flash kernel was
   launched once per layer of every prefill group.  Then a profiled
   window of decode steps (``_profile_decode``), and, on the same
   weights and the first group, the kernel path against the plain
   blockwise core (rtol/atol 5e-2): layer by layer in bf16 from the same
   inputs, and end to end in float32 activations (``_compare_cores``
   says why the bf16 end-to-end difference is printed, not held).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Everything measured is also written
to ``build/chip_smoke.json``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12
SLOTS, MAX_LEN, PAGE, NEW_TOKENS = 4, 128, 16, 16
MIXED_LENS = (5, 12, 16, 17, 29, 32, 40, 48)
SWEEP_B, SWEEP_S = (1, 4), (16, 32, 48, 128, 512)
MAIN_SHAPE = dict(B=SLOTS, S=48, H=32, KV=2, hd=128, causal=True,
                  dtype="bfloat16")
LOGIT_TOL = 5e-2


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def time_ms(fn, reps=20, trials=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed ``trials`` times between CUDA events (the median), so that
    the host's launch rate does not bound kernels of a few microseconds.
    Inputs stay resident in L2 across calls, as they are in serving,
    where the projection that made them ran just before."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound_ms(B, S, H, KV, hd, causal, dtype):
    """Least time for the function: each input read once and the output
    written once, against QK^T and PV on the pairs causality keeps."""
    import torch
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esize
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build(["flash_attention"])
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s")
    for line in logs.get("flash_attention", "").splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return {"nvidia_smi": smi, "build_s": build_s}


def _case(B, S, H, KV, hd, causal, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dt = getattr(torch, dtype)
    q = (torch.randn(B, S, H, hd, device="cuda", generator=gen) * 0.5).to(dt)
    k = (torch.randn(B, S, KV, hd, device="cuda", generator=gen) * 0.5
         ).to(dt)
    v = (torch.randn(B, S, KV, hd, device="cuda", generator=gen) * 0.5
         ).to(dt)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = (2e-3, 2e-4) if dtype == "float32" else (3e-2, 3e-2)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    # SDPA takes [B, H, S, hd]; K/V expanded to H heads outside the timing
    qs = q.transpose(1, 2)
    ks = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vs = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    bound, bound_by = attention_bound_ms(B, S, H, KV, hd, causal, dt)
    return {
        "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal,
        "dtype": dtype, "max_abs_err": err, "ok": ok,
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "plain_ms": time_ms(
            lambda: flash_attention_ref(q, k, v, causal=causal)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        "bound_ms": bound, "bound_by": bound_by}


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [dict(B=B, S=S, H=32, KV=2, hd=128, causal=c, dtype=dt)
             for B in SWEEP_B for S in SWEEP_S for c in (True, False)
             for dt in ("bfloat16", "float32")]
    cases.append(dict(B=2, S=16, H=4, KV=2, hd=16, causal=True,
                      dtype="float32"))
    results = []
    for c in cases:
        r = _case(**c, gen=gen)
        results.append(r)
        print(f"flash_attention B={r['B']} S={r['S']} H={r['H']} "
              f"KV={r['KV']} hd={r['hd']} {r['dtype']} "
              f"{'causal' if r['causal'] else 'full'}: "
              f"max_abs_err={r['max_abs_err']:.3e} ok={r['ok']} "
              f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f}", flush=True)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version in "
                   f"{len(bad)} case(s): {bad}")
    return results


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import closed_batch, slo_report
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import bucket_of

    cfg = with_kernel_backend(get_config("chatglm3-6b"), "pallas")
    axes = MeshAxes()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, materialize(model_decls(cfg, axes), gen, "cuda"),
                      slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      axes=axes, device="cuda")
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(eng.params)) / 1e9
    print(f"serve: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"weights on card {weights_gb:.2f} GB, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    closed = closed_batch(cfg.vocab_size, 8, 16, NEW_TOKENS, SEED)
    rng = np.random.RandomState(SEED + 1)
    mixed = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=NEW_TOKENS,
                     req_id=100 + i) for i, n in enumerate(MIXED_LENS)]
    eng.warmup(sorted({bucket_of(n, PAGE) for n in MIXED_LENS + (16,)}))

    # --- the main path: counts from zero, read right after ---------------
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    groups0 = eng.prefill_meter.calls
    flash_attention.launches = 0
    eng.run(closed)
    rep_closed = slo_report(closed)
    for r in mixed:
        r.arrival_s = eng.now_s
    eng.run(mixed)
    launches = flash_attention.launches
    groups = eng.prefill_meter.calls - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep_mixed = slo_report(mixed)

    for r in closed + mixed:
        check(r.done and len(r.out_tokens) == NEW_TOKENS,
              f"request {r.req_id} ended with {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.req_id} sampled out-of-vocab tokens")
    check(launches == groups * cfg.num_layers,
          f"flash kernel launched {launches} times for {groups} prefill "
          f"groups x {cfg.num_layers} layers")
    for name, rep in (("closed", rep_closed), ("mixed", rep_mixed)):
        print(f"serve {name}: requests={rep['requests']} "
              f"tokens={rep['generated_tokens']} "
              f"TTFT p50={rep['ttft_ms']['p50']:.3f} ms "
              f"TPOT p50={rep['tpot_ms']['p50']:.3f} ms "
              f"tokens/s={rep['tokens_per_s']:.1f}", flush=True)
    print(f"serve: prefill groups={groups} flash launches={launches} "
          f"memory allocated {start_gb:.2f} GB at the start, peak "
          f"{peak_gb:.2f} GB", flush=True)

    for name, meter in (("prefill", eng.prefill_meter),
                        ("decode", eng.decode_meter)):
        print(f"serve: {name} step median "
              f"{meter.median_us() / 1e3:.3f} ms over {meter.calls} calls")

    profile = _profile_decode(eng, cfg)
    toks = torch.from_numpy(np.stack([r.prompt for r in closed[:SLOTS]])
                            ).long().cuda()
    logit_errs = _compare_cores(cfg, axes, eng.params, toks)
    return {"launches": launches, "prefill_groups": groups,
            "weights_gb": weights_gb, "start_memory_gb": start_gb,
            "peak_memory_gb": peak_gb,
            "closed": rep_closed, "mixed": rep_mixed,
            "logits_max_abs_err": logit_errs, "decode_profile": profile,
            "prefill_meter": eng.prefill_meter.summary(),
            "decode_meter": eng.decode_meter.summary()}


def _profile_decode(eng, cfg, steps=4):
    """Where a decode step's time goes: ``torch.profiler`` over a few
    steps of a full batch (after the main path, outside its counts).
    Reports the wall time per step, the device time its kernels and
    copies took, and how many of them ran per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import closed_batch
    eng.submit(closed_batch(cfg.vocab_size, SLOTS, 16, steps + 2, SEED + 2))
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side entries only (kernels, copies): the CPU ops' device
    # columns count the same kernels again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    ops = sum(e.count for e in events) / steps
    while eng.has_active():
        eng.step()
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms or None,
           "device_busy_share": (device_ms / wall_ms) if device_ms else None,
           "device_ops_per_step": ops,
           "top_device_ms_per_step": {
               e.key[:60]: e.self_device_time_total / 1e3 / steps
               for e in top}}
    busy = out["device_busy_share"]
    top_ms = {k: round(v, 4) for k, v in out["top_device_ms_per_step"]
              .items()}
    print(f"serve: decode profile: wall {wall_ms:.3f} ms/step, device "
          f"{device_ms:.3f} ms/step, busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}, "
          f"{ops:.0f} device ops/step; top: {top_ms}",
          flush=True)
    return out


def _close(a, b):
    import torch
    return bool(torch.allclose(a.float(), b.float(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL))


def _compare_cores(cfg, axes, params, toks):
    """Prefill of the first group through the kernel path and through the
    plain blockwise core, on the same weights:

    * per layer, bf16 as served: both cores get the kernel path's input,
      so each layer's output and the final logits are held to 5e-2 without
      the drift of 28 chaotic random layers compounding one-ulp bf16
      differences;
    * end to end in float32 activations (fp32 kernel): held to 5e-2;
    * end to end in bf16: printed, not held (the drift above)."""
    import torch
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.models.blocks import block_apply
    from repro_torch.models.layers import (embed_apply, head_logits,
                                           norm_apply)
    from repro_torch.models.model import forward_prefill
    from repro_torch.parallel.params import tree_map
    plain = with_kernel_backend(cfg, "xla")
    V = cfg.vocab_size
    errs = {}
    with torch.no_grad():
        B, S = toks.shape
        pos = torch.arange(S, device=toks.device).expand(B, S)
        h = embed_apply(cfg, params["embed"], toks)
        worst = 0.0
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], params["layers"])
            h_k, _ = block_apply(cfg, lp, h, pos, axes, kind="prefill")
            h_x, _ = block_apply(plain, lp, h, pos, axes, kind="prefill")
            worst = max(worst, (h_k.float() - h_x.float()).abs().max().item())
            check(_close(h_k, h_x), f"layer {i}: kernel and plain core "
                                    f"outputs disagree")
            h = h_k

        def logits(x):
            return head_logits(cfg, params["head"], norm_apply(
                cfg, params["final_norm"], x)[:, -1:])[..., :V]
        lg_k, lg_x = logits(h_k), logits(h_x)
        check(bool(torch.isfinite(lg_k).all()), "non-finite logits")
        check(_close(lg_k, lg_x), "per-layer logits disagree")
        errs["per_layer_bf16_hidden"] = worst
        errs["per_layer_bf16_logits"] = (lg_k - lg_x).abs().max().item()

        for name, dt in (("end_to_end_fp32", "float32"),
                         ("end_to_end_bf16", "bfloat16")):
            c = cfg.replace(dtype=dt)
            lg_k, _ = forward_prefill(c, axes, params, {"tokens": toks})
            lg_x, _ = forward_prefill(with_kernel_backend(c, "xla"), axes,
                                      params, {"tokens": toks})
            errs[name] = (lg_k[..., :V] - lg_x[..., :V]).abs().max().item()
            if dt == "float32":
                check(_close(lg_k[..., :V], lg_x[..., :V]),
                      "fp32 end-to-end logits disagree")
    for name, e in errs.items():
        print(f"serve: kernel vs plain core, {name}: max_abs_err={e:.3e}"
              f"{'' if name == 'end_to_end_bf16' else ' (held to 5e-2)'}")
    return errs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    device = phase_device()
    sweep = phase_kernels()
    serve = phase_serve()

    main_case = next(r for r in sweep
                     if all(r[k] == v for k, v in MAIN_SHAPE.items()))
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"device": device, "sweep": sweep, "serve": serve,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
