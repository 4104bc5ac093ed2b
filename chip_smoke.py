#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit; build every kernel of the
   port from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
   parallel) and report the build time and the compiler's register
   report; check with ``cuobjdump -sass`` that every instantiation of
   the bf16 flash kernel multiplies on the tensor cores (HMMA); TF32 off
   for matmuls and convolutions.
2. kernels against their plain versions at chatglm3-6b's prefill
   geometry (H=32, KV=2, hd=128; B in {1, 4}; S in {16, 32, 48, 128,
   512}; causal and full; bf16 and fp32) plus one smoke-geometry case
   (hd=16), with peaked scores (std 2: an output is not a near-uniform
   mean of V).  Tolerances: fp32 rtol 2e-3 / atol 2e-4 (the reference's
   kernel tests); bf16 against the float32 plain version on the same
   inputs, each output within 1e-2 of sum_j p_j |v_j|, the size of its
   weighted sum (bf16 P and the rounded output each err by at most 2^-8
   of it).  Per case: max error, the kernel's device
   time (``time_ms``), its bound (the larger of bytes over 3.35 TB/s
   and FLOPs over the peak of the input type: 989 TFLOP/s bf16 tensor,
   67 TFLOP/s fp32 non-tensor), the plain version's time and the time of
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   inputs as a yardstick (the port never calls it).  Then, at the
   serving geometry in bf16 (B=4, S in {48, 512}, causal), the kernel's
   time with a cold L2 (``_flash_cold``).
3. phantom kernels against their plain versions (``_phantom_case``):
   ``phantom_fused_matmul``, ``matmul_nt`` (dgrad, ``[L;D]`` read through
   two pointers) and ``matmul_tn`` (wgrad, ``[x|g]`` through two) on the
   reference's sweeps (``tests/test_kernels.py``), the paper-ffn-16k
   per-rank shapes (M=64, K=N=2048, PK=128) and the Table I mini-run's
   (M=64, K=N=128, PK in {32, 64, 128}); float32 at 2e-4, bf16 at 2e-2.
   Per case and kernel: max error, device time, bound (bytes over
   3.35 TB/s or operations over 67 TFLOP/s fp32 / 989 TFLOP/s bf16),
   the plain version's time and ``torch.mm`` on operands concatenated
   and transposed outside the timing (the port never calls it).  For
   each kernel also the launch plan (forward and dgrad: splits; wgrad:
   persistent grid and rounds of tiles; all: 16-byte or masked copies,
   and the sweep must run both variants) and a second launch held
   bitwise equal to the first.  At the main shape all three are also
   timed with a cold L2 (``_phantom_cold``).  Then the gradients of
   ``phantom_fused_linear`` against autograd through the plain version,
   at 2e-3 (fp32) and 6e-2 (bf16).
4. serve: chatglm3-6b at full width and depth (28 layers), random
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
5. train: 8 ranks spawned once on the one card (gloo, card tensors
   through the host: collective times are not NCCL's), each running
   ``_train_rank``: paper-ffn-16k phantom on dp=1, tp=8, batch 64, AdamW
   3e-3 -- step 1 through the kernels, through plain torch and through
   plain torch in float64, from the same shards and batch (loss,
   gradients and updated parameters held to rtol 1e-4 / atol 1e-5,
   gradients also to 1e-4 of their largest against both other runs, the
   parameters of gradients within 10 eps of zero to the tolerance plus
   what their gradients imply: ``_step1_diff``); 20 kernel-path steps
   (losses finite and
   falling, each kernel launched 2 x 20 times on every rank); the same
   20 steps with ``tensor_col``; then the Table I mini-run (n=1024, L=2,
   target 0.175, at most 500 steps) for TP and phantom k in {4, 8, 16},
   whose iteration counts are printed beside the reference's, not held.
6. energy: in the same 8 ranks, the measured-vs-predicted ledger of the
   paper-ffn-16k step (``telemetry/probe.py: measure_ffn_step``, input
   grads kept): ``tensor_col`` and phantom through the kernels, each
   counted once (flops by ``FlopCounterMode``, the phantom kernels by
   their operators' formulas; wire bytes from the collective log) and
   run 5 metered steps, and the phantom step through plain torch,
   counted once.  Held on every rank: wire-byte and message-float
   ratios within 2% of 1.00, flops within the reference's pins (5%
   tensor_col, 25% phantom, measured >= 0.99 predicted), the kernel
   path's flops equal to the plain path's, each kernel launched twice
   per probe step.  Then the Table I iteration counts of phase 5 priced
   by ``repro_torch.benchmarks.table1_energy`` (E_tp, E_pp, saving per
   p).  The energies are the paper's model (Frontier A/B, alpha at the
   H100's float32 peak), not power read from the card.  The ledger goes
   to ``build/chip_smoke_ledger.json``.

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
KERNELS = ("flash_attention", "phantom_fused")
# (M, K, N, PK): the reference's sweeps (tests/test_kernels.py:13-19,
# 108-114; its backward check at :165-173 as a dgrad and a wgrad case),
# the paper-ffn-16k per-rank shapes at p=8 and batch 64, and the Table I
# mini-run's (n=1024, p=8)
PHANTOM_SHAPES = (
    [(128, 128, 128, 64), (256, 128, 128, 128), (128, 256, 384, 32),
     (512, 128, 256, 256), (128, 512, 128, 16),
     (192, 128, 128, 64), (192, 192, 192, 48), (100, 72, 56, 24),
     (130, 257, 129, 65), (128, 128, 300, 64),
     (96, 40, 160, 32), (96, 128, 112, 32)]
    + [(64, 128, 128, pk) for pk in (32, 64, 128)])
PHANTOM_MAIN = (64, 2048, 2048, 128)
PHANTOM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 6e-2}
GRAD_SHAPES = [(128, 128, 128, 16, 4), (192, 96, 80, 8, 2),
               (64, 64, 64, 4, 8)]
TRAIN_ARCH, TRAIN_DP, TRAIN_TP, TRAIN_STEPS = "paper-ffn-16k", 1, 8, 20
STEP1_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_NEAR_ZERO = 1e-7     # 10 x AdamW eps: see _step1_diff
TABLE1 = dict(n=1024, L=2, target=0.175, max_steps=500)
TABLE1_REFERENCE = {"tensor": 168, 4: 154, 8: 154, 16: 180}
ENERGY_STEPS = 5
# measured/predicted flops pins of the reference (tests/test_telemetry.py)
FLOPS_PIN = {"tensor_col": 0.05, "phantom": 0.25}
PEAK = {"float32": 67e12, "bfloat16": 989e12}


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
    where the projection that made them ran just before.  ``fn`` may be a
    list of calls on different operands, taken in turn, each at least
    once (``cold_ms``)."""
    import torch
    fns = fn if isinstance(fn, list) else [fn]
    reps = max(reps, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
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


def cold_ms(make, nbytes):
    """Device time per call with a cold L2: ``make()`` returns a call on
    fresh operands of ``nbytes`` input bytes; enough of them, taken in
    turn, that each call's inputs were evicted (twice the 50 MB L2)."""
    sets = max(4, -(-100_000_000 // nbytes))
    return time_ms([make() for _ in range(sets)])


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
    logs = build.build(KERNELS)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s ({', '.join(KERNELS)})")
    for name in KERNELS:
        for line in logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    hmma = {f"hd={name.split('ILi')[1].split('E')[0]}": n for name, n in
            _sass_count("flash_attention", "flash_mma_kernel",
                        "HMMA").items()}
    print(f"flash_mma_kernel HMMA instructions (cuobjdump -sass), by head "
          f"dim: {hmma}", flush=True)
    check(len(hmma) == 4 and all(hmma.values()),
          f"the bf16 flash kernel is not on the tensor cores: {hmma}")
    return {"nvidia_smi": smi, "build_s": build_s, "flash_hmma": hmma}


def _sass_count(kernel, function, opcode):
    """Instructions whose text holds ``opcode`` in each function of the
    built ``kernel`` library whose name holds ``function``, from
    ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import build
    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(build.library_path(kernel))], capture_output=True, text=True,
        check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if function in name:
                counts[name] = 0
        elif name in counts and opcode in line:
            counts[name] += 1
    return counts


def _flash_inputs(S, gen, B=4, H=32, KV=2, hd=128, dtype="bfloat16"):
    """q, k, v on the card with scores q.k / sqrt(hd) of std 2."""
    import torch
    return [(torch.randn(B, S, n, hd, device="cuda", generator=gen) * scale
             ).to(getattr(torch, dtype))
            for n, scale in ((H, 2.0), (KV, 1.0), (KV, 0.5))]


def _flash_held(got, q, k, v, causal):
    """The kernel's output against the plain version: fp32 within rtol
    2e-3 / atol 2e-4; bf16 against the float32 plain version on the same
    inputs, within 1e-2 of sum_j p_j |v_j|.  Returns the largest absolute
    error, the largest relative to that sum (bf16; None for fp32) and
    the verdict."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    if q.dtype == torch.float32:
        want = flash_attention_ref(q, k, v, causal=causal)
        diff = (got - want).abs()
        return (diff.max().item(), None,
                bool((diff <= 2e-4 + 2e-3 * want.abs()).all()))
    q, k, v = (t.float() for t in (q, k, v))
    want = flash_attention_ref(q, k, v, causal=causal)
    size = flash_attention_ref(q, k, v.abs(), causal=causal)
    diff = (got.float() - want).abs()
    rel = (diff / size).max().item()
    return diff.max().item(), rel, rel <= 1e-2


def _case(B, S, H, KV, hd, causal, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_inputs(S, gen, B, H, KV, hd, dtype)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err, rel, ok = _flash_held(got, q, k, v, causal)
    # SDPA takes [B, H, S, hd]; K/V expanded to H heads outside the timing
    qs = q.transpose(1, 2)
    ks = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vs = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    bound, bound_by = attention_bound_ms(B, S, H, KV, hd, causal, q.dtype)
    return {
        "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal,
        "dtype": dtype, "max_abs_err": err, "max_rel_err": rel, "ok": ok,
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
              f"max_abs_err={r['max_abs_err']:.3e}"
              + ("" if r["max_rel_err"] is None else
                 f" (of sum p|v|: {r['max_rel_err']:.3e})")
              + f" ok={r['ok']} "
              f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f}", flush=True)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version in "
                   f"{len(bad)} case(s): {bad}")
    return {"sweep": results, "cold": _flash_cold(gen)}


def _flash_cold(gen):
    """The bf16 kernel and SDPA at the serving geometry with a cold L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    out = {}
    for S in (48, 512):
        nbytes = sum(t.numel() * 2 for t in _flash_inputs(S, gen))

        def kern():
            q, k, v = _flash_inputs(S, gen)
            return lambda: flash_attention(q, k, v, causal=True)

        def lib():
            q, k, v = _flash_inputs(S, gen)
            qs = q.transpose(1, 2)
            ks, vs = (t.repeat_interleave(16, dim=2).transpose(1, 2)
                      for t in (k, v))
            return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True)
        out[S] = {"cold_ms": cold_ms(kern, nbytes),
                  "library_cold_ms": cold_ms(lib, nbytes)}
        print(f"flash_attention bf16 B=4 S={S} causal, cold L2: ms="
              f"{out[S]['cold_ms']:.4f} library_ms="
              f"{out[S]['library_cold_ms']:.4f}", flush=True)
    return out


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


def _gemm_bound_ms(nbytes, flops, dtype):
    """Least time: the larger of the bytes over 3.35 TB/s and the
    operations over the card's peak for the input type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _held(got, want, tol):
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            bool((diff <= tol + tol * want.float().abs()).all()))


def _phantom_case(M, K, N, PK, dtype, gen):
    """The three phantom kernels on one (M, K, N, PK): the forward
    z = x.L + g.D, the dgrad dz.[L;D]^T and the wgrad [x|g]^T.dz, each
    with its launch plan (forward and dgrad: splits per output tile;
    wgrad: persistent grid and rounds of tiles; 16-byte or masked
    copies) and whether a second launch on the same inputs gives the
    same bits."""
    import torch
    from repro_torch.kernels.phantom_fused import (dgrad_plan, forward_plan,
                                                   matmul_nt, matmul_tn,
                                                   phantom_fused_matmul,
                                                   resident_table, tn_plan)
    from repro_torch.kernels.ref import (matmul_nt_ref, matmul_tn_ref,
                                         phantom_fused_ref)
    dt = getattr(torch, dtype)

    def r(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen) * 0.3
                ).to(dt)
    x, L, g, D, dz = r(M, K), r(K, N), r(M, PK), r(PK, N), r(M, N)
    # the library's operands, concatenated (and viewed transposed) here,
    # outside the timing
    xg, LD = torch.cat([x, g], 1), torch.cat([L, D])
    LDt, xgt = LD.t(), xg.t()
    es, J = x.element_size(), K + PK
    flops = 2 * M * N * J
    calls = {
        "phantom_fused_matmul": (
            lambda: phantom_fused_matmul(x, L, g, D),
            lambda: phantom_fused_ref(x, L, g, D),
            lambda: torch.mm(xg, LD), (M * J + J * N + M * N) * es),
        "matmul_nt": (
            lambda: matmul_nt(dz, L, D),
            lambda: matmul_nt_ref(dz, torch.cat([L, D])),
            lambda: torch.mm(dz, LDt), (M * N + J * N + M * J) * es),
        "matmul_tn": (
            lambda: matmul_tn(x, dz, g),
            lambda: matmul_tn_ref(torch.cat([x, g], 1), dz),
            lambda: torch.mm(xgt, dz), (M * J + M * N + J * N) * es),
    }
    plans = {"phantom_fused_matmul": forward_plan(x, L, g, D),
             "matmul_nt": dgrad_plan(dz, L, D),
             "matmul_tn": tn_plan(x, dz, g)}
    out = []
    for name, (kern, plain, lib, nbytes) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        err, ok = _held(got, plain(), PHANTOM_TOL[dtype])
        bound, bound_by = _gemm_bound_ms(nbytes, flops, dtype)
        r = {"kernel": name, "M": M, "K": K, "N": N, "PK": PK,
             "dtype": dtype, "max_abs_err": err, "ok": ok,
             "ms": time_ms(kern), "plain_ms": time_ms(plain),
             "library_ms": time_ms(lib), "bound_ms": bound,
             "bound_by": bound_by}
        plan = plans[name]
        if name == "matmul_tn":
            r.update(tiles=plan.tiles, grid=plan.grid, rounds=plan.rounds,
                     resident_blocks=plan.resident)
        else:
            r.update(splits=plan.splits,
                     clusters=plan.grid[0] * plan.grid[1] // plan.splits,
                     resident_clusters=resident_table(
                         0, plan.dgrad, plan.esize)[plan.splits])
        r.update(variant=plan.variant, bitwise=bool(torch.equal(got, kern())))
        r["ok"] = ok and r["bitwise"]
        out.append(r)
    return out


def _phantom_cold(M, K, N, PK, gen):
    """The three kernels and their library calls at one shape, float32,
    with a cold L2 (``cold_ms``: enough operand sets in turn that each
    call finds its inputs evicted)."""
    import torch
    from repro_torch.kernels.phantom_fused import (matmul_nt, matmul_tn,
                                                   phantom_fused_matmul)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) * 0.3

    def ops():
        return r(M, K), r(K, N), r(M, PK), r(PK, N), r(M, N)
    calls = {   # kernel, library, input bytes
        "phantom_fused_matmul": (
            lambda x, L, g, D, dz: lambda: phantom_fused_matmul(x, L, g, D),
            lambda x, L, g, D, dz: (lambda a, b: lambda: torch.mm(a, b))(
                torch.cat([x, g], 1), torch.cat([L, D])),
            4 * (M * (K + PK) + (K + PK) * N)),
        "matmul_nt": (
            lambda x, L, g, D, dz: lambda: matmul_nt(dz, L, D),
            lambda x, L, g, D, dz: (lambda b: lambda: torch.mm(dz, b.t()))(
                torch.cat([L, D])),
            4 * (M * N + (K + PK) * N)),
        "matmul_tn": (
            lambda x, L, g, D, dz: lambda: matmul_tn(x, dz, g),
            lambda x, L, g, D, dz: (lambda a: lambda: torch.mm(a.t(), dz))(
                torch.cat([x, g], 1)),
            4 * (M * (K + PK) + M * N)),
    }
    out = {}
    for name, (kern, lib, nbytes) in calls.items():
        out[name] = {
            "cold_ms": cold_ms(lambda: kern(*ops()), nbytes),
            "library_cold_ms": cold_ms(lambda: lib(*ops()), nbytes)}
        print(f"{name} M={M} K={K} N={N} PK={PK} float32, cold L2: "
              f"ms={out[name]['cold_ms']:.4f} "
              f"library_ms={out[name]['library_cold_ms']:.4f}", flush=True)
    return out


def _phantom_grads(gen):
    """``phantom_fused_linear`` gradients (the kernels' backward) against
    autograd through the plain version, on the card."""
    import torch
    from repro_torch.kernels.ops import phantom_fused_linear
    from repro_torch.kernels.ref import phantom_fused_ref
    out = []
    for dtype in ("float32", "bfloat16"):
        dt, tol = getattr(torch, dtype), GRAD_TOL[dtype]
        for M, K, N, k, p in GRAD_SHAPES:
            shapes = ((M, K), (K, N), (M, p * k), (p * k, N))
            base = [(torch.randn(*s, device="cuda", generator=gen) * 0.3
                     ).to(dt) for s in shapes]
            res = {}
            for name, fn in (("kernel", phantom_fused_linear),
                             ("plain", phantom_fused_ref)):
                ins = [t.clone().requires_grad_(True) for t in base]
                loss = fn(*ins).square().sum()
                res[name] = (loss, torch.autograd.grad(loss, ins))
            torch.cuda.synchronize()
            errs, ok = [], True
            for a, b in zip((res["kernel"][0],) + res["kernel"][1],
                            (res["plain"][0],) + res["plain"][1]):
                err, good = _held(a, b, tol)
                errs.append(err)
                ok = ok and good and a.dtype == dt
            out.append({"M": M, "K": K, "N": N, "k": k, "p": p,
                        "dtype": dtype, "max_abs_err": max(errs), "ok": ok})
            print(f"phantom_fused_linear grads M={M} K={K} N={N} PK={p * k}"
                  f" {dtype}: max_abs_err={max(errs):.3e} ok={ok}",
                  flush=True)
    return out


def phase_phantom_kernels():
    import torch
    from repro_torch.kernels.phantom_fused import (resident_table,
                                                   wgrad_resident)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for dtype in ("float32", "bfloat16"):
        for shape in PHANTOM_SHAPES + [PHANTOM_MAIN]:
            for r in _phantom_case(*shape, dtype, gen):
                results.append(r)
                plan = (f" splits={r['splits']} clusters={r['clusters']} "
                        f"(resident at once: {r['resident_clusters']})"
                        if "splits" in r else
                        f" tiles={r['tiles']} grid={r['grid']} rounds="
                        f"{r['rounds']} (resident at once: "
                        f"{r['resident_blocks']})")
                plan += f" {r['variant']} bitwise={r['bitwise']}"
                print(f"{r['kernel']} M={r['M']} K={r['K']} N={r['N']} "
                      f"PK={r['PK']} {dtype}: max_abs_err="
                      f"{r['max_abs_err']:.3e} ok={r['ok']}{plan} "
                      f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                      f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']:.4f}", flush=True)
    grads = _phantom_grads(gen)
    bad = [r for r in results + grads if not r["ok"]]
    check(not bad, f"phantom kernels disagree with their plain versions or "
                   f"with themselves in {len(bad)} case(s): {bad}")
    for name in ("phantom_fused_matmul", "matmul_nt", "matmul_tn"):
        seen = {r["variant"] for r in results if r["kernel"] == name}
        check(seen == {"vec16", "masked"},
              f"{name}: the sweep ran variants {seen}, not both")
    cold = _phantom_cold(*PHANTOM_MAIN, gen)
    resident = {f"{k}_{es}": resident_table(0, k == "dgrad", es)
                for k in ("forward", "dgrad") for es in (4, 2)}
    print(f"split-contraction kernel, clusters of S blocks resident at "
          f"once, by S (forward/dgrad, float32 = 4, bfloat16 = 2): "
          f"{resident}", flush=True)
    wgrad = {f"{es}_{v}": wgrad_resident(0, es, v)
             for es in (4, 2) for v in ("vec16", "masked")}
    print(f"wgrad kernel, blocks resident at once (element size_variant): "
          f"{wgrad}", flush=True)
    return {"sweep": results, "grads": grads, "cold": cold,
            "resident_clusters": resident, "wgrad_resident_blocks": wgrad}


def _adamw_step1(params, grads, lr, eps):
    """AdamW's first step at weight decay 0, in the tensors' own dtype:
    the bias-corrected moments are g and g^2, so p - lr * g / (|g| + eps)."""
    from repro_torch.parallel.params import tree_leaves, tree_unflatten
    g = dict(tree_leaves(grads))
    return tree_unflatten(params, {
        path: p - lr * g[path] / (g[path].abs() + eps)
        for path, p in tree_leaves(params)})


def _step1_diff(res, part, lr, eps):
    """Kernel path against plain path for one part of step 1 (``loss``,
    ``grads`` or ``params``): the worst absolute difference, the worst
    difference over its leaf's largest magnitude, the elements outside
    rtol 1e-4 / atol 1e-5, and each path's worst difference from the
    plain path run in float64 (``*_vs_f64``; ``kernel_vs_f64_scaled``
    over the leaf's largest float64 magnitude).

    AdamW's first step moves a parameter by ``lr * f(g)`` with
    ``f(g) = g / (|g| + eps)``, whose slope ``eps / (|g| + eps)^2``
    reaches ``1 / eps`` at g = 0: there a float32 gradient difference of
    1e-10 moves the parameter by ~3e-5.  A parameter whose gradient lies
    within ``ADAM_NEAR_ZERO`` (10 eps) of zero on either path
    (``near_zero_grad``) is held to the tolerance plus what its two
    gradients imply, ``lr * |f(g_kernel) - f(g_plain)|`` in float64
    (``max_implied_near_zero_grad``); every other parameter is held to
    the tolerance alone, and ``max_abs_err`` covers those only.  The
    ``*_vs_f64_near_zero_grad`` entries show how far each float32 path
    is from float64 there.  ``zero_in_one_path`` counts gradients that
    are exactly zero on one path only (a ReLU that switched)."""
    from repro_torch.parallel.params import tree_leaves

    def flat(tree):
        return dict(tree_leaves(tree)) if isinstance(tree, dict) \
            else {"": tree}

    def worst(t, mask=None):
        t = t if mask is None else t[mask]
        return t.max().item() if t.numel() else 0.0
    kern, plain, f64 = (flat(res[run][part])
                        for run in ("kernel", "plain", "float64"))
    gk, gp = flat(res["kernel"]["grads"]), flat(res["plain"]["grads"])
    out = {"max_abs_err": 0.0, "max_scaled_err": 0.0, "outside": 0,
           "elements": 0, "kernel_vs_f64": 0.0,
           "kernel_vs_f64_scaled": 0.0, "plain_vs_f64": 0.0}
    if part == "grads":
        out["zero_in_one_path"] = 0
    if part == "params":
        out.update(near_zero_grad=0, max_abs_err_near_zero_grad=0.0,
                   max_implied_near_zero_grad=0.0,
                   kernel_vs_f64_near_zero_grad=0.0,
                   plain_vs_f64_near_zero_grad=0.0)
    for path, t in kern.items():
        u, w = plain[path].double(), f64[path]
        d = (t.double() - u).abs()
        tol = STEP1_TOL["atol"] + STEP1_TOL["rtol"] * u.abs()
        ek, ep = (t.double() - w).abs(), (u - w).abs()
        if part == "grads":
            out["zero_in_one_path"] += int(
                ((t == 0) != (plain[path] == 0)).sum())
        if part == "params":
            a, b = gk[path].double(), gp[path].double()
            near = (a.abs() < ADAM_NEAR_ZERO) | (b.abs() < ADAM_NEAR_ZERO)
            implied = lr * (a / (a.abs() + eps) - b / (b.abs() + eps)).abs()
            tol = tol + implied * near
            out["near_zero_grad"] += int(near.sum())
            for key, v in (("max_abs_err", d), ("max_implied", implied),
                           ("kernel_vs_f64", ek), ("plain_vs_f64", ep)):
                key += "_near_zero_grad"
                out[key] = max(out[key], worst(v, near))
            d = d * ~near
        out["outside"] += int((d > tol).sum())
        out["elements"] += d.numel()
        out["max_abs_err"] = max(out["max_abs_err"], worst(d))
        out["max_scaled_err"] = max(out["max_scaled_err"], worst(d) / max(
            u.abs().max().item(), 1e-30))
        out["kernel_vs_f64"] = max(out["kernel_vs_f64"], worst(ek))
        out["kernel_vs_f64_scaled"] = max(
            out["kernel_vs_f64_scaled"],
            worst(ek) / max(w.abs().max().item(), 1e-30))
        out["plain_vs_f64"] = max(out["plain_vs_f64"], worst(ep))
    return out


def _train_rank(axes, device, smoke=False, table1_steps=TABLE1["max_steps"]):
    """The train phase inside one rank (``launch/mesh.py: spawn``).
    ``smoke`` takes the configs' CPU geometry, for a rehearsal with
    ``device="cpu"``."""
    import gc
    import torch
    from repro_torch.benchmarks.table1_energy import table1_config
    from repro_torch.core.ffn import ffn_loss_and_grads, init_ffn, local_batch
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.launch.train_ffn import (BATCH, LR, SEED, train_config,
                                              train_rank)
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import tree_map

    comm = axes.world_comm
    out = {"rank": axes.rank, "backend": comm.backend,
           "via_host": comm.via_host}
    kcfg, xcfg = (train_config(TRAIN_ARCH, smoke=smoke, impl="phantom",
                               kernel_backend=b) for b in ("pallas", "xla"))

    # step 1 through the kernels, through plain torch and through plain
    # torch in float64, from the same shards and batch
    opt = AdamW(LR, weight_decay=0.0)
    params, state = init_ffn(kcfg, axes, opt, SEED, device)
    x, y = TeacherDataset(kcfg.ffn_width, BATCH, SEED, device)(0)
    x, y = local_batch(x, axes), local_batch(y, axes)
    res = {}
    for name, cfg in (("kernel", kcfg), ("plain", xcfg)):
        loss, grads, _ = ffn_loss_and_grads(cfg, axes, params, x, y, BATCH)
        new_params, _ = opt.update(grads, state, params, 0)
        res[name] = {"loss": loss, "grads": grads, "params": new_params}
    p64 = tree_map(lambda t: t.double(), params)
    loss, grads, _ = ffn_loss_and_grads(xcfg, axes, p64, x.double(),
                                        y.double(), BATCH)
    res["float64"] = {"loss": loss, "grads": grads,
                      "params": _adamw_step1(p64, grads, LR, opt.eps)}
    out["step1"] = {part: _step1_diff(res, part, LR, opt.eps)
                    for part in ("loss", "grads", "params")}
    del res, params, p64, state, x, y
    gc.collect()
    torch.cuda.empty_cache()

    # --- the main path: counts from zero, read right after -------------
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    for k in kernels:
        k.launches = 0
    out["phantom"] = train_rank(axes, device, kcfg, TRAIN_STEPS)
    out["launches"] = {k.__name__: k.launches for k in kernels}
    torch.cuda.empty_cache()
    out["tensor"] = train_rank(
        axes, device, train_config(TRAIN_ARCH, smoke=smoke, impl="tensor"),
        TRAIN_STEPS)
    torch.cuda.empty_cache()

    out["table1"] = {}
    for impl, k in (("tensor", 4), ("phantom", 4), ("phantom", 8),
                    ("phantom", 16)):
        run = train_rank(axes, device, table1_config(impl, k),
                         table1_steps, TABLE1["target"])
        out["table1"]["tensor" if impl == "tensor" else k] = run["losses"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["energy"] = _energy_rank(axes, device, smoke)
    out["energy_s"] = time.perf_counter() - t0
    return out


def _energy_rank(axes, device, smoke=False):
    """The energy phase inside one rank: the ledger probe of the train
    config for ``tensor_col`` and phantom through the kernels
    (``ENERGY_STEPS`` metered steps each) and for phantom through plain
    torch (counted only).  Each run's kernel counts start at 0 and are
    read right after it."""
    import gc
    import torch
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.launch.train_ffn import BATCH, SEED, train_config
    from repro_torch.telemetry import measure_ffn_step

    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    out = {}
    for name, impl, backend, steps in (
            ("tensor_col", "tensor", "pallas", ENERGY_STEPS),
            ("phantom", "phantom", "pallas", ENERGY_STEPS),
            ("phantom_plain", "phantom", "xla", 0)):
        cfg = train_config(TRAIN_ARCH, smoke=smoke, impl=impl,
                           kernel_backend=backend)
        for k in kernels:
            k.launches = 0
        measured, predicted = measure_ffn_step(cfg, axes, BATCH, steps=steps,
                                               seed=SEED, device=device)
        out[name] = {"measured": measured, "predicted": predicted,
                     "steps": steps,
                     "launches": {k.__name__: k.launches for k in kernels}}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train(device="cuda", smoke=False,
                table1_steps=TABLE1["max_steps"]):
    import gc
    import math
    import torch
    from repro_torch.launch.mesh import backend_for, spawn
    world = TRAIN_DP * TRAIN_TP
    gc.collect()
    torch.cuda.empty_cache()
    backend = backend_for("cuda", world)
    print(f"train: {world} ranks (dp={TRAIN_DP}, tp={TRAIN_TP}) on "
          f"{torch.cuda.device_count()} card(s); backend {backend}"
          f"{', card tensors through the host' if backend == 'gloo' else ''}",
          flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_train_rank, TRAIN_DP, TRAIN_TP, device,
                  args=(smoke, table1_steps), timeout_s=900)
    wall = time.perf_counter() - t0
    for r in ranks:
        rk = r["rank"]
        print(f"train: rank {rk} step 1 kernel vs plain: {r['step1']}",
              flush=True)
        for part, diff in r["step1"].items():
            check(diff["outside"] == 0,
                  f"rank {rk}: step-1 {part} of the kernel path differ "
                  f"from the plain path in {diff['outside']} of "
                  f"{diff['elements']} elements: {diff}")
        # the gradients are ~1e-4 and below, so atol 1e-5 alone says
        # little: each leaf is also held to rtol 1e-4 of its largest one
        for key in ("max_scaled_err", "kernel_vs_f64_scaled"):
            check(r["step1"]["grads"][key] <= STEP1_TOL["rtol"],
                  f"rank {rk}: step-1 gradients of the kernel path differ "
                  f"by more than 1e-4 of the largest one ({key}): "
                  f"{r['step1']['grads']}")
        for name in ("phantom", "tensor"):
            losses = r[name]["losses"]
            check(all(math.isfinite(v) for v in losses),
                  f"rank {rk}: non-finite {name} loss")
            check(losses[-1] < losses[0],
                  f"rank {rk}: {name} loss did not fall: {losses}")
        for name, n in r["launches"].items():
            check(n == 2 * TRAIN_STEPS,
                  f"rank {rk}: {name} launched {n} times in {TRAIN_STEPS} "
                  f"steps of {TRAIN_ARCH} (want 2 per step)")
        for key, losses in r["table1"].items():
            check(all(math.isfinite(v) for v in losses),
                  f"rank {rk}: non-finite Table I loss ({key})")
    r0 = ranks[0]
    def worst(part, key):
        return max(r["step1"][part][key] for r in ranks)
    print(f"train: {TRAIN_ARCH} phantom step 1, kernel vs plain, worst over "
          f"ranks (held to rtol 1e-4 / atol 1e-5): loss "
          f"{worst('loss', 'max_abs_err'):.3e}, grads "
          f"{worst('grads', 'max_abs_err'):.3e} "
          f"({worst('grads', 'max_scaled_err'):.3e} of the largest), params "
          f"{worst('params', 'max_abs_err'):.3e}; gradients within 10 eps "
          f"of zero: {worst('params', 'near_zero_grad')} params per rank "
          f"at most, differing by up to "
          f"{worst('params', 'max_abs_err_near_zero_grad'):.3e} (their "
          f"gradients imply up to "
          f"{worst('params', 'max_implied_near_zero_grad'):.3e}; from "
          f"float64 the kernel path differs there by up to "
          f"{worst('params', 'kernel_vs_f64_near_zero_grad'):.3e}, the "
          f"plain path by up to "
          f"{worst('params', 'plain_vs_f64_near_zero_grad'):.3e}); kernel "
          f"path vs float64: grads "
          f"{worst('grads', 'kernel_vs_f64_scaled'):.3e} of the largest, "
          f"params {worst('params', 'kernel_vs_f64'):.3e}", flush=True)
    for name in ("phantom", "tensor"):
        med = [statistics.median(r[name]["step_s"]) * 1e3 for r in ranks]
        losses = r0[name]["losses"]
        print(f"train: {TRAIN_ARCH} {name} {TRAIN_STEPS} steps, loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; per-rank step-time "
              f"median (8 ranks time-sharing one card) "
              f"{', '.join(f'{m:.2f}' for m in med)} ms", flush=True)
    print(f"train: launches per rank over {TRAIN_STEPS} steps: "
          f"{r0['launches']} (all ranks equal: "
          f"{all(r['launches'] == r0['launches'] for r in ranks)})")
    table1 = {}
    for key, losses in r0["table1"].items():
        hit = losses[-1] <= TABLE1["target"]
        table1[str(key)] = len(losses) if hit else None
        label = "TP" if key == "tensor" else f"PP k={key}"
        print(f"train: Table I mini-run {label}: "
              f"{len(losses) if hit else 'not reached in ' + str(len(losses))}"
              f" iterations to loss <= {TABLE1['target']} (reference: "
              f"{TABLE1_REFERENCE[key]}; other data and initial weights)")
    print(f"train: phase wall {wall:.1f} s")
    return {"ranks": ranks, "table1_iterations": table1, "wall_s": wall,
            "backend": backend}


RATIO_KEYS = ("flops_per_device", "collective_wire_bytes_per_device",
              "collective_m_floats", "energy_j_per_iter")


def phase_energy(train, smi):
    """Hold and print the ranks' ledger probes (``_energy_rank``), price
    the Table I run's iteration counts, write the ledger."""
    from repro_torch.benchmarks import table1_energy
    from repro_torch.telemetry import Ledger, LedgerEntry
    ranks = train["ranks"]
    probe_steps = 1 + 1 + ENERGY_STEPS     # counted, warm-up, metered
    for r in ranks:
        rk, e = r["rank"], r["energy"]
        for name, pin in FLOPS_PIN.items():
            m, pr = e[name]["measured"], e[name]["predicted"]
            for key in ("collective_wire_bytes_per_device",
                        "collective_m_floats"):
                check(abs(m[key] / pr[key] - 1) <= 0.02,
                      f"rank {rk}: {name} {key} measured {m[key]} vs "
                      f"predicted {pr[key]}: ratio outside 1.00 +- 2%")
            ratio = m["flops_per_device"] / pr["flops_per_device"]
            check(abs(ratio - 1) <= pin and ratio >= 0.99,
                  f"rank {rk}: {name} flops ratio {ratio:.4f} outside "
                  f"[0.99, {1 + pin}]")
        kernel, plain = (e[n]["measured"] for n in ("phantom",
                                                    "phantom_plain"))
        check(kernel["flops_per_device"] == plain["flops_per_device"],
              f"rank {rk}: the kernel path counts "
              f"{kernel['flops_per_device']} flops, the plain path "
              f"{plain['flops_per_device']}")
        for name, launches in e["phantom"]["launches"].items():
            check(launches == 2 * probe_steps,
                  f"rank {rk}: {name} launched {launches} times in "
                  f"{probe_steps} probe steps (want 2 per step)")
        for name in ("tensor_col", "phantom_plain"):
            check(not any(e[name]["launches"].values()),
                  f"rank {rk}: {name} launched a phantom kernel: "
                  f"{e[name]['launches']}")

    ledger = Ledger(run="chip_smoke", meta={"card": smi,
                                           "arch": TRAIN_ARCH})
    e0 = ranks[0]["energy"]
    for name in ("tensor_col", "phantom", "phantom_plain"):
        m, pr = e0[name]["measured"], e0[name]["predicted"]
        entry = ledger.record(LedgerEntry(
            name=f"chip_smoke_energy_{name}", suite="chip_smoke",
            kind="train", arch=TRAIN_ARCH, impl=pr["strategy"], p=TRAIN_TP,
            measured=m, predicted=pr,
            extra={"dp": TRAIN_DP, "tp": TRAIN_TP,
                   "kernel_backend": "xla" if name == "phantom_plain"
                   else "pallas", "metered_steps": e0[name]["steps"],
                   "launches": e0[name]["launches"],
                   "wall_us_median_by_rank": [
                       r["energy"][name]["measured"].get("wall_us_median")
                       for r in ranks]}))
        ratios = entry.ratios()
        print(f"energy: {TRAIN_ARCH} {name} (rank 0), measured / predicted "
              f"/ ratio: " + "; ".join(
                  f"{k} {m[k]:.6g} / {pr[k]:.6g} / {ratios[k]:.6f}"
                  for k in RATIO_KEYS), flush=True)
        print(f"energy: {name} alpha_s {m['alpha_s']:.6g} (predicted "
              f"{pr['alpha_s']:.6g}), beta_s {m['beta_s']:.6g} (predicted "
              f"{pr['beta_s']:.6g}); collectives " + "; ".join(
                  f"{op} x{rec['count']} issued as {rec['issued_as']}"
                  for op, rec in m["collectives"].items()))
        if e0[name]["steps"]:
            print(f"energy: {name} probe step wall median per rank "
                  f"(8 ranks time-sharing one card, gloo through the host) "
                  + ", ".join(f"{w / 1e3:.2f}" for w in
                              entry.extra["wall_us_median_by_rank"])
                  + " ms", flush=True)
    print(f"energy: phantom launches per rank in {probe_steps} probe steps: "
          f"{e0['phantom']['launches']}; kernel path flops == plain path "
          f"flops on all ranks")
    pe, pt = (e0[n]["predicted"]["energy_j_per_iter"]
              for n in ("phantom", "tensor_col"))
    me, mt = (e0[n]["measured"]["energy_j_per_iter"]
              for n in ("phantom", "tensor_col"))
    print(f"energy: phantom / tensor_col energy per iteration, predicted "
          f"{pe / pt:.4f}, measured {me / mt:.4f} (paper's model, Frontier "
          f"A/B, alpha at the H100 fp32 peak; not power read from the card)")

    iters = {("tensor" if key == "tensor" else int(key)): len(losses)
             for key, losses in ranks[0]["table1"].items()}
    rows = table1_energy.run(ledger, iters)
    for row in rows:
        print(f"energy: Table I priced, p={row['p']} k={row['k']}: E_tp "
              f"{row['energy_j_tp']:.1f} J, E_pp {row['energy_j_pp']:.1f} J, "
              f"saving {row['saving_fraction'] * 100:.1f}% (iterations "
              f"{iters})", flush=True)
    path = ledger.write_report(ROOT / "build" / "chip_smoke_ledger.json")
    print(f"energy: ledger written to {path}; the probes took "
          f"{max(r['energy_s'] for r in ranks):.1f} s in the ranks")
    return ledger.report()


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
    flash = phase_kernels()
    phantom = phase_phantom_kernels()
    serve = phase_serve()
    train = phase_train()
    ledger = phase_energy(train, device["nvidia_smi"])

    sweep = flash["sweep"]
    at = {S: next(r for r in sweep if all(
        r[k] == v for k, v in {**MAIN_SHAPE, "S": S}.items()))
        for S in (48, 512)}
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep),
        **{key: at[48][key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "cold_ms": flash["cold"][48]["cold_ms"],
        "s512": {**{key: at[512][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cold_ms": flash["cold"][512]["cold_ms"]}}]
    lines = {"phantom_fused_matmul": 118, "matmul_nt": 206, "matmul_tn": 239}
    for name, line in lines.items():
        cases = [r for r in phantom["sweep"] if r["kernel"] == name]
        main_r = next(r for r in cases if r["dtype"] == "float32" and
                      (r["M"], r["K"], r["N"], r["PK"]) == PHANTOM_MAIN)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/phantom_fused.cu",
            "replaces": f"src/repro/kernels/phantom_fused.py:{line}",
            "launches": train["ranks"][0]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main_r["ms"], "plain_ms": main_r["plain_ms"],
            "bound_ms": main_r["bound_ms"], "bound_by": main_r["bound_by"],
            "library_ms": main_r["library_ms"],
            "cold_ms": phantom["cold"][name]["cold_ms"]})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"device": device, "flash": flash, "phantom": phantom,
         "serve": serve, "train": train, "ledger": ledger,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
