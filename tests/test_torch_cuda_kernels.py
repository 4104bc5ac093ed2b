"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it runs where the
card is and JAX is not.  ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Every test needs a card (``cuda`` marker) and skips without one.
Inputs come from numpy seeds.  Tolerances: the phantom kernels float32
2e-4, bf16 2e-2 (the reference's kernel tests); flash attention float32
rtol 2e-3 / atol 2e-4.  bf16 flash attention is held to the float32
plain version on the same bf16 inputs, each output within 1e-2 of
sum_j p_j |v_j|, the size of its weighted sum (``_flash_close``): P
rounded to bf16 and the rounded output each err by at most 2^-8 of it.
Its scores are peaked (std 2), so an output is not a near-uniform mean
of V, and a planted fault in the kernel (a kv tile skipped, or loaded
into the buffer being read) must fail the check.  The phantom products'
bf16 tensor-core kernels (``wgmma_*_kernel``) are held likewise at every
LM site's shape and at ragged ones, every tile shape's instance at every
split it can run, and a fault planted in them (a wrong swizzle in the
wgmma descriptors, a dropped k-step, a split rank dropped from the sum)
must fail theirs.
"""
import ctypes
import subprocess

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import build
from repro_torch.kernels import phantom_fused as pf
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (flash_attention_ref, matmul_nt_ref,
                                     matmul_tn_ref, phantom_fused_ref)

PHANTOM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FLASH_TOL_F32 = dict(rtol=2e-3, atol=2e-4)
FLASH_TOL_BF16 = 1e-2      # of sum_j p_j |v_j|

# (M, K, N, PK): the reference's sweeps (tests/test_kernels.py:13-19 and
# :108-114), the Table I mini-run's per-rank shapes (n=1024, p=8) and
# 8-row microbatches of a pipeline stage
PHANTOM_SHAPES = [
    (128, 128, 128, 64), (256, 128, 128, 128), (128, 256, 384, 32),
    (512, 128, 256, 256), (128, 512, 128, 16),
    (192, 128, 128, 64), (192, 192, 192, 48), (100, 72, 56, 24),
    (130, 257, 129, 65), (128, 128, 300, 64),
    (64, 128, 128, 32), (64, 128, 128, 128),
    (8, 128, 128, 32), (8, 256, 192, 16),
]
PHANTOM_BF16_SHAPES = [(128, 128, 128, 64), (100, 72, 56, 24),
                       (130, 257, 129, 65), (64, 128, 128, 32),
                       (8, 128, 128, 32)]
PHANTOM_MAIN = (64, 2048, 2048, 128)
# a stage's microbatch of paper-ffn-16k at pipe 2 x dp 2 x tp 2, M = 4:
# 64 / (2 * 4) rows, n / tp = 8192, k * tp = 32
PHANTOM_PIPE = (8, 8192, 8192, 32)

# (B, S, H, KV, hd): GQA groups of 1, 2 and 16; hd 16 to 128, among them
# stablelm-3b's 80 and phi3-mini's 96 (MHA, up to its training length)
FLASH_SHAPES = [
    (2, 16, 4, 4, 16),
    (2, 128, 4, 4, 80),
    (1, 100, 8, 4, 80),
    (2, 70, 4, 4, 96),
    (1, 512, 8, 8, 96),
    (1, 48, 4, 2, 16),
    (1, 128, 4, 2, 16),
    (2, 16, 32, 2, 128),
    (1, 48, 32, 2, 128),
    (1, 128, 16, 1, 128),
    (1, 100, 8, 2, 64),
    (2, 70, 4, 1, 32),
    # seamless-m4t-large-v2 (hd 64): serving's prompts, a rank's at tp 4
    (4, 48, 16, 16, 64),
    (4, 512, 4, 4, 64),
]
# qwen2-vl-72b's MLP a rank at tp 4 (d_ff / tp = 7392, k 32 x 4): the
# first N (and down's contraction) that the 64-wide tiles do not divide
PHANTOM_RAGGED = [(256, 512, 7392, 128), (256, 7392, 512, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) to run the CUDA kernels")
    return torch.device("cuda")


def _arrays(seed, *shapes, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _on(arrs, dtype, device):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrs]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol, err_msg=msg)


def _phantom_cases():
    return ([(s, "float32") for s in PHANTOM_SHAPES]
            + [(s, "bfloat16") for s in PHANTOM_BF16_SHAPES])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset",
                         [c + (0,) for c in _phantom_cases()]
                         + [(PHANTOM_MAIN, "float32", 0),
                            (PHANTOM_PIPE, "float32", 0),
                            ((64, 256, 192, 32), "float32", 1),
                            ((8, 256, 192, 32), "float32", 1)]
                         + [(s, dt, 0) for s in PHANTOM_RAGGED
                            for dt in ("float32", "bfloat16")])
def test_cuda_kernels_match_plain(cuda_device, shape, dtype, offset):
    """Each phantom kernel launches once, agrees with its plain version
    and gives the same bits on a second launch.  ``offset`` 1: every
    operand is a column view one element into a wider tensor (unaligned:
    the masked variants)."""
    M, K, N, PK = shape
    x, L, g, D, dz = [t[:, offset:] for t in _on(_arrays(
        M + N, (M, K + offset), (K, N + offset), (M, PK + offset),
        (PK, N + offset), (M, N + offset)), dtype, cuda_device)]
    if offset:
        assert pf.forward_plan(x, L, g, D).variant == "masked"
        assert pf.dgrad_plan(dz, L, D).variant == "masked"
        assert pf.tn_plan(x, dz, g).variant == "masked"
    before = (pf.phantom_fused_matmul.launches, pf.matmul_nt.launches,
              pf.matmul_tn.launches)
    got = (pf.phantom_fused_matmul(x, L, g, D), pf.matmul_nt(dz, L, D),
           pf.matmul_tn(x, dz, g))
    torch.cuda.synchronize()
    assert (pf.phantom_fused_matmul.launches, pf.matmul_nt.launches,
            pf.matmul_tn.launches) == tuple(b + 1 for b in before)
    want = (phantom_fused_ref(x, L, g, D),
            matmul_nt_ref(dz, torch.cat([L, D])),
            matmul_tn_ref(torch.cat([x, g], 1), dz))
    for name, a, b in zip(("forward", "dgrad", "wgrad"), got, want):
        _close(a, b, PHANTOM_TOL[dtype], name)
    again = (pf.phantom_fused_matmul(x, L, g, D), pf.matmul_nt(dz, L, D),
             pf.matmul_tn(x, dz, g))
    for name, a, b in zip(("forward", "dgrad", "wgrad"), got, again):
        assert torch.equal(a, b), f"{name}: two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [(s, 0) for s in PHANTOM_SHAPES]
                         + [(PHANTOM_MAIN, 0), (PHANTOM_PIPE, 0),
                            ((64, 256, 192, 32), 1),
                            ((130, 257, 129, 65), 1)])
def test_cuda_kernels_counted_by_formula(cuda_device, shape, offset):
    """``FlopCounterMode`` counts each kernel, called through its
    dispatcher operator, by its formula (2MN(K+PK), 2MJN, 2INM), while
    the kernel itself launches (once each) and agrees with its plain
    version.  ``offset`` 1: unaligned column views (the masked
    variants)."""
    M, K, N, PK = shape
    x, L, g, D, dz = [t[:, offset:] for t in _on(_arrays(
        M + N + 1, (M, K + offset), (K, N + offset), (M, PK + offset),
        (PK, N + offset), (M, N + offset)), "float32", cuda_device)]
    ops = torch.ops.repro_torch
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    before = [k.launches for k in kernels]
    with FlopCounterMode(display=False) as counter:
        got = (ops.phantom_fused_matmul(x, L, g, D), ops.matmul_nt(dz, L, D),
               ops.matmul_tn(x, dz, g))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.phantom_fused_matmul": 2 * M * N * (K + PK),
                      "repro_torch.matmul_nt": 2 * M * (K + PK) * N,
                      "repro_torch.matmul_tn": 2 * (K + PK) * N * M}
    want = (phantom_fused_ref(x, L, g, D),
            matmul_nt_ref(dz, torch.cat([L, D])),
            matmul_tn_ref(torch.cat([x, g], 1), dz))
    for name, a, b in zip(("forward", "dgrad", "wgrad"), got, want):
        _close(a, b, PHANTOM_TOL["float32"], name)


# (M, K, N, PK) of the bf16 LM sites a rank runs (PERF.md rows b-n):
# phi3-mini at tp 4, qwen2.5-14b at tp 4, phi3-mini's microbatch at pp 2
# x tp 2, olmoe, mamba2, phi3-mini under FSDP, jamba, qwen2-vl, seamless,
# chatglm3-6b's served rows (4 and 192), the narrow served sites, and
# phi3-mini under the planner's winner; gate/up then down
LM_SITES = [
    (2048, 768, 2048, 48), (2048, 2048, 768, 48),
    (2048, 1280, 3456, 64), (2048, 3456, 1280, 64),
    (512, 1536, 4096, 24), (512, 4096, 1536, 24),
    (2048, 512, 512, 32),
    (2048, 256, 512, 32), (2048, 512, 256, 32),
    (1024, 1536, 4096, 24), (1024, 4096, 1536, 24),
    (2048, 2048, 6144, 128), (2048, 6144, 2048, 128),
    (2048, 2048, 7392, 128), (2048, 7392, 2048, 128),
    (2048, 256, 2048, 32), (2048, 2048, 256, 32),
    (4, 1024, 3424, 64), (4, 3424, 1024, 64),
    (192, 1024, 3424, 64), (192, 3424, 1024, 64),
    (4, 512, 512, 32), (192, 256, 2048, 32), (4, 2048, 6144, 128),
    (192, 2048, 7392, 128),
    (2048, 1536, 1536, 8), (2048, 1536, 4096, 8), (2048, 4096, 1536, 8),
]
# ragged: no side a multiple of a tile, one-slab and sub-slab contractions,
# PK below a wgmma's narrowest N, a part of C of fewer rows than a
# warpgroup
WG_RAGGED = [(300, 200, 264, 8), (300, 264, 200, 16), (130, 136, 72, 24),
             (70, 136, 520, 48), (384, 200, 600, 24), (640, 640, 520, 48),
             (64, 64, 64, 8), (1, 8, 8, 8), (2176, 1024, 6216, 8)]


def _wgmma_products(shape, device, seed=0):
    """The three products on aligned bf16 operands of ``shape``, each
    with its plan and plain version."""
    M, K, N, PK = shape
    x, L, g, D, dz = _on(_arrays(seed, (M, K), (K, N), (M, PK), (PK, N),
                                 (M, N)), "bfloat16", device)
    return {
        "forward": (lambda: pf.phantom_fused_matmul(x, L, g, D),
                    lambda: phantom_fused_ref(x, L, g, D),
                    pf.forward_plan(x, L, g, D)),
        "dgrad": (lambda: pf.matmul_nt(dz, L, D),
                  lambda: matmul_nt_ref(dz, torch.cat([L, D])),
                  pf.dgrad_plan(dz, L, D)),
        "wgrad": (lambda: pf.matmul_tn(x, dz, g),
                  lambda: matmul_tn_ref(torch.cat([x, g], 1), dz),
                  pf.tn_plan(x, dz, g)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LM_SITES + WG_RAGGED)
def test_wgmma_kernels_match_plain(cuda_device, shape):
    """Each product's bf16 tensor-core kernel at an LM site's shape or a
    ragged one: the plan takes the wgmma route, the kernel launches once,
    agrees with the plain version within 2e-2 and gives the same bits on
    a second launch."""
    counters = {"forward": pf.phantom_fused_matmul, "dgrad": pf.matmul_nt,
                "wgrad": pf.matmul_tn}
    for kind, (kern, plain, plan) in _wgmma_products(
            shape, cuda_device, seed=sum(shape)).items():
        assert plan.variant == "wgmma" and plan.kernel.startswith("wgmma_")
        before = counters[kind].launches
        got = kern()
        torch.cuda.synchronize()
        assert counters[kind].launches == before + 1, kind
        _close(got, plain(), PHANTOM_TOL["bfloat16"], f"{kind} {shape}")
        assert torch.equal(got, kern()), f"{kind} {shape}: launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,k,p", [
    (512, 768, 2048, 12, 4),    # phi3-mini at tp 4's gate/up, a microbatch
    (2048, 2048, 768, 12, 4),   # its down projection
    (256, 1024, 3424, 16, 4),   # chatglm3-6b's gate/up at tp 4
    (200, 136, 520, 8, 3),      # ragged
])
def test_fused_linear_grads_through_the_wgmma_route(cuda_device, M, K, N,
                                                    k, p):
    """``phantom_fused_linear`` on aligned bf16 card tensors: its forward,
    dgrad and wgrad each launch their wgmma kernel once, and the loss and
    gradients hold autograd through the plain version within 6e-2 (the
    reference's bf16 gradient tolerance) of each value, relative to the
    tensor's largest."""
    from repro_torch.kernels.ops import phantom_fused_linear
    base = _on(_arrays(M + K, (M, K), (K, N), (M, p * k), (p * k, N)),
               "bfloat16", cuda_device)
    assert pf.forward_plan(*base).variant == "wgmma"
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    res = {}
    for name, fn in (("kernel", phantom_fused_linear),
                     ("plain", phantom_fused_ref)):
        ins = [t.clone().requires_grad_(True) for t in base]
        before = [kk.launches for kk in kernels]
        loss = fn(*ins).float().square().sum()
        grads = torch.autograd.grad(loss, ins)
        torch.cuda.synchronize()
        assert [kk.launches - b for kk, b in zip(kernels, before)] == (
            [1, 1, 1] if name == "kernel" else [0, 0, 0])
        res[name] = (loss, grads)
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    torch.testing.assert_close(lk, lp, rtol=6e-2, atol=0)
    for name, a, b in zip(("dx", "dL", "dg", "dD"), gk, gp):
        assert a.dtype == torch.bfloat16, name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 6e-2 * scale, (name, err, scale)


# M of the instances' sweep: one row, a decode step's 4, a stage's 8,
# either side of a consumer warpgroup's 64, a prefill group's 192 and an
# LM batch's 2,048
INSTANCE_ROWS = [1, 4, 8, 63, 64, 65, 192, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("M", INSTANCE_ROWS)
@pytest.mark.parametrize("shape", pf.WG_SHAPES)
def test_every_wgmma_instance_matches_plain(cuda_device, shape, M):
    """Each tile shape's forward and dgrad instance at every split it can
    run (``wg_candidates``), forced through the wrappers' launch helpers,
    at narrow K and N (384, 448: ragged 64- and 128-wide tiles), PK 24
    (D's narrow tiles, the forward's second segment): within 2e-2 of the
    plain version and the same bits on a second launch.  At M below the
    tile's BM every split sums a tile of fewer real rows than BM."""
    K, N, PK = 384, 448, 24
    x, L, g, D, dz = _on(_arrays(M + shape[1], (M, K), (K, N), (M, PK),
                                 (PK, N), (M, N)), "bfloat16", cuda_device)
    runs = {"forward": (((M,), (N,), (K, PK)),
                        lambda p: pf._launch_forward(x, L, g, D, p),
                        phantom_fused_ref(x, L, g, D)),
            "dgrad": (((M,), (K, PK), (N,)),
                      lambda p: pf._launch_nt(dz, L, D, p),
                      matmul_nt_ref(dz, torch.cat([L, D])))}
    for kind, (parts, launch, want) in runs.items():
        resident = pf._wg_resident(kind, x)
        plans = [p for p in pf.wg_candidates(*parts, kind == "dgrad",
                                             resident)
                 if (p.bm, p.bn) == shape]
        assert plans and plans[0].splits == 1, kind
        if M < shape[0]:
            assert any(p.splits > 1 for p in plans), kind
        for plan in plans:
            got = launch(plan)
            torch.cuda.synchronize()
            _close(got, want, PHANTOM_TOL["bfloat16"],
                   f"{kind} {shape} S={plan.splits} M={M}")
            assert torch.equal(got, launch(plan)), \
                f"{kind} {shape} S={plan.splits} M={M}: launches differ"


# A fault planted in a copy of the wgmma kernels: the source text and
# what replaces it
WG_FAULTS = {
    # TMA copies the slabs unswizzled where the wgmma descriptors read
    # them 128-byte swizzled (every read stays inside the ring: a fault of
    # the numbers, not of the addresses)
    "wrong_swizzle": (
        "CU_TENSOR_MAP_SWIZZLE_128B,", "CU_TENSOR_MAP_SWIZZLE_NONE,"),
    # one of a slab's four 16-deep k-steps dropped
    "dropped_k_step": (
        "for (int kk = 0; kk < BK / 16; ++kk)\n    Wgmma<N, A_MN, B_MN>",
        "for (int kk = 0; kk < BK / 16 - 1; ++kk)\n    Wgmma<N, A_MN, B_MN>"),
}


# ... and one in the split's reduction alone: the rank-order sum of the
# partial tiles skips rank 0's
WG_SPLIT_FAULTS = {
    "dropped_split_rank": (
        "for (int q = 0; q < S; ++q) {   // rank order",
        "for (int q = 1; q < S; ++q) {   // rank order"),
}


@pytest.fixture(scope="module")
def faulty_phantom_libraries(tmp_path_factory):
    """The phantom source with each of ``WG_FAULTS`` and
    ``WG_SPLIT_FAULTS`` planted, built in parallel outside the
    checkout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) to run the CUDA kernels")
    src = (build.CSRC / "phantom_fused.cu").read_text()
    out = tmp_path_factory.mktemp("faulty_phantom")
    procs = {}
    for name, (old, new) in {**WG_FAULTS, **WG_SPLIT_FAULTS}.items():
        assert src.count(old) == 1, f"{name}: {old!r} not in the source"
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(src.replace(old, new))
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 1024, 64),
                                   (2048, 2048, 768, 48)])
@pytest.mark.parametrize("fault", sorted(WG_FAULTS))
def test_wgmma_check_sees_a_planted_fault(cuda_device,
                                          faulty_phantom_libraries,
                                          monkeypatch, fault, shape):
    """The 2e-2 check against the plain version fails each product of a
    kernel whose descriptors name the wrong swizzle or that drops one
    k-step in four, at a persistent grid and at a split one."""
    monkeypatch.setattr(build, "load",
                        lambda name: faulty_phantom_libraries[fault])
    for kind, (kern, plain, plan) in _wgmma_products(
            shape, cuda_device, seed=7).items():
        assert plan.variant == "wgmma"
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        diff = (got.float() - want.float()).abs()
        tol = 2e-2 + 2e-2 * want.float().abs()
        assert bool((diff > tol).any()), \
            f"{fault} {kind}: the check passed (max error {diff.max()})"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 512, 32), (4, 256, 512, 32),
                                   (192, 512, 512, 32)])
@pytest.mark.parametrize("fault", sorted(WG_SPLIT_FAULTS))
def test_wgmma_split_check_sees_a_dropped_rank(cuda_device,
                                               faulty_phantom_libraries,
                                               monkeypatch, fault, shape):
    """The 2e-2 check fails the forward and the dgrad of a kernel whose
    split reduction drops a rank's partial tile, where the plan splits a
    small tile (64 rows) at served sites of 4 and 192 rows."""
    monkeypatch.setattr(build, "load",
                        lambda name: faulty_phantom_libraries[fault])
    products = _wgmma_products(shape, cuda_device, seed=11)
    for kind in ("forward", "dgrad"):
        kern, plain, plan = products[kind]
        assert plan.splits > 1 and plan.bm == 64, (kind, plan)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        diff = (got.float() - want.float()).abs()
        tol = 2e-2 + 2e-2 * want.float().abs()
        assert bool((diff > tol).any()), \
            f"{fault} {kind}: the check passed (max error {diff.max()})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["vec16", "masked"])
@pytest.mark.parametrize("M,I0,I1,N,resident", [
    (64, 2048, 128, 2048, None),   # main shape: 1088 tiles, 3 rounds
    (64, 256, 128, 256, None),     # small output: 24 tiles, one round
    (40, 120, 16, 136, None),      # ragged edges in rows, cols and k
    (64, 512, 128, 640, 12),       # 100 tiles on 12 blocks: 9 rounds
    (72, 256, 16, 264, 5),         # 25 ragged tiles on 5: 5 full rounds
    (64, 192, 64, 200, 7),         # 16 tiles on 7: a last round of 2
])
def test_wgrad_grid_and_variants(cuda_device, monkeypatch, M, I0, I1, N,
                                 resident, variant, dtype):
    """``matmul_tn`` at the main shape, on small outputs, at tile edges,
    and on small grids (``resident``: the card made to hold that many
    blocks, so that tiles go round several times; a third of that for
    the wgmma kernel's larger tiles) in both variants (aligned bf16: the
    wgmma route): within tolerance of the plain version and the same
    bits on a second launch."""
    if resident is not None:
        monkeypatch.setattr(pf, "_wgrad_resident", lambda t, v: resident)
        monkeypatch.setattr(pf, "_wg_resident", lambda product, t: {
            shape: {s: max(1, resident // 3) for s in range(1, 9)}
            for shape in pf.WG_SHAPES})
    off = 0 if variant == "vec16" else 1
    x, g, dz = [t[:, off:] for t in _on(_arrays(
        M + I0 + N, (M, I0 + off), (M, I1 + off), (M, N + off)), dtype,
        cuda_device)]
    plan = pf.tn_plan(x, dz, g)
    assert plan.variant == ("wgmma" if (dtype, variant) == ("bfloat16",
                                                            "vec16")
                            else variant)
    if resident is not None or (M, I0) == (64, 2048):
        assert plan.rounds > 1
    before = pf.matmul_tn.launches
    got = pf.matmul_tn(x, dz, g)
    torch.cuda.synchronize()
    assert pf.matmul_tn.launches == before + 1
    _close(got, matmul_tn_ref(torch.cat([x, g], 1), dz), PHANTOM_TOL[dtype])
    assert torch.equal(got, pf.matmul_tn(x, dz, g)), "two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("pp", [1, 2])
def test_card_shards_equal_the_host_draw(cuda_device, pp):
    """The parameters and probe batch a rank draws for a card run are
    its CPU run's bit for bit: both are cut from one draw on the host."""
    from repro_torch.configs.base import PipelineConfig, get_config
    from repro_torch.core.ffn import ffn_decls, init_ffn
    from repro_torch.optim import AdamW
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    from repro_torch.telemetry.probe import probe_inputs
    cfg = get_config("paper-ffn-16k", smoke=True).replace(
        pipeline=PipelineConfig(stages=pp), microbatches=2)
    axes = MeshAxes(pp=pp, dp=2, tp=2, pp_rank=pp - 1, dp_rank=1, tp_rank=1)
    decls = ffn_decls(cfg, axes)
    runs = {dev: (init_ffn(cfg, axes, AdamW(1e-3), 5, dev)[0],
                  probe_inputs(cfg, axes, decls, 16, 5, dev))
            for dev in ("cpu", cuda_device)}
    (p_cpu, (q_cpu, x_cpu, y_cpu)), (p_card, (q_card, x_card, y_card)) = \
        runs["cpu"], runs[cuda_device]
    for tree_cpu, tree_card in ((p_cpu, p_card), (q_cpu, q_card)):
        for (path, a), (_, b) in zip(tree_leaves(tree_cpu),
                                     tree_leaves(tree_card)):
            assert b.device.type == "cuda"
            assert torch.equal(a, b.cpu()), path
    assert torch.equal(x_cpu, x_card.cpu()) and torch.equal(y_cpu,
                                                            y_card.cpu())


def _flash_inputs(B, S, H, KV, hd, dtype, device, seed=0):
    """q, k, v with scores q.k / sqrt(hd) of std 2."""
    rng = np.random.RandomState(seed)
    return _on([(rng.randn(*shape) * scale).astype(np.float32)
                for shape, scale in (((B, S, H, hd), 2.0),
                                     ((B, S, KV, hd), 1.0),
                                     ((B, S, KV, hd), 0.5))],
               dtype, device)


def _flash_close(got, q, k, v, causal):
    """Whether the kernel's output holds its tolerance against the plain
    version: float32 rtol 2e-3 / atol 2e-4; bf16 1e-2 of sum_j p_j |v_j|
    against the float32 plain version on the same inputs.  Returns the
    verdict and the largest error (bf16: relative to that sum)."""
    if q.dtype == torch.float32:
        want = flash_attention_ref(q, k, v, causal=causal)
        diff = (got - want).abs()
        tol = FLASH_TOL_F32["atol"] + FLASH_TOL_F32["rtol"] * want.abs()
        return bool((diff <= tol).all()), diff.max().item()
    q, k, v = (t.float() for t in (q, k, v))
    want = flash_attention_ref(q, k, v, causal=causal)
    size = flash_attention_ref(q, k, v.abs(), causal=causal)
    rel = ((got.float() - want).abs() / size).max().item()
    return rel <= FLASH_TOL_BF16, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, B, S, H, KV, hd, causal,
                                   dtype):
    q, k, v = _flash_inputs(B, S, H, KV, hd, dtype, cuda_device,
                            seed=S + hd)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ok, err = _flash_close(got, q, k, v, causal)
    assert ok, f"max error {err}"


SERVING = dict(B=4, H=32, KV=2, hd=128)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [16, 48, 128, 512])
def test_bf16_flash_on_the_tensor_cores(cuda_device, S, causal):
    """The bf16 kernel at the serving geometry (B=4, H=32, KV=2, hd=128:
    the 16 query heads of a kv head share a block's rows), up to 8 kv
    tiles: within tolerance of the plain version."""
    q, k, v = _flash_inputs(S=S, dtype="bfloat16", device=cuda_device,
                            seed=S, **SERVING)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ok, err = _flash_close(got, q, k, v, causal)
    assert ok, f"max error {err} of sum p|v|"


# A fault planted in a copy of the bf16 kernel: the source text and what
# replaces it
FAULTS = {
    "kv_tile_2_skipped": (
        "if (!warp_idle && !(causal && k0 > wpos_hi)) {",
        "if (t != 2 && !warp_idle && !(causal && k0 > wpos_hi)) {"),
    "next_tile_into_the_buffer_being_read": (
        "load_kv(t + 1, buf ^ 1);", "load_kv(t + 1, buf);"),
}


@pytest.fixture(scope="module")
def faulty_libraries(tmp_path_factory):
    """The flash source with each of ``FAULTS`` planted, built in
    parallel outside the checkout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) to run the CUDA kernels")
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = tmp_path_factory.mktemp("faulty")
    procs = {}
    for name, (old, new) in FAULTS.items():
        assert src.count(old) == 1, f"{name}: {old!r} not in the source"
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(src.replace(old, new))
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bf16_flash_check_sees_a_planted_fault(cuda_device, faulty_libraries,
                                               monkeypatch, fault):
    """The bf16 check at S = 512 (8 kv tiles, both K/V buffers reused)
    fails a kernel with a kv tile skipped or with the next tile copied
    into the buffer being read."""
    q, k, v = _flash_inputs(S=512, dtype="bfloat16", device=cuda_device,
                            seed=512, **SERVING)
    monkeypatch.setattr(build, "load", lambda name: faulty_libraries[fault])
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ok, err = _flash_close(got, q, k, v, True)
    assert not ok, f"{fault}: the check passed (max error {err} of sum p|v|)"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [80, 96])
def test_flash_attention_vjp_on_the_card(cuda_device, hd, dtype):
    """``flash_attention_vjp`` on card tensors: the forward launches the
    kernel once (within the kernel's tolerance of the plain version);
    the backward is autograd through the plain version, so the gradients
    are those of the plain path on the same inputs (rtol 1e-5 / atol
    1e-6 in float32; bf16 at one rounding, 1e-2)."""
    from repro_torch.kernels.ops import flash_attention_vjp
    q, k, v = _flash_inputs(2, 128, 4, 4, hd, dtype, cuda_device,
                            seed=hd)
    do = _on(_arrays(3, (2, 128, 4, hd)), dtype, cuda_device)[0]
    grads = {}
    for name, fn in (("kernel", flash_attention_vjp),
                     ("plain", flash_attention_ref)):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = flash_attention.launches
        out = fn(*ins, causal=True)
        out.backward(do)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + (name == "kernel")
        grads[name] = (out.detach(), [t.grad for t in ins])
    ok, err = _flash_close(grads["kernel"][0], q, k, v, True)
    assert ok, f"forward max error {err}"
    tol = 1e-5 if dtype == "float32" else 1e-2
    for a, b in zip(grads["kernel"][1], grads["plain"][1]):
        assert a.dtype == b.dtype == q.dtype
        torch.testing.assert_close(a, b, rtol=tol, atol=tol / 10)


@pytest.mark.cuda
def test_trainer_step_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of phi3-smoke (2 layers, d = 64) through
    ``train/trainer.py`` on the card, the kernel path against the plain
    path from one draw: loss and gradient norm rtol 1e-5; parameters
    rtol 1e-4 / atol 1e-5, where a gradient within 10 eps of zero is
    also allowed what the two gradients imply for AdamW's first step,
    ``lr |g_k / (|g_k| + eps) - g_p / (|g_p| + eps)|``."""
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.models.model import model_decls
    from repro_torch.optim import AdamW
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import (materialize, tree_leaves,
                                             tree_map)
    from repro_torch.train.trainer import make_train_step
    base = get_config("phi3-mini-3.8b", smoke=True, dtype="float32")
    params = materialize(model_decls(base, MeshAxes()),
                         torch.Generator().manual_seed(0), "cpu")
    batch = LMDataset(base.vocab_size, 4, 129, device=cuda_device)(0)
    lr, out = 1e-3, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        opt = AdamW(lr, weight_decay=0.1)
        seen, update = [], opt.update
        opt.update = lambda g, s, p, t: (seen.append(
            tree_map(torch.clone, g)), update(g, s, p, t))[1]
        step_fn, _, _ = make_train_step(with_kernel_backend(base, backend),
                                        MeshAxes(), opt, device=cuda_device)
        p = tree_map(lambda t: t.to(cuda_device), params)
        before = flash_attention.launches
        p, _, m = step_fn(p, opt.init(p), 0, batch)
        torch.cuda.synchronize()
        assert flash_attention.launches - before == (
            2 * base.num_layers if name == "kernel" else 0)
        out[name] = (m, dict(tree_leaves(seen[0])), dict(tree_leaves(p)))
    (mk, gk, pk), (mp, gp, pp) = out["kernel"], out["plain"]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[key], mp[key], rtol=1e-5, atol=0)

    def f(g):
        return g.double() / (g.double().abs() + opt.eps)
    for path, want in pp.items():
        near = (gk[path].abs() < 10 * opt.eps) | (gp[path].abs()
                                                  < 10 * opt.eps)
        implied = lr * (f(gk[path]) - f(gp[path])).abs() * near
        tol = 1e-5 + 1e-4 * want.double().abs() + implied
        diff = (pk[path].double() - want.double()).abs()
        assert bool((diff <= tol).all()), (path, diff.max().item())


@pytest.mark.cuda
def test_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of phi3-smoke with phantom MLP sites on 2
    gloo ranks sharing the card (the ``fp`` layout at tp = 2), the kernel
    path against the plain path from one draw, on every rank: each of
    the four kernels launched as the 2 layers imply (forward and
    recompute), loss and gradient norm rtol 1e-5, local parameters held
    as in ``test_trainer_step_kernel_path_matches_plain``."""
    _hold_card_step_ranks(cuda_device, pp=1, microbatches=1)


@pytest.mark.cuda
def test_trainer_step_at_pp2_tp2_kernel_path_matches_plain(cuda_device):
    """The same on 4 gloo ranks sharing the card, pp 2 x tp 2: one layer
    a stage, the 1F1B pipeline over 2 microbatches, each kernel launched
    as a stage's layer and 2 microbatches imply."""
    _hold_card_step_ranks(cuda_device, pp=2, microbatches=2)


@pytest.mark.cuda
def test_moe_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of olmoe-smoke on 2 gloo ranks sharing the
    card: phantom q/k/v/o sites (the ``fp`` layout), the experts behind
    the all-to-alls, the kernel path against the plain path from one
    draw; a layer launches flash twice, the phantom forward at its four
    sites twice (forward and recompute), the dgrad and wgrad once each
    a site."""
    _hold_card_step_ranks(cuda_device, pp=1, microbatches=1,
                          arch="olmoe-1b-7b", sites=4)


@pytest.mark.cuda
def test_ssm_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of mamba2-smoke on 2 gloo ranks sharing the
    card: phantom in and out sites (``wz``, ``wx``, ``out``), the kernel
    path against the plain path from one draw; a layer launches the
    phantom forward at its three sites twice (forward and recompute),
    the dgrad and wgrad once each a site, and no flash (no attention)."""
    _hold_card_step_ranks(cuda_device, pp=1, microbatches=1,
                          arch="mamba2-370m", sites=3, flash=False)


@pytest.mark.cuda
def test_fsdp_trainer_step_at_dp2_tp2_kernel_path_matches_plain(
        cuda_device):
    """One float32 AdamW step of phi3-smoke with ``fsdp=True`` on 4 gloo
    ranks sharing the card, dp 2 x tp 2: the weights gathered over dp
    before the flash and phantom kernels run on them, the kernel path
    against the plain path, every kernel's launches counted."""
    _hold_card_step_ranks(cuda_device, pp=1, microbatches=1, dp=2,
                          overrides={"fsdp": True})


@pytest.mark.cuda
def test_hybrid_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of jamba-smoke cut to 3 layers (attention +
    MLP, SSD + MoE, SSD + MLP: one superblock of its three block kinds)
    on 2 gloo ranks sharing the card, the kernel path against the plain
    path from one draw: flash at the attention layer and the phantom
    kernels at the two MLP layers' three sites, the forward twice
    (forward and the superblock's recompute), the dgrad and wgrad once.
    The full 8-layer smoke stack's float32 gradients are ill-conditioned
    (its gradient norm agrees to 1e-4 between two float32 runs;
    ``tests/test_torch_hybrid.py``), so the cut holds the step at this
    helper's tolerances."""
    _hold_card_step_ranks(
        cuda_device, pp=1, microbatches=1, arch="jamba-1.5-large-398b",
        overrides={"num_layers": 3},
        launches={"flash_attention": 2, "phantom_fused_matmul": 12,
                  "matmul_nt": 6, "matmul_tn": 6})


@pytest.mark.cuda
def test_vlm_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of qwen2-vl-smoke (M-RoPE ``positions`` and
    random vision embeddings from ``chip_smoke.py: StubbedLM``) on 2 gloo
    ranks sharing the card, the kernel path against the plain path from
    one draw: flash and the phantom kernels at its 2 layers' three MLP
    sites."""
    _hold_card_step_ranks(cuda_device, pp=1, microbatches=1,
                          arch="qwen2-vl-72b")


@pytest.mark.cuda
def test_encdec_trainer_step_at_tp2_kernel_path_matches_plain(cuda_device):
    """One float32 AdamW step of seamless-smoke (random frames) on 2 gloo
    ranks sharing the card, the kernel path against the plain path: flash
    at its 2 encoder layers (full) and 2 decoder layers (causal; the
    cross-attention runs the plain core), the phantom kernels at the
    gelu MLP's two sites of all four, the forward twice (forward and
    recompute), the dgrad and wgrad once."""
    _hold_card_step_ranks(
        cuda_device, pp=1, microbatches=1, arch="seamless-m4t-large-v2",
        launches={"flash_attention": 8, "phantom_fused_matmul": 16,
                  "matmul_nt": 8, "matmul_tn": 8})


def _hold_card_step_ranks(cuda_device, pp, microbatches,
                          arch="phi3-mini-3.8b", sites=3, flash=True, dp=1,
                          overrides=None, launches=None):
    """``torch_ranks.card_tp_step_body`` on pp x dp x 2 ranks, held on
    every rank: the kernel path's launches (forward and recompute of the
    stage's 2 / pp layers, once a microbatch, ``sites`` phantom sites a
    layer, and flash unless the model has no attention; or ``launches``
    where given), none on the plain path, loss and gradient norm rtol
    1e-5, and the local parameters rtol 1e-4 / atol 1e-5 plus what
    AdamW's first step implies near zero gradients."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.params import tree_leaves
    import torch_ranks
    build.build(["flash_attention", "phantom_fused"])
    ranks = spawn(torch_ranks.card_tp_step_body, dp, 2, cuda_device,
                  timeout_s=300, pp=pp, args=(microbatches, arch, overrides))
    n = 2 // pp * microbatches       # the smoke stage's layer passes
    lr = 1e-3
    for r in ranks:
        k, p = r["kernel"], r["plain"]
        assert k["launches"] == (launches or {
            "flash_attention": 2 * n * flash,
            "phantom_fused_matmul": 2 * sites * n, "matmul_nt": sites * n,
            "matmul_tn": sites * n})
        assert set(p["launches"].values()) == {0}
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(k[key], p[key], rtol=1e-5)
        gk, gp = dict(tree_leaves(k["grads"])), dict(tree_leaves(p["grads"]))

        def f(g):
            g = np.float64(g)
            return g / (np.abs(g) + r["eps"])
        for path, want in tree_leaves(p["params"]):
            near = ((np.abs(gk[path]) < 10 * r["eps"])
                    | (np.abs(gp[path]) < 10 * r["eps"]))
            implied = lr * np.abs(f(gk[path]) - f(gp[path])) * near
            tol = 1e-5 + 1e-4 * np.abs(np.float64(want)) + implied
            diff = np.abs(np.float64(dict(tree_leaves(k["params"]))[path])
                          - want)
            assert (diff <= tol).all(), (path, diff.max())
