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
into the buffer being read) must fail the check.
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
# :108-114) and the Table I mini-run's per-rank shapes (n=1024, p=8)
PHANTOM_SHAPES = [
    (128, 128, 128, 64), (256, 128, 128, 128), (128, 256, 384, 32),
    (512, 128, 256, 256), (128, 512, 128, 16),
    (192, 128, 128, 64), (192, 192, 192, 48), (100, 72, 56, 24),
    (130, 257, 129, 65), (128, 128, 300, 64),
    (64, 128, 128, 32), (64, 128, 128, 128),
]
PHANTOM_BF16_SHAPES = [(128, 128, 128, 64), (100, 72, 56, 24),
                       (130, 257, 129, 65), (64, 128, 128, 32)]
PHANTOM_MAIN = (64, 2048, 2048, 128)

# (B, S, H, KV, hd): GQA groups of 1, 2 and 16; hd 16 to 128
FLASH_SHAPES = [
    (2, 16, 4, 4, 16),
    (1, 48, 4, 2, 16),
    (1, 128, 4, 2, 16),
    (2, 16, 32, 2, 128),
    (1, 48, 32, 2, 128),
    (1, 128, 16, 1, 128),
    (1, 100, 8, 2, 64),
    (2, 70, 4, 1, 32),
]


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
                            ((64, 256, 192, 32), "float32", 1)])
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
                         + [(PHANTOM_MAIN, 0), ((64, 256, 192, 32), 1),
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
    blocks, so that tiles go round several times) in both variants:
    within tolerance of the plain version and the same bits on a second
    launch."""
    if resident is not None:
        monkeypatch.setattr(pf, "_wgrad_resident", lambda t, v: resident)
    off = 0 if variant == "vec16" else 1
    x, g, dz = [t[:, off:] for t in _on(_arrays(
        M + I0 + N, (M, I0 + off), (M, I1 + off), (M, N + off)), dtype,
        cuda_device)]
    plan = pf.tn_plan(x, dz, g)
    assert plan.variant == variant
    if resident is not None or (M, I0) == (64, 2048):
        assert plan.rounds > 1
    before = pf.matmul_tn.launches
    got = pf.matmul_tn(x, dz, g)
    torch.cuda.synchronize()
    assert pf.matmul_tn.launches == before + 1
    _close(got, matmul_tn_ref(torch.cat([x, g], 1), dz), PHANTOM_TOL[dtype])
    assert torch.equal(got, pf.matmul_tn(x, dz, g)), "two launches differ"


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
