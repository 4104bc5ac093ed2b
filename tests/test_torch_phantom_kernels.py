"""The port's phantom kernels (``repro_torch.kernels.phantom_fused``)
against the JAX package's Pallas kernels of the same names.

On the CPU each wrapper takes its plain version (``kernels/ref.py``);
the JAX side runs its Pallas kernels in interpret mode, as the
reference's own tests do (``tests/test_kernels.py``).  Inputs come from
numpy seeds and go to both sides unchanged.  The port's dgrad and wgrad
read ``[L ; D]`` and ``[x | g]`` through two operands; the reference gets
the concatenation it builds itself.

Tolerances are the reference's: float32 rtol/atol 2e-4, bf16 2e-2 for
the kernels, 2e-3 / 6e-2 for the gradients of ``phantom_fused_linear``.
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda_kernels.py``, which imports no JAX.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import phantom_fused as jpf
from repro.kernels.ops import phantom_fused_linear as jax_fused_linear
from repro_torch.kernels import phantom_fused as pf
from repro_torch.kernels.ops import KernelConfigError, phantom_fused_linear
from repro_torch.kernels.ref import (matmul_nt_ref, matmul_tn_ref,
                                     phantom_fused_ref)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 6e-2}

# (M, K, N, PK): the reference's sweeps (tests/test_kernels.py:13-19 and
# :108-114) and the Table I mini-run's per-rank shapes (n=1024, p=8)
SHAPES = [
    (128, 128, 128, 64), (256, 128, 128, 128), (128, 256, 384, 32),
    (512, 128, 256, 256), (128, 512, 128, 16),
    (192, 128, 128, 64), (192, 192, 192, 48), (100, 72, 56, 24),
    (130, 257, 129, 65), (128, 128, 300, 64),
    (64, 128, 128, 32), (64, 128, 128, 128),
]
BF16_SHAPES = [(128, 128, 128, 64), (100, 72, 56, 24), (130, 257, 129, 65),
               (64, 128, 128, 32)]
# qwen2.5-14b a rank at tp = 4, batch 4 x seq 512: gate/up and down (k 16)
QWEN_TP4_SHAPES = [(2048, 1280, 3456, 64), (2048, 3456, 1280, 64)]


def _arrays(seed, *shapes, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _cases():
    return ([(s, "float32") for s in SHAPES]
            + [(s, "bfloat16") for s in BF16_SHAPES])


@pytest.mark.parametrize("shape,dtype", _cases())
def test_forward_matches_pallas(shape, dtype):
    M, K, N, PK = shape
    arrs = _arrays(M + K + N + PK, (M, K), (K, N), (M, PK), (PK, N))
    before = pf.phantom_fused_matmul.launches
    got = pf.phantom_fused_matmul(*_torch(arrs, dtype))
    want = jpf.phantom_fused_matmul(*_jax(arrs, dtype), interpret=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    assert pf.phantom_fused_matmul.launches == before   # the CPU path
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("shape,dtype", _cases())
def test_dgrad_matches_pallas(shape, dtype):
    """dz @ [L ; D]^T: the port reads L and D through two operands."""
    M, K, N, PK = shape
    arrs = _arrays(M + 2 * K, (M, N), (K, N), (PK, N))
    dz, L, D = _torch(arrs, dtype)
    got = pf.matmul_nt(dz, L, D)
    jdz, jL, jD = _jax(arrs, dtype)
    want = jpf.matmul_nt(jdz, jnp.concatenate([jL, jD]), interpret=True)
    assert got.shape == (M, K + PK)
    _close(got, want, TOL[dtype])
    dx, dg = pf.phantom_fused_dgrad(dz, L, D)
    jdx, jdg = jpf.phantom_fused_dgrad(jdz, jL, jD, interpret=True)
    _close(dx, jdx, TOL[dtype], "dx")
    _close(dg, jdg, TOL[dtype], "dg")


@pytest.mark.parametrize("shape,dtype", _cases())
def test_wgrad_matches_pallas(shape, dtype):
    """[x | g]^T @ dz: the port reads x and g through two operands."""
    M, K, N, PK = shape
    arrs = _arrays(M + 3 * K, (M, K), (M, PK), (M, N))
    x, g, dz = _torch(arrs, dtype)
    got = pf.matmul_tn(x, dz, g)
    jx, jg, jdz = _jax(arrs, dtype)
    want = jpf.matmul_tn(jnp.concatenate([jx, jg], 1), jdz, interpret=True)
    assert got.shape == (K + PK, N)
    _close(got, want, TOL[dtype])
    dL, dD = pf.phantom_fused_wgrad(x, g, dz)
    jdL, jdD = jpf.phantom_fused_wgrad(jx, jg, jdz, interpret=True)
    _close(dL, jdL, TOL[dtype], "dL")
    _close(dD, jdD, TOL[dtype], "dD")


def test_single_operand_backward_kernels():
    """The reference's transpose-math check (tests/test_kernels.py:165):
    ``matmul_nt`` and ``matmul_tn`` with one operand each."""
    a, b, c = _arrays(41, (96, 160), (72, 160), (96, 112))
    ta, tb, tc = _torch([a, b, c], "float32")
    _close(pf.matmul_nt(ta, tb),
           jpf.matmul_nt(*_jax([a, b], "float32"), interpret=True), 2e-4)
    _close(pf.matmul_tn(ta, tc),
           jpf.matmul_tn(*_jax([a, c], "float32"), interpret=True), 2e-4)


@pytest.mark.parametrize("case", ["D shape", "L rows", "g rows", "b cols",
                                  "b rows"])
def test_typed_errors_match_the_reference(case):
    """Mismatched operands raise ``KernelConfigError`` with the
    reference's message, on both sides."""
    x, L, g = _arrays(38, (64, 64), (64, 64), (64, 32))
    bad = {
        "D shape": ((x, L, g, np.zeros((8, 8), np.float32)),
                    pf.phantom_fused_matmul, jpf.phantom_fused_matmul),
        "L rows": ((x, np.zeros((32, 64), np.float32), g,
                    np.zeros((32, 64), np.float32)),
                   pf.phantom_fused_matmul, jpf.phantom_fused_matmul),
        "g rows": ((x, L, g[:48], np.zeros((32, 64), np.float32)),
                   pf.phantom_fused_matmul, jpf.phantom_fused_matmul),
        "b cols": ((x, np.zeros((16, 48), np.float32)),
                   pf.matmul_nt, jpf.matmul_nt),
        "b rows": ((x, np.zeros((48, 16), np.float32)),
                   pf.matmul_tn, jpf.matmul_tn),
    }[case]
    arrs, ours, theirs = bad
    with pytest.raises(KernelConfigError, match=case):
        ours(*_torch(arrs, "float32"))
    with pytest.raises(jpf.KernelConfigError, match=case):
        theirs(*_jax(arrs, "float32"), interpret=True)


def test_shared_memory_check():
    """The shared-memory counterpart of the reference's VMEM check: the
    split-contraction kernel's ring (forward and dgrad layouts, float32
    and bfloat16) fits one H100 block; tiles past 227 KB raise."""
    for (b_kfast, esize), need in pf.SMEM_BYTES.items():
        assert need == pf.check_kernel_fits(b_kfast, esize) == \
            pf.kernel_smem_bytes(b_kfast, esize) < pf.SMEM_BUDGET_BYTES
        # over 48 KB in float32: dynamic shared memory, set per kernel
        assert need > 48 * 1024 or esize == 2
    # the partial tile [BM][BN] fp32 reuses the ring: the ring is larger
    assert min(pf.SMEM_BYTES.values()) >= 4 * pf.BM * pf.BN
    with pytest.raises(KernelConfigError, match="shared memory"):
        pf.check_kernel_fits(False, 4, bm=256, bn=256, bk=128)


def _constants(src, namespace):
    """The ``constexpr int`` values of one namespace of a CUDA source."""
    body = src[src.index(f"namespace {namespace} {{"):
               src.index(f"}}  // namespace {namespace}")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", body)}


def test_kernel_constants_match_the_source():
    """The plans price tiles, rings and grids from Python constants; they
    must be the CUDA source's: ``namespace sk`` (forward and dgrad) and
    ``namespace tn`` (wgrad) of ``phantom_fused.cu``."""
    csrc = Path(pf.__file__).parent / "csrc"
    src = (csrc / "phantom_fused.cu").read_text()
    sk, tn = _constants(src, "sk"), _constants(src, "tn")
    for name in ("BM", "BN", "BK", "STAGES", "MAX_SPLITS"):
        assert sk[name] == getattr(pf, name), name
    for name in ("BM", "BN", "BK", "STAGES"):
        assert tn[name] == getattr(pf, "WGRAD_" + name), name


def _ceil(a, b):
    return -(-a // b)


def _plan_operands(shape, kind, dtype=torch.float32):
    M, K, N, PK = shape
    e = functools.partial(torch.empty, dtype=dtype)
    if kind == "forward":
        ops = (e(M, K), e(K, N), e(M, PK), e(PK, N))
        return pf.forward_plan(*ops), ops, M, N, _ceil(K, 32) + _ceil(PK, 32)
    ops = (e(M, N), e(K, N), e(PK, N))
    return pf.dgrad_plan(*ops), ops, M, K + PK, _ceil(N, 32)


@pytest.mark.parametrize("kind", ["forward", "dgrad"])
@pytest.mark.parametrize("shape", SHAPES + [(64, 128, 128, 64),
                                            (64, 2048, 2048, 128)]
                         + QWEN_TP4_SHAPES)
def test_gemm_plan(shape, kind):
    """The launch plan of the split-contraction kernel on the sweep, the
    Table I mini-run, the paper-ffn-16k per-rank shapes and qwen2.5-14b's
    at tp = 4 (CPU operands: the H100's residency table): the block
    ranges cover the contraction exactly, every block of a split gets at
    least two slabs, the cluster is at most 8 and fits the card in one
    wave, shared memory fits, and the main shape keeps at least 1.5
    blocks per SM busy.  qwen's 640 to 1,760 tiles fill more than one
    wave without a split, on 16-byte copies."""
    resident = pf.H100_RESIDENT_CLUSTERS
    for dtype in (torch.float32, torch.bfloat16):
        plan, ops, rows, cols, slabs = _plan_operands(shape, kind, dtype)
        assert plan.slabs == slabs
        S = plan.splits
        assert 1 <= S <= pf.MAX_SPLITS
        assert plan.cluster == (S, 1, 1)
        assert plan.grid == (_ceil(cols, pf.BN) * S, _ceil(rows, pf.BM))
        tiles = _ceil(cols, pf.BN) * _ceil(rows, pf.BM)
        ranges = plan.ranges()
        assert len(ranges) == S and ranges[0][0] == 0 and \
            ranges[-1][1] == slabs
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if S > 1:
            assert min(b - a for a, b in ranges) >= 2
            assert tiles <= resident[S]             # one wave
        if S < pf.MAX_SPLITS:                       # and no larger S fits
            assert slabs < 2 * (S + 1) or tiles > resident[S + 1]
        assert plan.smem_bytes == pf.kernel_smem_bytes(
            kind == "dgrad", ops[0].element_size()) <= pf.SMEM_BUDGET_BYTES
        v = 16 // ops[0].element_size()
        aligned = all(t.shape[1] % v == 0 for t in ops)
        assert plan.variant == ("vec16" if aligned else "masked")
        if shape == (64, 2048, 2048, 128):
            assert plan.variant == "vec16"
            assert S == {"forward": 7, "dgrad": 6}[kind]
            assert plan.grid[0] * plan.grid[1] >= 1.5 * 132
        if shape == (130, 257, 129, 65):
            assert plan.variant == "masked"
        if shape in QWEN_TP4_SHAPES:
            assert plan.variant == "vec16" and S == 1
            assert tiles > resident[2]


_H100 = pf.H100_RESIDENT_CLUSTERS


@pytest.mark.parametrize("table,splits", [
    (_H100, 7),
    ({s: 264 for s in range(1, 9)}, 8),
    ({**_H100, 7: 30}, 6),
    ({**_H100, 7: 31, 6: 31}, 5),
    ({s: 16 for s in range(1, 9)}, 1),
])
def test_gemm_plan_follows_the_residency_table(table, splits):
    """The forward at the main shape (32 output tiles, 68 slabs) on cards
    that hold ``table[S]`` clusters of S blocks at once: the largest S
    whose 32 clusters run in one wave, else 1."""
    plan = pf.gemm_plan(64, 2048, (2048, 128), False, 4, True, table)
    assert plan.splits == splits


@pytest.mark.parametrize("shape", SHAPES + [(64, 128, 128, 64),
                                            (64, 2048, 2048, 128)]
                         + QWEN_TP4_SHAPES)
def test_wgrad_plan(shape):
    """The wgrad's persistent grid on the sweep, the Table I mini-run, the
    paper-ffn-16k per-rank shapes and qwen2.5-14b's at tp = 4, with the
    H100's residency (CPU operands): never more blocks than the card
    holds at once nor than there are tiles, and shared memory for the
    blocks an SM holds.  At the main shape 1088 tiles on 528 blocks: two
    full rounds and a third of 32 tiles (a design of 128-tiles that
    filled whole rounds measured within the spread between runs of it,
    PERF.md); at qwen's, 1,134 and 1,100 tiles in three rounds."""
    M, K, N, PK = shape
    for dtype in (torch.float32, torch.bfloat16):
        x, g, dz = (torch.empty(M, K, dtype=dtype),
                    torch.empty(M, PK, dtype=dtype),
                    torch.empty(M, N, dtype=dtype))
        es = x.element_size()
        plan = pf.tn_plan(x, dz, g)
        per_sm = pf.H100_WGRAD_BLOCKS_PER_SM[(es, plan.variant)]
        tiles = _ceil(K + PK, pf.WGRAD_BM) * _ceil(N, pf.WGRAD_BN)
        assert plan.tiles == tiles
        assert plan.resident == pf.H100_SMS * per_sm
        assert plan.grid == min(tiles, plan.resident)
        assert (plan.rounds - 1) * plan.grid < tiles <= \
            plan.rounds * plan.grid
        assert per_sm * plan.smem_bytes <= 228 * 1024
        assert plan.smem_bytes == pf.WGRAD_STAGES * pf.WGRAD_BK * \
            (pf.WGRAD_BM + pf.WGRAD_BN) * es
        if shape == (64, 2048, 2048, 128):
            assert (plan.tiles_m, plan.tiles_n) == (34, 32)
            assert (plan.resident, plan.grid, plan.rounds) == (528, 528, 3)
            assert plan.tiles - 2 * plan.grid == 32
            assert plan.variant == "vec16"
        elif shape in QWEN_TP4_SHAPES:
            assert plan.tiles in (21 * 54, 55 * 20)
            assert (plan.grid, plan.rounds) == (528, 3)
            assert plan.variant == "vec16"
        else:    # the sweep's and the mini-run's outputs are small
            assert plan.rounds == 1


@pytest.mark.parametrize("resident,grid,rounds", [
    (528, 528, 3),     # the H100: two full rounds, a third of 32 tiles
    (264, 264, 5),     # two blocks an SM
    (544, 544, 2),     # whole rounds
    (2000, 1088, 1),   # every tile in one round
    (1, 1, 1088),      # one block walks every tile
    (100, 100, 11),
])
def test_wgrad_plan_follows_the_residency(resident, grid, rounds):
    """The main shape's 1088 tiles on cards that hold ``resident`` blocks
    of the kernel at once."""
    plan = pf.wgrad_plan(2176, 2048, 4, True, resident)
    assert (plan.grid, plan.rounds) == (grid, rounds)


def test_gemm_plan_variant_of_column_views():
    """A column view whose base or row pitch is not a multiple of 16
    bytes takes the masked variant; one whose pitch and base are aligned
    keeps the 16-byte copies."""
    wide = torch.empty(64, 2048 + 8)
    L, g, D = torch.empty(2048, 2048), torch.empty(64, 128), \
        torch.empty(128, 2048)
    assert pf.forward_plan(wide[:, :2048], L, g, D).variant == "vec16"
    assert pf.forward_plan(wide[:, 4:2052], L, g, D).variant == "vec16"
    assert pf.forward_plan(wide[:, 1:2049], L, g, D).variant == "masked"
    odd = torch.empty(64, 2048 + 1)[:, :2048]   # pitch 2049 floats
    assert pf.forward_plan(odd, L, g, D).variant == "masked"
    dz = torch.empty(64, 2048 + 4)[:, 4:]
    assert pf.dgrad_plan(dz, L, D).variant == "vec16"
    assert pf.dgrad_plan(dz.bfloat16()[:, 2:], L.bfloat16(),
                         D.bfloat16()).variant == "masked"


def test_non_cpu_tensors_never_take_the_plain_version():
    x, L, g, D = _torch(_arrays(5, (8, 8), (8, 8), (8, 4), (4, 8)),
                        "float32")
    with pytest.raises(ValueError, match="no phantom kernel"):
        pf.phantom_fused_matmul(*(t.to("meta") for t in (x, L, g, D)))
    with pytest.raises(ValueError, match="no phantom kernel"):
        pf.matmul_nt(x.to("meta"), L.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,k,p", [
    (128, 128, 128, 16, 4),
    (192, 96, 80, 8, 2),
    (64, 64, 64, 4, 8),
])
def test_fused_linear_grads_match_jax(dtype, M, K, N, k, p):
    """``phantom_fused_linear``'s loss and gradients against the
    reference's custom_vjp (Pallas forward and backward, interpreted) on
    the grid of tests/test_kernels.py:177-208."""
    arrs = _arrays(50 + M, (M, K), (K, N), (M, p * k), (p * k, N))
    ins = [t.requires_grad_(True) for t in _torch(arrs, dtype)]
    loss = phantom_fused_linear(*ins).float().square().sum()
    grads = torch.autograd.grad(loss, ins)

    def jloss(x, L, g, D):
        return jnp.sum(jnp.square(jax_fused_linear(
            x, L, g, D, interpret=True).astype(jnp.float32)))
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        *_jax(arrs, dtype))
    tol = GRAD_TOL[dtype]
    _close(loss, jl, tol, "loss")
    for name, a, b in zip(("dx", "dL", "dg", "dD"), grads, jg):
        assert a.dtype == getattr(torch, dtype), name
        _close(a, b, tol, name)


def test_fused_linear_leading_batch_dims():
    """[B, S, K] activations flatten around the 2-D kernels, as the
    reference's ``phantom_fused_linear`` does."""
    B, S, K, N, PK = 2, 24, 64, 48, 32
    arrs = _arrays(54, (B, S, K), (K, N), (B, S, PK), (PK, N))
    got = phantom_fused_linear(*_torch(arrs, "float32"))
    want = jax_fused_linear(*_jax(arrs, "float32"), interpret=True)
    assert got.shape == (B, S, N)
    _close(got, want, 2e-4)
    x, L, g, D = _torch(arrs, "float32")
    _close(got.reshape(-1, N),
           phantom_fused_ref(x.reshape(-1, K), L, g.reshape(-1, PK), D),
           2e-4)
