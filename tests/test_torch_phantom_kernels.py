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
``tests/test_torch_cuda_kernels.py``, which imports no JAX; here, besides
the numbers, each wrapper's plan: which kernel every call takes (the
wgmma route for aligned bf16, the CUDA-core kernels otherwise, never the
plain version for a CUDA tensor), its tiles, splits and grid.
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
    and bfloat16) and the wgmma route's TMA ring (with the split's fp32
    partial tile in it) fit one H100 block at every tile shape; tiles
    past 227 KB raise."""
    assert pf.WG_SMEM_BYTES[pf.WG_SHAPES[0]] == pf.wg_smem_bytes()
    for (bm, bn), need in pf.WG_SMEM_BYTES.items():
        stages = pf.WG_RING[(bm, bn)]
        assert need == pf.wg_smem_bytes(bm, bn, stages=stages) == (
            stages * (bm + bn) * pf.WG_BK * 2 + pf.WG_SLACK)
        assert 48 * 1024 < need <= pf.SMEM_BUDGET_BYTES
        assert 4 * bm * bn <= need - pf.WG_SLACK
    with pytest.raises(KernelConfigError, match="shared memory"):
        pf.wg_smem_bytes(stages=pf.WG_RING[pf.WG_SHAPES[0]] + 1)
    with pytest.raises(KernelConfigError, match="partial tile"):
        pf.wg_smem_bytes(bn=512, stages=1)
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
    must be the CUDA source's: ``namespace sk`` (forward and dgrad),
    ``namespace tn`` (wgrad) and ``namespace wg`` (the bf16 wgmma route)
    of ``phantom_fused.cu``."""
    csrc = Path(pf.__file__).parent / "csrc"
    src = (csrc / "phantom_fused.cu").read_text()
    sk, tn = _constants(src, "sk"), _constants(src, "tn")
    wg = _constants(src, "wg")
    for name in ("BM", "BN", "BK", "STAGES", "MAX_SPLITS"):
        assert sk[name] == getattr(pf, name), name
    for name in ("BM", "BN", "BK", "STAGES"):
        assert tn[name] == getattr(pf, "WGRAD_" + name), name
    for name in ("BK", "MAX_SPLITS", "SLACK", "SM_SMEM", "BLOCK_RESERVED"):
        assert wg[name] == getattr(pf, "WG_" + name), name
    # the forward's and the dgrad's instances and their rings, in the
    # plan's order; the wgrad's one instance at the first
    line = next(ln for ln in src.splitlines()
                if ln.startswith("#define WG_SHAPES(X)"))
    shapes = [tuple(int(v) for v in x) for x in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", line)]
    assert tuple((m, n) for m, n, _ in shapes) == pf.WG_SHAPES
    assert {(m, n): st for m, n, st in shapes} == pf.WG_RING
    assert "wg::gemm<true, true, wg::Shape<%d, %d, %d>>" % (
        *pf.WG_WGRAD_SHAPE, pf.WG_RING[pf.WG_WGRAD_SHAPE]) in src
    # a wgmma tile: one or two consumer warpgroups of 64 rows, one wgmma
    # wide, slabs of 128 bytes
    for bm, bn in pf.WG_SHAPES:
        assert bm in (64, 128) and bn in (64, 128, 256), (bm, bn)
        assert pf.wg_threads(bm) == 128 * (1 + bm // 64)
    assert pf.WG_BK * 2 == 128


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
        if dtype == torch.bfloat16 and pf.takes_16b(*ops):
            _check_wg_plan(plan, shape, kind)
            continue
        assert plan.kernel == "splitk_kernel"
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


def _check_wg_plan(plan, shape, kind):
    """A wgmma plan of the forward or the dgrad at (M, K, N, PK): one of
    ``wg_candidates`` -- tiles of one of ``WG_SHAPES`` over each part of
    C's columns on its own, slabs of 64, every block one slab or more,
    with a split one cluster per tile in one wave, else a persistent grid
    -- the one of least estimate, the larger tile and then the fewer
    splits on a tie, and its estimate as ``wg_estimate_us`` prices it."""
    M, K, N, PK = shape
    assert plan.variant == "wgmma" and plan.esize == 2
    assert plan.kernel == {"forward": "wgmma_fwd_kernel",
                           "dgrad": "wgmma_dgrad_kernel"}[kind]
    bm, bn = plan.bm, plan.bn
    assert (bm, bn) in pf.WG_SHAPES
    resident = pf.H100_WG_RESIDENT_CLUSTERS[(bm, bn)]
    if kind == "forward":
        tiles = _ceil(M, bm) * _ceil(N, bn)
        slabs = _ceil(K, 64) + _ceil(PK, 64)
        parts = ((M,), (N,), (K, PK))
    else:
        tiles = _ceil(M, bm) * (_ceil(K, bn) + _ceil(PK, bn))
        slabs = _ceil(N, 64)
        parts = ((M,), (K, PK), (N,))
    assert (plan.tiles, plan.slabs) == (tiles, slabs)
    assert plan.smem_bytes == pf.WG_SMEM_BYTES[(bm, bn)]
    assert plan.stages == pf.WG_RING[(bm, bn)]
    S = plan.splits
    assert plan.cluster == (S, 1, 1)
    ranges = plan.ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == slabs and len(ranges) == S
    assert min(b - a for a, b in ranges) >= 1
    if S > 1:
        assert plan.grid == (tiles * S, 1) and tiles <= resident[S]
    else:
        assert plan.grid == (min(tiles, resident[1]), 1)
    assert plan.est_us == pytest.approx(pf.wg_estimate_us(
        kind, (bm, bn), tiles, slabs, S, plan.grid[0], min(bm, M),
        min(bn, max(parts[1])), resident))
    cands = pf.wg_candidates(*parts, kind == "dgrad")
    first = min(cands, key=lambda c: c.est_us)
    assert (plan.bm, plan.bn, plan.splits) == (first.bm, first.bn,
                                               first.splits)
    assert all(plan.est_us <= c.est_us for c in cands)


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
        if dtype == torch.bfloat16 and pf.takes_16b(x, g, dz):
            _check_wg_wgrad_plan(plan, M, K, N, PK)
            continue
        assert plan.kernel == "tn_kernel" and plan.splits == 1
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


def _check_wg_wgrad_plan(plan, M, K, N, PK):
    """A wgmma wgrad plan: rows tiled over x's columns and then g's, 256
    columns a tile, the contraction M in slabs of 64, split as
    ``wg_split`` says or a persistent grid of one block per tile at
    most."""
    resident = pf.H100_WG_RESIDENT_CLUSTERS[pf.WG_WGRAD_SHAPE]
    assert pf.WG_WGRAD_SHAPE == (128, 256)
    assert plan.variant == "wgmma" and plan.kernel == "wgmma_wgrad_kernel"
    assert (plan.tiles_m, plan.tiles_n) == (_ceil(K, 128) + _ceil(PK, 128),
                                            _ceil(N, 256))
    assert plan.smem_bytes == pf.WG_SMEM_BYTES[pf.WG_WGRAD_SHAPE]
    S, tiles = plan.splits, plan.tiles
    assert (S, plan.grid) == pf.wg_split(tiles, _ceil(M, 64), resident)
    assert plan.resident == resident[S] * S
    if S > 1:
        assert plan.grid == tiles * S and tiles <= resident[S]
        assert _ceil(M, 64) >= 2 * S
    else:
        assert plan.grid == min(tiles, resident[1])
        assert (plan.rounds - 1) * plan.grid < tiles <= \
            plan.rounds * plan.grid


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


class _FakeLibrary:
    """Stands in for the built library: records each C call with its
    arguments and returns ``err``."""

    def __init__(self, calls, err=0):
        self.calls, self.err = calls, err

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


def _never(*args, **kw):
    raise AssertionError("a CUDA tensor reached the plain version")


def _as_if_on_the_card(monkeypatch, calls, err=0):
    """The wrappers as they run on a CUDA tensor, on CPU tensors: the
    device checks pass, the library is ``_FakeLibrary`` and the plain
    versions raise if called."""
    monkeypatch.setattr(pf, "_library", lambda: _FakeLibrary(calls, err))
    monkeypatch.setattr(pf, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(pf, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(pf, "_stream", lambda dev: 0)
    for name in ("phantom_fused_ref", "matmul_nt_ref", "matmul_tn_ref"):
        monkeypatch.setattr(pf, name, _never)


# (M, K, N, PK): a decode step's 4 rows and a prefill group's 192
# (chatglm3-6b at tp 4), a pipeline stage's 8, the paper-ffn-16k rank's
# 64, LM sites at 2,048 (qwen2-vl-72b gate/up and down, phi3-mini under
# the planner's winner) and a ragged sweep shape
ROUTE_SHAPES = [(4, 1024, 3424, 64), (192, 1024, 3424, 64),
                (8, 8192, 8192, 32), (64, 2048, 2048, 128),
                (2048, 2048, 7392, 128), (2048, 7392, 2048, 128),
                (2048, 1536, 4096, 8), (100, 72, 56, 24)]
C_CALLS = {True: ("repro_wgmma_fwd", "repro_wgmma_nt", "repro_wgmma_tn"),
           False: ("repro_phantom_fused_fwd", "repro_matmul_nt",
                   "repro_matmul_tn")}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_route_of_every_call(monkeypatch, shape, dtype, aligned):
    """Which kernel each product takes on a CUDA tensor: aligned bf16 the
    wgmma kernels (``repro_wgmma_*``, with the plan's tile shape, splits
    and grid),
    float32 and unaligned bf16 the CUDA-core kernels (the 16-byte or the
    masked variant); each call launches once, counted, and never reaches
    the plain version.  Unaligned: every operand a column view one
    element into a wider tensor."""
    M, K, N, PK = shape
    dt, off = getattr(torch, dtype), 0 if aligned else 1

    def e(rows, cols):
        return torch.empty(rows, cols + off, dtype=dt)[:, off:]
    x, L, g, D, dz = e(M, K), e(K, N), e(M, PK), e(PK, N), e(M, N)
    calls = []
    _as_if_on_the_card(monkeypatch, calls)
    plans = (pf.forward_plan(x, L, g, D), pf.dgrad_plan(dz, L, D),
             pf.tn_plan(x, dz, g))
    tc = dtype == "bfloat16" and aligned
    assert [p.variant for p in plans] == (
        ["wgmma"] * 3 if tc else ["vec16" if aligned else "masked"] * 3)
    assert [p.kernel for p in plans] == (
        ["wgmma_fwd_kernel", "wgmma_dgrad_kernel", "wgmma_wgrad_kernel"]
        if tc else ["splitk_kernel", "splitk_kernel", "tn_kernel"])
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    before = [k.launches for k in kernels]
    outs = (pf.phantom_fused_matmul(x, L, g, D), pf.matmul_nt(dz, L, D),
            pf.matmul_tn(x, dz, g))
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    assert [o.shape for o in outs] == [(M, N), (M, K + PK), (K + PK, N)]
    assert tuple(name for name, _ in calls) == C_CALLS[tc]
    if tc:   # the plan's tile shape, splits and grid, then the stream
        (_, fwd), (_, nt), (_, tn) = calls
        assert fwd[-5:] == (plans[0].bm, plans[0].bn, plans[0].splits,
                            plans[0].grid[0], 0)
        assert nt[-5:] == (plans[1].bm, plans[1].bn, plans[1].splits,
                           plans[1].grid[0], 0)
        assert tn[-3:] == (plans[2].splits, plans[2].grid, 0)


@pytest.mark.parametrize("err,match", [
    (1, "launch failed: cudaError 1"),
    (700, "launch failed: cudaError 700"),
    (100_001, "cuTensorMapEncodeTiled refused a TMA descriptor: CUresult 1"),
])
def test_a_failed_wgmma_launch_raises(monkeypatch, err, match):
    """A refused descriptor or launch on the wgmma route raises; it never
    takes the CUDA-core kernel or the plain version, and is not
    counted."""
    x, L, g, D, dz = (torch.empty(*s, dtype=torch.bfloat16) for s in
                      ((256, 512), (512, 768), (256, 64), (64, 768),
                       (256, 768)))
    calls = []
    _as_if_on_the_card(monkeypatch, calls, err)
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    before = [k.launches for k in kernels]
    for fn, args in ((pf.phantom_fused_matmul, (x, L, g, D)),
                     (pf.matmul_nt, (dz, L, D)), (pf.matmul_tn, (x, dz, g))):
        with pytest.raises(RuntimeError, match=match):
            fn(*args)
    assert [k.launches for k in kernels] == before
    assert tuple(name for name, _ in calls) == C_CALLS[True]


def _bf16(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("M,K,N,PK,want", [
    # qwen2-vl-72b at tp 4: K = 7,392 (the down projection's contraction,
    # the gate/up dgrad's L rows) is no multiple of 128 or 256; 128 x 256
    # tiles everywhere
    (2048, 2048, 7392, 128, {"forward": ((128, 256), 16 * 29),
                             "dgrad": ((128, 256), 16 * (8 + 1)),
                             "wgrad": ((128, 256), (16 + 1) * 29)}),
    (2048, 7392, 2048, 128, {"forward": ((128, 256), 16 * 8),
                             "dgrad": ((128, 256), 16 * (29 + 1)),
                             "wgrad": ((128, 256), (58 + 1) * 8)}),
    # chatglm3-6b at tp 4, a decode step: N = 3,424, 64-row tiles
    (4, 1024, 3424, 64, {"forward": ((64, 128), 1 * 27),
                         "dgrad": ((64, 64), 1 * (16 + 1)),
                         "wgrad": ((128, 256), (8 + 1) * 14)}),
    (4, 3424, 1024, 64, {"forward": ((64, 64), 1 * 16),
                         "dgrad": ((64, 128), 1 * (27 + 1)),
                         "wgrad": ((128, 256), (27 + 1) * 4)}),
])
def test_tiles_across_the_joins(M, K, N, PK, want):
    """No wgmma tile straddles a join: the dgrad's output columns are
    tiled over L's K rows and then D's PK, the wgrad's output rows over
    x's K columns and then g's PK, each on its own, at the tile shape the
    plan chose, so [L ; D] and [x | g] are never built; at K = 7,392 and
    N = 3,424 that can be one tile more than tiling the joined width
    (7,520 = 29.4 tiles of 256; 3,488 = 27.25 of 128)."""
    x, L, g, D, dz = _bf16(M, K), _bf16(K, N), _bf16(M, PK), _bf16(PK, N), \
        _bf16(M, N)
    plans = {"forward": pf.forward_plan(x, L, g, D),
             "dgrad": pf.dgrad_plan(dz, L, D), "wgrad": pf.tn_plan(x, dz, g)}
    got = {"forward": ((plans["forward"].bm, plans["forward"].bn),
                       plans["forward"].tiles),
           "dgrad": ((plans["dgrad"].bm, plans["dgrad"].bn),
                     plans["dgrad"].tiles),
           "wgrad": (pf.WG_WGRAD_SHAPE, plans["wgrad"].tiles)}
    assert got == want
    (dm, dn), (wm, wn) = want["dgrad"][0], want["wgrad"][0]
    joined = {"dgrad": _ceil(M, dm) * _ceil(K + PK, dn),
              "wgrad": _ceil(K + PK, wm) * _ceil(N, wn)}
    assert got["dgrad"][1] >= joined["dgrad"]
    assert got["wgrad"][1] >= joined["wgrad"]
    assert got["dgrad"][1] - joined["dgrad"] <= _ceil(M, dm)
    assert got["wgrad"][1] - joined["wgrad"] <= _ceil(N, wn)


@pytest.mark.parametrize("M,K,N,PK,want", [
    # a decode step's 4 rows: 17 and 55 slabs over a few 64-row tiles,
    # split 4 to 8 ways
    (4, 1024, 3424, 64, {"forward": 6, "dgrad": 7, "wgrad": 1}),
    (4, 3424, 1024, 64, {"forward": 8, "dgrad": 4, "wgrad": 1}),
    # a pipeline stage's 8 rows: 64 and 65 tiles of 64 x 128 fit clusters
    # of 3 (and 2)
    (8, 8192, 8192, 32, {"forward": 3, "dgrad": 2, "wgrad": 1}),
    # 2,048 rows: hundreds of tiles, a persistent grid
    (2048, 2048, 7392, 128, {"forward": 1, "dgrad": 1, "wgrad": 1}),
    (2048, 1536, 4096, 8, {"forward": 1, "dgrad": 1, "wgrad": 1}),
    # 2,048 rows of narrow sites: a wave of small tiles, no split (the
    # wgrad's long contractions are split: olmoe q/k/v/o, phi3-mini's
    # down at tp 4)
    (2048, 512, 512, 32, {"forward": 1, "dgrad": 1, "wgrad": 8}),
    (2048, 2048, 768, 48, {"forward": 1, "dgrad": 1, "wgrad": 2}),
])
def test_split_plan_at_short_and_long_inputs(M, K, N, PK, want):
    """The wgmma route's splits at 4, 8 and 2,048 rows on the H100's
    residency: the forward's and the dgrad's as ``wg_plan``'s estimate
    picks them, a split where its clusters fit one wave; the wgrad's
    where its reduction (``WG_SPLIT_SLABS``) costs less than the slabs
    it saves.  The grid is one cluster per tile with a split, else one
    block per tile up to the blocks the card holds; a short input
    spreads over at least 40 blocks."""
    x, L, g, D, dz = _bf16(M, K), _bf16(K, N), _bf16(M, PK), _bf16(PK, N), \
        _bf16(M, N)
    plans = {"forward": pf.forward_plan(x, L, g, D),
             "dgrad": pf.dgrad_plan(dz, L, D), "wgrad": pf.tn_plan(x, dz, g)}
    assert {k: p.splits for k, p in plans.items()} == want
    for kind, p in plans.items():
        grid = p.grid if kind == "wgrad" else p.grid[0]
        table = pf.H100_WG_RESIDENT_CLUSTERS[
            pf.WG_WGRAD_SHAPE if kind == "wgrad" else (p.bm, p.bn)]
        if p.splits > 1:
            assert grid == p.tiles * p.splits
            assert p.tiles <= table[p.splits]
        else:
            assert grid == min(p.tiles, table[1])
    if M <= 8:
        assert plans["forward"].grid[0] >= 40
        assert plans["dgrad"].grid[0] >= 40


def test_wg_split_follows_the_residency():
    """The wgrad's ``wg_split`` and the forward's and dgrad's ``wg_plan``
    on cards that hold other numbers of clusters: a split needs its
    clusters in one wave, and a card that holds fewer takes larger tiles
    or fewer splits."""
    assert pf.wg_split(14, 17, pf.H100_WG_RESIDENT_CLUSTERS[(128, 256)]) \
        == (8, 112)
    assert pf.wg_split(14, 17, {**pf.H100_WG_RESIDENT_CLUSTERS[(128, 256)],
                                8: 13, 7: 13}) == (6, 84)
    assert pf.wg_split(14, 17, {s: 8 for s in range(1, 9)}) == (1, 8)
    assert pf.wg_split(500, 34, pf.H100_WG_RESIDENT_CLUSTERS[(128, 256)]) \
        == (1, 132)
    assert pf.wg_split(3, 3, pf.H100_WG_RESIDENT_CLUSTERS[(128, 256)]) == \
        (1, 3)
    half = {shape: {s: max(1, n // 2) for s, n in table.items()}
            for shape, table in pf.H100_WG_RESIDENT_CLUSTERS.items()}
    one = {shape: {s: 1 for s in table}
           for shape, table in pf.H100_WG_RESIDENT_CLUSTERS.items()}
    olmoe4_fwd, olmoe4_dgrad = ((4,), (512,), (512, 32)), \
        ((4,), (512, 32), (512,))
    olmoe_fwd = ((2048,), (512,), (512, 32))

    def got(parts, dgrad, resident):
        p = pf.wg_plan(*parts, dgrad, resident)
        return (p.bm, p.bn), p.splits, p.grid[0]
    assert got(olmoe4_fwd, False, pf.H100_WG_RESIDENT_CLUSTERS) == \
        ((64, 64), 5, 40)
    assert got(olmoe4_dgrad, True, pf.H100_WG_RESIDENT_CLUSTERS) == \
        ((64, 64), 8, 72)
    assert got(olmoe_fwd, False, pf.H100_WG_RESIDENT_CLUSTERS) == \
        ((64, 128), 1, 128)
    assert got(olmoe4_fwd, False, half) == ((64, 64), 5, 40)
    assert got(olmoe4_dgrad, True, half) == ((64, 128), 8, 40)
    assert got(olmoe_fwd, False, half) == ((128, 128), 1, 64)
    assert got(olmoe4_fwd, False, one) == ((128, 256), 1, 1)
    assert got(olmoe4_dgrad, True, one) == ((64, 128), 1, 1)


# (M, K, N, PK) of PERF.md's rows e-n a rank (benchmarks/wgmma_plan.py:
# SITES), each with the forward's and the dgrad's plan: (tile shape,
# splits, blocks)
SITE_PLANS = {
    "e": {(2048, 512, 512, 32): ((64, 128, 1, 128), (128, 128, 1, 80))},
    "f": {(2048, 256, 512, 32): ((64, 64, 1, 256), (64, 128, 1, 96)),
          (2048, 512, 256, 32): ((64, 64, 1, 128), (128, 128, 1, 80))},
    "g": {(1024, 1536, 4096, 24): ((128, 256, 1, 128), (128, 128, 1, 104)),
          (1024, 4096, 1536, 24): ((128, 128, 1, 96), (128, 128, 1, 132))},
    "h": {(2048, 2048, 6144, 128): ((128, 256, 1, 132), (128, 256, 1, 132)),
          (2048, 6144, 2048, 128): ((128, 256, 1, 128), (128, 256, 1, 132))},
    "i": {(2048, 2048, 7392, 128): ((128, 256, 1, 132), (128, 256, 1, 132)),
          (2048, 7392, 2048, 128): ((128, 256, 1, 128), (128, 256, 1, 132))},
    "j": {(2048, 256, 2048, 32): ((128, 256, 1, 128), (64, 128, 2, 192)),
          (2048, 2048, 256, 32): ((64, 64, 2, 256), (128, 256, 1, 132))},
    "k": {(4, 1024, 3424, 64): ((64, 128, 6, 162), (64, 64, 7, 119)),
          (4, 3424, 1024, 64): ((64, 64, 8, 128), (64, 128, 4, 112)),
          (192, 1024, 3424, 64): ((64, 128, 1, 81), (64, 128, 8, 216)),
          (192, 3424, 1024, 64): ((64, 128, 8, 192), (64, 128, 1, 84))},
    "l": {(4, 512, 512, 32): ((64, 64, 5, 40), (64, 64, 8, 72)),
          (4, 256, 512, 32): ((64, 64, 5, 40), (64, 64, 8, 40)),
          (4, 512, 256, 32): ((64, 64, 5, 20), (64, 64, 4, 36)),
          (4, 256, 2048, 32): ((64, 128, 5, 80), (64, 64, 8, 40)),
          (4, 2048, 256, 32): ((64, 64, 7, 28), (64, 64, 4, 132)),
          (192, 512, 512, 32): ((64, 64, 5, 120), (64, 64, 4, 108)),
          (192, 256, 512, 32): ((64, 64, 1, 24), (64, 64, 8, 120)),
          (192, 512, 256, 32): ((64, 64, 5, 60), (64, 64, 1, 27)),
          (192, 256, 2048, 32): ((64, 64, 1, 96), (64, 64, 8, 120)),
          (192, 2048, 256, 32): ((64, 64, 7, 84), (64, 64, 1, 99))},
    "m": {(4, 2048, 6144, 128): ((64, 128, 4, 192), (64, 128, 7, 119)),
          (4, 6144, 2048, 128): ((64, 128, 8, 128), (64, 128, 4, 196)),
          (4, 1280, 3456, 64): ((64, 128, 7, 189), (64, 64, 6, 126)),
          (4, 3456, 1280, 64): ((64, 128, 8, 80), (64, 128, 7, 196)),
          (4, 2048, 7392, 128): ((64, 128, 4, 232), (64, 128, 7, 119)),
          (4, 7392, 2048, 128): ((64, 128, 8, 128), (64, 128, 4, 236)),
          (192, 2048, 6144, 128): ((128, 128, 1, 96), (64, 128, 4, 204)),
          (192, 6144, 2048, 128): ((64, 128, 4, 192), (128, 128, 1, 98)),
          (192, 1280, 3456, 64): ((64, 128, 1, 81), (64, 128, 4, 132)),
          (192, 3456, 1280, 64): ((64, 128, 8, 240), (64, 128, 1, 84)),
          (192, 2048, 7392, 128): ((128, 128, 1, 116), (64, 128, 4, 204)),
          (192, 7392, 2048, 128): ((64, 128, 4, 192), (128, 128, 1, 118))},
    "n": {(2048, 1536, 1536, 8): ((128, 256, 1, 96), (128, 256, 1, 112)),
          (2048, 1536, 4096, 8): ((128, 256, 1, 132), (128, 256, 1, 112)),
          (2048, 4096, 1536, 8): ((128, 256, 1, 96), (128, 128, 1, 132))},
}


@pytest.mark.parametrize("row,shape", [(row, shape) for row, sites in
                                       SITE_PLANS.items() for shape in sites])
def test_wg_plan_at_every_site(row, shape):
    """The forward's and the dgrad's plan at each site of rows e-n on the
    H100's residency (CPU operands): the tile shape, splits and blocks
    ``wg_plan``'s estimate picks (measured against every other launch on
    the card by benchmarks/wgmma_plan.py, PERF.md).  The 2,048-row narrow
    sites (e, f) run 80 to 256 blocks of smaller tiles in one wave, where
    128 x 256 ran 16-48; a 4-row one spreads over 20 blocks or more,
    where it ran 1-8; the wide sites (h, i) keep 128 x 256 with no
    split."""
    M, K, N, PK = shape
    x, L, g, D, dz = _bf16(M, K), _bf16(K, N), _bf16(M, PK), _bf16(PK, N), \
        _bf16(M, N)
    plans = (pf.forward_plan(x, L, g, D), pf.dgrad_plan(dz, L, D))
    assert tuple((p.bm, p.bn, p.splits, p.grid[0]) for p in plans) == \
        SITE_PLANS[row][shape]
    for kind, plan in zip(("forward", "dgrad"), plans):
        _check_wg_plan(plan, shape, kind)
        one_wave = pf.H100_WG_RESIDENT_CLUSTERS[(plan.bm, plan.bn)][1]
        if row in "ef":
            assert 80 <= plan.grid[0] <= one_wave
        if M == 4:
            assert plan.grid[0] >= 20
        if row in "hi":
            assert (plan.bm, plan.bn, plan.splits) == (128, 256, 1)


def test_split_priced_on_real_rows():
    """A split's reduction is priced on the tile's real rows and columns:
    a 4-row tile's costs a sixteenth of a full 64-row one's bytes, so at
    4 rows the plan splits a 64 x 64 tile where at 64 rows of the same
    site it does not; the estimate of each candidate is its walk plus
    that price."""
    assert pf.wg_split_us(4, 64) < pf.wg_split_us(64, 64) < \
        pf.wg_split_us(128, 256)
    assert pf.wg_split_us(64, 64) - pf.wg_split_us(4, 64) == pytest.approx(
        pf.WG_SPLIT_US_PER_KB * 60 * 64 * 4 / 1024)
    for M, want in ((4, 5), (64, 1)):
        cands = pf.wg_candidates((M,), (512,), (256, 32), False)
        plan = pf.wg_plan((M,), (512,), (256, 32), False)
        assert (plan.bm, plan.bn, plan.splits) == (64, 64, want)
        for c in cands:
            if c.splits > 1:
                walk = pf.wg_estimate_us(
                    "forward", (c.bm, c.bn), c.tiles, c.slabs, c.splits,
                    c.grid[0], 0, 0, pf.H100_WG_RESIDENT_CLUSTERS[
                        (c.bm, c.bn)], split_us=0.0, split_us_per_kb=0.0)
                assert c.est_us == pytest.approx(
                    walk + pf.wg_split_us(min(M, c.bm), min(512, c.bn)))


@pytest.mark.parametrize("shape", pf.WG_SHAPES)
def test_wg_shape_fits_an_sm(shape):
    """Each tile shape's block: its ring (with the split's fp32 partial
    tile in it) within the 227 KB a block may use, as many blocks as its
    shared memory allows resident on an SM together with their threads,
    and the H100 residency table of that many blocks an SM: 132 of them
    for S = 1, and non-increasing in S, S blocks to a cluster."""
    bm, bn = shape
    smem, per_sm = pf.WG_SMEM_BYTES[shape], pf.wg_blocks_per_sm(shape)
    assert smem <= pf.SMEM_BUDGET_BYTES
    assert 4 * bm * bn <= smem - pf.WG_SLACK
    assert per_sm * (smem + pf.WG_BLOCK_RESERVED) <= pf.WG_SM_SMEM
    assert per_sm * pf.wg_threads(bm) <= 2048
    assert per_sm == {(128, 256): 1, (128, 128): 1, (64, 128): 2,
                      (64, 64): 2}[shape]
    table = pf.H100_WG_RESIDENT_CLUSTERS[shape]
    assert sorted(table) == list(range(1, pf.WG_MAX_SPLITS + 1))
    assert table[1] == pf.H100_SMS * per_sm
    assert all(table[s + 1] <= table[s] for s in range(1, pf.WG_MAX_SPLITS))
    assert all(s * table[s] <= table[1] for s in table)


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
