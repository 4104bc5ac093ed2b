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
The CUDA kernels themselves run only on a card (``cuda`` marker).
"""
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
    kernels' tiles fit one H100 block; tiles past 227 KB raise."""
    need = pf.check_kernel_fits(pf.TILE, pf.TILE, pf.TILE)
    assert need == pf.SMEM_BYTES == pf.kernel_smem_bytes(
        pf.TILE, pf.TILE, pf.TILE) < pf.SMEM_BUDGET_BYTES
    with pytest.raises(KernelConfigError, match="shared memory"):
        pf.check_kernel_fits(256, 256, 128)


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) to run the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", _cases()
                         + [((64, 2048, 2048, 128), "float32")])
def test_cuda_kernels_match_plain(cuda_device, shape, dtype):
    """Each kernel launches once and agrees with its plain version."""
    M, K, N, PK = shape
    x, L, g, D, dz = [t.to(cuda_device) for t in _torch(_arrays(
        M + N, (M, K), (K, N), (M, PK), (PK, N), (M, N)), dtype)]
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
        _close(a.cpu(), b.cpu(), TOL[dtype], name)
