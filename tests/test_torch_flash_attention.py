"""Flash attention in the PyTorch port against the JAX reference.

The port's plain version (``repro_torch.kernels.ref``), its wrapper's
CPU dispatch and its blockwise core are held to the reference's oracle
``repro.kernels.ref.flash_attention_ref`` and to its XLA blockwise core
(``repro.models.attention.attn_block_update``).  The reference's Pallas
kernel cannot be the oracle here: it calls ``pl.load``, which the
installed jax no longer has.  Inputs come from numpy seeds and go to
both sides unchanged.

Tolerances: float32 rtol 2e-3 / atol 2e-4, bf16 3e-2, as the reference's
own kernel tests use (the two sides sum in different orders; bf16 rounds
each output once).  ``flash_attention_vjp``'s gradients are held to
``jax.vjp`` of the same oracle at float32 rtol 1e-4 / atol 1e-5 (one
dense float32 computation on each side) and at the bf16 tolerance.
The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda_kernels.py``, which imports no JAX.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_supported)
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as torch_attn

TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

# (B, S, H, KV, hd): GQA groups Hg = H/KV of 1, 2 and 16; hd 16 and 128;
# S 16, 48 and 128
SHAPES = [
    (2, 16, 4, 4, 16),
    (1, 48, 4, 2, 16),
    (1, 128, 4, 2, 16),
    (2, 16, 32, 2, 128),
    (1, 48, 32, 2, 128),
    (1, 128, 16, 1, 128),
]


def _inputs(B, S, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _jax_blockwise(q, k, v, causal, kv_chunk=512):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    acc = jax_attn.init_acc(B, S, KV, H // KV, hd)
    q_pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    acc = jax_attn.attn_block_update(acc, jax_attn._gqa_q(q, KV), k, v,
                                     q_pos, 0, causal=causal,
                                     kv_chunk=kv_chunk)
    return jax_attn.finalize_acc(acc, q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", SHAPES)
def test_flash_plain_and_cpu_dispatch_match_reference(B, S, H, KV, hd,
                                                      causal, dtype):
    arrs = _inputs(B, S, H, KV, hd, seed=S + H + hd)
    want = _np(jax_flash_ref(*_jax(arrs, dtype), causal=causal))
    want_xla = _np(_jax_blockwise(*_jax(arrs, dtype), causal))
    q, k, v = _torch(arrs, dtype)
    plain = flash_attention_ref(q, k, v, causal=causal)
    dispatched = flash_attention(q, k, v, causal=causal)
    assert plain.dtype == q.dtype and plain.shape == q.shape
    for got in (plain, dispatched):
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])
        np.testing.assert_allclose(_np(got), want_xla, **TOL[dtype])


@pytest.mark.parametrize("kv_chunk", [16, 48])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_core_matches_reference(causal, kv_chunk):
    """The port's plain core (the ``xla`` backend) against the
    reference's, with several kv chunks, in float32."""
    arrs = _inputs(2, 48, 8, 2, 16, seed=7)
    want = _np(_jax_blockwise(*_jax(arrs, "float32"), causal,
                              kv_chunk=kv_chunk))
    q, k, v = _torch(arrs, "float32")
    acc = torch_attn.init_acc(2, 48, 2, 4, 16)
    q_pos = torch.arange(48).expand(2, 48)
    acc = torch_attn.attn_block_update(acc, torch_attn._gqa_q(q, 2), k, v,
                                       q_pos, 0, causal=causal,
                                       kv_chunk=kv_chunk)
    got = torch_attn.finalize_acc(acc, torch.float32)
    np.testing.assert_allclose(_np(got), want, **TOL["float32"])


def test_blockwise_core_decode_kv_limit_matches_reference():
    """One query per row at per-row positions against a cache whose rows
    past ``pos`` are masked (the decode path)."""
    rng = np.random.RandomState(3)
    q = rng.randn(3, 1, 2, 4, 16).astype(np.float32)
    k = rng.randn(3, 32, 2, 16).astype(np.float32)
    v = rng.randn(3, 32, 2, 16).astype(np.float32)
    pos = np.array([0, 9, 31], np.int32)
    kw = dict(causal=True, kv_chunk=16)
    ja = jax_attn.attn_block_update(
        jax_attn.init_acc(3, 1, 2, 4, 16), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pos)[:, None], 0,
        kv_limit=jnp.asarray(pos) + 1, **kw)
    tp = torch.from_numpy(pos).long()
    ta = torch_attn.attn_block_update(
        torch_attn.init_acc(3, 1, 2, 4, 16), torch.from_numpy(q),
        torch.from_numpy(k), torch.from_numpy(v), tp[:, None], 0,
        kv_limit=tp + 1, **kw)
    np.testing.assert_allclose(_np(torch_attn.finalize_acc(ta,
                                                           torch.float32)),
                               _np(jax_attn.finalize_acc(ja, jnp.float32)),
                               **TOL["float32"])


@pytest.mark.parametrize("s_q,s_kv,h,kv", [
    (16, 16, 32, 2), (48, 48, 4, 2), (144, 144, 4, 2), (256, 256, 8, 2),
    (16, 32, 4, 2), (16, 16, 6, 4), (16, 16, 4, 0)])
def test_supported_gate_matches_reference(s_q, s_kv, h, kv):
    from repro.kernels.flash_attention import \
        flash_attention_supported as jax_supported
    assert flash_attention_supported(s_q, s_kv, h, kv) == \
        jax_supported(s_q, s_kv, h, kv)


def _tc_constants():
    """The ``constexpr int`` values of the bf16 kernel's ``namespace tc``
    in ``csrc/flash_attention.cu``."""
    src = (Path(ops.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    body = src[src.index("namespace tc {"):
               src.index("}  // namespace tc")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", body)}


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 96, 128])
def test_bf16_kernel_fits_two_blocks_an_sm(hd):
    """The bf16 kernel's tiles, from its source: 16 rows a warp, and Q
    plus double-buffered K and V (rows padded by 16 bytes) in the shared
    memory of two blocks an SM of an H100 (228 KB), as its
    ``__launch_bounds__`` promise."""
    tc = _tc_constants()
    assert tc["BQ"] == 16 * tc["WARPS"]
    smem = (tc["BQ"] + 4 * tc["BKV"]) * (hd + 8) * 2
    assert 2 * smem <= 228 * 1024
    assert hd % 16 == 0 and tc["BKV"] % 16 == 0    # whole mma k-steps


def test_backend_table():
    """"xla" is the plain core; "pallas" and "auto" are the kernel path
    (which the wrapper runs as the plain version on CPU tensors)."""
    assert ops.resolve_kernel_backend("xla") == "xla"
    assert ops.resolve_kernel_backend("pallas") == "pallas"
    assert ops.resolve_kernel_backend("auto") == "pallas"
    with pytest.raises(ValueError):
        ops.resolve_kernel_backend("triton")


def test_wrapper_refuses_other_devices_and_counts_nothing_on_cpu():
    before = flash_attention.launches
    q, k, v = _torch(_inputs(1, 16, 4, 2, 16), "float32")
    flash_attention(q, k, v)
    assert flash_attention.launches == before
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# (B, S, H, KV, hd): MHA at hd 96 (phi3-mini) and 80 (stablelm-3b), GQA
VJP_SHAPES = [(2, 32, 4, 4, 96), (1, 48, 4, 4, 80), (2, 16, 4, 2, 16)]
VJP_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": TOL["bfloat16"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", VJP_SHAPES)
def test_flash_attention_vjp_matches_jax_vjp(B, S, H, KV, hd, causal,
                                             dtype):
    """Forward and the gradients of q, k and v for one cotangent, against
    ``jax.vjp`` of the reference's oracle (its ``custom_vjp`` backward)."""
    arrs = _inputs(B, S, H, KV, hd, seed=hd + S)
    do = np.random.RandomState(1).randn(B, S, H, hd).astype(np.float32)
    jq, jk, jv = _jax(arrs, dtype)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash_ref(q, k, v, causal=causal), jq, jk, jv)
    want_grads = vjp(jnp.asarray(do).astype(getattr(jnp, dtype)))
    q, k, v = (t.requires_grad_(True) for t in _torch(arrs, dtype))
    out = ops.flash_attention_vjp(q, k, v, causal=causal)
    out.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    assert out.dtype == q.grad.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out.detach()), _np(want),
                               **VJP_TOL[dtype])
    for got, w, name in zip((q.grad, k.grad, v.grad), want_grads, "qkv"):
        np.testing.assert_allclose(_np(got), _np(w), err_msg=name,
                                   **VJP_TOL[dtype])


def test_head_dims_cover_the_dense_configs():
    """Every LM config's head dim, full and smoke, is one the kernel
    takes where its attention can reach the kernel (head mode; ring
    attention, granite-moe-3b's hd 64 among it, never runs it; an
    attention-free config, mamba2-370m, has none; seamless-m4t-large-v2
    brings hd 64 in head mode): the gate checks none, so a missing one
    would raise on the card where the reference runs its kernel."""
    from repro_torch.configs.base import _MODULES, get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    cfgs = [get_config(a, smoke=s) for a in _MODULES
            if not a.startswith("paper-ffn") for s in (False, True)]
    dims = {c.resolved_head_dim() for c in cfgs
            if c.attn_shard != "ring" and c.attn_period != -1}
    assert dims == {16, 64, 80, 96, 128} and dims <= set(HEAD_DIMS)
