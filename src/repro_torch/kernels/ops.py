"""The public kernel API: backend resolution and the kernel entry points.

``resolve_kernel_backend`` maps ``ProjectionSpec.kernel_backend`` to the
executing path:

  ========== =========================== ===============================
  value      on a CUDA tensor            on a CPU tensor
  ========== =========================== ===============================
  "xla"      the plain torch core        the plain torch core
  "pallas"   the hand-written kernel     the kernel's plain version
  "auto"     the hand-written kernel     the kernel's plain version
  ========== =========================== ===============================

The name "pallas" is the reference's; in the port it selects the
hand-written Hopper kernel.  The wrapper decides between kernel and plain
version from the tensor's device alone, and never falls back on a CUDA
tensor.

``flash_attention_vjp`` is the attention core the model calls, the
counterpart of the reference's ``custom_vjp``: its forward is the flash
kernel (the plain version on a CPU tensor) through its dispatcher
operator, so ``FlopCounterMode`` counts it, its backward autograd
through the plain version ``kernels/ref.py: flash_attention_ref``, as the
reference's backward is ``jax.vjp`` of its dense oracle.  A fused
backward kernel would go beyond the reference.

``phantom_fused_linear`` binds the three phantom kernels into one
differentiable op, as the reference's ``custom_vjp`` does: the forward is
the fused (local + ghost-decompress) GEMM, the backward one dgrad and one
wgrad launch, each through its dispatcher operator
(``torch.ops.repro_torch.*``), so ``FlopCounterMode`` counts them.
Collectives stay outside the op.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_supported)
from repro_torch.kernels.phantom_fused import (  # noqa: F401
    KernelConfigError, phantom_fused_dgrad, phantom_fused_matmul,
    phantom_fused_wgrad)
from repro_torch.kernels.ref import flash_attention_ref

KERNEL_BACKENDS = ("xla", "pallas", "auto")


def resolve_kernel_backend(backend: str) -> str:
    """'pallas' | 'auto' -> 'pallas' (the kernel path), 'xla' -> 'xla';
    validates the name."""
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {backend!r}; "
                         f"known: {KERNEL_BACKENDS}")
    return "xla" if backend == "xla" else "pallas"


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return torch.ops.repro_torch.flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        # the dense oracle's gradients: materialises the [B, S, KV, Hg, S]
        # float32 scores, as the reference's backward does
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_ref(q, k, v, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        return dq, dk, dv, None


def flash_attention_vjp(q, k, v, *, causal: bool = True):
    """``flash_attention`` forward with a differentiable backward (autograd
    through the plain version): what the attention core calls, so that a
    gradient never reaches the kernel's wrapper, which has none.  The
    forward goes through the kernel's dispatcher operator
    (``torch.ops.repro_torch.flash_attention``), so ``FlopCounterMode``
    counts it and a meta tensor gets its shape."""
    return _FlashAttention.apply(q, k, v, bool(causal))


class _FusedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, L, g, D):
        ctx.save_for_backward(x, L, g, D)
        return torch.ops.repro_torch.phantom_fused_matmul(x, L, g, D)

    @staticmethod
    def backward(ctx, dz):
        x, L, g, D = ctx.saved_tensors
        dz = dz.to(x.dtype).contiguous()
        dx, dg = phantom_fused_dgrad(dz, L, D)
        dL, dD = phantom_fused_wgrad(x, g, dz)
        return (dx.to(x.dtype), dL.to(L.dtype), dg.to(g.dtype),
                dD.to(D.dtype))


def phantom_fused_linear(x, L, g, D):
    """z = x @ L + g @ D with the fused kernels forward AND backward.

    x [..., K] local activation shard, L [K, N] diagonal block,
    g [..., PK] gathered ghosts, D [PK, N] concatenated decompressors
    -> z [..., N].  Leading batch dims are flattened around the 2-D
    kernels."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    g2 = g.reshape(-1, g.shape[-1]).contiguous()
    z = _FusedLinear.apply(x2, L.contiguous(), g2, D.contiguous())
    return z.reshape(*lead, L.shape[1])
