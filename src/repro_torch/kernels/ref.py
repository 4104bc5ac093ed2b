"""Plain torch versions of the port's kernels: the CPU path of each
kernel's wrapper, and what ``chip_smoke.py`` holds each kernel to on the
card."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """[B, S, H, hd] x [B, S, KV, hd] -> [B, S, H, hd]; GQA broadcast;
    float32 softmax (the reference's ``kernels/ref.py``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k.to(torch.float32))
    s = s * hd ** -0.5
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask[None, :, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def phantom_fused_ref(x, L, g, D):
    """z = x @ L + g @ D with float32 accumulation, in x's dtype (the
    reference's ``kernels/ref.py: phantom_fused_ref``)."""
    f = torch.float32
    z = x.to(f) @ L.to(f) + g.to(f) @ D.to(f)
    return z.to(x.dtype)


def matmul_nt_ref(a, b):
    """c[M, J] = a[M, N] @ b[J, N]^T, float32 accumulation, a's dtype."""
    return (a.to(torch.float32) @ b.to(torch.float32).T).to(a.dtype)


def matmul_tn_ref(a, b):
    """c[I, N] = a[M, I]^T @ b[M, N], float32 accumulation, a's dtype."""
    return (a.to(torch.float32).T @ b.to(torch.float32)).to(a.dtype)
