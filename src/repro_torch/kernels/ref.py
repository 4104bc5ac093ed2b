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
