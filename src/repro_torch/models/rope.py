"""Rotary position embeddings: full, partial (chatglm3 "2d" rope) and
M-RoPE (qwen2-vl's three position axes).

Convention, as in the reference: the first ``rot = fraction * hd`` dims
(rounded down to even) rotate, split into two halves paired as
``(x[i], x[i + rot/2])`` (``rotate_half``); the remaining dims pass
through.  Angles are computed in float32 and cast to ``x.dtype`` before
the rotation, which runs in ``x.dtype``.

M-RoPE, as the reference computes it: the head dim is cut into three
contiguous sections (``mrope_sections``: a quarter, three eighths and
three eighths of its pairs), and section ``i`` is rotated by
``apply_rope`` over its own width at position row ``i`` (t, h, w), so
each section has its own frequency ladder starting at 1.  Qwen2-VL's
published rotary instead takes the three sections' frequencies from one
ladder over the whole head dim (ROADMAP.md queue 3).
"""
from __future__ import annotations

import torch


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _angles(positions, rot_dim: int, theta: float):
    """positions [...] -> cos/sin [..., rot_dim] (float32)."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    inv = 1.0 / (theta ** exponent)
    ang = positions[..., None].to(torch.float32) * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, *, fraction: float = 1.0,
               theta: float = 10000.0):
    """x: [B, S, H, hd]; positions: [B, S] (or [S])."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _angles(positions, rot, theta)               # [B, S, rot]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    xr = xr * cos + _rotate_half(xr) * sin
    return torch.cat([xr, xp], dim=-1)


def mrope_sections(hd: int):
    """The widths of M-RoPE's (t, h, w) sections of a head dim ``hd``:
    a quarter of its pairs, then half of the rest each (the remainder
    to w)."""
    half = hd // 2
    s0 = half // 4
    s1 = (half - s0) // 2
    s2 = half - s0 - s1
    return (2 * s0, 2 * s1, 2 * s2)


def apply_mrope(x, positions3, *, theta: float = 10000.0):
    """x: [B, S, H, hd]; positions3: [3, B, S] (the t, h and w position
    ids).  Each section rotates at its own row, over its own width."""
    outs, off = [], 0
    for i, sec in enumerate(mrope_sections(x.shape[-1])):
        outs.append(apply_rope(x[..., off:off + sec], positions3[i],
                               theta=theta))
        off += sec
    if off < x.shape[-1]:
        outs.append(x[..., off:])
    return torch.cat(outs, dim=-1)


def rope_for(cfg, x, positions):
    """Dispatch on cfg.rope; positions [B, S], or [3, B, S] for
    M-RoPE."""
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, theta=cfg.rope_theta)
    frac = cfg.rope_fraction if cfg.rope == "partial" else 1.0
    return apply_rope(x, positions, fraction=frac, theta=cfg.rope_theta)
