"""Rotary position embeddings: full and partial (chatglm3 "2d" rope).

Convention, as in the reference: the first ``rot = fraction * hd`` dims
(rounded down to even) rotate, split into two halves paired as
``(x[i], x[i + rot/2])`` (``rotate_half``); the remaining dims pass
through.  Angles are computed in float32 and cast to ``x.dtype`` before
the rotation, which runs in ``x.dtype``.
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


def rope_for(cfg, x, positions):
    """Dispatch on cfg.rope; positions [B, S]."""
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        raise NotImplementedError(
            "M-RoPE arrives with the vision-language slice "
            "(ROADMAP.md queue 1)")
    frac = cfg.rope_fraction if cfg.rope == "partial" else 1.0
    return apply_rope(x, positions, fraction=frac, theta=cfg.rope_theta)
