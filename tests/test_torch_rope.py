"""Partial and full RoPE in the PyTorch port against the JAX reference:
which dims rotate, how they pair (rotate_half over the rotated part) and
where the cast to the input dtype happens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import rope as jax_rope
from repro_torch.configs.base import get_config
from repro_torch.models import rope as torch_rope


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("fraction", [0.5, 1.0, 0.25])
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("per_row", [True, False])
def test_apply_rope_matches_reference(hd, fraction, dtype, tol, per_row):
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 12, 3, hd).astype(np.float32)
    if per_row:
        pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    else:
        pos = np.arange(5, 17, dtype=np.int32)
    want = jax_rope.apply_rope(jnp.asarray(x).astype(getattr(jnp, dtype)),
                               jnp.asarray(pos), fraction=fraction)
    got = torch_rope.apply_rope(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(pos).long(), fraction=fraction)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_rope_for_chatglm3_rotates_half_the_head():
    """chatglm3's "2d" rope: the last half of each head passes through
    unchanged, as in the reference's ``rope_for``."""
    cfg, jcfg = get_config("chatglm3-6b"), jax_get_config("chatglm3-6b")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 2, 128).astype(np.float32)
    pos = np.arange(4, dtype=np.int32)[None]
    got = torch_rope.rope_for(cfg, torch.from_numpy(x),
                              torch.from_numpy(pos).long()).numpy()
    want = np.asarray(jax_rope.rope_for(jcfg, jnp.asarray(x),
                                        jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 64:], x[..., 64:])
