"""Serving ring attention, the vision-language and the encoder-decoder
families over a dp 2 x tp 4 mesh: the port's engine on 8 gloo CPU ranks
against the reference's on its ``mesh24`` and against the port's tp = 1
engine, on qwen2.5-14b (ring attention: 4 heads, KV 2), qwen2-vl-72b
(M-RoPE and the vision splice) and seamless-m4t-large-v2 (the encoder at
prefill, the cross K/V cache sequence-sharded and read through the
log-sum-exp merge) smoke configs in float32, each with its own
projection map (phantom MLP sites: the ``fp`` stream) and with the
router's tensor candidate (``sp`` at prefill, ``rep`` at decode).  The
vision embeddings and the frames are drawn non-zero from each row's
tokens on both sides (on zero frames the encoder's memory is exactly
zero).  Held, as in ``tests/test_torch_serve_mesh_moe_ssm.py``
(``tests/serve_families.py``):

  * prefill and decode logits against the reference's ``prefill_fn`` /
    ``decode_fn`` within rtol/atol 1e-4, and the decode against the full
    forward at position 16 for qwen2.5 and qwen2-vl; seamless's decode
    weighs the cross cache's zero rows past the encoder's length, as the
    reference's does (ROADMAP.md queue 3), which the full forward does
    not, so its decode is held to ``decode_fn`` alone;
  * each rank's cache (the self K/V, and seamless's cross K/V) against
    the reference engine's cut to the rank's rows and positions;
  * greedy streams through a poisson ``replay`` against the reference
    engine's and the port's tp = 1 engine's, token for token;
  * each rank's wire bytes against ``chip_smoke.py: serve_wire_bytes``.
"""
import pytest

import serve_families as fam

ARCHS = ("qwen2.5-14b", "qwen2-vl-72b", "seamless-m4t-large-v2")
CASES = [f"{a}/{m}" for a in ARCHS for m in fam.MAPS]


@pytest.fixture(scope="module")
def runs(mesh24):
    return fam.run(mesh24, ARCHS)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_reference(runs, case):
    fam.check_logits(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_rank_cache_matches_reference(runs, case):
    fam.check_cache(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_replay_streams_match_reference_and_tp1(runs, case):
    fam.check_streams(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_wire_bytes_match_the_count_from_shapes(runs, case):
    fam.check_wire(runs, case)
