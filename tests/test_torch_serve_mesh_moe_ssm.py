"""Serving the MoE, SSM and hybrid families over a dp 2 x tp 4 mesh: the
port's engine on 8 gloo CPU ranks against the reference's on its
``mesh24`` and against the port's tp = 1 engine, on olmoe-1b-7b,
mamba2-370m and jamba-1.5-large-398b's smoke configs in float32, each
with its own projection map (olmoe's phantom q/k/v/o: the ``fp`` stream,
the experts' two all-to-alls and the router logits' psum; mamba2's
phantom in/out; jamba's phantom MLP sites, its attention sub at KV 2,
replicated at tp 4, and its MoE in ``fp``) and with the router's tensor
candidate (``sp`` at prefill, ``rep`` at decode, where each rank runs
its own experts).  One numpy draw gives the global parameters; the
reference takes them whole and each rank its shards.  Held
(``tests/serve_families.py``):

  * the logits of a prefill of 16 tokens and of one decode step at
    position 16 after the engine's splice equal the reference's
    ``prefill_fn`` / ``decode_fn`` and its full forward
    (``forward_logits``) at position 16, within rtol/atol 1e-4 (float32
    on both sides, summed in different orders; the SSD blocks' chunked
    prefill against the stepwise decode too);
  * each rank's cache after submitting a group of prompts equals the
    reference engine's global cache cut to the rank's rows and its
    positions (K/V), channels (the conv rows) or heads (the SSD state),
    within 1e-4;
  * the greedy streams of six prompts through a poisson ``replay``
    equal the reference engine's and the port's tp = 1 engine's, token
    for token (a phantom model's tp = 1 twin serves the dense matrices
    its sites compute);
  * each rank's counted wire bytes of the prefill and of the decode step
    equal ``chip_smoke.py: serve_wire_bytes``, to the byte.

The hybrid is held to 1e-4 as well: the reference's atol of 0.1 covers
its bf16 jitter over 8 layers, and these runs are float32.
"""
import pytest

import serve_families as fam

ARCHS = ("olmoe-1b-7b", "mamba2-370m", "jamba-1.5-large-398b")
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
