"""Logical parallel axes and the device the port runs on.

The reference binds logical axes (``dp``, ``tp``, ``pp``) to a JAX mesh
and runs every forward inside ``shard_map``.  This slice of the port
runs on one device: dp = tp = pp = 1, so every collective of the
reference is the identity and every residual layout (sequence-, feature-
or un-sharded) is the full ``[B, S, d]`` tensor.  ``MeshAxes`` keeps the
reference's axis sizes so code that reads ``axes.tp`` stays in place for
the multi-device slice, and refuses any other mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MULTI_DEVICE_TODO = ("ROADMAP.md queue 1, item 1 (collectives slice: "
                     "tp > 1 and dp > 1 over torch.distributed)")


@dataclass(frozen=True)
class MeshAxes:
    tp: int = 1                      # size of the model axis
    dp: int = 1                      # data-parallel ways
    pp: int = 1                      # pipeline stages

    def __post_init__(self):
        if (self.tp, self.dp, self.pp) != (1, 1, 1):
            raise NotImplementedError(
                f"mesh dp={self.dp} tp={self.tp} pp={self.pp}: the port "
                f"runs on one device so far; see {MULTI_DEVICE_TODO}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU.  Asking for the card on a machine without one is
    an error, never a quiet switch to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return dev
