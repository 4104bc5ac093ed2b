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
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_supported)

KERNEL_BACKENDS = ("xla", "pallas", "auto")


def resolve_kernel_backend(backend: str) -> str:
    """'pallas' | 'auto' -> 'pallas' (the kernel path), 'xla' -> 'xla';
    validates the name."""
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {backend!r}; "
                         f"known: {KERNEL_BACKENDS}")
    return "xla" if backend == "xla" else "pallas"
