"""PyTorch port of the phantom-parallelism system, for NVIDIA Hopper.

Mirrors the module layout of the JAX package ``repro`` (the reference,
which it never imports).  Entry points run on the card unless the caller
passes ``device="cpu"``; on the CPU every hand-written kernel's wrapper
runs the kernel's plain torch version.
"""
