"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names and imports neither JAX nor ``repro``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where every kernel wrapper takes
its plain PyTorch version.
"""
