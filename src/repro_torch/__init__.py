"""PyTorch/CUDA port of the Arcus reproduction (``src/repro``).

Mirrors the JAX package module for module; imports ``torch`` and numpy and
never ``jax`` or anything of ``repro``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
