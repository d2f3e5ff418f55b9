"""Hippo stage-tree HPO system — the PyTorch / CUDA package.

Counterpart of the JAX package ``repro``: same sub-package and module
names, no import of ``jax`` or of ``repro``.  Entry points run on a CUDA
device unless the caller passes ``device="cpu"``.
"""
