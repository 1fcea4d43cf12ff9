"""PyTorch/CUDA port of the RecMG tiered-memory DLRM system.

The JAX package ``src/repro`` is the reference; each module here sits at
the same path as its counterpart there.  The port imports ``torch`` and
``numpy`` and never ``jax`` or anything of ``repro``.
"""
