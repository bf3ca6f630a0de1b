"""PyTorch/CUDA port of the CJT/Treant dashboard accelerator.

The JAX package ``repro`` is the reference; this package imports none of it
and no JAX.  Engines run on a CUDA device unless the caller passes
``device="cpu"``.
"""
