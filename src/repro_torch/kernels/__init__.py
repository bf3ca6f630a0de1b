"""Hand-written Hopper kernels (CUDA C++ under each kernel's ``csrc/``), each
beside its plain PyTorch version (``ref.py``) and its wrapper (``ops.py``)."""
