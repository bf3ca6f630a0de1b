"""Load and launch the Hopper tropical_contract kernel.

The hand-written CUDA C++ kernel ``csrc/tropical_contract.cu`` replaces the
Pallas TPU kernel ``src/repro/kernels/tropical_contract/kernel.py:37``
``tropical_contract`` (body ``_kernel``).  It is built by
:mod:`repro_torch.kernels.build` on first use; nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SYMBOL = "tropical_contract"


def _load() -> ctypes.CDLL:
    lib = build.load(SYMBOL)
    fn = getattr(lib, SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(m: torch.Tensor, r: torch.Tensor, out: torch.Tensor, is_min: bool) -> None:
    """Launch on the current stream of ``m``'s device.

    ``m`` (G, B), ``r`` (B, A) float32 and ``out`` (G, A) float32 filled
    with the ⊕-identity: contiguous CUDA tensors, checked by the caller.
    Raises if the launch is refused.
    """
    lib = _load()
    g, b = m.shape
    a = r.shape[1]
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = getattr(lib, SYMBOL)(
            m.data_ptr(), r.data_ptr(), out.data_ptr(), g, b, a, int(is_min), stream,
        )
    build.check(lib, SYMBOL, rc)
