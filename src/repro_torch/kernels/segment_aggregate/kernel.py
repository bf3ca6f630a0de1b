"""Build, load and launch the Hopper segment-aggregate kernels.

Two hand-written CUDA C++ kernels (``csrc/``) replace the two Pallas TPU
kernels of ``src/repro/kernels/segment_aggregate/kernel.py``:

=========================  =================================================
``segment_aggregate``      kernel.py:62 ``segment_aggregate`` (body ``_kernel``)
``level_segment_aggregate`` kernel.py:125 ``level_segment_aggregate``
                           (body ``_level_kernel``)
=========================  =================================================

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``build/kernels/`` at the repo
root.  The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  All sources compile
at once (one ``nvcc`` process each).  Nothing here runs at import time: the
CPU tests import this module on a machine with neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
SOURCES = {
    "segment_aggregate": "segment_aggregate.cu",
    "level_segment_aggregate": "level_segment_aggregate.cu",
}
HEADERS = ("segment_aggregate.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
OP_CODES = {"sum": 0, "min": 1, "max": 2}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the segment-aggregate kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> dict[str, Path]:
    """Compile every kernel whose library is missing, all sources at once.

    Returns ``{kernel name: library path}``.  Each build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<library>.log``.  Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for name, src in SOURCES.items():
        path = library_path(name)
        if path.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(f"{path}.log", "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running.append((name, path, tmp, proc, log))
    failed = []
    for name, path, tmp, proc, log in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n{Path(f'{path}.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in SOURCES}


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        for n, path in build().items():
            if n in _libs:
                continue
            loaded = ctypes.CDLL(str(path))
            fn = getattr(loaded, n)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = getattr(loaded, f"{n}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[n] = loaded
        lib = _libs[name]
    return lib


def launch(name: str, codes: torch.Tensor, values: torch.Tensor, out: torch.Tensor,
           op: str) -> None:
    """Launch kernel ``name`` on the current stream of ``codes``' device.

    ``codes`` (N,) int32, ``values`` (N, V) float32 and ``out`` (G, V)
    float32 are contiguous CUDA tensors; ``out`` holds the ⊕-identity.  The
    caller checks all of that.  Raises if the launch is refused.
    """
    lib = _load(name)
    n, v = values.shape
    g = out.shape[0]
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = getattr(lib, name)(
            codes.data_ptr(), values.data_ptr(), out.data_ptr(),
            n, v, g, OP_CODES[op], stream,
        )
    if rc != 0:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
