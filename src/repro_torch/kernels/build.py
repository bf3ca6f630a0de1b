"""Build and load the hand-written Hopper kernels of every kernel package.

Each kernel is one CUDA C++ source under ``<package>/csrc/`` with a plain C
interface (``extern "C"``), compiled by ``nvcc`` for ``sm_90a`` into its own
shared library and loaded with ``ctypes``.  Headers shared by several
packages live in ``kernels/csrc/`` (on the include path).  Libraries go to
``build/kernels/`` at the repo root; a library's name carries a hash of its
source, its package's headers, the shared headers and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
:func:`build` compiles every missing library at once, one ``nvcc`` process
each.  Nothing here runs at import time: the CPU tests import this module on
a machine with neither ``nvcc`` nor a card.

Each kernel package binds its C symbol through :class:`launch.Kernel`;
every C symbol ``<name>`` has a companion ``<name>_error(int)`` returning
``cudaGetErrorString`` of its return code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
SHARED_CSRC = KERNELS_DIR / "csrc"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
# (package, source under <package>/csrc, C symbol)
KERNELS = (
    ("segment_aggregate", "segment_aggregate.cu", "segment_aggregate"),
    ("segment_aggregate", "level_segment_aggregate.cu", "level_segment_aggregate"),
    ("semiring_contract", "semiring_contract.cu", "semiring_contract"),
    ("tropical_contract", "tropical_contract.cu", "tropical_contract"),
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the hand-written kernels need the CUDA toolkit")


def library_path(package: str, source: str, symbol: str) -> Path:
    csrc = KERNELS_DIR / package / "csrc"
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(csrc.glob("*.cuh")) + sorted(SHARED_CSRC.glob("*.cuh"))
    for f in [csrc / source] + headers:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{symbol}-{h.hexdigest()[:12]}.so"


def build() -> dict[str, Path]:
    """Compile every kernel whose library is missing, all sources at once.

    Returns ``{C symbol: library path}``.  Each build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<library>.log``.  Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for package, source, symbol in KERNELS:
        path = library_path(package, source, symbol)
        if path.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(f"{path}.log", "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(SHARED_CSRC), "-o", str(tmp),
             str(KERNELS_DIR / package / "csrc" / source)],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running.append((symbol, path, tmp, proc, log))
    failed = []
    for symbol, path, tmp, proc, log in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{symbol} (nvcc exit {rc}):\n{Path(f'{path}.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {symbol: library_path(p, s, symbol) for p, s, symbol in KERNELS}


def load(symbol: str) -> ctypes.CDLL:
    """The loaded library of kernel ``symbol`` (building every missing
    library first), with ``<symbol>_error`` typed."""
    lib = _libs.get(symbol)
    if lib is None:
        lib = ctypes.CDLL(str(build()[symbol]))
        err = getattr(lib, f"{symbol}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[symbol] = lib
    return lib


def check(lib: ctypes.CDLL, symbol: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{symbol}_error")(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} (cudaError {rc})")
