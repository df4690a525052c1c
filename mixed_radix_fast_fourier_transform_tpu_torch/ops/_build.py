"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface, ``_build/libspectral_kernels.so`` inside the package, loaded with
ctypes.  The build runs at the first CUDA launch
(never at import, so the package imports where there is no CUDA toolkit)
and again whenever a source or the flags change.  It uses only the sources
in the package and none of PyTorch's headers, which keeps it to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
# Where the library is built (settable: set_build_dir), the library, the
# digest of the sources and flags it was built from, and ptxas's report
# (registers, shared memory and spills of every kernel instantiation) from
# the build that made it.
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libspectral_kernels.so"
_STAMP = BUILD_DIR / "libspectral_kernels.sha256"
PTXAS_LOG = BUILD_DIR / "ptxas.txt"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB = None
# Seconds the last build took in this process (0.0 when the library was
# already up to date).
BUILD_SECONDS = 0.0


def set_build_dir(path) -> Path:
    """Build and load the library in ``path`` from now on (a directory that
    outlives the process spares the next one the compile).  A library this
    process has loaded stays loaded."""
    global BUILD_DIR, LIB_PATH, _STAMP, PTXAS_LOG
    with _LOCK:
        BUILD_DIR = Path(path)
        LIB_PATH = BUILD_DIR / "libspectral_kernels.so"
        _STAMP = BUILD_DIR / "libspectral_kernels.sha256"
        PTXAS_LOG = BUILD_DIR / "ptxas.txt"
    return BUILD_DIR


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: install the CUDA toolkit or set CUDA_HOME"
        )
    return found


def build() -> Path:
    """Compile the kernel library unless it is up to date; return its path."""
    global BUILD_SECONDS
    digest = _digest()
    if LIB_PATH.exists() and _STAMP.exists() and _STAMP.read_text() == digest:
        BUILD_SECONDS = 0.0
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in SOURCES]
    tmp = BUILD_DIR / f".libspectral_kernels.{tag}.so"
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{log}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    PTXAS_LOG.write_text("".join(logs))
    _STAMP.write_text(digest)
    BUILD_SECONDS = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.spectral_stockham_fft.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp]
            lib.spectral_stockham_fft.restype = ci
            lib.spectral_error_string.argtypes = [ci]
            lib.spectral_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.spectral_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
