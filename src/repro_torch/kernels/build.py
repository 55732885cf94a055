"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds, and no ``ninja``
is needed.  The library lands in ``build/torch_ext/<hash>/`` at the root of
the checkout (listed in ``.gitignore``), keyed by a hash of the sources and
the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``nvcc`` comes from the CUDA toolkit PyTorch reports
(``torch.utils.cpp_extension.CUDA_HOME``), the host compiler from
``torch.utils.cpp_extension``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gather_encode.cu",)
#: repo-root build directory (``src/repro_torch/kernels`` -> root)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # the reference flushes denormals; divisions and square roots are
    # IEEE; no contraction the source does not write out
    "-ftz=true", "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build (or cache hit) did: seconds, path, ptxas report
last_build: dict = {}


def _nvcc() -> str:
    from torch.utils import cpp_extension
    home = cpp_extension.CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH): cannot build the kernels")
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _host_compiler() -> Optional[str]:
    from torch.utils import cpp_extension
    get = getattr(cpp_extension, "get_cxx_compiler", None)
    return get() if get is not None else None


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns the
    library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        last_build.update(seconds=0.0, path=str(lib), cached=True,
                          ptxas="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cxx = _host_compiler()
    if cxx:
        cmd += ["-ccbin", cxx]
    cmd += [str(CSRC / s) for s in SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent loader never sees
    last_build.update(seconds=secs, path=str(lib), cached=False,  # a half
                      ptxas=proc.stderr)                          # file
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, p, i, i, f]
    for name in ("gather_ef_int8", "gather_ef_int4", "gather_ef_sign"):
        fn = getattr(lib, name)
        fn.argtypes = common + [p, p, p, p, p]
        fn.restype = i
    lib.gather_ef_topk.argtypes = common + [i, p, p, p]
    lib.gather_ef_topk.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
