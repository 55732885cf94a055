"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, at first use, and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds, and no ``ninja``
is needed.  Each source compiles in its own ``nvcc``, all started at once,
and one more ``nvcc`` links the objects.  The library lands in
``build/torch_ext/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.  ``nvcc`` comes from the CUDA toolkit PyTorch reports
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
SOURCES = ("gather_encode.cu", "decode_accum.cu")
#: repo-root build directory (``src/repro_torch/kernels`` -> root)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    cxx = _host_compiler()
    host = ["-ccbin", cxx] if cxx else []
    objs = [out_dir / f".{Path(src).stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([_nvcc(), *NVCC_FLAGS, *host, "-c", "-o", str(o),
                          str(CSRC / src)] for src, o in zip(SOURCES, objs))]
    outs = [proc.communicate() for _, proc in procs]
    done = [(cmd, proc.returncode, out, err)
            for (cmd, proc), (out, err) in zip(procs, outs)]
    reports = [err for _, _, _, err in done]
    for cmd, rc, out, err in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           *host, "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent loader never sees
    last_build.update(seconds=secs, path=str(lib), cached=False,  # a half
                      ptxas="".join(reports))                     # file
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
    # flat encoders and the dequantiser: (inputs..., rows[, gamma][, k],
    # outputs..., stream)
    flat = {
        "quantize_int8": [p, i, p, p, p, p],
        "ef_int4": [p, p, i, f, p, p, p, p],
        "ef_sign": [p, p, i, f, p, p, p, p],
        "ef_topk": [p, p, i, f, i, p, p, p],
        "dequant_int8": [p, p, i, p, p],
    }
    # decode-accumulate: (acc..., payload..., s, w, rows[, k | bits],
    # out..., stream)
    decl = {
        "decode_accum_int8": [p, p, p, p, i, p, p],
        "decode_accum_int4": [p, p, p, p, i, p, p],
        "sign_vote_accum": [p, p, p, p, p, i, p, p, p],
        "topk_scatter_accum": [p, p, p, p, p, i, i, p, p],
        "decode_accum_int8_fp": [p, p, p, p, i, i, p, p],
        "decode_accum_int4_fp": [p, p, p, p, i, i, p, p],
        "sign_vote_accum_fp": [p, p, p, p, p, i, i, p, p, p],
    }
    for name, args in (*flat.items(), *decl.items()):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
