"""Build and load the port's CUDA kernels.

Each source under ``singlehdr_tpu_torch/csrc`` compiles in its own ``nvcc``
process, all started together, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes``.
(``torch.utils.cpp_extension.load`` would include PyTorch's headers, which
takes minutes to compile; this takes seconds.)  The library is keyed by a
hash of the sources and flags and lands in ``build/kernels/`` at the root of
the checkout.  It is built at first use, never at import: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "shdr_apply_rf_f32": (_P, _P, _P, _I, ctypes.c_longlong, _I, _I, _P),
    "shdr_apply_rf_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _P),
    "shdr_conv_gemm_f32": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "shdr_conv_gemm_bf16": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "shdr_lin_stem_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "shdr_lin_stem_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc call, if this process built


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libshdr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    path = _library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, cu.stem + ".o") for cu in sorted(CSRC.glob("*.cu"))]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for cu, obj in zip(sorted(CSRC.glob("*.cu")), objs)
        ]
        stderr = [p.communicate()[1] for p in procs]  # waits for every compile
        failed = [f"{p.args[-1]} ({p.returncode}):\n{err}"
                  for p, err in zip(procs, stderr) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        os.replace(so, path)  # atomic: a concurrent loader sees all or nothing
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.shdr_error_string.argtypes = (ctypes.c_int,)
            so.shdr_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def call(name: str, *args) -> None:
    """Launch C entry ``name``; raise if the launch reported a CUDA error."""
    so = lib()
    err = getattr(so, name)(*args)
    if err != 0:
        msg = so.shdr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
