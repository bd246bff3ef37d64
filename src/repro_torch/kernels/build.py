"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes``; no PyTorch headers, so a build takes seconds. The
library is built at first use into ``build/repro_torch_kernels/`` at the
repository root, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "stochastic_quant.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from the CUDA toolkit PyTorch was pointed at (``CUDA_HOME``
    or the toolkit's usual location), else from ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "repro_torch: nvcc was not found (set CUDA_HOME or put the CUDA "
            "toolkit's bin/ on PATH); the CUDA kernels are built at first use"
        )
    return found


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the library if its hashed file is missing. Returns
    ``(path, seconds spent building, compiler output)``; seconds is 0 when
    an earlier build was reused."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libstochastic_quant_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"repro_torch: nvcc failed ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, seconds, log


_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # idx, signs, coef, out, k, n, device, stream
    "sq_aggregate_u8": (_PTR, _PTR, _PTR, _PTR, _I64, _I64, ctypes.c_int, _PTR),
    "sq_aggregate_u16": (_PTR, _PTR, _PTR, _PTR, _I64, _I64, ctypes.c_int, _PTR),
    # x, rbits, scale, idx, signs, n, levels, device, stream
    "sq_quantize": (_PTR, _PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float,
                    ctypes.c_int, _PTR),
    # idx, signs, scale, out, n, levels, 1 / levels, device, stream
    "sq_dequantize": (_PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, _PTR),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes``/``restype``
    declared (an undeclared pointer would be cut to 32 bits)."""
    path, _seconds, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.sq_error_string.argtypes = [ctypes.c_int]
    lib.sq_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.sq_error_string(err).decode(errors="replace")
        raise RuntimeError(f"repro_torch: {name} launch failed: CUDA error {err} ({msg})")
