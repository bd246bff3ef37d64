"""Build, load and launch-check the port's CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` by hand into one shared library per source with a plain C
interface, loaded with ``ctypes``; no PyTorch headers, so a build takes
seconds. A library is built at first use into ``build/repro_torch_kernels/``
at the repository root, named by a hash of its source and the flags, so an
edited source rebuilds and an unchanged one is reused. :func:`build` starts
one ``nvcc`` per missing library, all at once. Nothing is built when this
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# source name -> (its cudaError_t -> message function, {entry point: argtypes})
LIBRARIES = {
    "stochastic_quant": ("sq_error_string", {
        # idx, signs, coef, out, k, n, device, stream
        "sq_aggregate_u8": (_PTR, _PTR, _PTR, _PTR, _I64, _I64, _INT, _PTR),
        "sq_aggregate_u16": (_PTR, _PTR, _PTR, _PTR, _I64, _I64, _INT, _PTR),
        # x, rbits, scale, idx, signs, n, levels, device, stream
        "sq_quantize": (_PTR, _PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float, _INT, _PTR),
        "sq_quantize_vec4": (_PTR, _PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float, _INT, _PTR),
        # idx, signs, scale, out, n, levels, 1 / levels, device, stream
        "sq_dequantize": (_PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float,
                          ctypes.c_float, _INT, _PTR),
        "sq_dequantize_vec4": (_PTR, _PTR, _PTR, _PTR, _I64, ctypes.c_float,
                               ctypes.c_float, _INT, _PTR),
        # device, stream: one launch of an empty kernel (the launch floor)
        "sq_empty": (_INT, _PTR),
    }),
    "flash_attention": ("fa_error_string", {
        # q, k, v, out, lse, q/k/v strides (batch, position, head),
        # batch, s, t, h, kv heads, hd, causal, window, offset, out_f32,
        # scale, is_bf16, async_loads (flash_attention._load_variant),
        # device, stream
        "fa_forward": (_PTR, _PTR, _PTR, _PTR, _PTR, *(_I64,) * 9, *(_INT,) * 10,
                       ctypes.c_float, _INT, _INT, _INT, _PTR),
    }),
    "flash_attention_wgmma": ("faw_error_string", {
        # q, k, v, out, lse, 3 x 11 tensor-map plans (flash_attention.tma_plan),
        # batch, s, t, h, kv heads, hd, causal, window, offset, out_f32,
        # scale, device, stream
        "faw_forward": (_PTR, _PTR, _PTR, _PTR, _PTR, ctypes.POINTER(_I64), *(_INT,) * 10,
                        ctypes.c_float, _INT, _PTR),
        # hd -> dynamic shared memory of one CTA, bytes
        "faw_shared_bytes": (_INT,),
    }),
    "qccf_kkt": ("kkt_error_string", {
        # v, w, d, theta, lam, n, n_v, n_w, n_d, n_theta, consts (host fp32
        # array, kkt.CONSTANTS), n_consts, grid_n, q, f, feasible, q_hat,
        # case, device, stream
        "qccf_kkt": (*(_PTR,) * 5, *(_I64,) * 5, _PTR, _I64, _INT, *(_PTR,) * 5, _INT, _PTR),
    }),
    "moe_grouped": ("mg_error_string", {
        # a, a_rows (or null), b, seg, c, lda, b strides (expert, k, n), ldc,
        # experts, k, n, accumulate, row tiles, device, stream
        "moe_rows_gemm": (*(_PTR,) * 5, *(_I64,) * 5, *(_INT,) * 4, _I64, _INT, _PTR),
        # a, a_rows (or null), b, seg, c, lda, ldb, experts, k, n, device, stream
        "moe_wgrad_gemm": (*(_PTR,) * 5, _I64, _I64, *(_INT,) * 3, _INT, _PTR),
    }),
}
# the fleet round launches both, so the first use of either builds the pair
# in one build(): a cold set-up waits for the longer nvcc run, not the sum.
# The pair fails together too: a qccf_kkt that does not compile makes
# library("stochastic_quant") raise, on paths that never solve the KKT
FLEET_LIBRARIES = ("stochastic_quant", "qccf_kkt")


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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, tuple[Path, float, str]]:
    """Compile the named libraries (all of :data:`LIBRARIES` when none is
    named) whose hashed file is missing, one ``nvcc`` each, all started
    together. Returns ``{name: (path, seconds spent building, compiler
    output)}``; seconds is 0 when an earlier build was reused."""
    libs = {name: library_path(name) for name in names or LIBRARIES}
    out = {name: (lib, 0.0, "") for name, lib in libs.items() if lib.exists()}
    missing = [name for name in libs if name not in out]
    if not missing:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running, failures = {}, []
    try:
        for name in missing:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            running[name] = (tmp, cmd, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (tmp, cmd, t0, proc) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({' '.join(cmd)}):\n{log}")
                continue
            os.replace(tmp, libs[name])  # atomic: a concurrent build never sees half a file
            out[name] = (libs[name], time.perf_counter() - t0, log)
    finally:
        # a failed or interrupted build leaves no compiler running and no temp file
        for tmp, _cmd, _t0, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("repro_torch: " + "\n".join(failures))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with every entry point's
    ``argtypes``/``restype`` declared (an undeclared pointer would be cut to
    32 bits). Either of :data:`FLEET_LIBRARIES` is built with the other."""
    path = build(*(FLEET_LIBRARIES if name in FLEET_LIBRARIES else (name,)))[name][0]
    lib = ctypes.CDLL(str(path))
    error_fn, signatures = LIBRARIES[name]
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    getattr(lib, error_fn).argtypes = [ctypes.c_int]
    getattr(lib, error_fn).restype = ctypes.c_char_p
    return lib


def check(name: str, what: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch of ``what``
    from library ``name``."""
    if err != 0:
        msg = getattr(library(name), LIBRARIES[name][0])(err).decode(errors="replace")
        raise RuntimeError(f"repro_torch: {what} launch failed: CUDA error {err} ({msg})")


def refuse_grad(name: str, instead: str, *tensors: torch.Tensor) -> None:
    """Raise a ``ValueError`` when autograd would record a call of the
    wrapper ``name``: grad mode is on and an input requires grad. The
    port's kernels have no backward (nor have the Pallas kernels they
    replace), and a result written through ``ctypes`` carries no
    ``grad_fn``, so the gradient would be dropped without a word. The rule
    holds on every device, so the plain version on the CPU stays the
    kernel's exact stand-in. ``instead`` names the differentiable route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: its kernel has no backward, and an input requires grad; "
            f"use {instead}, or call it under torch.no_grad()")


def route(name: str, *tensors: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel, False -> the plain version (CPU).
    Mixed devices, or a device that is neither, raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs are on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as an integer handle."""
    return torch.cuda.current_stream(dev).cuda_stream
