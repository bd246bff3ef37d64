#!/usr/bin/env python3
"""Device time of ``dequantize`` layouts at the wire entry point's shape.

    PYTHONPATH=src python3 scripts/dequantize_layouts.py

Needs a CUDA device and nvcc. Times, with ``torch.profiler`` (each
kernel's own device time over 200 launches, the mean of 3 repeats) at
M = 2048 rows of 128 (q = 4):

  * ``vec4``: the port's kernel (``stochastic_quant.dequantize`` on aligned
    planes): 4 elements per thread, one 4-byte word of each plane in, one
    16-byte store out;
  * ``scalar``: the port's one-element-per-thread kernel (a view 3 bytes
    off a 16-byte boundary);
  * ``uint4x16``: the layout the port did not take, 16 elements per thread
    from one 16-byte load of each plane and four 16-byte stores, built here
    from the source below at 128 threads per block;
  * ``empty``: the port's empty kernel, the floor of any launch.

All three dequantize layouts are checked bit-equal to ``dequantize_plain``.
Prints one line per layout and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

UINT4X16 = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ float one(unsigned i, unsigned s, float levels, float step) {
  const float mag = __fmul_rn(fminf(static_cast<float>(i), levels), step);
  return s ? -mag : mag;
}
__global__ void dequantize_uint4x16(const uint4* idx, const uint4* signs, const float* scale,
                                    float4* out, int64_t n16, float levels, float inv_levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n16) return;
  const float step = __fmul_rn(__ldg(scale), inv_levels);
  const uint4 iv = __ldg(idx + v), sv = __ldg(signs + v);
  const unsigned iw[4] = {iv.x, iv.y, iv.z, iv.w}, sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
    out[v * 4 + w] = make_float4(one(iw[w] & 255u, sw[w] & 255u, levels, step),
                                 one((iw[w] >> 8) & 255u, (sw[w] >> 8) & 255u, levels, step),
                                 one((iw[w] >> 16) & 255u, (sw[w] >> 16) & 255u, levels, step),
                                 one(iw[w] >> 24, sw[w] >> 24, levels, step));
}
extern "C" int run(const void* idx, const void* signs, const void* scale, void* out, int64_t n,
                   float levels, float inv_levels, void* stream) {
  const int64_t n16 = n / 16;
  dequantize_uint4x16<<<static_cast<unsigned>((n16 + 127) / 128), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(idx), static_cast<const uint4*>(signs),
      static_cast<const float*>(scale), static_cast<float4*>(out), n16, levels, inv_levels);
  return static_cast<int>(cudaGetLastError());
}
"""


def device_us(fn, name: str, iters: int = 200) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and name in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        raise SystemExit(f"no device kernel named {name!r} in the trace")
    return sum(e.self_device_time_total for e in hits) / count


def main() -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import stochastic_quant as sq

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "dequantize_uint4x16.cu", out_dir / "libdequantize_uint4x16.so"
    src.write_text(UINT4X16)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    other = ctypes.CDLL(str(lib_path))
    other.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_float,
                                                   ctypes.c_float, ctypes.c_void_p]
    lib = build.library("stochastic_quant")

    gen = torch.Generator(device="cuda").manual_seed(0)
    m, q_bits = 2048, 4
    idx = torch.randint(0, 256, (m, 128), generator=gen, device="cuda").to(torch.uint8)
    signs = torch.randint(0, 2, (m, 128), generator=gen, device="cuda").to(torch.uint8)
    scale = torch.rand((1,), generator=gen, device="cuda") + 0.5
    buf = torch.empty(m * 128 + 16, dtype=torch.uint8, device="cuda")
    idx_off = buf[3:3 + m * 128].view(m, 128)
    idx_off.copy_(idx)
    want = sq.dequantize_plain(idx, signs, scale, q_bits)
    out = torch.empty((m, 128), device="cuda")
    stream = build.stream(torch.device("cuda"))
    levels, inv = float(2**q_bits - 1), sq._inv_levels(q_bits)

    def uint4x16():
        build.check("stochastic_quant", "uint4x16",
                    other.run(idx.data_ptr(), signs.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), idx.numel(), levels, inv, stream))

    uint4x16()
    assert sq.dequantize_variant(idx, signs, out) == "vec4"
    assert sq.dequantize_variant(idx_off, signs, out) == "scalar"
    for got in (sq.dequantize(idx, signs, scale, q_bits),
                sq.dequantize(idx_off, signs, scale, q_bits), out):
        if not torch.equal(got, want):
            raise SystemExit("a dequantize layout is not bit-equal to dequantize_plain")
    dev = torch.cuda.current_device()
    cases = {
        "vec4": (lambda: sq.dequantize(idx, signs, scale, q_bits), "dequantize_kernel_vec4"),
        "scalar": (lambda: sq.dequantize(idx_off, signs, scale, q_bits), "dequantize_kernel("),
        "uint4x16": (uint4x16, "dequantize_uint4x16"),
        "empty": (lambda: build.check("stochastic_quant", "empty", lib.sq_empty(dev, stream)),
                  "empty_kernel"),
    }
    times = {k: [] for k in cases}
    for _ in range(3):
        for k, (fn, name) in cases.items():
            times[k].append(device_us(fn, name))
    bound_us = m * 128 * 6 / 3.35e12 * 1e6
    for k, ts in times.items():
        print(f"{k}: {sum(ts) / len(ts):.3f} us ({', '.join(f'{t:.3f}' for t in ts)})")
    print(f"byte bound: {bound_us:.3f} us (6 bytes per element at 3.35 TB/s)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
