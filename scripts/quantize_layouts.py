#!/usr/bin/env python3
"""Device time of ``quantize`` layouts at the wire entry point's shape.

    PYTHONPATH=src python3 scripts/quantize_layouts.py

Needs a CUDA device and nvcc. Times, with ``torch.profiler`` (each
kernel's own device time over 200 launches, the mean of 3 repeats) at
M = 2048 rows of 128 (q = 4):

  * ``vec4``: the port's kernel (``stochastic_quant.quantize`` on aligned
    planes): 4 elements per thread, one 16-byte load of x and of rbits,
    one 4-byte word of each plane out, 256 threads per block;
  * ``vec4_into``: the port's vec4 kernel through its C entry point into
    planes allocated once (the wrapper allocates its planes every call);
  * ``scalar``: the port's one-element-per-thread kernel (an x view 4 bytes
    off a 16-byte boundary);
  * ``vec4_b128_fresh``, ``vec4_b256_fresh``: the vec4 body at 128 and 256
    threads into planes allocated every call, as the wrapper does;
  * ``vec4_b64``, ``vec4_b128``, ``vec4_b256``, ``vec4_b512``: the vec4
    body at 64 to 512 threads per block, into planes allocated once;
  * ``vec2``: 2 elements per thread (8-byte loads, 2-byte stores);
  * ``vec8``, ``vec8_b64``: 8 elements per thread (two 16-byte loads of
    each input, one 8-byte store of each plane) at 256 and 64 threads;
  * ``vec4_ratio_first``: vec4 with the range read and divided before the
    loads of x and rbits are issued (the order of the port's first vec4
    kernel);
  * ``vec4_b128_given_ratio``: vec4 at 128 threads with L / scale passed in
    (computed on the host from the range read back): what the per-thread
    division costs; not usable by the port, which never reads the range;
  * ``move_only``, ``move_only_b128``: the vec4 layout's loads and stores
    with no arithmetic (each plane word a function of the loaded bits
    only), at 256 and 128 threads: the memory traffic alone, not a
    quantizer;
  * ``empty``: the port's empty kernel, the floor of any launch.

Every quantize layout is checked bit-equal to ``quantize_plain``. Prints
one line per layout and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LAYOUTS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t one(float xv, uint32_t bits, float ratio, float levels) {
  const float scaled = fminf(__fmul_rn(fabsf(xv), ratio), levels);
  const float lower = floorf(scaled);
  const float frac = __fsub_rn(scaled, lower);
  const float u = __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
  return static_cast<uint32_t>(fminf(__fadd_rn(lower, u < frac ? 1.0f : 0.0f), levels));
}
__device__ __forceinline__ float ratio_of(const float* scale_p, float levels) {
  const float s = __ldg(scale_p);
  return __fdiv_rn(levels, s > 0.0f ? s : 1.0f);
}
__device__ __forceinline__ uint32_t sgn(float v) { return v < 0.0f ? 1u : 0u; }
__device__ __forceinline__ void word4(float4 xv, uint4 bv, float r, float l, uint32_t* iw,
                                      uint32_t* sw) {
  *iw = one(xv.x, bv.x, r, l) | one(xv.y, bv.y, r, l) << 8 | one(xv.z, bv.z, r, l) << 16 |
        one(xv.w, bv.w, r, l) << 24;
  *sw = sgn(xv.x) | sgn(xv.y) << 8 | sgn(xv.z) << 16 | sgn(xv.w) << 24;
}
__global__ void q_vec4(const float4* x, const uint4* rb, const float* sc, uint32_t* idx,
                       uint32_t* signs, int64_t n4, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  uint32_t iw, sw;
  word4(__ldg(x + v), __ldg(rb + v), ratio_of(sc, levels), levels, &iw, &sw);
  idx[v] = iw;
  signs[v] = sw;
}
__global__ void q_vec2(const float2* x, const uint2* rb, const float* sc, uint16_t* idx,
                       uint16_t* signs, int64_t n2, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n2) return;
  const float r = ratio_of(sc, levels);
  const float2 xv = __ldg(x + v);
  const uint2 bv = __ldg(rb + v);
  idx[v] = static_cast<uint16_t>(one(xv.x, bv.x, r, levels) | one(xv.y, bv.y, r, levels) << 8);
  signs[v] = static_cast<uint16_t>(sgn(xv.x) | sgn(xv.y) << 8);
}
__global__ void q_vec8(const float4* x, const uint4* rb, const float* sc, uint2* idx,
                       uint2* signs, int64_t n8, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n8) return;
  const float r = ratio_of(sc, levels);
  const float4 x0 = __ldg(x + 2 * v), x1 = __ldg(x + 2 * v + 1);
  const uint4 b0 = __ldg(rb + 2 * v), b1 = __ldg(rb + 2 * v + 1);
  uint2 iw, sw;
  word4(x0, b0, r, levels, &iw.x, &sw.x);
  word4(x1, b1, r, levels, &iw.y, &sw.y);
  idx[v] = iw;
  signs[v] = sw;
}
__global__ void move_only(const float4* x, const uint4* rb, uint32_t* idx, uint32_t* signs,
                          int64_t n4) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const float4 xv = __ldg(x + v);
  const uint4 bv = __ldg(rb + v);
  idx[v] = bv.x ^ bv.y ^ bv.z ^ bv.w;
  signs[v] = __float_as_uint(xv.x) ^ __float_as_uint(xv.y) ^ __float_as_uint(xv.z) ^
             __float_as_uint(xv.w);
}
__global__ void q_vec4_ratio_first(const float4* x, const uint4* rb, const float* sc,
                                   uint32_t* idx, uint32_t* signs, int64_t n4, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const float r = ratio_of(sc, levels);
  const float4 xv = __ldg(x + v);
  const uint4 bv = __ldg(rb + v);
  uint32_t iw, sw;
  word4(xv, bv, r, levels, &iw, &sw);
  idx[v] = iw;
  signs[v] = sw;
}
static unsigned blocks(int64_t n, int t) { return static_cast<unsigned>((n + t - 1) / t); }
__global__ void q_vec4_given_ratio(const float4* x, const uint4* rb, float ratio, uint32_t* idx,
                                   uint32_t* signs, int64_t n4, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  uint32_t iw, sw;
  word4(__ldg(x + v), __ldg(rb + v), ratio, levels, &iw, &sw);
  idx[v] = iw;
  signs[v] = sw;
}
extern "C" int run(int layout, int t, const void* x, const void* rb, const void* sc, void* idx,
                   void* signs, int64_t n, float levels, float ratio, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = static_cast<const float4*>(x);
  const uint4* r4 = static_cast<const uint4*>(rb);
  const float* scale = static_cast<const float*>(sc);
  switch (layout) {
    case 0:
      q_vec4<<<blocks(n / 4, t), t, 0, s>>>(x4, r4, scale, static_cast<uint32_t*>(idx),
                                                 static_cast<uint32_t*>(signs), n / 4, levels);
      break;
    case 1:
      q_vec2<<<blocks(n / 2, t), t, 0, s>>>(
          static_cast<const float2*>(x), static_cast<const uint2*>(rb), scale,
          static_cast<uint16_t*>(idx), static_cast<uint16_t*>(signs), n / 2, levels);
      break;
    case 2:
      q_vec8<<<blocks(n / 8, t), t, 0, s>>>(x4, r4, scale, static_cast<uint2*>(idx),
                                                 static_cast<uint2*>(signs), n / 8, levels);
      break;
    case 5:
      q_vec4_ratio_first<<<blocks(n / 4, t), t, 0, s>>>(x4, r4, scale,
                                                         static_cast<uint32_t*>(idx),
                                                         static_cast<uint32_t*>(signs), n / 4,
                                                         levels);
      break;
    case 4:
      q_vec4_given_ratio<<<blocks(n / 4, t), t, 0, s>>>(x4, r4, ratio,
                                                         static_cast<uint32_t*>(idx),
                                                         static_cast<uint32_t*>(signs), n / 4,
                                                         levels);
      break;
    default:
      move_only<<<blocks(n / 4, t), t, 0, s>>>(x4, r4, static_cast<uint32_t*>(idx),
                                                    static_cast<uint32_t*>(signs), n / 4);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
# name -> (layout, threads per block, kernel name)
NAMES = {"vec4_b64": (0, 64, "q_vec4"), "vec4_b128": (0, 128, "q_vec4"),
         "vec4_b256": (0, 256, "q_vec4"),
         "vec4_b512": (0, 512, "q_vec4"), "vec2": (1, 256, "q_vec2"),
         "vec8": (2, 256, "q_vec8"), "vec8_b64": (2, 64, "q_vec8"),
         "vec4_b128_given_ratio": (4, 128, "q_vec4_given_ratio"),
         "vec4_ratio_first": (5, 256, "q_vec4_ratio_first"),
         "move_only": (3, 256, "move_only"), "move_only_b128": (3, 128, "move_only")}


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
    import numpy as np
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stochastic_quant as sq

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "quantize_layouts.cu", out_dir / "libquantize_layouts.so"
    src.write_text(LAYOUTS)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    other = ctypes.CDLL(str(lib_path))
    other.run.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib = build.library("stochastic_quant")

    gen = torch.Generator(device="cuda").manual_seed(0)
    m, q_bits = 2048, 4
    x = torch.randn((m, 128), generator=gen, device="cuda") * 0.05
    rbits = ops.random_bits(x.shape, gen)
    scale = x.abs().amax().reshape(1)
    buf = torch.empty(m * 128 + 4, device="cuda")
    x_off = buf[1:1 + m * 128].view(m, 128)
    x_off.copy_(x)
    want = sq.quantize_plain(x, rbits, scale, q_bits)
    idx = torch.empty((m, 128), dtype=torch.uint8, device="cuda")
    signs = torch.empty_like(idx)
    stream = build.stream(torch.device("cuda"))
    levels = float(2**q_bits - 1)
    # the IEEE fp32 quotient L / scale, computed once here (ablation only:
    # the port cannot read the range on the host without a sync)
    ratio = float(np.float32(levels) / np.float32(scale.item()))

    def layout(code, threads):
        return lambda: build.check("stochastic_quant", "layout", other.run(
            code, threads, x.data_ptr(), rbits.data_ptr(), scale.data_ptr(), idx.data_ptr(),
            signs.data_ptr(), x.numel(), levels, ratio, stream))

    assert sq.quantize_variant(x, rbits, idx, signs) == "vec4"
    assert sq.quantize_variant(x_off, rbits, idx, signs) == "scalar"
    for got in (sq.quantize(x, rbits, scale, q_bits), sq.quantize(x_off, rbits, scale, q_bits)):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit("a port quantize kernel is not bit-equal to quantize_plain")
    for name, (code, threads, _k) in NAMES.items():
        if name.startswith("move_only"):
            continue
        idx.zero_()
        signs.zero_()
        layout(code, threads)()
        if not (torch.equal(idx, want[0]) and torch.equal(signs, want[1])):
            raise SystemExit(f"layout {name} is not bit-equal to quantize_plain")
    def port_vec4_into(out_idx, out_signs):
        build.check("stochastic_quant", "quantize", lib.sq_quantize_vec4(
            x.data_ptr(), rbits.data_ptr(), scale.data_ptr(), out_idx.data_ptr(),
            out_signs.data_ptr(), x.numel(), levels, dev, stream))

    def layout_fresh(code, threads):
        def run():
            i, g = torch.empty_like(idx), torch.empty_like(signs)
            build.check("stochastic_quant", "layout", other.run(
                code, threads, x.data_ptr(), rbits.data_ptr(), scale.data_ptr(), i.data_ptr(),
                g.data_ptr(), x.numel(), levels, ratio, stream))
        return run

    dev = torch.cuda.current_device()
    cases = {
        "vec4": (lambda: sq.quantize(x, rbits, scale, q_bits), "quantize_kernel_vec4"),
        "vec4_into": (lambda: port_vec4_into(idx, signs), "quantize_kernel_vec4"),
        "vec4_b128_fresh": (layout_fresh(0, 128), "q_vec4"),
        "vec4_b256_fresh": (layout_fresh(0, 256), "q_vec4"),
        "scalar": (lambda: sq.quantize(x_off, rbits, scale, q_bits), "quantize_kernel("),
        **{name: (layout(code, threads), kname)
           for name, (code, threads, kname) in NAMES.items()},
        "empty": (lambda: build.check("stochastic_quant", "empty", lib.sq_empty(dev, stream)),
                  "empty_kernel"),
    }
    times = {k: [] for k in cases}
    for _ in range(3):
        for k, (fn, name) in cases.items():
            times[k].append(device_us(fn, name))
    bound_us = m * 128 * 10 / 3.35e12 * 1e6
    for k, ts in times.items():
        print(f"{k}: {sum(ts) / len(ts):.3f} us ({', '.join(f'{t:.3f}' for t in ts)})")
    print(f"byte bound: {bound_us:.3f} us (10 bytes per element at 3.35 TB/s)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
