// Hopper (sm_90a) ports of the three Pallas TPU kernels of
// src/repro/kernels/stochastic_quant.py: the eq.-4 stochastic quantizer,
// the clamped dequantizer and the fused dequantize + eq.-2 aggregate.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. The Python wrappers
// (repro_torch/kernels/stochastic_quant.py) check device, dtype, shape and
// contiguity, allocate every output, and pass the current stream; nothing
// here allocates or synchronises.
//
// All three are elementwise or short per-element reductions on a flat
// (M * 128) wire layout, so each is bound by device-memory bytes, not by
// arithmetic (a few flops per byte moved against the H100's ~20 flop/byte
// fp32 ridge). aggregate is the plain design: one thread per output
// element, neighbouring threads on neighbouring bytes so every warp load
// coalesces. quantize and dequantize were redesigned to 4 elements per
// thread (16-byte loads and 4-byte words of each plane, every access of a
// warp contiguous), with their one-element kernels kept for views that are
// not aligned for it (see below).
// The TPU's (block_m, 128) VMEM tiling has no role here; a ragged tail is
// masked instead of padded.
//
// Rounding: every multiply and add is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract them into FMAs. Each kernel then does
// the same IEEE fp32 operations in the same order as its plain torch
// version (and the Pallas kernel), which keeps quantize/dequantize
// bit-equal to them and aggregate equal up to the summation order the
// plain version also uses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int n_blocks(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Replaces _aggregate_kernel / aggregate (stochastic_quant.py:145-239).
//   out[e] = sum_{k=0}^{K-1} coef[k] * (sign[k][e] ? -1 : +1) * idx[k][e]
// with coef[k] = w_k * scale_k / (2^{q_k} - 1) computed by the wrapper. No
// clamp on idx, as in the TPU kernel. The TPU walks the client axis as a
// sequential grid dimension with the partial sum resident in VMEM
// (output-block revisiting); here each thread walks k = 0..K-1 in its own
// register, the same order, so any K and any M work with no padding.
// Byte bound: K * n * (sizeof(IdxT) + 1) read + 4 n written; at the fleet
// round's S = 8, Zpad = 253,952 (u8) that is 5.1 MB, ~1.5 us at 3.35 TB/s.
template <typename IdxT>
__global__ void aggregate_kernel(const IdxT* __restrict__ idx,
                                 const uint8_t* __restrict__ signs,
                                 const float* __restrict__ coef,
                                 float* __restrict__ out,
                                 int64_t k, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int64_t j = 0; j < k; ++j) {
    const float mag = static_cast<float>(idx[j * n + e]);
    const float val = signs[j * n + e] ? -mag : mag;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(coef + j), val));
  }
  out[e] = acc;
}

// Replaces _quant_kernel / quantize (stochastic_quant.py:35-84).
//   u = (rbits >> 8) * 2^-24, scaled = min(|x| * (L / safe), L),
//   idx = min(floor(scaled) + [u < frac], L) as u8, sign = x < 0.
// The range scalar stays on the device (a 1-element fp32 tensor), read once
// per thread from the read-only cache.
// Byte bound: 4 (x) + 4 (rbits) read + 1 + 1 written = 10 B per element;
// 262,144 elements (M = 2048, the wire entry point's FEMNIST planes) ->
// 2.6 MB, ~0.78 us at 3.35 TB/s: under an empty kernel's ~0.9 us, so, as
// for dequantize, the time is a launch and one memory round trip. The
// redesign (quantize_kernel_vec4) gives each thread 4 elements: one 16-byte
// load of x and one of rbits, one 4-byte store of each plane (element
// 4v + j is byte j of the little-endian word, as dequantize_kernel_vec4
// reads it), L / safe once per thread, n / 4 threads (256 blocks of 256 at
// M = 2048). Each thread issues its loads of x and rbits before it reads
// the range and divides: the division's slow path is a branch the loads
// would otherwise wait behind, a second memory round trip in a kernel that
// is one round trip long. Measured against it (scripts/quantize_layouts.py):
// 2 or 8 elements per thread and blocks of 64 to 512 are no faster; the
// same loads and stores with no arithmetic take ~1.4 us. The wrapper takes
// it for x and rbits on 16-byte and the planes on 4-byte boundaries with n
// a multiple of 4, and gives any other view to the one-element
// quantize_kernel. Both do the same rounded operations per element,
// bit-equal to the plain version.
__device__ __forceinline__ uint32_t quant_one(float xv, uint32_t bits, float ratio,
                                              float levels) {
  const float scaled = fminf(__fmul_rn(fabsf(xv), ratio), levels);
  const float lower = floorf(scaled);
  const float frac = __fsub_rn(scaled, lower);
  const float u = __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
  return static_cast<uint32_t>(fminf(__fadd_rn(lower, u < frac ? 1.0f : 0.0f), levels));
}

__device__ __forceinline__ float quant_ratio(const float* __restrict__ scale_p, float levels) {
  const float scale = __ldg(scale_p);
  return __fdiv_rn(levels, scale > 0.0f ? scale : 1.0f);
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const uint32_t* __restrict__ rbits,
                                const float* __restrict__ scale_p,
                                uint8_t* __restrict__ idx,
                                uint8_t* __restrict__ signs,
                                int64_t n, float levels) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float xv = x[e];
  const uint32_t bits = rbits[e];
  idx[e] = static_cast<uint8_t>(quant_one(xv, bits, quant_ratio(scale_p, levels), levels));
  signs[e] = xv < 0.0f ? 1 : 0;
}

__global__ void quantize_kernel_vec4(const float4* __restrict__ x,
                                     const uint4* __restrict__ rbits,
                                     const float* __restrict__ scale_p,
                                     uint32_t* __restrict__ idx,
                                     uint32_t* __restrict__ signs,
                                     int64_t n4, float levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const float4 xv = __ldg(x + v);
  const uint4 bv = __ldg(rbits + v);
  const float ratio = quant_ratio(scale_p, levels);
  idx[v] = quant_one(xv.x, bv.x, ratio, levels) | quant_one(xv.y, bv.y, ratio, levels) << 8 |
           quant_one(xv.z, bv.z, ratio, levels) << 16 | quant_one(xv.w, bv.w, ratio, levels) << 24;
  signs[v] = (xv.x < 0.0f ? 1u : 0u) | (xv.y < 0.0f ? 1u : 0u) << 8 |
             (xv.z < 0.0f ? 1u : 0u) << 16 | (xv.w < 0.0f ? 1u : 0u) << 24;
}

// Replaces _dequant_kernel / dequantize (stochastic_quant.py:87-124).
//   mag = min(idx, L) * (scale * (1 / L)), negated where the sign is set.
// The clamp keeps a corrupted index plane inside [-scale, scale]. The step
// multiplies by the fp32 reciprocal of L, as the Pallas kernel does once
// XLA has rewritten its division by the constant L.
// Byte bound: 1 + 1 read + 4 written = 6 B per element; 262,144 elements
// (M = 2048) -> 1.6 MB, ~0.47 us at 3.35 TB/s, under the ~0.9 us an empty
// kernel takes on the card: the time is a launch and one memory round trip.
// The redesign (dequantize_kernel_vec4) gives each thread 4 elements: one
// 4-byte load of idx, one of signs, one 16-byte store, every access of a
// warp contiguous, and n / 4 threads (256 blocks of 256 at M = 2048).
// Measured against it (scripts/dequantize_layouts.py): 16 elements per
// thread from one 16-byte load each is slower, since a lane's four float4
// stores are 64 bytes apart from its neighbours' and a quarter of the
// threads hide less latency. The wire layout is (M, 128), so n is a
// multiple of 4; the wrapper takes the vec4 kernel for idx and signs on
// 4-byte and out on 16-byte boundaries, and gives any other view to the
// one-element-per-thread dequantize_kernel. Both do the same two rounded
// multiplies per element, bit-equal to the plain version.
__device__ __forceinline__ float dequant_one(unsigned int i, unsigned int sign, float levels,
                                             float step) {
  const float mag = __fmul_rn(fminf(static_cast<float>(i), levels), step);
  return sign ? -mag : mag;
}

__global__ void dequantize_kernel(const uint8_t* __restrict__ idx,
                                  const uint8_t* __restrict__ signs,
                                  const float* __restrict__ scale_p,
                                  float* __restrict__ out,
                                  int64_t n, float levels, float inv_levels) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float step = __fmul_rn(__ldg(scale_p), inv_levels);
  out[e] = dequant_one(idx[e], signs[e], levels, step);
}

__global__ void dequantize_kernel_vec4(const uint32_t* __restrict__ idx,
                                       const uint32_t* __restrict__ signs,
                                       const float* __restrict__ scale_p,
                                       float4* __restrict__ out,
                                       int64_t n4, float levels, float inv_levels) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const float step = __fmul_rn(__ldg(scale_p), inv_levels);
  const uint32_t iw = __ldg(idx + v), sw = __ldg(signs + v);
  // element 4v + j is byte j of the little-endian word
  out[v] = make_float4(dequant_one(iw & 0xffu, sw & 0xffu, levels, step),
                       dequant_one((iw >> 8) & 0xffu, (sw >> 8) & 0xffu, levels, step),
                       dequant_one((iw >> 16) & 0xffu, (sw >> 16) & 0xffu, levels, step),
                       dequant_one(iw >> 24, sw >> 24, levels, step));
}

// No work: its device time is the floor of any launch on this card, the
// yardstick a kernel of a few microseconds is read against.
__global__ void empty_kernel() {}

// The library keeps its own (static) CUDA runtime, whose current device is
// not the caller's: select the tensors' device before each launch.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

template <typename IdxT>
int launch_aggregate(const void* idx, const void* signs, const void* coef,
                     void* out, int64_t k, int64_t n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_kernel<IdxT><<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const IdxT*>(idx), static_cast<const uint8_t*>(signs),
      static_cast<const float*>(coef), static_cast<float*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sq_aggregate_u8(const void* idx, const void* signs, const void* coef,
                    void* out, int64_t k, int64_t n, int device, void* stream) {
  return launch_aggregate<uint8_t>(idx, signs, coef, out, k, n, device, stream);
}

int sq_aggregate_u16(const void* idx, const void* signs, const void* coef,
                     void* out, int64_t k, int64_t n, int device, void* stream) {
  return launch_aggregate<uint16_t>(idx, signs, coef, out, k, n, device, stream);
}

int sq_quantize(const void* x, const void* rbits, const void* scale, void* idx,
                void* signs, int64_t n, float levels, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(rbits),
      static_cast<const float*>(scale), static_cast<uint8_t*>(idx),
      static_cast<uint8_t*>(signs), n, levels);
  return static_cast<int>(cudaGetLastError());
}

// n a multiple of 4; x and rbits 16-byte, idx and signs 4-byte aligned (the
// wrapper checks).
int sq_quantize_vec4(const void* x, const void* rbits, const void* scale, void* idx,
                     void* signs, int64_t n, float levels, int device, void* stream) {
  if (n % 4 != 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(rbits)) % 16 ||
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(signs)) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = n / 4;
  quantize_kernel_vec4<<<n_blocks(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const uint4*>(rbits),
      static_cast<const float*>(scale), static_cast<uint32_t*>(idx),
      static_cast<uint32_t*>(signs), n4, levels);
  return static_cast<int>(cudaGetLastError());
}

int sq_dequantize(const void* idx, const void* signs, const void* scale,
                  void* out, int64_t n, float levels, float inv_levels, int device,
                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequantize_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(signs),
      static_cast<const float*>(scale), static_cast<float*>(out), n, levels, inv_levels);
  return static_cast<int>(cudaGetLastError());
}

// n a multiple of 4; idx and signs 4-byte, out 16-byte aligned (the
// wrapper checks).
int sq_dequantize_vec4(const void* idx, const void* signs, const void* scale,
                       void* out, int64_t n, float levels, float inv_levels, int device,
                       void* stream) {
  if (n % 4 != 0 || (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(signs)) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = n / 4;
  dequantize_kernel_vec4<<<n_blocks(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(idx), static_cast<const uint32_t*>(signs),
      static_cast<const float*>(scale), static_cast<float4*>(out), n4, levels, inv_levels);
  return static_cast<int>(cudaGetLastError());
}

int sq_empty(int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* sq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
