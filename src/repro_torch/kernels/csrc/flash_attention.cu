// Hopper (sm_90a) port of the Pallas TPU kernel flash_attention_pallas
// (_flash_kernel) of src/repro/kernels/flash_attention.py: blockwise
// online-softmax attention, causal and/or sliding-window, GQA without
// expanding K/V, optional fp32 log-sum-exp.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math: expf, logf and the final division are the accurate
// ones) into a shared library with the plain C interface at the bottom of
// this file, loaded with ctypes. The Python wrapper
// (repro_torch/kernels/flash_attention.py) checks device, dtype, shapes and
// strides, allocates the outputs and passes the current stream; nothing
// here allocates or synchronises.
//
// Bound at the serve path's shape (Llama-3-8B prefill: B=4, S=T=4096,
// H=32 over KV=8, hd=128, causal, bf16): 4 * B * H * hd * S(S+1)/2 ~ 550
// GFLOP per layer call, ~0.56 ms at the H100's 989 TFLOP/s bf16 dense
// tensor-core rate. Operations bound it: its ~335 MB of bytes (q, k, v
// read once, out written once) alone would take ~0.10 ms at 3.35 TB/s.
//
// Design (simple and right first). The TPU kernel walks the KV blocks as a
// sequential grid axis with (o, m, l) resident in VMEM across it. Here one
// thread block of 256 threads owns one (batch * H + head, 64-row query
// tile) and loops over the 64-key tiles that kv_block_range admits, with
// m, l and the output accumulator in registers: thread (ty, tx) of the
// 16 x 16 grid owns query rows 4ty..4ty+3, key columns 4tx..4tx+3 of each
// score tile and output columns 4tx..4tx+3 (+64) of those rows, so a row's
// max and sum are a 16-lane shuffle reduction. Q^T, K^T and V tiles are
// staged in shared memory as fp32 (bf16 widens exactly), and both products
// are fp32 FMAs on the CUDA cores: s, m, l, p and the accumulator are fp32
// whatever the input type, as in the TPU kernel. So this kernel is bound by
// the 67 TFLOP/s fp32 rate, not by the bf16 tensor-core bound above; wgmma
// with TMA-fed shared-memory rings (and p rounded to bf16 for the second
// product) is a later PR's work.
//
// Masking follows the TPU kernel: a KV tile outside the causal / window
// range is never visited; inside a visited edge tile each score is masked
// with the finite NEG_INF = -1e30 and p is masked to 0 after the exp, so a
// fully masked row keeps (m, l, acc) = (-1e30, 0, 0) and writes 0. Ragged S
// and T edges are masked (keys) or not written (queries); no divisibility is
// required. Query head h reads KV head h / (H / KV) of the same batch row.
// Heaviest query tiles (last under causal masking) are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per thread block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // row padding of the transposed tiles (keeps float4 alignment)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: not asked for
  int64_t q_sb, q_ss, q_sh;  // element strides of batch, position, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int s, t, h, kvh, hd, causal, window;
  float scale;
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return kpos < a.t && (!a.causal || kpos <= qpos) && (!a.window || kpos > qpos - a.window);
}

template <typename T, int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HDP * (kBQ + kPad) + HDP * (kBK + kPad) + kBK * HDP);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Args a) {
  constexpr int QLD = kBQ + kPad;  // row length of Q^T and of P^T
  constexpr int KLD = kBK + kPad;  // row length of K^T
  constexpr int NG = HDP / 64;     // groups of 4 output columns per thread
  static_assert(kBK * QLD <= HDP * KLD, "P^T must fit in the K^T buffer");
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HDP][QLD]  Q^T of this query tile
  float* kp = qt + HDP * QLD;                   // [HDP][KLD]  K^T of a KV tile, then P^T [kBK][QLD]
  float* vs = kp + HDP * KLD;                   // [kBK][HDP]  V of a KV tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.h;
  const int hh = blockIdx.y % a.h;
  const int kv_head = hh / (a.h / a.kvh);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kv_head * a.v_sh;

  const int q_first = qi * kBQ;
  const int q_last = min(q_first + kBQ, a.s) - 1;  // last real query row of the tile

  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP, row = q_first + r;
    qt[d * QLD + r] = (row < a.s && d < a.hd) ? load_f(q + row * a.q_ss + d) : 0.0f;
  }

  // kv_block_range at this kernel's tiles: [lo, hi) holds every key tile
  // with a visible (q, k) pair for some row of this query tile
  int lo = 0;
  int hi = (a.t + kBK - 1) / kBK;
  if (a.causal) hi = min(hi, q_last / kBK + 1);
  if (a.window) lo = max(0, (q_first - a.window + 1) / kBK);

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.0f;
  }

  for (int kj = lo; kj < hi; ++kj) {
    const int k_first = kj * kBK;
    __syncthreads();  // the previous tile's P^T and V are no longer read
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int c = e / HDP, d = e % HDP, col = k_first + c;
      const bool in = col < a.t && d < a.hd;
      kp[d * KLD + c] = in ? load_f(k + col * a.k_ss + d) : 0.0f;
      vs[c * HDP + d] = in ? load_f(v + col * a.v_ss + d) : 0.0f;
    }
    __syncthreads();

    // s = q k^T over the zero-padded head dim (padding adds exact zeros)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * QLD + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kp + d * KLD + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // a tile that is not wholly visible to every row pays the element mask
    const bool edge = (a.causal && k_first + kBK - 1 > q_first) ||
                      (a.window && k_first <= q_first + kBQ - 1 - a.window) ||
                      (k_first + kBK > a.t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * a.scale;
        if (edge && !visible(a, qpos, k_first + tx * 4 + j)) x = kNegInf;
        sc[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(sc[i][j] - m_new);
        if (edge && !visible(a, qpos, k_first + tx * 4 + j)) p = 0.0f;  // p-masking
        sc[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K^T: reuse it for P^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(kp + (tx * 4 + j) * QLD + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // acc += p v
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(kp + c * QLD + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(vs + c * HDP + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], vb.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], vb.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], vb.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], vb.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30) in the input type; lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_first + ty * 4 + i;
    if (row >= a.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const int64_t at = (static_cast<int64_t>(b) * a.s + row) * a.h + hh;
    T* o = static_cast<T*>(a.o) + at * a.hd;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < a.hd) store_f(o + d, acc[i][g * 4 + c] / den);
      }
    if (a.lse != nullptr && tx == 0) a.lse[at] = m[i] + logf(den);
  }
}

template <typename T, int HDP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, batch * a.h);
  flash_fwd_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The library keeps its own (static) CUDA runtime, whose current device is
// not the caller's: select the tensors' device before each launch.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k and v (B, T, KV, hd), each with unit stride on hd and
// the given element strides on batch, position and head; out (B, S, H, hd)
// contiguous in the input type; lse (B, S, H) contiguous fp32 or null.
// is_bf16: 1 for bf16 inputs and output, 0 for fp32.
int fa_forward(const void* q, const void* k, const void* v, void* out, void* lse,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               int batch, int s, int t, int h, int kvh, int hd,
               int causal, int window, float scale, int is_bf16, int device, void* stream) {
  if (batch < 1 || s < 1 || t < 0 || kvh < 1 || h % kvh != 0 || hd < 1 || hd > 128 ||
      window < 0 || static_cast<int64_t>(batch) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, out, static_cast<float*>(lse),
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               s, t, h, kvh, hd, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = hd <= 64 ? launch<__nv_bfloat16, 64>(a, batch, st) : launch<__nv_bfloat16, 128>(a, batch, st);
  else
    err = hd <= 64 ? launch<float, 64>(a, batch, st) : launch<float, 128>(a, batch, st);
  return static_cast<int>(err);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
