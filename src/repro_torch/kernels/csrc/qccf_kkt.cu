// Hopper (sm_90a) kernel of the decision's vectorised KKT solve (eq. 41/42):
// repro_torch/kernels/kkt.py's solve_kkt_plain in one launch.
//
// Replaces no Pallas kernel: the JAX package's repro.sim.policy.solve_kkt is
// plain jnp that XLA fuses into a few loops. Its op-by-op torch port runs
// some 3,450 tiny elementwise launches a call (80 bisection halvings of ~35
// ops each, a (U, 512) grid, the case selects), each a few microseconds of
// host time with the device idle between them. Here one thread takes one
// client element and walks every case in registers:
//
//   qmax and the feasibility mask; Case 1 (q = 1); Case 2 (f = f_min, q from
//   the depressed cubic, Cardano and trigonometric branches); Cases 4 and 3
//   (latency tight, f pinned at f_min or f_max); Case 5 (80 halvings of a
//   bisection on h(q)); the 512-point grid, only where no case holds (the
//   select reads it nowhere else); the priority select 1, 2, 4, 3, 5, grid;
//   Theorem-3 integerization clamped to q_cap.
//
// Bound: neither bytes (5 x 4 B read, 18 B written per client) nor fp32
// operations (~3,300 per client without the grid, ~60,000 with it: well
// under a microsecond of the card's 67 TFLOP/s at U = 1,024) but latency.
// At U = 1,024 there are 32 warps, each a dependent chain of divisions and
// powf calls; the time is that chain's, on a card that would otherwise sit
// idle waiting for the host's launches. The launch floor (sq_empty) is the
// yardstick.
//
// Rounding. Every product, sum and quotient of the plain version is one
// torch op, rounded once, so each is written here as an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// that nvcc cannot contract into an FMA, in the plain version's
// association order. torch's CUDA ops are mirrored where they deviate from
// plain IEEE: a tensor divided by a Python float multiplies by the fp32
// reciprocal of the fp32 divisor (the host precomputes it), x**2 is x*x and
// x**3 is x*x*x, a Python float / tensor is reciprocal then multiply, clamp
// and maximum propagate NaN, sign(0) = 0, argmin takes the first minimum
// with NaN as the least. powf, log2f, sqrtf, acosf and cosf are the same
// CUDA math functions torch's elementwise kernels call. Chains of
// SystemParams floats that Python folds in double before torch sees them
// arrive folded in KktConsts (kkt.kernel_constants).
//
// Built by repro_torch/kernels/build.py (route b: nvcc into a shared
// library with the plain C interface at the bottom, loaded with ctypes).
// The wrapper checks dtypes, contiguity and shapes, allocates every output
// and passes the current stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // 16 blocks at U = 1,024: the warps spread over SMs
constexpr int kBisections = 80;

// Field order is kkt.CONSTANTS'.
struct KktConsts {
  float t_max, tau_e, gamma, tau_gamma, rcp_f_max, z, rcp_z, p_v, lipschitz, ln2,
      bits_q1, f_min, f_max, rcp_4p_v, rcp_f_min, kappa4_max, kappa3_min, rcp_v, p,
      two_alpha, lo, eps9, grid_step, cmp_k, com_k, q_cap, f_max_tol, t_max_tol, v_min;
};
constexpr int kNumConsts = sizeof(KktConsts) / sizeof(float);

// Literal divisors of the plain version, as torch multiplies by them.
constexpr float kRcp3 = 1.0f / 3.0f;
constexpr float kRcp27 = 1.0f / 27.0f;
constexpr float kThird = static_cast<float>(1.0 / 3.0);  // the exponent of x ** (1/3)
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float square(float x) { return mul(x, x); }
__device__ __forceinline__ float cube(float x) { return mul(mul(x, x), x); }

// torch.clamp and torch.maximum: a NaN input comes out as it went in.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

// z * q + z + RANGE_BITS at a tensor q: the payload in bits.
__device__ __forceinline__ float bits_of(float q, const KktConsts& k) {
  return add(add(mul(q, k.z), k.z), 32.0f);
}

// Per-client inputs, read once.
struct Client {
  float v, w, d, theta, lam;
};

// _s_of_q: the latency-tight frequency, inf when the deadline is unmeetable.
__device__ __forceinline__ float s_of_q(const Client& c, float bits, const KktConsts& k) {
  const float slack = sub(mul(c.v, k.t_max), bits);
  const float f_req = dvd(mul(mul(mul(c.v, k.tau_e), k.gamma), c.d), clamp_min(slack, kTiny));
  return slack > 0.0f ? clamp_min(f_req, k.f_min) : INFINITY;
}

// _j3 at level q and frequency f.
__device__ __forceinline__ float j3(const Client& c, float q, float f, const KktConsts& k) {
  const float levels = sub(powf(2.0f, q), 1.0f);
  const float quant = dvd(mul(mul(mul(mul(c.lam, c.w), k.z), k.lipschitz), square(c.theta)),
                          mul(square(levels), 8.0f));
  const float cmp_e = mul(mul(k.cmp_k, c.d), square(f));
  const float com_e = dvd(mul(k.com_k, q), c.v);
  return add(add(quant, cmp_e), com_e);
}

// _g_of_q, 0 past q = 60.
__device__ __forceinline__ float g_of_q(const Client& c, float q, const KktConsts& k) {
  const float y = powf(2.0f, clamp_max(q, 60.0f));
  const float num =
      mul(mul(mul(mul(mul(y, k.ln2), c.lam), c.w), k.lipschitz), square(c.theta));
  const float den = mul(cube(clamp_min(sub(y, 1.0f), kTiny)), 4.0f);
  const float g = dvd(num, den);
  return q > 60.0f ? 0.0f : g;
}

__device__ __forceinline__ float cbrt_signed(float x) {
  return mul(sign(x), powf(fabsf(x), kThird));
}

// _case2_cubic: the largest positive real root of y^3 - A4 y - A4 = 0.
__device__ __forceinline__ float case2_cubic(float a4) {
  const float a = clamp_min(a4, kTiny);
  const float disc = sub(mul(square(a), 0.25f), mul(cube(a), kRcp27));
  const float sq = sqrtf(clamp_min(disc, 0.0f));
  const float half = mul(a, 0.5f);
  const float y_card = add(cbrt_signed(add(half, sq)), cbrt_signed(sub(half, sq)));
  const float arg = clamp(mul(sqrtf(mul(dvd(1.0f, a), 3.0f)), 1.5f), -1.0f, 1.0f);
  const float y_trig =
      mul(mul(sqrtf(mul(a, kRcp3)), 2.0f), cosf(mul(acosf(arg), kRcp3)));
  return disc >= 0.0f ? y_card : y_trig;
}

// h(q) of Case 5's bisection.
__device__ __forceinline__ float h_of(const Client& c, float q, const KktConsts& k) {
  const float den = clamp_min(sub(mul(c.v, k.t_max), bits_of(q, k)), kTiny);
  const float f = dvd(mul(mul(mul(c.v, k.tau_e), k.gamma), c.d), den);
  return sub(sub(mul(mul(c.v, g_of_q(c, q, k)), k.rcp_v), k.p), mul(cube(f), k.two_alpha));
}

// pinned(f_pin) of Cases 4 and 3: (q_pin, kappa1).
__device__ __forceinline__ float2 pinned(const Client& c, float rcp_f_pin, const KktConsts& k) {
  const float slack = sub(mul(c.v, k.t_max),
                          mul(mul(mul(mul(c.v, k.tau_e), k.gamma), c.d), rcp_f_pin));
  const float q_pin = mul(sub(sub(slack, k.z), 32.0f), k.rcp_z);
  return make_float2(q_pin, sub(mul(c.v, g_of_q(c, q_pin, k)), k.p_v));
}

// The grid fallback's q0: the first point of least J3 (torch.argmin: the
// first minimum, a NaN below every number) among 1 + span * i / (n - 1).
__device__ float grid_q0(const Client& c, float qmax, int grid_n, const KktConsts& k) {
  const float span = sub(clamp_min(qmax, 1.0f), 1.0f);
  float best_j = 0.0f, best_q = 0.0f;
  for (int i = 0; i < grid_n; ++i) {
    const float qs = add(mul(span, mul(static_cast<float>(i), k.grid_step)), 1.0f);
    const float fs = s_of_q(c, bits_of(qs, k), k);
    const float js = fs <= k.f_max ? j3(c, qs, fs, k) : INFINITY;
    const bool take = i == 0 || (isnan(js) ? !isnan(best_j) : js < best_j);
    if (take) {
      best_j = js;
      best_q = qs;
    }
  }
  return best_q;
}

// j_of of the integerization: (J3 or inf where the level misses C5 or the
// deadline by more than fp32 rounding, the clamped frequency).
__device__ __forceinline__ float2 j_of(const Client& c, float qq, const KktConsts& k) {
  float f = s_of_q(c, bits_of(qq, k), k);
  bool ok = f <= k.f_max_tol;
  f = clamp_max(f, k.f_max);
  const float lat = add(dvd(mul(k.tau_gamma, c.d), f), dvd(bits_of(qq, k), c.v));
  ok = ok && lat <= k.t_max_tol;
  const float j = j3(c, qq, f, k);
  return make_float2(ok ? j : INFINITY, f);
}

__global__ void __launch_bounds__(kThreads)
qccf_kkt_kernel(const float* __restrict__ v_in, const float* __restrict__ w_in,
                const float* __restrict__ d_in, const float* __restrict__ theta_in,
                const float* __restrict__ lam_in, int64_t n, int64_t n_v, int64_t n_w,
                int64_t n_d, int64_t n_theta, const KktConsts k, int grid_n,
                int64_t* __restrict__ q_out, float* __restrict__ f_out,
                bool* __restrict__ feasible_out, float* __restrict__ q_hat_out,
                int8_t* __restrict__ case_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  // an input of the clients' trailing dims repeats along the leading ones
  Client c;
  c.v = clamp_min(__ldg(v_in + (n_v == n ? e : e % n_v)), k.v_min);
  c.w = __ldg(w_in + (n_w == n ? e : e % n_w));
  c.d = __ldg(d_in + (n_d == n ? e : e % n_d));
  c.theta = __ldg(theta_in + (n_theta == n ? e : e % n_theta));
  c.lam = __ldg(lam_in);

  const float qmax = mul(sub(sub(sub(mul(c.v, k.t_max),
                                     mul(mul(mul(k.tau_gamma, c.d), c.v), k.rcp_f_max)),
                                 k.z), 32.0f), k.rcp_z);
  bool feasible = qmax >= 1.0f;

  // Case 1: C8' tight (q = 1).
  const float theta2 = square(c.theta);
  const bool pre1 = sub(k.p_v, mul(mul(mul(mul(mul(mul(c.v, 0.5f), c.w), k.lipschitz), c.lam),
                                      theta2), k.ln2)) >= 0.0f;
  const bool ok1 = pre1 && s_of_q(c, k.bits_q1, k) <= k.f_max;

  // Case 2: latency loose, f = f_min, q from the depressed cubic.
  const float a4 =
      mul(mul(mul(mul(mul(mul(c.v, c.w), k.lipschitz), c.lam), theta2), k.ln2), k.rcp_4p_v);
  const float q2 = log2f(add(case2_cubic(a4), 1.0f));
  const float lat2 = add(mul(mul(k.tau_gamma, c.d), k.rcp_f_min), dvd(bits_of(q2, k), c.v));
  const bool ok2 = a4 > 0.0f && q2 > 1.0f && lat2 < k.t_max;

  // Cases 4/3: latency tight, f pinned at a bound.
  const float2 p4 = pinned(c, k.rcp_f_min, k);
  const bool ok4 = p4.x > 1.0f && p4.y >= 0.0f && p4.y <= k.kappa4_max;
  const float2 p3 = pinned(c, k.rcp_f_max, k);
  const bool ok3 = p3.x > 1.0f && p3.y >= 0.0f && p3.y >= k.kappa3_min;

  // Case 5: bisection on h(q) over (1, qmax), all 80 halvings.
  float lo = k.lo;
  const float hi0 = sub(qmax, k.eps9);
  const bool bracket = c.lam > 0.0f && qmax > 1.0f && hi0 > lo && h_of(c, lo, k) >= 0.0f &&
                       h_of(c, hi0, k) <= 0.0f;
  float hi = maximum(hi0, lo);
  for (int it = 0; it < kBisections; ++it) {
    const float mid = mul(add(lo, hi), 0.5f);
    const bool up = h_of(c, mid, k) > 0.0f;
    lo = up ? mid : lo;
    hi = up ? hi : mid;
  }
  const float q5 = mul(add(lo, hi), 0.5f);
  const float f5 = s_of_q(c, bits_of(q5, k), k);
  const bool ok5 = bracket && q5 > 1.0f && k.f_min < f5 && f5 < k.f_max;

  // Priority select (host order: 1, 2, 4, 3, 5, grid fallback).
  const int8_t code = ok1 ? 1 : ok2 ? 2 : ok4 ? 4 : ok3 ? 3 : ok5 ? 5 : 6;
  float q_hat = ok1 ? 1.0f : ok2 ? q2 : ok4 ? p4.x : ok3 ? p3.x : q5;
  if (code == 6) q_hat = grid_q0(c, qmax, grid_n, k);

  // Theorem 3 integerization, clamped to the wire format's q_cap.
  q_hat = clamp(q_hat, 1.0f, k.q_cap);
  const float q_lo = clamp_min(floorf(q_hat), 1.0f);
  const float q_hi = clamp_min(ceilf(q_hat), 1.0f);
  const float2 jf_lo = j_of(c, q_lo, k);
  const float2 jf_hi = j_of(c, q_hi, k);
  const bool take_hi = jf_hi.x < jf_lo.x;  // ties keep floor
  feasible = feasible && isfinite(take_hi ? jf_hi.x : jf_lo.x);

  q_out[e] = static_cast<int64_t>(take_hi ? q_hi : q_lo);
  f_out[e] = take_hi ? jf_hi.y : jf_lo.y;
  feasible_out[e] = feasible;
  q_hat_out[e] = q_hat;
  case_out[e] = code;
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

// v, w, d, theta: fp32 client inputs of n_v, n_w, n_d, n_theta elements,
// each n or a divisor of n repeating along the leading dims; lam: one fp32
// on the device; consts: n_consts host fp32 in KktConsts' order; outputs of
// n elements: q int64, f fp32, feasible bool, q_hat fp32, case int8.
int qccf_kkt(const void* v, const void* w, const void* d, const void* theta, const void* lam,
             int64_t n, int64_t n_v, int64_t n_w, int64_t n_d, int64_t n_theta,
             const void* consts, int64_t n_consts, int grid_n, void* q, void* f,
             void* feasible, void* q_hat, void* cases, int device, void* stream) {
  if (n_consts != kNumConsts || grid_n < 2 || n < 1 || n_v < 1 || n_w < 1 || n_d < 1 ||
      n_theta < 1 || n % n_v || n % n_w || n % n_d || n % n_theta)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const KktConsts k = *static_cast<const KktConsts*>(consts);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  qccf_kkt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(w), static_cast<const float*>(d),
      static_cast<const float*>(theta), static_cast<const float*>(lam), n, n_v, n_w, n_d,
      n_theta, k, grid_n, static_cast<int64_t*>(q), static_cast<float*>(f),
      static_cast<bool*>(feasible), static_cast<float*>(q_hat), static_cast<int8_t*>(cases));
  return static_cast<int>(cudaGetLastError());
}

const char* kkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
