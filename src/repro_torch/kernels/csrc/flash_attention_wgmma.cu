// Hopper (sm_90a) port of the Pallas TPU kernel flash_attention_pallas
// (_flash_kernel) of src/repro/kernels/flash_attention.py, for bf16 inputs:
// blockwise online-softmax attention, causal and/or sliding-window, GQA
// without expanding K/V, optional fp32 log-sum-exp. fp32 inputs, and bf16
// inputs that TMA cannot describe, take flash_fwd_kernel in
// flash_attention.cu; the Python wrapper (repro_torch/kernels/
// flash_attention.py, _kernel_route) picks one of the two before launching.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math) into a shared library with the plain C interface at
// the bottom of this file, loaded with ctypes. cuTensorMapEncodeTiled is
// looked up with cudaGetDriverEntryPoint, so the library needs no -lcuda.
// The wrapper computes the tensor maps' dimensions, byte strides and boxes
// in Python (tested on the CPU), allocates the outputs and passes the
// current stream; nothing here allocates or synchronises.
//
// What bounds it. At the serve path's shape (Llama-3-8B prefill: B=4,
// S=T=4096, H=32 over KV=8, hd=128, causal) the function is
// 4 * B * H * hd * S(S+1)/2 ~ 550 GFLOP, ~0.56 ms at the H100's 989 TFLOP/s
// bf16 dense tensor-core rate; its ~335 MB of bytes would take ~0.10 ms at
// 3.35 TB/s. So operations bound it, and only wgmma reaches that rate.
//
// Design.
// - Work split: one CTA of three warpgroups owns one (batch * H + head,
//   128-row query tile). Warpgroups 0 and 1 are consumers, 64 query rows
//   each; warpgroup 2 is the producer, of which one thread issues every TMA
//   load. setmaxnreg gives the consumers 240 registers and the producer 24.
//   Heaviest causal tiles are scheduled first; the CTA walks the 64-key
//   tiles of kv_block_range from the last to the first.
// - TMA: q, k and v are 4-D tensor maps (hd, head, position, batch) with the
//   tensors' own strides; a 128-wide bf16 row is two 64-column boxes of 128
//   bytes, stored with the 128-byte swizzle that wgmma reads. The Q tile is
//   loaded once; K and V tiles come through a ring of kStages shared-memory
//   stages with mbarrier full/empty pairs. Out-of-bounds reads are
//   zero-filled: ragged S and T and hd < 64 / 128 need no copy.
// - S = Q K^T: wgmma m64 x n64 x k16, both operands from shared memory
//   (K-major), fp32 accumulator in registers; q is not pre-scaled.
// - Online softmax on the accumulator fragment: each thread holds two rows
//   of its warpgroup's 64, so a row's max is a 4-lane shuffle; m and l stay
//   fp32, m in the units of the scaled scores. The scale is folded into the
//   exponent: p = 2^(s * (scale log2 e) - m log2 e) by one FMA and the
//   SFU's ex2.approx (relative error ~2^-22; results below 2^-126 flush to
//   0), where the TPU kernel scales, subtracts and calls exp. Only edge
//   tiles (causal diagonal, window edge, ragged T) pay the element mask,
//   with the finite NEG_INF = -1e30 and p-masking after the exp, so a fully
//   masked row and an empty KV range write 0 and lse -1e30.
// - Position offset: query row i sits at position i + off relative to key 0
//   (off = q_offset - k_offset of a ring step), so key j is visible iff
//   j <= i + off (causal) and j > i + off - window. Each thread shifts its
//   rows once; the tile range and the edge test shift by off, the range by
//   floor_div, since an offset can make the dividend negative and C++ '/'
//   truncates toward zero. A row with no visible key in the launch keeps
//   (m, l, acc) = (-1e30, 0, 0).
// - O += P V: the fp32 score fragment of an m64 wgmma is, pair by pair, the
//   bf16 A-operand register fragment of the next one. p is split into
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both are issued against
//   the same V tile (B operand MN-major: V is stored keys x hd). Why split:
//   a single bf16 p carries 2^-9 relative error, ~1e-5 absolute on an output
//   of weights ~1/T at T = 4096, ten times the bf16 tolerance's atol of 1e-6
//   near zero; the split leaves ~2^-17, under the fp32 reordering error.
//   Products of bf16 values are exact in fp32 and the tensor cores
//   accumulate in fp32, so the kernel keeps the reference's numerics at
//   1.5x the tensor-core work (QK^T, then PV twice).
// - Overlap: each consumer runs one tile ahead, issuing tile i's QK^T and
//   tile i - 1's PV together and doing tile i's softmax while that PV runs.
// - Epilogue: out = acc / max(l, 1e-30) rounded to bf16, or kept fp32 in
//   the OUT_F32 instantiations (a ring step's partial, merged before any
//   rounding), lse = m + log(max(l, 1e-30)), from registers.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;           // query rows per CTA
constexpr int kBK = 64;                        // keys per KV tile
constexpr int kStages = 4;                     // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;                   // bf16 columns of a TMA box: one 128-byte row
constexpr int kMapArgs = 11;                   // dims[4], byte strides[3], box[4] per tensor

// Shared memory for HDP (64 or 128) head-dim columns, from a 1024-byte
// aligned base (the 128-byte swizzle repeats every 8 rows of 128 bytes):
// Q [boxes][kBQ rows], then kStages K tiles and kStages V tiles, each
// [boxes][kBK rows] of 128 bytes, then the barriers.
template <int HDP>
struct Layout {
  static constexpr int kBoxes = HDP / kBoxCols;
  static constexpr int kQBytes = kBoxes * kBQ * 128;
  static constexpr int kTileBytes = kBoxes * kBK * 128;  // one K or one V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

struct Params {
  void* o;     // (B, S, H, hd) contiguous: bf16, or fp32 (the OUT_F32 kernels)
  float* lse;  // (B, S, H) fp32, contiguous; nullptr: not asked for
  int s, t, h, kvh, hd, causal, window;
  int off;     // position of query row 0 minus that of key 0
  float scale;
};

// floor(a / b) for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box of a 4-D map into shared memory; completion counts its bytes
// on the barrier (out-of-bounds elements are zero-filled and counted).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous operations that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (m64 x n64, fp32) += A (64 x 16, smem desc) * B (16 x 64, smem desc), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db); else wgmma_rs_n128(d, a, db);
}

// qpos: the query's position counted from key 0 (its row + a.off)
__device__ __forceinline__ bool visible(const Params& a, int qpos, int kpos) {
  return kpos < a.t && (!a.causal || kpos <= qpos) && (!a.window || kpos > qpos - a.window);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the SFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue (and commit, without waiting) s = q k^T for one key tile over the
// zero-filled head dim: HDP / 16 wgmmas m64 x n64 x k16, A = this
// warpgroup's 64 Q rows, B = the K tile, both K-major in 64-column boxes.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns: 32 bytes of a 128-byte row
    wgmma_ss_n64(sc, sw128_desc(q_rows + (ks / 4) * kBQ * 128 + off, 16, 1024),
                 sw128_desc(k_tile + (ks / 4) * kBK * 128 + off, 16, 1024));
  }
  wgmma_commit();
}

// Issue (and commit) acc += p v for one key tile, p as its bf16 halves. V
// is [box][key][64 columns], so B (keys x hd) is MN-major: 16 keys are two
// 8-row groups 1024 bytes apart, the next 64 columns of hd one box
// (kBK * 128 bytes) further.
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&acc)[HDP / 2], const uint32_t (&p_hi)[kBK / 16][4],
                                         const uint32_t (&p_lo)[kBK / 16][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = sw128_desc(v_tile + kk * 16 * 128, kBK * 128, 1024);
    wgmma_rs<HDP>(acc, p_hi[kk], db);
    wgmma_rs<HDP>(acc, p_lo[kk], db);
  }
  wgmma_commit();
}

// Mask one tile of raw scores and run the online softmax on it, in place:
// sc becomes p. Updates the running max m (of the scaled scores) and this
// thread's share of the row sums l, and returns the accumulator's
// correction factors. Score element sc[4j + 2r + e] is the query at
// position pos0 + 8r (counted from key 0), key k_first + 8j + col0 + e. The scale is applied inside the exponent,
// p = 2^(s * scale * log2 e - m log2 e): scaling by a positive constant
// keeps each row's max where it is, and m is kept in the scaled units.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], const Params& a, bool edge,
                                             int pos0, int k_first, int col0, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge && !visible(a, pos0 + 8 * (e / 2), k_first + 8 * j + col0 + (e & 1)))
        sc[4 * j + e] = kNegInf;
      rmax[e / 2] = fmaxf(rmax[e / 2], sc[4 * j + e]);
    }
  float m_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    const float m_new = fmaxf(m[r], rmax[r] == kNegInf ? kNegInf : rmax[r] * a.scale);
    corr[r] = exp2_sfu((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    m_log2[r] = m_new * kLog2e;
  }
  const float scale_log2 = a.scale * kLog2e;
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_sfu(fmaf(sc[4 * j + e], scale_log2, -m_log2[e / 2]));
      if (edge && !visible(a, pos0 + 8 * (e / 2), k_first + 8 * j + col0 + (e & 1))) p = 0.0f;
      sc[4 * j + e] = p;
      rsum[e / 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
}

// p = p_hi + p_lo in bf16, in the A-operand fragment of the PV wgmma: the
// m64 score fragment is, pair by pair, that fragment (register q of key
// slice kk holds p[8kk + 2q], p[8kk + 2q + 1]).
__device__ __forceinline__ void split_p(const float (&p)[kBK / 2], uint32_t (&p_hi)[kBK / 16][4],
                                        uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = p[8 * kk + 2 * q], x1 = p[8 * kk + 2 * q + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      p_hi[kk][q] = bf16x2_bits(h2);
      p_lo[kk][q] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// The epilogue's output element and its stores: fp32 as is (a ring step's
// partial), bf16 rounded to nearest; a pair of adjacent columns as one store.
template <bool F32> struct OutType { using type = __nv_bfloat16; };
template <> struct OutType<true> { using type = float; };
__device__ __forceinline__ void store_one(float* o, float x) { *o = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float x) { *o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_pair(float* o, float x0, float x1) {
  *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
}

// OUT_F32: out is written in fp32 (a ring step's partial), else in bf16.
// OFFSET: a.off may be nonzero; the instantiations without it compile the
// offset out (a runtime offset slowed the kernel at Llama's shape).
template <int HDP, bool OUT_F32, bool OFFSET>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const int off = OFFSET ? a.off : 0;
  using OutT = typename OutType<OUT_F32>::type;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto k_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.h;
  const int hh = blockIdx.y % a.h;
  const int kv_head = hh / (a.h / a.kvh);
  const int q_first = qi * kBQ;
  const int q_last = min(q_first + kBQ, a.s) - 1;  // last real query row of the tile

  // kv_block_range at these tiles: [lo, hi) holds every key tile with a
  // visible (q, k) pair for some row of this query tile; tile i of the
  // walk is key tile hi - 1 - i, in ring stage i % kStages
  int lo = 0;
  int hi = (a.t + kBK - 1) / kBK;
  if (a.causal) hi = min(hi, floor_div(q_last + off, kBK) + 1);
  if (a.window) lo = max(0, floor_div(q_first + off - a.window + 1, kBK));
  const int n_tiles = max(hi - lo, 0);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      bar_init(k_full(st), 1);
      bar_init(v_full(st), 1);
      bar_init(empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      bar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(sq + c * kBQ * 128, &tm_q, bar_q, c * kBoxCols, hh, q_first, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int k_first = (hi - 1 - i) * kBK;
        bar_wait(empty(st), ((i / kStages) & 1) ^ 1);  // the first round passes at once
        bar_expect_tx(k_full(st), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(sk + st * L::kTileBytes + c * kBK * 128, &tm_k, k_full(st),
                   c * kBoxCols, kv_head, k_first, b);
        bar_expect_tx(v_full(st), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(sv + st * L::kTileBytes + c * kBK * 128, &tm_v, v_full(st),
                   c * kBoxCols, kv_head, k_first, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int qw_first = q_first + 64 * wg;            // this warpgroup's rows
    // this thread's rows row0 = qw_first + 16 warp + lane / 4 and row0 + 8, at
    // positions pos0 = row0 + off and pos0 + 8 counted from key 0 (row0 is
    // not kept live through the walk), and columns col0, col0 + 1 of each 8
    const int pos0 = qw_first + 16 * warp + lane / 4 + off;
    const int col0 = 2 * (lane % 4);
    const int pos_first = qw_first + off;
    const int pos_last = pos_first + 63;
    const uint32_t q_rows = sq + 64 * wg * 128;
    // a tile that is not wholly visible to every row pays the element mask
    auto edge = [&](int k_first) {
      return (a.causal && k_first + kBK - 1 > pos_first) ||
             (a.window && k_first <= pos_last - a.window) || (k_first + kBK > a.t);
    };

    // accumulator fragment of m64 x n(HDP): acc[4j + 2r + e] is row row0 + 8r,
    // column 8j + col0 + e
    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums, summed at the end
    float sc[kBK / 2], corr[2];
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];

    // The walk runs one tile ahead: tile i's QK^T is issued with tile
    // i - 1's PV, and tile i's softmax runs while that PV does. Only the
    // fp32 scores change while a PV is in flight; p and acc change after it.
    bar_wait(bar_q, 0);
    if (n_tiles > 0) {
      const int k_first = (hi - 1) * kBK;
      bar_wait(k_full(0), 0);
      issue_qk<HDP>(sc, q_rows, sk);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, a, edge(k_first), pos0, k_first, col0, m, l, corr);
      split_p(sc, p_hi, p_lo);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int prev = (i - 1) % kStages;
      const int k_first = (hi - 1 - i) * kBK;
      bar_wait(k_full(st), (i / kStages) & 1);
      bar_wait(v_full(prev), ((i - 1) / kStages) & 1);
      // the PV below reads acc and p as they are now: no write to them may
      // sink past the wgmma fence in issue_qk
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      issue_qk<HDP>(sc, q_rows, sk + st * L::kTileBytes);
      issue_pv<HDP>(acc, p_hi, p_lo, sv + prev * L::kTileBytes);
      wgmma_wait<1>();  // the scores are in; the PV may still run
      fence_regs(sc);
      softmax_tile(sc, a, edge(k_first), pos0, k_first, col0, m, l, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      bar_arrive(empty(prev));
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e / 2];
      split_p(sc, p_hi, p_lo);
    }
    if (n_tiles > 0) {
      const int st = (n_tiles - 1) % kStages;
      bar_wait(v_full(st), ((n_tiles - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_pv<HDP>(acc, p_hi, p_lo, sv + st * L::kTileBytes);
      wgmma_wait<0>();
      fence_regs(acc);
      bar_arrive(empty(st));
    }

    // out = acc / max(l, 1e-30) in bf16 (or fp32); lse = m + log(max(l, 1e-30))
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = pos0 - off + 8 * r;
      if (row >= a.s) continue;
      const float den = fmaxf(lr, 1e-30f);
      const int64_t at = (static_cast<int64_t>(b) * a.s + row) * a.h + hh;
      OutT* o = static_cast<OutT*>(a.o) + at * a.hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + col0;
        const float x0 = acc[4 * j + 2 * r] / den;
        const float x1 = acc[4 * j + 2 * r + 1] / den;
        if (col + 1 < a.hd && (a.hd & 1) == 0) {
          store_pair(o + col, x0, x1);
        } else {
          if (col < a.hd) store_one(o + col, x0);
          if (col + 1 < a.hd) store_one(o + col + 1, x1);
        }
      }
      if (a.lse != nullptr && lane % 4 == 0) a.lse[at] = m[r] + logf(den);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of this library beyond cudaError_t's
constexpr int kNoEncoder = 100000;
constexpr int kBadPlan = 100001;
constexpr int kEncodeFailed = 200000;  // + the CUresult

// plan: dims[4] (hd, heads, positions, batch), byte strides[3] (head,
// position, batch), box[4] (64, 1, rows, 1), as the wrapper computed them
int encode(CUtensorMap* map, const void* ptr, const int64_t* plan, int rows) {
  if (plan[7] != kBoxCols || plan[8] != 1 || plan[9] != rows || plan[10] != 1) return kBadPlan;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(plan[0]), static_cast<cuuint64_t>(plan[1]),
                              static_cast<cuuint64_t>(plan[2]), static_cast<cuuint64_t>(plan[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(plan[4]), static_cast<cuuint64_t>(plan[5]),
                                 static_cast<cuuint64_t>(plan[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(plan[7]), static_cast<cuuint32_t>(plan[8]),
                             static_cast<cuuint32_t>(plan[9]), static_cast<cuuint32_t>(plan[10])};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int HDP, bool OUT_F32, bool OFFSET>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const Params& a, int batch, cudaStream_t stream) {
  constexpr int smem = Layout<HDP>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HDP, OUT_F32, OFFSET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, batch * a.h);
  flash_fwd_wgmma_kernel<HDP, OUT_F32, OFFSET><<<grid, kThreads, smem, stream>>>(q, k, v, a);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_hd(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                      const Params& a, int batch, bool out_f32, cudaStream_t stream) {
  if (out_f32)
    return a.off ? launch<HDP, true, true>(q, k, v, a, batch, stream)
                 : launch<HDP, true, false>(q, k, v, a, batch, stream);
  return a.off ? launch<HDP, false, true>(q, k, v, a, batch, stream)
               : launch<HDP, false, false>(q, k, v, a, batch, stream);
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

// q (B, S, H, hd), k and v (B, T, KV, hd) in bf16, each described by its
// tensor-map plan (kMapArgs int64 each, q then k then v: see encode); out
// (B, S, H, hd) contiguous, bf16, or fp32 when out_f32; lse (B, S, H)
// contiguous fp32 or null. offset: the position of query row 0 minus that
// of key 0 (0 for a single pass; a ring step's q_offset - k_offset).
int faw_forward(const void* q, const void* k, const void* v, void* out, void* lse,
                const int64_t* plans, int batch, int s, int t, int h, int kvh, int hd,
                int causal, int window, int offset, int out_f32, float scale, int device,
                void* stream) {
  if (batch < 1 || s < 1 || t < 0 || kvh < 1 || h % kvh != 0 || hd < 1 || hd > 128 ||
      window < 0 || static_cast<int64_t>(batch) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t cerr = use_device(device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(&tm_q, q, plans, kBQ);
  if (err == 0 && t > 0) err = encode(&tm_k, k, plans + kMapArgs, kBK);
  if (err == 0 && t > 0) err = encode(&tm_v, v, plans + 2 * kMapArgs, kBK);
  if (err != 0) return err;
  if (t == 0) tm_k = tm_v = tm_q;  // no key tile is ever loaded
  const Params a{out, static_cast<float*>(lse), s, t, h, kvh, hd, causal, window, offset,
                 scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cerr = hd <= 64 ? launch_hd<64>(tm_q, tm_k, tm_v, a, batch, out_f32, st)
                  : launch_hd<128>(tm_q, tm_k, tm_v, a, batch, out_f32, st);
  return static_cast<int>(cerr);
}

// Dynamic shared memory of one CTA of the kernel that head dim hd takes
int faw_shared_bytes(int hd) {
  return hd <= 64 ? Layout<64>::kAlloc : Layout<128>::kAlloc;
}

const char* faw_error_string(int err) {
  static char buf[96];
  if (err == kNoEncoder) return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (err == kBadPlan) return "a tensor-map plan does not match the kernel's boxes";
  if (err >= kEncodeFailed) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d", err - kEncodeFailed);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
