// Hopper (sm_90a) port of the Pallas TPU kernel flash_attention_pallas
// (_flash_kernel) of src/repro/kernels/flash_attention.py: blockwise
// online-softmax attention, causal and/or sliding-window, GQA without
// expanding K/V, optional fp32 log-sum-exp. This is the route for fp32
// inputs and for bf16 inputs that TMA cannot describe; bf16 that TMA can
// describe takes flash_attention_wgmma.cu.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math: logf and the final division are the accurate ones)
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. The Python wrapper
// (repro_torch/kernels/flash_attention.py) checks device, dtype, shapes and
// strides, picks the load variant, allocates the outputs and passes the
// current stream; nothing here allocates or synchronises.
//
// Numbers. s, m, l, p and the accumulator are fp32 and both products are
// plain fp32 FMAs on the CUDA cores, whatever the input type (bf16 widens
// exactly), so this route is bound by the 67 TFLOP/s fp32 rate: 4 * hd
// flops per visible (query, key) pair, 8.2 ms at Llama-3-8B's prefill
// shape (B=4, S=T=4096, H=32 over KV=8, hd=128, causal), against ~0.35 ms
// for its bytes (q, k, v read once, out written once) at 3.35 TB/s.
//
// No tensor cores. An fp32-exact product on them takes 3xTF32 (hi*hi +
// hi*lo + lo*hi): three times the tensor work, hi/lo copies of every
// operand tile in shared memory, and a transposed V, since tf32 wgmma takes
// only K-major operands (unlike the bf16 PV of flash_attention_wgmma.cu).
// At the 26 % of its bound that this repository's bf16 wgmma kernel
// reaches, three tf32 products would not beat FMAs run near their peak.
//
// Design (what binds the FMA rate, and what is done about it):
// - One CTA of 256 threads per (batch, KV head, query-position tile). The
//   g = H / KV query heads that share the KV head are folded into the
//   CTA's 128 rows, position-major (row r is position r / g, head r % g of
//   the group), as flash_attention_plain folds them, so each K/V tile in
//   shared memory serves g heads. A tile holds floor(128 / g) positions;
//   the rows beyond positions * g are padding, never written (StarCoder2's
//   g = 9 uses 126 rows). Above g = 128 the group's heads are split into
//   chunks of 128 over CTAs.
// - Thread (ty, tx), tid = 16 ty + tx, owns rows ty + 16 i (i < 8) and, in
//   QK^T, keys tx + 16 j (j < 8) of a 128-key tile, in PV output columns
//   4 tx .. 4 tx + 3 (+64): an 8 x 8 register tile in both products, so
//   every 16-byte shared load feeds 16 FMAs (at hd <= 64 the PV tile is
//   8 x 4: 10.7).
// - Q stays in shared memory for the CTA's life. K and V stream through a
//   ring of 4 stages in chunks: a tile is 4 K chunks (128 keys x 32 head
//   columns) then 4 V chunks (32 keys x hd), so a stage is 18 KB and the
//   ring, Q and P fit one CTA per SM (204 KB at hd 128). One barrier per
//   chunk: wait for chunk i, barrier, start chunk i + 3 into the stage
//   everyone finished, compute chunk i. P^T goes through shared memory once
//   per tile, written after the last K chunk and read by the next four; the
//   chunk barriers order it, so P costs no barrier of its own.
// - Two load variants of one kernel: for fp32 K and V whose base pointers
//   and (non-unit) strides are 16-byte aligned and hd % 4 == 0, chunks come
//   in by cp.async.cg 16-byte copies (commit_group / wait_group, 3 chunks
//   in flight, out-of-range keys and columns zero-filled); any other input
//   (every bf16 one, odd fp32 strides) loads the next chunk into registers
//   before computing the current one and stores it after, so its load
//   latency overlaps the compute too (16 consecutive elements of one row
//   per thread). The wrapper picks the variant from a
//   pure function of pointers and strides; both are supported paths.
// - Row padding keeps the compute loop's float4 reads free of bank
//   conflicts: Q and P^T rows are 132 floats, K chunk rows 36 (an odd
//   number of float4s, so 8 lanes reading 8 rows hit 8 distinct groups of
//   4 banks); V rows are read contiguously.
// - Softmax: m is kept in scaled units, p = 2^(s * (scale log2 e) - m log2 e)
//   by one FMA and ex2.approx (relative error ~2^-22, inside the fp32
//   tolerance), as in the wgmma kernel. A row's m and l live in shared
//   memory (the registers go to the two 8 x 8 tiles); its 16 lanes reduce
//   the tile's max and sum by shuffles.
//
// What binds it (scripts/flash_simt_ablation.py, NVIDIA H100 80GB HBM3 at
// 700 W, the Llama-3-8B fp32 shape): 14.24 ms in all, 58 % of the fp32
// bound. Each product alone adds ~5.6-5.9 ms for 4.2 ms of FMAs at the
// peak, ~73 %, though its SASS block is 91-94 % FFMA: with one CTA of 8
// warps per SM (2 per scheduler, 254 registers each) shared-load latency
// is not hidden. The rest, 2.8 ms of chunk loads, barriers and softmax,
// adds on top rather than overlapping, since every warp meets the same
// barrier each chunk; releasing the stages by mbarriers per warp did not
// change that. The register-staged variant (misaligned bf16, odd fp32
// strides) runs ~1.2-1.3x the cp.async one: its loads cost issue slots and
// registers the products need. Spread as 16 strided elements per thread it
// spilled (ptxas) and waited for each load where it issued it; 16
// consecutive elements of one row per thread need one row pointer.
//
// Masking follows the TPU kernel: a KV tile outside kv_block_range is never
// visited; inside a visited edge tile each score outside its row's visible
// key interval is masked with the finite NEG_INF = -1e30 and p is 0 after
// the exp (2^(-1e29) flushes to 0; in a row with no visible key so far p is
// set to 0), so a fully masked row keeps (m, l, acc) = (-1e30, 0, 0) and
// writes 0. Ragged S and T edges are
// masked (keys, zero-filled) or not written (queries); no divisibility and
// no copy is required. Heaviest query tiles (last under causal masking) are
// scheduled first: the grid is one-dimensional, position tile slowest and
// counted down.
//
// Position offset: query position p sits at p + off relative to key 0
// (off = q_offset - k_offset of a ring step), so every row's visible key
// interval, the tile range and the edge test shift by off; the tile range
// divides with floor_div, since an offset can make the dividend negative and
// C++ '/' truncates toward zero. With out_f32 the output is written in fp32
// whatever the input type (a ring step's partial, merged before rounding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;     // folded query rows per CTA
constexpr int kBK = 128;       // keys per KV tile
constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kStages = 4;     // ring depth
constexpr int kKC = 32;        // head columns per K chunk
constexpr int kVC = 32;        // keys per V chunk
constexpr int kKLD = kKC + 4;  // K chunk row, floats
constexpr int kPLD = kRows + 4;  // P^T row, floats
constexpr int kStageFloats = kBK * kKLD;  // >= kVC * HDP for HDP <= 128

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
  int off;       // position of query 0 minus that of key 0
  int out_f32;   // 1: out is fp32 whatever T is
  int gc;        // heads of the group per CTA: min(g, kRows)
  int n_chunks;  // ceil(g / gc)
  int n_pos;     // positions per CTA: kRows / gc
  int n_tiles;   // ceil(s / n_pos)
  float scale;
};

template <int HDP>
struct Layout {
  static constexpr int QLD = HDP + 4;
  static constexpr int KCHUNKS = HDP / kKC;
  static constexpr int VCHUNKS = kBK / kVC;
  static constexpr int CPT = KCHUNKS + VCHUNKS;  // chunks per KV tile
  static constexpr int NG = HDP / 64;            // groups of 4 output columns per thread
  static constexpr size_t smem_floats =
      kRows * QLD + kBK * kPLD + kStages * kStageFloats + 4 * kRows;
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ uint32_t raw_bits(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ uint32_t raw_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// floor(a / b) for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in_range) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in_range ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where the elements of one chunk come from: chunk c of a KV tile starting
// at key k_first. K chunk c < KCHUNKS: keys k_first .. +127, head columns
// 32c .. 32c + 31, stored [key][kKLD]. V chunk c - KCHUNKS: keys
// k_first + 32 (c - KCHUNKS) .. +31, all HDP columns, stored [key][HDP].
template <typename T, int HDP>
struct Chunk {
  using L = Layout<HDP>;
  const T* k;
  const T* v;
  int64_t k_ss, v_ss;
  int t, hd;

  // async: 16-byte copies (T = float only); 4 per thread at HDP 128
  __device__ __forceinline__ void issue_async(float* stage, int k_first, int c, int tid) const {
    if (c < L::KCHUNKS) {
#pragma unroll
      for (int r = 0; r < kBK * kKC / 4 / kThreads; ++r) {
        const int e = tid + r * kThreads, key = e >> 3, col = c * kKC + (e & 7) * 4;
        const bool in = k_first + key < t && col < hd;
        const float* src = reinterpret_cast<const float*>(k) +
                           (in ? static_cast<int64_t>(k_first + key) * k_ss + col : 0);
        cp_async16(stage + key * kKLD + (e & 7) * 4, src, in);
      }
    } else {
      const int kv0 = k_first + (c - L::KCHUNKS) * kVC;
#pragma unroll
      for (int r = 0; r < kVC * HDP / 4 / kThreads; ++r) {
        const int e = tid + r * kThreads, key = e / (HDP / 4), col = (e % (HDP / 4)) * 4;
        const bool in = kv0 + key < t && col < hd;
        const float* src = reinterpret_cast<const float*>(v) +
                           (in ? static_cast<int64_t>(kv0 + key) * v_ss + col : 0);
        cp_async16(stage + key * HDP + col, src, in);
      }
    }
  }

  // sync: element loads into registers, kept as raw bits (bf16 two to a
  // register). Each thread takes 16 consecutive elements of one row (2
  // threads per K row, HDP / 16 per V row), so one row pointer serves all
  // 16 loads; the read-only cache merges a warp's neighbouring rows.
  static constexpr int kPend = 16;
  static constexpr int kWords = kPend * sizeof(T) / 4;
  static_assert(kBK * kKC == kThreads * kPend && kVC * HDP <= kThreads * kPend, "chunk split");
  __device__ __forceinline__ void put(uint32_t (&pend)[kWords], int r, uint32_t bits) const {
    if constexpr (sizeof(T) == 4) pend[r] = bits;
    else if (r % 2 == 0) pend[r / 2] = bits;
    else pend[r / 2] |= bits << 16;
  }
  __device__ __forceinline__ float get(const uint32_t (&pend)[kWords], int r) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(pend[r]);
    else return __uint_as_float(r % 2 == 0 ? pend[r / 2] << 16 : pend[r / 2] & 0xffff0000u);
  }
  // (row, first column) of this thread's 16 elements; row < 0: no work
  __device__ __forceinline__ void span(int c, int tid, int& row, int& col) const {
    if (c < L::KCHUNKS) {
      row = tid >> 1;
      col = c * kKC + (tid & 1) * kPend;
    } else {
      constexpr int per_row = HDP / kPend;
      row = tid < kVC * per_row ? tid / per_row : -1;
      col = (tid % per_row) * kPend;
    }
  }
  __device__ __forceinline__ void load(uint32_t (&pend)[kWords], int k_first, int c,
                                       int tid) const {
    int row, col;
    span(c, tid, row, col);
    if (row < 0) return;
    const int key = c < L::KCHUNKS ? k_first + row : k_first + (c - L::KCHUNKS) * kVC + row;
    const T* base = (c < L::KCHUNKS ? k + static_cast<int64_t>(key) * k_ss
                                     : v + static_cast<int64_t>(key) * v_ss) + col;
    const bool in_row = key < t;
#pragma unroll
    for (int r = 0; r < kPend; ++r)
      put(pend, r, (in_row && col + r < hd) ? raw_bits(base + r) : 0u);
  }
  __device__ __forceinline__ void store(const uint32_t (&pend)[kWords], float* stage, int c,
                                        int tid) const {
    int row, col;
    span(c, tid, row, col);
    if (row < 0) return;
    float* dst = c < L::KCHUNKS ? stage + row * kKLD + (col - c * kKC) : stage + row * HDP + col;
#pragma unroll
    for (int r = 0; r < kPend; r += 4)
      *reinterpret_cast<float4*>(dst + r) =
          make_float4(get(pend, r), get(pend, r + 1), get(pend, r + 2), get(pend, r + 3));
  }
};

template <typename T, int HDP, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Args a) {
  using L = Layout<HDP>;
  static_assert(kVC * HDP <= kStageFloats, "a V chunk must fit a stage");
  static_assert(!ASYNC || sizeof(T) == 4, "the async variant copies fp32");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][QLD]   Q, rows folded
  float* pt = qs + kRows * L::QLD;              // [kBK][kPLD]    P^T of the current tile
  float* ring = pt + kBK * kPLD;                // kStages x kStageFloats
  float* ms = ring + kStages * kStageFloats;    // [kRows] running max m (scaled units)
  float* ls = ms + kRows;                       // [kRows] running sum l
  int* klo = reinterpret_cast<int*>(ls + kRows);  // [kRows] first visible key of the row
  int* khi = klo + kRows;                         // [kRows] last visible key of the row

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nbh = gridDim.x / a.n_tiles;  // B * KV * n_chunks
  const int tile = a.n_tiles - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int b = bh / (a.kvh * a.n_chunks);
  const int kv_head = (bh / a.n_chunks) % a.kvh;
  const int j0 = (bh % a.n_chunks) * a.gc;  // first head of the group in this CTA
  const int g = a.h / a.kvh;
  const int p_first = tile * a.n_pos;
  const int p_last = min(p_first + a.n_pos, a.s) - 1;  // last real position of the tile

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (kv_head * g + j0) * a.q_sh;
  const Chunk<T, HDP> src{static_cast<const T*>(a.k) + b * a.k_sb + kv_head * a.k_sh,
                          static_cast<const T*>(a.v) + b * a.v_sb + kv_head * a.v_sh,
                          a.k_ss, a.v_ss, a.t, a.hd};

  // Q, zero for padding rows, ragged positions and head columns >= hd
#pragma unroll 16
  for (int e = tid; e < kRows * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP, pos = p_first + r / a.gc, jj = r % a.gc;
    const bool in = r < a.n_pos * a.gc && pos < a.s && j0 + jj < g && d < a.hd;
    qs[r * L::QLD + d] = in ? load_f(q + static_cast<int64_t>(pos) * a.q_ss + jj * a.q_sh + d)
                            : 0.0f;
  }
  if (tid < kRows) {
    // key k is visible to position qp iff k < t, k <= qp when causal and
    // k > qp - window when windowed: row tid sees keys klo .. khi (qp
    // counted from key 0)
    const int qp = p_first + tid / a.gc + a.off;
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
    klo[tid] = a.window ? qp - a.window + 1 : 0;
    khi[tid] = a.causal ? min(qp, a.t - 1) : a.t - 1;
  }

  // kv_block_range at this kernel's tiles: [lo, hi) holds every key tile
  // with a visible (q, k) pair for some real position of this tile
  int lo = 0;
  int hi = (a.t + kBK - 1) / kBK;
  if (a.causal) hi = min(hi, floor_div(p_last + a.off, kBK) + 1);
  if (a.window) lo = max(0, floor_div(p_first + a.off - a.window + 1, kBK));
  const int total = max(hi - lo, 0) * L::CPT;

  float sc[8][8], acc[8][4 * L::NG];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::NG; ++c) acc[i][c] = 0.0f;
  const float scale_log2 = a.scale * kLog2e;

  uint32_t pend[Chunk<T, HDP>::kWords];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) {
      const int k_first = (lo + i / L::CPT) * kBK;
      if constexpr (ASYNC) {
        src.issue_async(ring + i * kStageFloats, k_first, i % L::CPT, tid);
      } else {
        src.load(pend, k_first, i % L::CPT, tid);
        src.store(pend, ring + i * kStageFloats, i % L::CPT, tid);
      }
    }
    if constexpr (ASYNC) cp_async_commit();
  }

  for (int it = 0; it < total; ++it) {
    if constexpr (ASYNC) cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk it is in; everyone is done with chunk it - 1
    const int nx = it + kStages - 1;
    if (nx < total) {
      const int nk_first = (lo + nx / L::CPT) * kBK;
      if constexpr (ASYNC)
        src.issue_async(ring + (nx % kStages) * kStageFloats, nk_first, nx % L::CPT, tid);
      else
        src.load(pend, nk_first, nx % L::CPT, tid);
    }
    if constexpr (ASYNC) cp_async_commit();

    const float* stage = ring + (it % kStages) * kStageFloats;
    const int c = it % L::CPT;
    const int k_first = (lo + it / L::CPT) * kBK;
    if (c < L::KCHUNKS) {
      // s += q k^T over head columns 32c .. 32c + 31 (zero-padded past hd)
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
      }
#pragma unroll
      for (int d4 = 0; d4 < kKC / 4; ++d4) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::QLD + c * kKC + 4 * d4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(stage + (tx + 16 * j) * kKLD + 4 * d4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sc[i][j] = fmaf(qv[i].x, kv.x, sc[i][j]);
            sc[i][j] = fmaf(qv[i].y, kv.y, sc[i][j]);
            sc[i][j] = fmaf(qv[i].z, kv.z, sc[i][j]);
            sc[i][j] = fmaf(qv[i].w, kv.w, sc[i][j]);
          }
        }
      }
      if (c == L::KCHUNKS - 1) {
        // online softmax of this tile; p goes to P^T for the V chunks. m
        // and l live in shared memory, one value per row, read by the 16
        // lanes of the row and written by its lane tx = 0 (the registers go
        // to the two 8 x 8 tiles).
        const bool edge = (a.causal && k_first + kBK - 1 > p_first + a.off) ||
                          (a.window && k_first <= p_last + a.off - a.window) ||
                          (k_first + kBK > a.t);
        if (edge) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int lo_i = klo[ty + 16 * i], hi_i = khi[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int kp = k_first + tx + 16 * j;
              if (kp < lo_i || kp > hi_i) sc[i][j] = kNegInf;
            }
          }
        }
        // the eight rows side by side: their shuffle chains and exps overlap
        float m_new[8], corr[8], rsum[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          m_new[i] = kNegInf;
#pragma unroll
          for (int j = 0; j < 8; ++j) m_new[i] = fmaxf(m_new[i], sc[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], off));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float m_old = ms[ty + 16 * i];
          m_new[i] = fmaxf(m_old, m_new[i] == kNegInf ? kNegInf : m_new[i] * a.scale);
          corr[i] = exp2_sfu((m_old - m_new[i]) * kLog2e);
          const float m_log2 = m_new[i] * kLog2e;
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = exp2_sfu(fmaf(sc[i][j], scale_log2, -m_log2));
        }
        // p-masking: a masked score (-1e30) gives p = 2^(-1e29 - m) = 0 in a
        // row with a visible key; a row whose keys so far are all masked
        // (m = -1e30) would give 2^(+1e29), so its p are zeroed
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (m_new[i] == kNegInf)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rsum[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) rsum[i] += sc[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < 8; ++i) rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rsum[i] += ls[ty + 16 * i] * corr[i];
#pragma unroll
          for (int cc = 0; cc < 4 * L::NG; ++cc) acc[i][cc] *= corr[i];
        }
        __syncwarp();  // every lane of a row has read its m and l
        if (tx == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ms[ty + 16 * i] = m_new[i];
            ls[ty + 16 * i] = rsum[i];
          }
        }
        // P^T[key][8 ty + i]: each thread's 8 rows contiguous for the PV reads
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* dst = pt + (tx + 16 * j) * kPLD + 8 * ty;
          *reinterpret_cast<float4*>(dst) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
        }
      }
    } else {
      // acc += p v over keys 32 (c - KCHUNKS) .. +31 of the tile
      const float* pk = pt + (c - L::KCHUNKS) * kVC * kPLD + 8 * ty;
#pragma unroll
      for (int kk = 0; kk < kVC; ++kk) {
        const float4 pa = *reinterpret_cast<const float4*>(pk + kk * kPLD);
        const float4 pb = *reinterpret_cast<const float4*>(pk + kk * kPLD + 4);
        const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int gg = 0; gg < L::NG; ++gg) {
          const float4 vb = *reinterpret_cast<const float4*>(stage + kk * HDP + gg * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][gg * 4 + 0] = fmaf(pv[i], vb.x, acc[i][gg * 4 + 0]);
            acc[i][gg * 4 + 1] = fmaf(pv[i], vb.y, acc[i][gg * 4 + 1]);
            acc[i][gg * 4 + 2] = fmaf(pv[i], vb.z, acc[i][gg * 4 + 2]);
            acc[i][gg * 4 + 3] = fmaf(pv[i], vb.w, acc[i][gg * 4 + 3]);
          }
        }
      }
    }
    if constexpr (!ASYNC) {
      if (nx < total) src.store(pend, ring + (nx % kStages) * kStageFloats, nx % L::CPT, tid);
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();  // no copy outlives the CTA
  __syncthreads();  // m and l of every row are written

  // out = acc / max(l, 1e-30) in the input type (or fp32); lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i, pos = p_first + r / a.gc, jj = r % a.gc;
    if (r >= a.n_pos * a.gc || pos >= a.s || j0 + jj >= g) continue;
    const float den = fmaxf(ls[r], 1e-30f);
    const int64_t at = (static_cast<int64_t>(b) * a.s + pos) * a.h + kv_head * g + j0 + jj;
#pragma unroll
    for (int gg = 0; gg < L::NG; ++gg)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int d = gg * 64 + tx * 4 + cc;
        if (d >= a.hd) continue;
        const float x = acc[i][gg * 4 + cc] / den;
        if (a.out_f32) store_f(static_cast<float*>(a.o) + at * a.hd + d, x);
        else store_f(static_cast<T*>(a.o) + at * a.hd + d, x);
      }
    if (a.lse != nullptr && tx == 0) a.lse[at] = ms[r] + logf(den);
  }
}

template <typename T, int HDP, bool ASYNC>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = Layout<HDP>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP, ASYNC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(a.n_tiles) * batch * a.kvh * a.n_chunks;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, HDP, ASYNC><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(a);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q (B, S, H, hd), k and v (B, T, KV, hd), each with unit stride on hd and
// the given element strides on batch, position and head; out (B, S, H, hd)
// contiguous in the input type, or fp32 when out_f32; lse (B, S, H)
// contiguous fp32 or null. offset: the position of query 0 minus that of
// key 0 (0 for a single pass; a ring step's q_offset - k_offset).
// is_bf16: 1 for bf16 inputs and output, 0 for fp32. async_loads: 1 for the
// cp.async variant (fp32, k and v 16-byte aligned with 16-byte strides and
// hd % 4 == 0, as flash_attention._load_variant decides), 0 for the
// register-staged one.
int fa_forward(const void* q, const void* k, const void* v, void* out, void* lse,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               int batch, int s, int t, int h, int kvh, int hd,
               int causal, int window, int offset, int out_f32, float scale, int is_bf16,
               int async_loads, int device, void* stream) {
  if (batch < 1 || s < 1 || t < 0 || kvh < 1 || h % kvh != 0 || hd < 1 || hd > 128 ||
      window < 0 || static_cast<int64_t>(batch) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // a stride of a dim of size 1 never moves an address
  const bool strides16 = (batch == 1 || (k_sb % 4 == 0 && v_sb % 4 == 0)) &&
                         (t <= 1 || (k_ss % 4 == 0 && v_ss % 4 == 0)) &&
                         (kvh == 1 || (k_sh % 4 == 0 && v_sh % 4 == 0));
  if (async_loads &&
      (is_bf16 || hd % 4 != 0 || !aligned16(k) || !aligned16(v) || !strides16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = h / kvh;
  const int gc = g < kRows ? g : kRows;
  const int n_pos = kRows / gc;
  const Args a{q, k, v, out, static_cast<float*>(lse),
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               s, t, h, kvh, hd, causal, window, offset, out_f32,
               gc, (g + gc - 1) / gc, n_pos, (s + n_pos - 1) / n_pos, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = hd <= 64 ? launch<__nv_bfloat16, 64, false>(a, batch, st)
                   : launch<__nv_bfloat16, 128, false>(a, batch, st);
  else if (async_loads)
    err = hd <= 64 ? launch<float, 64, true>(a, batch, st) : launch<float, 128, true>(a, batch, st);
  else
    err = hd <= 64 ? launch<float, 64, false>(a, batch, st)
                   : launch<float, 128, false>(a, batch, st);
  return static_cast<int>(err);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
