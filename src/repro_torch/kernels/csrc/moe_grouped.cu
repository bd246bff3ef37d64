// Grouped fp32 matrix products over the experts a layer holds, for the
// dropless MoE of the hybrid_moe family (repro_torch.kernels.moe_grouped).
//
// Replaces no TPU kernel: the JAX package's MoE is the capacity route,
// whose expert products are dense batched matmuls over fixed queues. The
// dropless route sorts its routing slots by expert, so expert e owns rows
// [seg[e], seg[e+1]) of the sorted slots, and how many rows each expert
// owns is known only on the device. These kernels read seg on the device:
// the host never waits for the counts, and the grid is sized for the most
// rows the layer can route (its tiles past the last routed row return at
// once).
//
//   moe_rows_gemm:  C[r, :] (+)= A[row(r), :] @ B_e     r in expert e's rows
//   moe_wgrad_gemm: C_e      = A[rows of e]^T @ B[rows of e]
//
// row(r) is a_rows[r] where given (the token a slot routes), else r. B_e is
// expert e's (K, N) matrix at strides (sbe, sbk, sbn), so a transposed
// weight needs no copy. Plain fp32 FMA (no tensor cores, no TF32): the
// products stay at the precision the configurations state. Each output
// element sums its K products in index order, so a call's numbers do not
// depend on the schedule. Bound by the SMs' fp32 FMA rate at these widths
// (K and N of 768 and 4,096); 64 x 64 output tiles, 4 x 4 a thread, the
// operands staged through shared memory 16 deep.
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define BK 16
#define NT 256

namespace {

__device__ __forceinline__ void fma_tile(float (*as)[BM + 4], float (*bs)[BN + 4],
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
}

__global__ void __launch_bounds__(NT) moe_rows_gemm_kernel(
    const float* __restrict__ a, const int64_t* __restrict__ a_rows,
    const float* __restrict__ b, const int64_t* __restrict__ seg, float* __restrict__ c,
    int64_t lda, int64_t sbe, int64_t sbk, int64_t sbn, int64_t ldc,
    int n_experts, int k_dim, int n_dim, int accumulate) {
    __shared__ __align__(16) float as[BK][BM + 4];
    __shared__ __align__(16) float bs[BK][BN + 4];
    __shared__ int64_t tile[3];
    const int tid = threadIdx.x;
    if (tid == 0) {
        // this block's tile: the expert whose rows it covers, its first row
        // and the expert's end; -1 past the last routed row
        int64_t t = blockIdx.x, first = 0;
        tile[0] = -1;
        for (int e = 0; e < n_experts; ++e) {
            const int64_t lo = seg[e], hi = seg[e + 1];
            const int64_t tiles = (hi - lo + BM - 1) / BM;
            if (t < first + tiles) {
                tile[0] = e;
                tile[1] = lo + (t - first) * BM;
                tile[2] = hi;
                break;
            }
            first += tiles;
        }
    }
    __syncthreads();
    const int64_t e = tile[0];
    if (e < 0) return;
    const int64_t row0 = tile[1], row_end = tile[2];
    const int n0 = blockIdx.y * BN;
    const float* be = b + e * sbe;
    const int tx = tid % 16, ty = tid / 16;

    int64_t src[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = (tid + i * NT) / BK;
        const int64_t r = row0 + m;
        src[i] = r < row_end ? (a_rows ? a_rows[r] : r) : -1;
    }
    const bool n_fast = sbn == 1;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < k_dim; k0 += BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int l = tid + i * NT, m = l / BK, kk = l % BK, k = k0 + kk;
            as[kk][m] = (src[i] >= 0 && k < k_dim) ? a[src[i] * lda + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int l = tid + i * NT;
            const int kk = n_fast ? l / BN : l % BK;
            const int nn = n_fast ? l % BN : l / BK;
            const int k = k0 + kk, n = n0 + nn;
            bs[kk][nn] = (k < k_dim && n < n_dim) ? be[k * sbk + n * sbn] : 0.f;
        }
        __syncthreads();
        fma_tile(as, bs, ty, tx, acc);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + ty * 4 + i;
        if (r >= row_end) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n >= n_dim) continue;
            float* p = c + r * ldc + n;
            *p = accumulate ? *p + acc[i][j] : acc[i][j];
        }
    }
}

__global__ void __launch_bounds__(NT) moe_wgrad_gemm_kernel(
    const float* __restrict__ a, const int64_t* __restrict__ a_rows,
    const float* __restrict__ b, const int64_t* __restrict__ seg, float* __restrict__ c,
    int64_t lda, int64_t ldb, int k_dim, int n_dim) {
    __shared__ __align__(16) float as[BK][BM + 4];
    __shared__ __align__(16) float bs[BK][BN + 4];
    const int tid = threadIdx.x;
    const int e = blockIdx.y;
    const int tiles_n = (n_dim + BN - 1) / BN;
    const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
    const int64_t lo = seg[e], hi = seg[e + 1];
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4] = {};
    for (int64_t r0 = lo; r0 < hi; r0 += BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int l = tid + i * NT, kk = l / BM, m = l % BM;
            const int64_t r = r0 + kk;
            const int col = m0 + m;
            float v = 0.f;
            if (r < hi && col < k_dim) v = a[(a_rows ? a_rows[r] : r) * lda + col];
            as[kk][m] = v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int l = tid + i * NT, kk = l / BN, nn = l % BN;
            const int64_t r = r0 + kk;
            const int n = n0 + nn;
            bs[kk][nn] = (r < hi && n < n_dim) ? b[r * ldb + n] : 0.f;
        }
        __syncthreads();
        fma_tile(as, bs, ty, tx, acc);
        __syncthreads();
    }
    float* ce = c + (int64_t)e * k_dim * n_dim;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= k_dim) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n < n_dim) ce[(int64_t)m * n_dim + n] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" {

const char* mg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// max_tiles: the row tiles the grid covers (at least the routed rows' tiles)
int moe_rows_gemm(const float* a, const int64_t* a_rows, const float* b, const int64_t* seg,
                  float* c, int64_t lda, int64_t sbe, int64_t sbk, int64_t sbn, int64_t ldc,
                  int n_experts, int k_dim, int n_dim, int accumulate, int64_t max_tiles,
                  int device, void* stream) {
    cudaSetDevice(device);
    if (max_tiles <= 0) return 0;
    dim3 grid((unsigned)max_tiles, (unsigned)((n_dim + BN - 1) / BN));
    moe_rows_gemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, a_rows, b, seg, c, lda, sbe, sbk, sbn, ldc, n_experts, k_dim, n_dim, accumulate);
    return (int)cudaGetLastError();
}

int moe_wgrad_gemm(const float* a, const int64_t* a_rows, const float* b, const int64_t* seg,
                   float* c, int64_t lda, int64_t ldb, int n_experts, int k_dim, int n_dim,
                   int device, void* stream) {
    cudaSetDevice(device);
    if (n_experts <= 0) return 0;
    const int tiles = ((k_dim + BM - 1) / BM) * ((n_dim + BN - 1) / BN);
    dim3 grid((unsigned)tiles, (unsigned)n_experts);
    moe_wgrad_gemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, a_rows, b, seg, c, lda, ldb, k_dim, n_dim);
    return (int)cudaGetLastError();
}

}  // extern "C"
