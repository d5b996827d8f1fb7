// Fused out-proj + residual + RMSNorm, backward.
//
// Replaces: ray_tpu/ops/fused_norm.py:_bwd_kernel (via _mrn_bwd, the
// custom VJP of matmul_residual_norm).
//
// Given the forward's a [N, K], w [K, d], rout [N, d], scale [d], rstd [N]
// (f32) and the cotangents drout, dy [N, d] (bf16 or f32, one dtype;
// d = 768), per row (fused_norm.py:162-183):
//   xhat   = rout * rstd,  dxhat = dy * scale
//   dr     = rstd * (dxhat - xhat * mean(dxhat * xhat)) + drout   (f32)
//   dresid = dr rounded to the storage dtype (= the dp that both products
//            contract against, fused_norm.py:177)
//   dscale = sum over rows of dy * xhat   (f32)
//   da     = dresid @ w^T                 (f32 accumulation)
//   dw     = a^T @ dresid                 (f32 accumulation, cast once)
//
// Cross-block reductions, deterministic (no atomics): dscale is a sum over
// all N rows, so mrn_bwd_rows_kernel writes one [d] partial per 64-row
// block and a column sum adds them in block order; dw is a sum over N as
// well, so its product is split along N into kSplits slices, each written
// as an f32 [K, d] partial, and a column sum adds the slices in order and
// casts once (the reference sums bf16 per-row-block partials in f32).
//
// What bounds it on an H100: the two products, 4*N*K*d flops (58 GFLOP at
// N = 24576, K = d = 768, ~0.06 ms at 989 TFLOP/s), against ~(2*N*K +
// 5*N*d)*2 bytes (~0.07 ms at 3.35 TB/s): close to the ridge.  The products
// run on bf16 WMMA fragments (rtt::block_mma) over 64x64 output tiles; the
// row pass reads each row once and keeps its values in registers.
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 768;          // d, the one output width
constexpr int CPL = WIDTH / 32;     // columns per lane in the row pass
constexpr int ROWS = 64;            // rows per block of the row pass
constexpr int kSplits = 8;          // slices of N in the dw product

// the row pass: dresid and the per-block dscale partials
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mrn_bwd_rows_kernel(const T* __restrict__ rout,
                        const T* __restrict__ scale,
                        const float* __restrict__ rstd,
                        const T* __restrict__ drout,
                        const T* __restrict__ dy, T* __restrict__ dresid,
                        float* __restrict__ dsp, int N) {
  __shared__ float part[WARPS][WIDTH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dsc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) dsc[j] = 0.f;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int n = blockIdx.x * ROWS + r;
    if (n >= N) break;
    const long off = static_cast<long>(n) * WIDTH;
    const float rs = rstd[n];
    float xhat[CPL], g[CPL], dot = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      xhat[j] = rtt::to_f32(rout[off + c]) * rs;
      g[j] = rtt::to_f32(dy[off + c]);
      dot += g[j] * rtt::to_f32(scale[c]) * xhat[j];
      dsc[j] += g[j] * xhat[j];
    }
    const float mean = rtt::warp_sum(dot) / static_cast<float>(WIDTH);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      const float dxhat = g[j] * rtt::to_f32(scale[c]);
      const float dr =
          rs * (dxhat - xhat[j] * mean) + rtt::to_f32(drout[off + c]);
      dresid[off + c] = rtt::from_f32<T>(dr);
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) part[warp][lane + 32 * j] = dsc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < WIDTH; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += part[wp][c];
    dsp[static_cast<long>(blockIdx.x) * WIDTH + c] = s;
  }
}

// C [M, N] = A [M, K] @ B [K, N] over a 64 x 64 output tile per block,
// K in steps of 32 through shared memory.  A is row-major with leading
// dimension lda, or with A_COL the transpose of a row-major [K, M]; B is
// row-major [K, N], or with B_COL the transpose of a row-major [N, K].
// blockIdx.z selects a slice of K (k_len long): with part != nullptr the
// f32 tile goes to part[z] [M, N], otherwise it is cast into C.
constexpr int TM = 64, TN = 64, TK = 32;

template <typename T, bool A_COL, bool B_COL>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B,
                int ldb, T* __restrict__ C, float* __restrict__ part, int M,
                int N, int K, int k_len) {
  constexpr int P = rtt::kPad<T>;
  // A tile as [TM][TK] (row) or [TK][TM] (col); B as [TK][TN] or [TN][TK]
  constexpr int LDA = A_COL ? TM + P : TK + P;
  constexpr int LDB = B_COL ? TK + P : TN + P;
  constexpr int LDC = TN + 4;
  __shared__ __align__(128) T As[A_COL ? TK : TM][LDA];
  __shared__ __align__(128) T Bs[B_COL ? TN : TK][LDB];
  __shared__ __align__(128) float Cs[TM][LDC];

  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k_beg = blockIdx.z * k_len;
  const int k_end = min(K, k_beg + k_len);
  for (int i = threadIdx.x; i < TM * LDC; i += THREADS) (&Cs[0][0])[i] = 0.f;

  for (int k0 = k_beg; k0 < k_end; k0 += TK) {
    __syncthreads();  // the last step's readers of As, Bs are done
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      if constexpr (A_COL) {
        const int kk = i / TM, m = i % TM;
        As[kk][m] = (m0 + m < M && k0 + kk < k_end)
                        ? A[static_cast<long>(k0 + kk) * lda + m0 + m]
                        : rtt::from_f32<T>(0.f);
      } else {
        const int m = i / TK, kk = i % TK;
        As[m][kk] = (m0 + m < M && k0 + kk < k_end)
                        ? A[static_cast<long>(m0 + m) * lda + k0 + kk]
                        : rtt::from_f32<T>(0.f);
      }
    }
    for (int i = threadIdx.x; i < TN * TK; i += THREADS) {
      if constexpr (B_COL) {
        const int n = i / TK, kk = i % TK;
        Bs[n][kk] = (n0 + n < N && k0 + kk < k_end)
                        ? B[static_cast<long>(n0 + n) * ldb + k0 + kk]
                        : rtt::from_f32<T>(0.f);
      } else {
        const int kk = i / TN, n = i % TN;
        Bs[kk][n] = (n0 + n < N && k0 + kk < k_end)
                        ? B[static_cast<long>(k0 + kk) * ldb + n0 + n]
                        : rtt::from_f32<T>(0.f);
      }
    }
    __syncthreads();
    rtt::block_mma<A_COL, B_COL>(&Cs[0][0], LDC, &As[0][0], LDA, &Bs[0][0],
                                 LDB, TM, TN, TK, true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int m = i / TN, n = i % TN;
    if (m0 + m >= M || n0 + n >= N) continue;
    const long o = static_cast<long>(m0 + m) * N + n0 + n;
    if (part != nullptr)
      part[static_cast<long>(blockIdx.z) * M * N + o] = Cs[m][n];
    else
      C[o] = rtt::from_f32<T>(Cs[m][n]);
  }
}

template <typename T>
int launch(const void* a, const void* w, const void* rout, const void* scale,
           const void* rstd, const void* drout, const void* dy, void* da,
           void* dw, void* dresid, void* dscale, void* dsp, void* dwp, int N,
           int K, cudaStream_t stream) {
  const int d = WIDTH;
  const int n_blk = (N + ROWS - 1) / ROWS;
  mrn_bwd_rows_kernel<T><<<n_blk, THREADS, 0, stream>>>(
      static_cast<const T*>(rout), static_cast<const T*>(scale),
      static_cast<const float*>(rstd), static_cast<const T*>(drout),
      static_cast<const T*>(dy), static_cast<T*>(dresid),
      static_cast<float*>(dsp), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // da [N, K] = dresid [N, d] @ w^T  (w is row-major [K, d])
  gemm_kernel<T, false, true>
      <<<dim3((K + TN - 1) / TN, (N + TM - 1) / TM, 1), THREADS, 0, stream>>>(
          static_cast<const T*>(dresid), d, static_cast<const T*>(w), d,
          static_cast<T*>(da), nullptr, N, K, d, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dw [K, d] = a^T @ dresid, N split into kSplits f32 slices
  const int k_len = ((N + kSplits - 1) / kSplits + TK - 1) / TK * TK;
  gemm_kernel<T, true, false>
      <<<dim3((d + TN - 1) / TN, (K + TM - 1) / TM, kSplits), THREADS, 0,
         stream>>>(static_cast<const T*>(a), K,
                   static_cast<const T*>(dresid), d, nullptr,
                   static_cast<float*>(dwp), K, d, N, k_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = rtt::launch_column_sum(static_cast<const float*>(dwp),
                                  static_cast<T*>(dw), kSplits,
                                  static_cast<long>(K) * d, stream);
  if (rc) return rc;
  return rtt::launch_column_sum(static_cast<const float*>(dsp),
                                static_cast<float*>(dscale), n_blk, d,
                                stream);
}

}  // namespace

// da [N, K], dw [K, d], dresid [N, d] in the storage dtype, dscale [d] f32.
// Scratch (f32): dsp of ceil(N / 64) x d, dwp of 8 x K x d.
extern "C" int matmul_residual_norm_bwd(
    const void* a, const void* w, const void* rout, const void* scale,
    const void* rstd, const void* drout, const void* dy, void* da, void* dw,
    void* dresid, void* dscale, void* dsp, void* dwp, int N, int K, int d,
    int dtype, void* stream) {
  if (N <= 0) return 0;
  if (K % 16 || K > 1536 || d != WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kF32)
    return launch<float>(a, w, rout, scale, rstd, drout, dy, da, dw, dresid,
                         dscale, dsp, dwp, N, K, st);
  if (dtype == rtt::kBF16)
    return launch<__nv_bfloat16>(a, w, rout, scale, rstd, drout, dy, da, dw,
                                 dresid, dscale, dsp, dwp, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
