// Fused attention out-projection + residual add + RMSNorm (forward).
//
// Replaces: ray_tpu/ops/fused_norm.py:_fwd_kernel (via _run_fwd;
// public matmul_residual_norm).
//
// Computes, for a [N, K], w [K, d], resid [N, d], scale [d] (bf16 or
// f32, one dtype; d = 768, GPT-2's width, is the one instantiation):
//   p    = a @ w                       (f32 accumulation)
//   r    = resid + p.astype(dtype)     (the residual add in the storage
//                                       dtype, as fused_norm.py:153)
//   rstd = 1 / sqrt(mean(r^2) + eps)   (f32 statistics)
//   y    = (r * rstd * scale).astype(dtype)
// emitting r, y (storage dtype) and rstd [N] (f32, kept for the
// backward that a later slice ports).
//
// What bounds it on an H100: at the prefill shapes (N = bucket, K = d =
// 768) the product is 2*N*K*d flops over ~(N*K + K*d + 3*N*d)*2 bytes;
// at N = 1024 that is ~280 flops per byte, right at the bf16 ridge, and
// at N = 32 it is memory-bound on reading w.
//
// What the design does about it: one block owns BN = 16 full rows of
// the output, so the norm runs in the epilogue on data that never left
// the SM: the f32 product lands in shared memory, the residual add and
// the row statistics read it there, and r and y are written once each.
// The bf16 product runs on the tensor cores through WMMA 16x16x16
// fragments (a from shared memory, w streamed from L2, which all blocks
// share), each warp holding all of its output tiles' accumulators so
// the w loads of a k-step are in flight together; f32 inputs take a
// CUDA-core FMA loop.  wgmma with TMA-fed tiles and a split of d across
// blocks for small N are later work.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BN = 16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WIDTH = 768;                 // the one output width, d
constexpr int NT = WIDTH / (16 * WARPS);  // 16-wide output tiles per warp

// P[BN, d] (f32, shared) = As[BN, K] (shared) @ w[K, d] (global).
// Warp w owns output tiles w, w + WARPS, ... (NT of them) and keeps all
// their accumulators live, so each k-step starts its NT independent
// w-fragment loads together instead of one at a time.
__device__ __forceinline__ void block_matmul(const __nv_bfloat16* As,
                                             const __nv_bfloat16* w, float* P,
                                             int K, int d) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::load_matrix_sync(fa, As + kk, K);
    const __nv_bfloat16* wk = w + static_cast<long>(kk) * d + warp * 16;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, wk + t * WARPS * 16, d);
      wmma::mma_sync(acc[t], fa, fb, acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(P + (warp + t * WARPS) * 16, acc[t], d,
                            wmma::mem_row_major);
}

__device__ __forceinline__ void block_matmul(const float* As, const float* w,
                                             float* P, int K, int d) {
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float acc[BN];
#pragma unroll
    for (int r = 0; r < BN; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float wv = w[static_cast<long>(kk) * d + c];
#pragma unroll
      for (int r = 0; r < BN; ++r) acc[r] += As[r * K + kk] * wv;
    }
#pragma unroll
    for (int r = 0; r < BN; ++r) P[r * d + c] = acc[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mrn_kernel(const T* __restrict__ a, const T* __restrict__ w,
               const T* __restrict__ resid, const T* __restrict__ scale,
               T* __restrict__ r_out, T* __restrict__ y_out,
               float* __restrict__ rstd_out, int N, int K, int d, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  float* P = reinterpret_cast<float*>(smem_raw + sizeof(T) * BN * K);
  const int n0 = blockIdx.x * BN;
  const int rows = min(BN, N - n0);

  for (int i = threadIdx.x; i < BN * K; i += THREADS) {
    const int r = i / K;
    As[i] = r < rows ? a[static_cast<long>(n0) * K + i] : rtt::from_f32<T>(0.f);
  }
  __syncthreads();
  block_matmul(As, w, P, K, d);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {
    const long off = static_cast<long>(n0 + r) * d;
    float* pr = P + r * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float rr =
          rtt::round_to<T>(rtt::to_f32(resid[off + c]) + rtt::round_to<T>(pr[c]));
      pr[c] = rr;
      r_out[off + c] = rtt::from_f32<T>(rr);
      ss += rr * rr;
    }
    ss = rtt::warp_sum(ss);
    const float rstd = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
    for (int c = lane; c < d; c += 32)
      y_out[off + c] = rtt::from_f32<T>(pr[c] * rstd * rtt::to_f32(scale[c]));
    if (lane == 0) rstd_out[n0 + r] = rstd;
  }
}

template <typename T>
int launch(const void* a, const void* w, const void* resid, const void* scale,
           void* r, void* y, void* rstd, int N, int K, int d, float eps,
           cudaStream_t stream) {
  const size_t smem = sizeof(T) * BN * K + sizeof(float) * BN * d;
  cudaError_t err = cudaFuncSetAttribute(
      mrn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + BN - 1) / BN;
  mrn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<const T*>(resid), static_cast<const T*>(scale),
      static_cast<T*>(r), static_cast<T*>(y), static_cast<float*>(rstd), N, K,
      d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_residual_norm_fwd(const void* a, const void* w,
                                        const void* resid, const void* scale,
                                        void* r, void* y, void* rstd, int N,
                                        int K, int d, float eps, int dtype,
                                        void* stream) {
  if (N <= 0) return 0;
  if (K % 16 || K > 1536 || d != WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kF32)
    return launch<float>(a, w, resid, scale, r, y, rstd, N, K, d, eps, st);
  if (dtype == rtt::kBF16)
    return launch<__nv_bfloat16>(a, w, resid, scale, r, y, rstd, N, K, d,
                                 eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
