// Block-level building blocks of the f32 instantiations of the port's
// matmul-shaped kernels (the out-proj epilogue backward and flash-CE):
// tile products on shared memory, row copies into shared memory, and a
// deterministic column sum.
//
// A tile product accumulates in an f32 tile kept in shared memory, so a
// kernel can run several products into one accumulator across a loop.
// It is a CUDA-core FMA loop in full f32, so the f32 instantiation of a
// kernel is held to the plain version at summation-order tolerance; the
// bf16 instantiations run on wgmma (hopper.cuh).
#pragma once

#include "common.cuh"

namespace rtt {

// shared-memory row padding, in elements: 16 bytes keeps every row start
// 16-byte aligned (vector copies) and staggers banks between rows
template <typename T> constexpr int kPad = 16 / static_cast<int>(sizeof(T));

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// C[M][N] (f32, shared, row-major, ldc) = (accumulate ? C : 0) + A B, with
// A [M][K] and B [K][N] f32 in shared memory, on the CUDA cores in full
// f32.  A is row-major (a(m,k) = A[m*lda + k]) or, with A_COL,
// column-major (a(m,k) = A[k*lda + m]); B is row-major (b(k,n) =
// B[k*ldb + n]) or, with B_COL, column-major (b(k,n) = B[n*ldb + k]).
// Each thread owns 4x4 micro-tiles (rows m0..m0+3, columns nc + j*N/4),
// so every pair of shared loads feeds four FMAs.  M and N are multiples
// of 4.  Every thread of the block calls it; it does not synchronise.
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void block_mma(float* C, int ldc, const float* A,
                                          int lda, const float* B, int ldb,
                                          int M, int N, int K,
                                          bool accumulate) {
  const int n4 = N / 4;
  for (int t = threadIdx.x; t < (M / 4) * n4; t += blockDim.x) {
    const int m0 = (t / n4) * 4;
    const int nc = t % n4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(m0 + i) * ldc + nc + j * n4] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_COL ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_COL ? B[(nc + j * n4) * ldb + k] : B[k * ldb + nc + j * n4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(m0 + i) * ldc + nc + j * n4] = acc[i][j];
  }
}

// C + p * stride ([M][N] f32, p < PARTS) = A[:, K_p] B[K_p, :], the
// product over the p-th of PARTS equal slices of K (layouts as in
// block_mma); the caller adds the parts.  A product with few output
// tiles and a long K thus keeps every thread busy.  K / PARTS is a
// multiple of 4; each thread takes 4x4 micro-tiles over one slice.
template <int PARTS, bool A_COL, bool B_COL>
__device__ __forceinline__ void block_mma_ksplit(float* C, int ldc,
                                                 int stride, const float* A,
                                                 int lda, const float* B,
                                                 int ldb, int M, int N,
                                                 int K) {
  const int n4 = N / 4, tiles = (M / 4) * n4, kp = K / PARTS;
  for (int u = threadIdx.x; u < tiles * PARTS; u += blockDim.x) {
    const int t = u % tiles, p = u / tiles;
    const int m0 = (t / n4) * 4, nc = t % n4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = p * kp; k < (p + 1) * kp; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_COL ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_COL ? B[(nc + j * n4) * ldb + k] : B[k * ldb + nc + j * n4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        C[p * stride + (m0 + i) * ldc + nc + j * n4] = acc[i][j];
  }
}

// loads a thread keeps in flight before it stores any of them: a copy
// into shared memory is bound by the latency of its global loads
constexpr int kInFlight = 8;

// rows [r0, r0 + rows) of src [n_rows][d] into dst [rows][ld] (shared),
// zero past n_rows; 16-byte vectors (d * sizeof(T) % 16 == 0, src rows
// 16-byte aligned)
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int r0, int rows, int n_rows,
                                          int d) {
  const int vpr = d * static_cast<int>(sizeof(T)) / 16;  // vectors per row
  const int total = rows * vpr;
  for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
    uint4 val[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * blockDim.x;
      const int r = i / vpr;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r0 + r < n_rows)
        val[u] = reinterpret_cast<const uint4*>(
            src + static_cast<long>(r0 + r) * d)[i % vpr];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total)
        reinterpret_cast<uint4*>(dst + (i / vpr) * ld)[i % vpr] = val[u];
    }
  }
}

// rows [r0, r0 + rows) of x [n_rows][d] into dst [rows][ld] (shared) as
// y = (x * rstd[row] * scale) rounded to T (the RMSNorm with its saved
// statistics); zero past n_rows.  16-byte vectors, as copy_rows.
template <typename T>
__device__ __forceinline__ void norm_rows(T* dst, int ld, const T* x,
                                          const float* rstd, const T* scale,
                                          int r0, int rows, int n_rows,
                                          int d) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int vpr = d / E;
  const int total = rows * vpr;
  for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
    uint4 val[kInFlight];
    float rs[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * blockDim.x;
      const int n = r0 + i / vpr;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      rs[u] = 0.f;
      if (i < total && n < n_rows) {
        val[u] = reinterpret_cast<const uint4*>(
            x + static_cast<long>(n) * d)[i % vpr];
        rs[u] = rstd[n];
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        float f[E], s[E];
        unpack16(val[u], f);
        unpack16(reinterpret_cast<const uint4*>(scale)[i % vpr], s);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = f[e] * rs[u] * s[e];
        reinterpret_cast<uint4*>(dst + (i / vpr) * ld)[i % vpr] = pack16(f);
      }
    }
  }
}

// (internal linkage: every source that includes this header gets its own
// copy of the kernel, so no two objects register one symbol)
namespace {

// out[c] = sum over p < n_parts of parts[p][c], in order of p (one
// thread per column): the second pass of a deterministic cross-block sum
template <typename OutT>
__global__ void column_sum_kernel(const float* __restrict__ parts,
                                  OutT* __restrict__ out, int n_parts,
                                  long n_cols) {
  const long c = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += parts[p * n_cols + c];
  out[c] = from_f32<OutT>(s);
}

template <typename OutT>
int launch_column_sum(const float* parts, OutT* out, int n_parts,
                      long n_cols, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = static_cast<int>((n_cols + threads - 1) / threads);
  column_sum_kernel<OutT><<<blocks, threads, 0, stream>>>(parts, out, n_parts,
                                                          n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace rtt
