// RMSNorm backward.
//
// Replaces: ray_tpu/ops/rmsnorm.py:_bwd_kernel (via _rmsnorm_bwd, the
// backward of rmsnorm's custom VJP).
//
// Given the forward's x [N, D], scale [D], rstd [N] (f32) and the
// cotangent dy [N, D] (bf16 or f32, one dtype; D in 64, 768, 1024, 1280),
// per row
// (rmsnorm.py:56-65), in f32:
//   xhat  = x * rstd,  dxhat = dy * scale
//   dx    = rstd * (dxhat - xhat * mean(dxhat * xhat))   (rounded to T)
//   dscale = sum over all N rows of dy * xhat           (cast to T once)
//
// The cross-row sum is the hard part.  The TPU kernel keeps dscale in VMEM
// across its sequential sweep of row blocks; Hopper blocks run in no
// order.  As in the epilogue backward (matmul_residual_norm_bwd.cu), each
// block of ROWS rows writes one f32 [D] partial, and a column sum adds the
// partials in block order and casts once: no atomics, and the same bits on
// every run.
//
// What bounds it on an H100: bytes, (3 N D sizeof(T) + 4 N) (x and dy
// read, dx written, rstd read) over the memory rate.  One warp per row as
// in the forward: a lane holds its D / 32 columns of x and dy in registers
// from 16-byte loads, and accumulates its columns' dscale partial in
// registers across the warp's rows; only the block's final partial goes
// through shared memory.  The partials (N / 128 rows of D f32) are 1/64
// of the bytes of x in bf16.
#include "tile_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 128;  // rows per block, one dscale partial each

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dsp, int N) {
  constexpr int VN = rtt::Vec16<T>::N;
  constexpr int NV = D / VN;           // 16-byte loads a row
  constexpr int NCH = (NV + 31) / 32;  // ... a lane, at most
  static_assert(D % VN == 0, "a row must split into whole loads");
  __shared__ float part[WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  // a lane's load j is live when it falls inside the row
  auto live = [&](int j) { return NV % 32 == 0 || lane + 32 * j < NV; };
  float s[NCH][VN], dsc[NCH][VN];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
#pragma unroll
    for (int e = 0; e < VN; ++e) s[j][e] = dsc[j][e] = 0.f;
    if (live(j)) rtt::unpack16(sr[lane + 32 * j], s[j]);
  }
  for (int r = warp; r < ROWS; r += WARPS) {
    const long n = static_cast<long>(blockIdx.x) * ROWS + r;
    if (n >= N) break;
    const uint4* xr = reinterpret_cast<const uint4*>(x + n * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + n * D);
    const float rs = rstd[n];
    float xh[NCH][VN], g[NCH][VN], dot = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (!live(j)) continue;
      rtt::unpack16(xr[lane + 32 * j], xh[j]);
      rtt::unpack16(gr[lane + 32 * j], g[j]);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        xh[j][e] *= rs;
        dot += g[j][e] * s[j][e] * xh[j][e];
        dsc[j][e] += g[j][e] * xh[j][e];
      }
    }
    const float mean = rtt::warp_sum(dot) / static_cast<float>(D);
    uint4* dr = reinterpret_cast<uint4*>(dx + n * D);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (!live(j)) continue;
#pragma unroll
      for (int e = 0; e < VN; ++e)
        g[j][e] = rs * (g[j][e] * s[j][e] - xh[j][e] * mean);
      dr[lane + 32 * j] = rtt::pack16(g[j]);
    }
  }
  // lane's element e of load j is column (lane + 32 j) * VN + e
#pragma unroll
  for (int j = 0; j < NCH; ++j)
    if (live(j))
#pragma unroll
      for (int e = 0; e < VN; ++e)
        part[warp][(lane + 32 * j) * VN + e] = dsc[j][e];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += part[w][c];
    dsp[static_cast<long>(blockIdx.x) * D + c] = t;
  }
}

template <typename T, int D>
int launch(const void* x, const void* scale, const void* rstd, const void* dy,
           void* dx, void* dscale, void* dsp, int N, cudaStream_t stream) {
  const int n_blk = (N + ROWS - 1) / ROWS;
  rmsnorm_bwd_kernel<T, D><<<n_blk, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const float*>(rstd), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(dsp), N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return rtt::launch_column_sum(static_cast<const float*>(dsp),
                                static_cast<T*>(dscale), n_blk, D, stream);
}

template <typename T>
int launch_width(const void* x, const void* scale, const void* rstd,
                 const void* dy, void* dx, void* dscale, void* dsp, int N,
                 int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(x, scale, rstd, dy, dx, dscale, dsp, N, st);
    case 768:
      return launch<T, 768>(x, scale, rstd, dy, dx, dscale, dsp, N, st);
    case 1024:
      return launch<T, 1024>(x, scale, rstd, dy, dx, dscale, dsp, N, st);
    case 1280:
      return launch<T, 1280>(x, scale, rstd, dy, dx, dscale, dsp, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dx [N, D] and dscale [D] in x's dtype, D in {64, 768, 1024, 1280}.
// Scratch: dsp, ceil(N / 128) x D f32.  x, scale, dy and dx 16-byte
// aligned.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* rstd,
                           const void* dy, void* dx, void* dscale, void* dsp,
                           int N, int D, int dtype, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return launch_width<__nv_bfloat16>(x, scale, rstd, dy, dx, dscale, dsp,
                                       N, D, st);
  if (dtype == rtt::kF32)
    return launch_width<float>(x, scale, rstd, dy, dx, dscale, dsp, N, D,
                               st);
  return static_cast<int>(cudaErrorInvalidValue);
}
