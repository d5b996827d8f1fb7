// RMSNorm forward.
//
// Replaces: ray_tpu/ops/rmsnorm.py:_fwd_kernel (via _run_fwd, the forward
// of rmsnorm's custom VJP).
//
// Computes, for x [N, D] and scale [D] (bf16 or f32, one dtype; D is one
// of the model widths instantiated below: 64, 768, 1024, 1280), per row:
//   rstd = rsqrt(mean(x^2) + eps)        (f32, written as a plain [N])
//   y    = (x * rstd) * scale            (f32, rounded to x's dtype once)
// The TPU kernel writes rstd broadcast over 128 lanes ([N, 128]), a VMEM
// tile layout with no meaning here.
//
// What bounds it on an H100: bytes.  Each row costs 3 flops per element
// against 2 * sizeof(T) bytes (x read, y written), far below the ridge;
// the least time is (2 N D sizeof(T) + 4 N) bytes over the memory rate.
//
// What the design does about it: one warp per row, each row read once
// into registers.  A lane holds D / 32 elements in 16-byte loads (at D =
// 768, 3 in bf16 and 6 in f32; at D = 64 in bf16 only lanes 0-7 hold
// one), neighbouring lanes on neighbouring 16 bytes, so
// every load and store is coalesced; the sum of squares reduces across
// the warp by shuffles and nothing goes through shared memory.  The scale
// row is read by every warp and stays in L1/L2.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       T* __restrict__ y, float* __restrict__ rstd, int N,
                       float eps) {
  constexpr int VN = rtt::Vec16<T>::N;   // elements per 16-byte load
  constexpr int NV = D / VN;             // 16-byte loads a row
  constexpr int NCH = (NV + 31) / 32;    // ... a lane, at most
  static_assert(D % VN == 0, "a row must split into whole loads");
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  float v[NCH][VN];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (NV % 32 != 0 && lane + 32 * j >= NV) continue;
    rtt::unpack16(xr[lane + 32 * j], v[j]);
#pragma unroll
    for (int e = 0; e < VN; ++e) ss += v[j][e] * v[j][e];
  }
  const float r = rsqrtf(rtt::warp_sum(ss) / static_cast<float>(D) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (NV % 32 != 0 && lane + 32 * j >= NV) continue;
    float s[VN];
    rtt::unpack16(sr[lane + 32 * j], s);
#pragma unroll
    for (int e = 0; e < VN; ++e) v[j][e] = v[j][e] * r * s[e];
    yr[lane + 32 * j] = rtt::pack16(v[j]);
  }
  if (lane == 0) rstd[row] = r;
}

template <typename T, int D>
int launch(const void* x, const void* scale, void* y, void* rstd, int N,
           float eps, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T, D><<<(N + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), static_cast<float*>(rstd), N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* x, const void* scale, void* y, void* rstd,
                 int N, int D, float eps, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(x, scale, y, rstd, N, eps, stream);
    case 768: return launch<T, 768>(x, scale, y, rstd, N, eps, stream);
    case 1024: return launch<T, 1024>(x, scale, y, rstd, N, eps, stream);
    case 1280: return launch<T, 1280>(x, scale, y, rstd, N, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y [N, D] in x's dtype, rstd [N] f32, D in {64, 768, 1024, 1280}.  x,
// scale and y 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           void* rstd, int N, int D, float eps, int dtype,
                           void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return launch_width<__nv_bfloat16>(x, scale, y, rstd, N, D, eps, st);
  if (dtype == rtt::kF32)
    return launch_width<float>(x, scale, y, rstd, N, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
