// Helpers shared by the port's kernels: the storage types they take
// (f32 and bf16), conversions to and from the f32 they compute in, and
// the masking constant of the online softmax.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rtt {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

// finite, as in the JAX kernels: -inf would turn fully masked rows
// into NaN through exp/max arithmetic
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded through the storage type T (a no-op for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 16 bytes of T unpacked to f32: 4 floats or 8 bf16 values
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Element c of one (position, head) row of q or k, as the attention
// kernels load it.  With ROPE it is rotated as attention.py:_rot does:
// x * cos2 + roll(x, D/2) * sinm in f32 (no fused multiply-add, so the
// rounding is the reference's), then rounded to the storage type T;
// cos2 and sinm are the [S, D] tables and pos the row's position.
template <typename T, int D, bool ROPE>
__device__ __forceinline__ float load_rot(const T* row, const T* cos2,
                                          const T* sinm, int pos, int c) {
  const float x = to_f32(row[c]);
  if constexpr (!ROPE) {
    return x;
  } else {
    const float xp = to_f32(row[(c + D / 2) % D]);
    const long t = static_cast<long>(pos) * D + c;
    return round_to<T>(__fadd_rn(__fmul_rn(x, to_f32(cos2[t])),
                                 __fmul_rn(xp, to_f32(sinm[t]))));
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace rtt
