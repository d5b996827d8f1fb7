// One-tile checks of the wgmma variants with MN-major operands
// (hopper.cuh), for chip_smoke.py to hold against the plain product
// before it trusts the kernels built on them.
//
// C [64][64] (f32) = A B over k = 64, from row-major bf16 tiles of 64 x
// 64 loaded as they lie into one 128-byte-swizzled tile each:
// - variant 0, wgmma_ss_m64n64k16_tb: a is A [m][k] (K-major), b is
//   B [k][n] (MN-major), the forward epilogue's a and w;
// - variant 1, wgmma_ss_m64n64k16_tt: a is A^T [k][m] (MN-major), b is
//   B [k][n], the epilogue backward's a and dresid in dw = a^T dresid.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int VARIANT>
__global__ void __launch_bounds__(128)
    wgmma_tile_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                      float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rtt::tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sa = rtt::tc::smem_addr(smem), sb = sa + 64 * 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int p = tid; p < 64 * 8; p += 128) {
    const int r = p >> 3, ch = p & 7;
    rtt::tc::cp_async16(sa + rtt::tc::swz128(r, ch), a + r * 64 + 8 * ch,
                        true);
    rtt::tc::cp_async16(sb + rtt::tc::swz128(r, ch), b + r * 64 + 8 * ch,
                        true);
  }
  rtt::tc::cp_async_commit();
  rtt::tc::cp_async_wait<0>();
  rtt::tc::fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  const uint64_t da = rtt::tc::desc_sw128(sa), db = rtt::tc::desc_sw128(sb);
  rtt::tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (VARIANT == 0)
      rtt::tc::wgmma_ss_m64n64k16_tb(acc, da + 2 * kk, db + 128 * kk);
    else
      rtt::tc::wgmma_ss_m64n64k16_tt(acc, da + 128 * kk, db + 128 * kk);
  }
  rtt::tc::wgmma_commit();
  rtt::tc::wgmma_wait<0>();
  rtt::tc::fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[(16 * warp + (lane >> 2) + 8 * i) * 64 + 8 * j + 2 * (lane & 3) +
          e] = acc[4 * j + 2 * i + e];
}

}  // namespace

// a, b: 64 x 64 bf16, 16-byte aligned; c: 64 x 64 f32
extern "C" int wgmma_tile_check(const void* a, const void* b, void* c,
                                int variant, void* stream) {
  auto* kernel = variant == 0   ? wgmma_tile_kernel<0>
                 : variant == 1 ? wgmma_tile_kernel<1>
                                : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<1, 128, 1024 + 2 * 64 * 128, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
