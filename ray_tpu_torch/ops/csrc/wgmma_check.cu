// One-tile checks of the wgmma variants that the kernels built on them
// trust (hopper.cuh), for chip_smoke.py to hold against the plain
// product first.
//
// C (f32) = a product over k = 64 of row-major bf16 tiles, each loaded
// as it lies into 128-byte-swizzled shared memory:
// - variant 0, wgmma_ss_m64n64k16_tb: a is A [64 m][64 k] (K-major), b
//   is B [64 k][64 n] (MN-major), C [64][64] = A B: the epilogue
//   forward's a and w;
// - variant 1, wgmma_ss_m64n64k16_tt: a is A^T [k][m], b is B [k][n]
//   (both MN-major), C = A B: the epilogue backward's dw = a^T dresid;
// - variant 2, wgmma_ss_m64n128k16: a is A [64 m][64 k], b is Bt [128
//   n][64 k] (both K-major), C [64][128] = A Bt^T: flash-CE's logits y
//   w^T;
// - variant 3, wgmma_ss_m64n128k16_tb: a is A [m][k], b is B [64 k][128
//   n] (MN-major, two atoms), C [64][128] = A B: flash-CE's dx = dl w;
// - variant 4, wgmma_ss_m64n128k16_tt: a is A^T [k][m], b is B [k][128
//   n], C [64][128] = A B: flash-CE's dw = dl^T y.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace tc = rtt::tc;

template <int VARIANT>
__global__ void __launch_bounds__(128)
    wgmma_tile_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                      float* __restrict__ c) {
  constexpr int NW = VARIANT < 2 ? 64 : 128;  // columns of C
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sa = tc::smem_addr(smem), sb = sa + 64 * 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int p = tid; p < 64 * 8; p += 128) {
    const int r = p >> 3, ch = p & 7;
    tc::cp_async16(sa + tc::swz128(r, ch), a + r * 64 + 8 * ch, true);
  }
  // b: 64 rows of NW columns (variants 0, 1, 3, 4; atoms of 64 columns
  // 8 KB apart) or 128 rows of 64 (variant 2, one 128-row K-major tile)
  for (int p = tid; p < 64 * NW / 8; p += 128) {
    if constexpr (VARIANT == 2) {
      const int r = p >> 3, ch = p & 7;
      tc::cp_async16(sb + tc::swz128(r, ch), b + r * 64 + 8 * ch, true);
    } else {
      const int r = p / (NW / 8), ch = p % (NW / 8);
      tc::cp_async16(sb + (ch >> 3) * 8192 + tc::swz128(r, ch & 7),
                     b + r * NW + 8 * ch, true);
    }
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();
  float acc[NW / 2];
#pragma unroll
  for (int x = 0; x < NW / 2; ++x) acc[x] = 0.f;
  const uint64_t da = tc::desc_sw128(sa), db = tc::desc_sw128(sb);
  const uint64_t db_mn = tc::desc_sw128_mn(sb, 8192);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (VARIANT == 0)
      tc::wgmma_ss_m64n64k16_tb(
          *reinterpret_cast<float(*)[32]>(acc), da + 2 * kk, db + 128 * kk);
    else if constexpr (VARIANT == 1)
      tc::wgmma_ss_m64n64k16_tt(
          *reinterpret_cast<float(*)[32]>(acc), da + 128 * kk, db + 128 * kk);
    else if constexpr (VARIANT == 2)
      tc::wgmma_ss_m64n128k16(*reinterpret_cast<float(*)[64]>(acc),
                              da + 2 * kk, db + 2 * kk);
    else if constexpr (VARIANT == 3)
      tc::wgmma_ss_m64n128k16_tb(*reinterpret_cast<float(*)[64]>(acc),
                                 da + 2 * kk, db_mn + 128 * kk);
    else
      tc::wgmma_ss_m64n128k16_tt(*reinterpret_cast<float(*)[64]>(acc),
                                 da + 128 * kk, db_mn + 128 * kk);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[(16 * warp + (lane >> 2) + 8 * i) * NW + 8 * j + 2 * (lane & 3) +
          e] = acc[4 * j + 2 * i + e];
}

}  // namespace

// a: 64 x 64 bf16; b: 64 x 64 (variants 0, 1), 128 x 64 (variant 2) or
// 64 x 128 bf16 (variants 3, 4); 16-byte aligned; c: 64 x 64 or 64 x 128
// f32
extern "C" int wgmma_tile_check(const void* a, const void* b, void* c,
                                int variant, void* stream) {
  auto* kernel = variant == 0   ? wgmma_tile_kernel<0>
                 : variant == 1 ? wgmma_tile_kernel<1>
                 : variant == 2 ? wgmma_tile_kernel<2>
                 : variant == 3 ? wgmma_tile_kernel<3>
                 : variant == 4 ? wgmma_tile_kernel<4>
                                : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<1, 128, 1024 + 3 * 64 * 128, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
