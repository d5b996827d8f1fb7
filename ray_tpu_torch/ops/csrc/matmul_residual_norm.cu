// Fused attention out-projection + residual add + RMSNorm (forward).
//
// Replaces: ray_tpu/ops/fused_norm.py:_fwd_kernel (via _run_fwd;
// public matmul_residual_norm).
//
// Computes, for a [N, K], w [K, d], resid [N, d], scale [d] (bf16 or
// f32, one dtype; d = 768, GPT-2's width, or 1024 or 1280):
//   p    = a @ w                       (f32 accumulation)
//   r    = resid + p.astype(dtype)     (the residual add in the storage
//                                       dtype, as fused_norm.py:153)
//   rstd = 1 / sqrt(mean(r^2) + eps)   (f32 statistics of the rounded r)
//   y    = (r * rstd * scale).astype(dtype)
// emitting r, y (storage dtype) and rstd [N] (f32, kept for
// matmul_residual_norm_bwd.cu).
//
// What bounds it on an H100: at the training shape (N = 24576, K = d =
// 768) the product is 2 N K d = 29.0 GFLOP (0.029 ms at 989 TFLOP/s)
// over (N K + K d + 3 N d) 2 + 4 N bytes = 152 MB (0.045 ms at 3.35
// TB/s): bound by bytes, at 191 flops a byte, under the bf16 ridge of
// ~295.  The norm needs whole rows, so a block owns full 768-wide rows
// and every block reads all of w: at 64 rows a block, 0.45 GB of L2
// reads over the grid, three times the device-memory bytes.
//
// Three designs, chosen by dtype and width:
// - bf16 at d = 768: mrn_tc_kernel (below), on the tensor cores through
//   wgmma, the norm taken on the accumulators.
// - bf16 at d = 1024 and 1280 (gpt2_medium, gpt2_large): a 64-row block
//   of f32 accumulators d wide no longer fits the register file, so the
//   product runs as flash_ce_tc.cuh's wgmma GEMM (128 x 128 tiles, TMA
//   ring) with bf16(p) stored into y, and a row pass (wide_fwd::
//   mrn_rows_kernel, one warp a row) then takes r, rstd and y with the
//   same rounding points: one more read and write of an [N, d] bf16.
// - f32: mrn_kernel, CUDA-core FMAs in full f32, so that it is held to
//   the plain version at summation-order bounds: one block of 16 rows,
//   the product in shared memory, one warp a row for the norm; any of
//   the three widths.
#include "common.cuh"
#include "flash_ce_tc.cuh"
#include "hopper.cuh"

namespace {

constexpr int WIDTH = 768;  // the output width d of the wgmma design

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BN = 16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// P[BN, d] (shared) = As[BN, K] (shared) @ w[K, d] (global)
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

__global__ void __launch_bounds__(THREADS)
    mrn_kernel(const float* __restrict__ a, const float* __restrict__ w,
               const float* __restrict__ resid,
               const float* __restrict__ scale, float* __restrict__ r_out,
               float* __restrict__ y_out, float* __restrict__ rstd_out, int N,
               int K, int d, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* P = As + BN * K;
  const int n0 = blockIdx.x * BN;
  const int rows = min(BN, N - n0);

  for (int i = threadIdx.x; i < BN * K; i += THREADS)
    As[i] = i / K < rows ? a[static_cast<long>(n0) * K + i] : 0.f;
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
      const float rr = resid[off + c] + pr[c];
      pr[c] = rr;
      r_out[off + c] = rr;
      ss += rr * rr;
    }
    ss = rtt::warp_sum(ss);
    const float rstd = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
    for (int c = lane; c < d; c += 32)
      y_out[off + c] = pr[c] * rstd * scale[c];
    if (lane == 0) rstd_out[n0 + r] = rstd;
  }
}

int launch_f32(const void* a, const void* w, const void* resid,
               const void* scale, void* r, void* y, void* rstd, int N, int K,
               int d, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BN * K + BN * d);
  cudaError_t err = cudaFuncSetAttribute(
      mrn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mrn_kernel<<<(N + BN - 1) / BN, THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(resid), static_cast<const float*>(scale),
      static_cast<float*>(r), static_cast<float*>(y),
      static_cast<float*>(rstd), N, K, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) with register-resident accumulators
// ---------------------------------------------------------------------------
//
// A block owns 64 rows and all 768 output columns, so the norm runs on
// the product where it is, in registers: four warpgroups, each holding
// a 64 x 192 slice as three m64n64 accumulators (96 f32 a thread, 128
// registers in all, the cap of a 512-thread block, with no spill).
//
// Per k step of 64, per warpgroup, 12 wgmma m64n64k16 from shared memory:
//   A  a[n0:n0+64, k0:k0+64], K-major, one 128-byte-swizzled tile;
//   B  w[k0:k0+64, c:c+64] for the warpgroup's three 64-column atoms,
//      each stored as it lies in w (rows k, n contiguous): MN-major, the
//      transpose bit set, one instruction per atom.
// Loads: TMA (cp.async.bulk.tensor) into a 2-stage ring, a stage being
// 13 boxes of 64 x 64 (8 KB of a, 96 KB of w) that the copy engine
// lands with the 128-byte swizzle wgmma reads, counted on the stage's
// mbarrier.  Thread 0 issues step kt + 1 while step kt's products run;
// the block barrier that ends a step frees its stage.  The rows of a
// past N arrive as zeros.  Feeding the same ring by cp.async from every
// thread took 0.1375 ms at N = 24576 (chip_smoke.py on an H100 at 700 W;
// this kernel's time is in PERF.md section 6), 42 us a block even at N =
// 1024, where 16 blocks leave L2 idle: the per-thread copies, not L2,
// limited it.  The last step's copy brings the block's resid rows into
// the free stage instead.
//
// Epilogue, on the accumulator fragment, rounding where fused_norm.py
// and the plain version do: r = bf16(resid + bf16(p)) written back over
// resid; the sum of squares of the rounded r in f32, over the 4 lanes of
// a row (shuffles), then over the four warpgroups through a [4][64]
// exchange; rstd = 1 / sqrt(ss / d + eps); y = bf16(r rstd scale) into
// the other stage.  The fragment reads and writes the swizzled 64 x 64
// boxes the copies use (8 rows of a warp fall on 8 distinct 16-byte
// slots: no bank conflict), and r and y leave by TMA stores, which skip
// the rows past N.
//
// At N = 24576 the grid is 384 blocks, ~2.9 waves at one block an SM
// (214 KB of shared memory); each block reads all of w from L2, 0.45 GB
// over the grid.  Small N (a serving prefill of 1024 rows: 16 blocks)
// leaves most SMs idle; splitting d across blocks for it is later work
// (ROADMAP Queue 1 item 8).

namespace tc_fwd {

namespace tc = rtt::tc;
using bf16 = __nv_bfloat16;

constexpr int WG = 4;                          // consumer warpgroups
constexpr int NT = 128 * WG;                   // threads
constexpr int AW = WIDTH / 64 / WG;            // w atoms of a warpgroup
constexpr int BM = 64;                         // rows of a block
constexpr int BK = 64;                         // k of a stage
constexpr int ATOM = 64 * 128;                 // [64][64] bf16, 128-byte rows
constexpr int NA = WIDTH / 64;                 // 64-column atoms of a row
constexpr int STAGE = (1 + NA) * ATOM;         // a tile + 12 w atoms
constexpr int BAR = 2 * STAGE;                 // 3 mbarriers: stages, resid
constexpr int SSQ = BAR + 64;                  // [WG][BM] f32 exchange
constexpr size_t SMEM = 1024 + SSQ + WG * BM * sizeof(float);

__global__ void __launch_bounds__(NT, 1)
    mrn_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_resid,
                  const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_y,
                  const bf16* __restrict__ scale,
                  float* __restrict__ rstd_out, int N, int K, float eps) {
  extern __shared__ uint8_t smem_tc[];
  uint8_t* smem =
      smem_tc + ((1024 - (tc::smem_addr(smem_tc) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(smem);
  const uint32_t bar = sbase + BAR;  // + 8 s: stage s; + 16: the resid rows
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * BM;
  const int nk = K / BK;

  // thread 0 copies: k step kt of a and w into stage kt % 2
  auto load_stage = [&](int kt) {
    const uint32_t st = sbase + (kt & 1) * STAGE, b = bar + 8 * (kt & 1);
    tc::mbar_expect_tx(b, STAGE);
    tc::tma_load_2d(st, &tm_a, kt * BK, n0, b);
#pragma unroll 1
    for (int j = 0; j < NA; ++j)
      tc::tma_load_2d(st + (1 + j) * ATOM, &tm_w, 64 * j, kt * BK, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tc::mbar_init(bar + 8 * i, 1);
    tc::fence_mbar_init();
    load_stage(0);
  }
  __syncthreads();

  float acc[AW][32];
#pragma unroll
  for (int j = 0; j < AW; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (tid == 0) {
      if (kt + 1 < nk) {
        load_stage(kt + 1);
      } else {  // the block's resid rows into the free stage
        const uint32_t st = sbase + ((kt + 1) & 1) * STAGE;
        tc::mbar_expect_tx(bar + 16, NA * ATOM);
#pragma unroll 1
        for (int j = 0; j < NA; ++j)
          tc::tma_load_2d(st + j * ATOM, &tm_resid, 64 * j, n0, bar + 16);
      }
    }
    tc::mbar_wait(bar + 8 * (kt & 1), (kt >> 1) & 1);
    const uint32_t st = sbase + (kt & 1) * STAGE;
    const uint64_t desc_a = tc::desc_sw128(st);
    const uint64_t desc_w = tc::desc_sw128(st + (1 + AW * wg) * ATOM);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < AW; ++j)  // +32 bytes along a's rows, +16 w rows
        tc::wgmma_ss_m64n64k16_tb(acc[j], desc_a + 2 * kk,
                                  desc_w + j * (ATOM >> 4) + 128 * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < AW; ++j) tc::fence_regs(acc[j]);
    __syncthreads();  // stage kt % 2 is free for step kt + 2
  }
  tc::mbar_wait(bar + 16, 0);

  // epilogue: this thread's rows row0 + {0, 8}, columns 64 (AW wg + j) +
  // 8 t + 2 (lane % 4) + {0, 1} (the wgmma accumulator layout), read and
  // written in the swizzled 64 x 64 atoms the tensor maps copy
  uint8_t* rt = smem + (nk & 1) * STAGE;        // resid, then r
  uint8_t* yt = smem + ((nk - 1) & 1) * STAGE;  // y
  float* ssq = reinterpret_cast<float*>(smem + SSQ);
  const int row0 = 16 * warp + (lane >> 2);
  auto at = [&](int i, int j, int t) {  // byte offset in an atom stack
    const int r = row0 + 8 * i;
    return (AW * wg + j) * ATOM + tc::swz128(r, t) + 4 * (lane & 3);
  };
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < AW; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * t + 2 * i;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(rt + at(i, j, t));
        const float2 res = __bfloat1622float2(*q);
        const float2 p = __bfloat1622float2(
            __floats2bfloat162_rn(acc[j][x], acc[j][x + 1]));
        const __nv_bfloat162 r = __floats2bfloat162_rn(res.x + p.x,
                                                       res.y + p.y);
        *q = r;
        const float2 rf = __bfloat1622float2(r);
        acc[j][x] = rf.x;
        acc[j][x + 1] = rf.y;
        ss[i] += rf.x * rf.x + rf.y * rf.y;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
    if ((lane & 3) == 0) ssq[wg * BM + row0 + 8 * i] = ss[i];
  }
  __syncthreads();
  float rstd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    float tot = 0.f;
#pragma unroll
    for (int g = 0; g < WG; ++g) tot += ssq[g * BM + r];
    rstd[i] = 1.f / sqrtf(tot / static_cast<float>(WIDTH) + eps);
    if (wg == 0 && (lane & 3) == 0 && n0 + r < N) rstd_out[n0 + r] = rstd[i];
  }
#pragma unroll
  for (int j = 0; j < AW; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = 64 * (AW * wg + j) + 8 * t + 2 * (lane & 3);
      const float2 sc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(scale + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * t + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(yt + at(i, j, t)) =
            __floats2bfloat162_rn(acc[j][x] * rstd[i] * sc.x,
                                  acc[j][x + 1] * rstd[i] * sc.y);
      }
    }
  // r and y leave by TMA, which skips the rows past N
  tc::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    const uint32_t rs = tc::smem_addr(rt), ys = tc::smem_addr(yt);
#pragma unroll 1
    for (int j = 0; j < NA; ++j) {
      tc::tma_store_2d(&tm_r, rs + j * ATOM, 64 * j, n0);
      tc::tma_store_2d(&tm_y, ys + j * ATOM, 64 * j, n0);
    }
    tc::tma_store_commit();
    tc::tma_store_wait_read();
  }
}

int launch(const void* a, const void* w, const void* resid,
           const void* scale, void* r, void* y, void* rstd, int N, int K,
           float eps, cudaStream_t stream) {
  CUtensorMap tm[5];
  if (!tc::tmap_bf16_64x64(&tm[0], a, K, N, 2L * K) ||
      !tc::tmap_bf16_64x64(&tm[1], w, WIDTH, K, 2L * WIDTH) ||
      !tc::tmap_bf16_64x64(&tm[2], resid, WIDTH, N, 2L * WIDTH) ||
      !tc::tmap_bf16_64x64(&tm[3], r, WIDTH, N, 2L * WIDTH) ||
      !tc::tmap_bf16_64x64(&tm[4], y, WIDTH, N, 2L * WIDTH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mrn_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  mrn_tc_kernel<<<(N + BM - 1) / BM, NT, SMEM, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], static_cast<const bf16*>(scale),
      static_cast<float*>(rstd), N, K, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_fwd

// ---------------------------------------------------------------------------
// bf16 at d = 1024, 1280: the wgmma GEMM, then a row pass
// ---------------------------------------------------------------------------

namespace wide_fwd {

using bf16 = __nv_bfloat16;

// one warp a row: p = y (the GEMM's bf16 product), r = bf16(resid + p)
// to r, rstd of the rounded r, y = bf16(r rstd scale) over p
__global__ void __launch_bounds__(256)
    mrn_rows_kernel(const bf16* __restrict__ resid,
                    const bf16* __restrict__ scale, bf16* __restrict__ r,
                    bf16* __restrict__ y, float* __restrict__ rstd, int N,
                    int d, float eps) {
  constexpr int MAXC = tc_ce::MAX_CHUNKS;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (n >= N) return;
  const int nch = d / 8;
  const long off = static_cast<long>(n) * d;
  const uint4* pr = reinterpret_cast<const uint4*>(y + off);
  const uint4* qr = reinterpret_cast<const uint4*>(resid + off);
  uint4* rr = reinterpret_cast<uint4*>(r + off);
  uint4 rv[MAXC];
  float ss = 0.f;
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    const int c = lane + 32 * m;
    if (c < nch) {
      float p[8], q[8];
      rtt::unpack16(pr[c], p);
      rtt::unpack16(qr[c], q);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] += p[e];
      rv[m] = rtt::pack16(q);
      rr[c] = rv[m];
      rtt::unpack16(rv[m], q);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += q[e] * q[e];
    }
  }
  ss = rtt::warp_sum(ss);
  const float rs = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
  if (lane == 0) rstd[n] = rs;
  uint4* yr = reinterpret_cast<uint4*>(y + off);
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    const int c = lane + 32 * m;
    if (c < nch) {
      float f[8], sc[8];
      rtt::unpack16(rv[m], f);
      rtt::unpack16(reinterpret_cast<const uint4*>(scale)[c], sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] * rs * sc[e];
      yr[c] = rtt::pack16(f);
    }
  }
}

int launch(const void* a, const void* w, const void* resid,
           const void* scale, void* r, void* y, void* rstd, int N, int K,
           int d, float eps, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!tc_ce::tmap(&ta, a, K, N, K) || !tc_ce::tmap(&tb, w, d, K, d))
    return static_cast<int>(cudaErrorInvalidValue);
  // p = a w, rounded to bf16, into y: kDx's layouts (A K-major, B = w as
  // it lies, MN-major)
  tc_ce::Epi ep{};
  ep.M = N;
  ep.tiles_m = (N + tc_ce::BM - 1) / tc_ce::BM;
  ep.tiles_n = d / tc_ce::BN;
  ep.steps = K / tc_ce::BK;
  ep.o16 = static_cast<bf16*>(y);
  ep.ld = d;
  ep.mode = tc_ce::kBF16;
  int rc = tc_ce::launch_gemm<tc_ce::kDx, tc_ce::kStore>(ta, tb, ta, ep,
                                                         stream);
  if (rc) return rc;
  mrn_rows_kernel<<<(N + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(resid), static_cast<const bf16*>(scale),
      static_cast<bf16*>(r), static_cast<bf16*>(y), static_cast<float*>(rstd),
      N, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide_fwd

}  // namespace

// bf16 runs on the tensor cores and takes K a multiple of 64; f32 on the
// CUDA cores, K a multiple of 16; both K <= 1536 and d in {768, 1024,
// 1280}.  The bf16 kernels copy by TMA: a, w, resid, r and y 16-byte
// aligned, scale 4-byte aligned (16-byte at d = 1024, 1280).
extern "C" int matmul_residual_norm_fwd(const void* a, const void* w,
                                        const void* resid, const void* scale,
                                        void* r, void* y, void* rstd, int N,
                                        int K, int d, float eps, int dtype,
                                        void* stream) {
  if (N <= 0) return 0;
  if (K <= 0 || K > 1536 || (d != WIDTH && d != 1024 && d != 1280))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && K % tc_fwd::BK == 0 && d == WIDTH)
    return tc_fwd::launch(a, w, resid, scale, r, y, rstd, N, K, eps, st);
  if (dtype == rtt::kBF16 && K % tc_fwd::BK == 0)
    return wide_fwd::launch(a, w, resid, scale, r, y, rstd, N, K, d, eps, st);
  if (dtype == rtt::kF32 && K % 16 == 0)
    return launch_f32(a, w, resid, scale, r, y, rstd, N, K, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
