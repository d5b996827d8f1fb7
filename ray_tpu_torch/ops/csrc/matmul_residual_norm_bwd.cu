// Fused out-proj + residual + RMSNorm, backward.
//
// Replaces: ray_tpu/ops/fused_norm.py:_bwd_kernel (via _mrn_bwd, the
// custom VJP of matmul_residual_norm).
//
// Given the forward's a [N, K], w [K, d], rout [N, d], scale [d], rstd [N]
// (f32) and the cotangents drout, dy [N, d] (bf16 or f32, one dtype;
// d = 768, 1024 or 1280), per row (fused_norm.py:162-183):
//   xhat   = rout * rstd,  dxhat = dy * scale
//   dr     = rstd * (dxhat - xhat * mean(dxhat * xhat)) + drout   (f32)
//   dresid = dr rounded to the storage dtype (= the dp that both products
//            contract against, fused_norm.py:177)
//   dscale = sum over rows of dy * xhat   (f32)
//   da     = dresid @ w^T                 (f32 accumulation)
//   dw     = a^T @ dresid                 (f32 accumulation, cast once)
//
// Cross-block reductions, deterministic (no atomics): dscale is a sum over
// all N rows, so each 64-row block writes one [d] partial and a column sum
// adds them in block order; dw is a sum over N as well, so its product is
// split along N into kSplits slices, each written as an f32 [K, d]
// partial, and a column sum adds the slices in order and casts once (the
// reference sums bf16 per-row-block partials in f32).  Two calls on the
// same inputs give the same bits.
//
// What bounds it on an H100: at the training shape (N = 24576, K = d =
// 768) the two products are 4 N K d = 58 GFLOP (0.059 ms at 989 TFLOP/s)
// over (2 N K + 2 K d + 4 N d + 2 d) 2 + 4 N + 4 d bytes = 229 MB (0.068
// ms at 3.35 TB/s): bytes by a little, near the ridge.  As in the forward, the
// operand a block re-reads from L2 (w for da; a and dresid for dw) is
// the traffic that limits it.
//
// Three designs, chosen by dtype and width:
// - bf16 at d = 768 (tc_bwd below): two wgmma kernels.  mrn_bwd_da_kernel fuses the
//   row pass into the da product: a block computes dr for its 64 rows,
//   writes dresid, and keeps the same bf16 dr in shared memory as the A
//   operand of da = dr w^T, so dresid is never read back.
//   mrn_bwd_dw_kernel takes dw = a^T dresid on 128 x 128 output tiles
//   with both operands MN-major (as they lie in a and dresid).
// - bf16 at d = 1024 and 1280 (wide_bwd below): the row pass alone, then
//   flash_ce_tc.cuh's wgmma GEMM for da and for the dw slices.
// - f32, any of the three widths: the first port's kernels, CUDA-core FMAs in full f32 so that it
//   is held to the plain version at summation-order bounds:
//   mrn_bwd_rows_kernel, then gemm_kernel (rtt::block_mma's f32 loop)
//   for da and for the dw slices.
#include "flash_ce_tc.cuh"
#include "hopper.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 768;          // d of the fused wgmma design
constexpr int ROWS = 64;            // rows per block of the row pass
constexpr int kSplits = 7;          // slices of N in the dw product

// the row pass: dresid and the per-block dscale partials, d = W
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    mrn_bwd_rows_kernel(const T* __restrict__ rout,
                        const T* __restrict__ scale,
                        const float* __restrict__ rstd,
                        const T* __restrict__ drout,
                        const T* __restrict__ dy, T* __restrict__ dresid,
                        float* __restrict__ dsp, int N) {
  constexpr int CPL = W / 32;   // columns per lane
  __shared__ float part[WARPS][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dsc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) dsc[j] = 0.f;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int n = blockIdx.x * ROWS + r;
    if (n >= N) break;
    const long off = static_cast<long>(n) * W;
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
    const float mean = rtt::warp_sum(dot) / static_cast<float>(W);
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
  for (int c = threadIdx.x; c < W; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += part[wp][c];
    dsp[static_cast<long>(blockIdx.x) * W + c] = s;
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

template <int D>
int launch_f32(const void* a, const void* w, const void* rout,
               const void* scale, const void* rstd, const void* drout,
               const void* dy, void* da, void* dw, void* dresid, void* dscale,
               void* dsp, void* dwp, int N, int K, cudaStream_t stream) {
  using T = float;
  const int d = D;
  const int n_blk = (N + ROWS - 1) / ROWS;
  mrn_bwd_rows_kernel<T, D><<<n_blk, THREADS, 0, stream>>>(
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

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) with register-resident accumulators
// ---------------------------------------------------------------------------
//
// mrn_bwd_da_kernel: a block owns 64 rows, three warpgroups.
// - Prologue, the row pass: 12 warps over the 64 rows, 16-byte loads of
//   rout, dy, drout and scale, each lane 24 columns, a warp's next row
//   fetched while it computes the current one.  dr in f32; dresid =
//   bf16(dr) to device memory and the same bf16 dr into shared memory as
//   the K-major A operand of da (64 x 768 bf16: 12 swizzled 64-column
//   atoms, 96 KB).  The block's dscale partial, over its real rows only,
//   is summed over the warps in a fixed order through an exchange in the
//   second w stage, before that stage is first loaded.
// - Main loop: da = dr w^T.  The K output columns run in chunks of 384
//   (3 warpgroups x 128, two m64n64 accumulators each); each chunk walks
//   d in 12 steps of 64 with A = dr's atom of the step and B = w[j0:j0+
//   384, c0:c0+64], K-major (rows j, d contiguous), in 6 TMA boxes of 64
//   x 64 through a 2-stage ring (48 KB a stage, rows past K arriving as
//   zeros).  Chunks of 768 would need 96 KB stages, two of which do not
//   fit beside dr; the w bytes read per block are the same either way.
//   A warpgroup whose 128 columns lie past K multiplies zeros (a branch
//   around its wgmma would serialize them) and stores nothing.
// - A chunk's da leaves through the stage its last step freed: the
//   fragment's 4-byte writes into swizzled 64 x 64 boxes (no bank
//   conflict), then TMA stores, which skip rows past N and columns past
//   K.
//
// mrn_bwd_dw_kernel: dw = a^T dresid over 128 x 128 output tiles (two
// warpgroups, each 64 k-rows x 128 columns); blockIdx.z is a slice of N.
// Per step of 64 rows n: A = a[n:n+64, k0:k0+128] as two boxes of rows n
// (MN-major: m = k contiguous), B = dresid[n:n+64, c0:c0+128] likewise
// (MN-major), both transpose bits set; a 3-stage TMA ring of 32 KB
// stages, so two blocks share an SM.  At K = d = 768 the 36 tiles times
// kSplits = 7 slices make 252 blocks, all resident on 132 SMs at once;
// 4 slices at one block an SM (144 blocks: a second wave of 12) took
// twice as long (PERF.md section 6).  Rows past N arrive as zeros, so they add nothing (and a NaN
// past N never enters the sum); a slice is whole 64-row steps, so no
// step reaches into the next.  The f32 tile goes straight from the
// fragment to the slice's partial (8-byte stores, every 32-byte sector
// written whole).
//
// Both kernels' copies are issued by thread 0 and counted on one
// mbarrier a stage; feeding them by cp.async from every thread took
// 0.3160 ms for the whole backward at N = 24576 (chip_smoke.py on an
// H100 at 700 W; the TMA kernels' time is in PERF.md section 6).

namespace tc_bwd {

namespace tc = rtt::tc;
using bf16 = __nv_bfloat16;

constexpr int ATOM = 64 * 128;          // [64][64] bf16, 128-byte rows
constexpr int CPR = WIDTH / 8;          // 16-byte chunks of a d-row

// the da kernel
constexpr int WG = 3;
constexpr int NT = 128 * WG;
constexpr int BM = 64;                  // rows of a block
constexpr int CH = 128 * WG;            // output columns of a chunk
constexpr int STEPS = WIDTH / 64;       // d steps of a chunk
constexpr int DR_BYTES = STEPS * ATOM;  // dr, 12 atoms
constexpr int STAGE = CH / 64 * ATOM;   // w[j0:j0+CH, c0:c0+64]
constexpr int DA_BAR = DR_BYTES + 2 * STAGE;  // 2 mbarriers: the stages
constexpr size_t SMEM = 1024 + DA_BAR + 16;
static_assert((NT / 32) * WIDTH * 4 <= STAGE, "dscale exchange fits");

__global__ void __launch_bounds__(NT, 1)
    mrn_bwd_da_kernel(const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_da,
                      const bf16* __restrict__ rout,
                      const bf16* __restrict__ scale,
                      const float* __restrict__ rstd,
                      const bf16* __restrict__ drout,
                      const bf16* __restrict__ dy,
                      bf16* __restrict__ dresid, float* __restrict__ dsp,
                      int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(smem);
  const uint32_t sring = sbase + DR_BYTES;
  const uint32_t bar = sbase + DA_BAR;  // + 8 s: stage s
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wid = tid >> 5;  // warp of the block, for the row pass
  const int n0 = blockIdx.x * BM;
  const int n_it = (K + CH - 1) / CH * STEPS;

  // thread 0 copies: iteration it is chunk it / STEPS (output columns
  // j0..j0+CH) and d step it % STEPS, w[j0:j0+CH, c0:c0+64] as 6 atoms;
  // rows past K arrive as zeros
  auto load_w = [&](int it) {
    const uint32_t st = sring + (it & 1) * STAGE, b = bar + 8 * (it & 1);
    const int j0 = it / STEPS * CH, c0 = it % STEPS * 64;
    tc::mbar_expect_tx(b, STAGE);
#pragma unroll 1
    for (int a = 0; a < CH / 64; ++a)
      tc::tma_load_2d(st + a * ATOM, &tm_w, c0, j0 + 64 * a, b);
  };
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::mbar_init(bar + 8, 1);
    tc::fence_mbar_init();
    load_w(0);
  }

  // the row pass; lane holds columns 8 (lane + 32 m) + e
  {
    float sc[3][8], dsc[3][8];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      rtt::unpack16(
          reinterpret_cast<const uint4*>(scale)[lane + 32 * m], sc[m]);
#pragma unroll
      for (int e = 0; e < 8; ++e) dsc[m][e] = 0.f;
    }
    // a row's inputs as they arrive (16-byte chunks lane + 32 m of rout,
    // dy and drout, and its rstd); the warp's next row is fetched while
    // this one is computed, so each row's loads are not waited out alone
    struct Row {
      uint4 r[3], g[3], d[3];
      float rs;
    };
    auto fetch = [&](Row& x, int r) {
      const int n = n0 + r;
      if (r >= BM || n >= N) return;
      const long q = static_cast<long>(n) * CPR + lane;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        x.r[m] = reinterpret_cast<const uint4*>(rout)[q + 32 * m];
        x.g[m] = reinterpret_cast<const uint4*>(dy)[q + 32 * m];
        x.d[m] = reinterpret_cast<const uint4*>(drout)[q + 32 * m];
      }
      x.rs = rstd[n];
    };
    Row cur{}, nxt{};
    fetch(cur, wid);
    for (int r = wid; r < BM; r += NT / 32) {
      fetch(nxt, r + NT / 32);
      const int n = n0 + r;
      uint4 out[3] = {};
      if (n < N) {
        const float rs = cur.rs;
        float dot = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          float x[8], g[8];
          rtt::unpack16(cur.r[m], x);
          rtt::unpack16(cur.g[m], g);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xh = x[e] * rs;
            dot += g[e] * sc[m][e] * xh;
            dsc[m][e] += g[e] * xh;
          }
        }
        const float mean = rtt::warp_sum(dot) / static_cast<float>(WIDTH);
        const long q = static_cast<long>(n) * CPR + lane;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          float x[8], g[8], dr[8];
          rtt::unpack16(cur.r[m], x);
          rtt::unpack16(cur.g[m], g);
          rtt::unpack16(cur.d[m], dr);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dr[e] += rs * (g[e] * sc[m][e] - x[e] * rs * mean);
          out[m] = rtt::pack16(dr);
          reinterpret_cast<uint4*>(dresid)[q + 32 * m] = out[m];
        }
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int q = lane + 32 * m;  // 16-byte chunk of the row
        *reinterpret_cast<uint4*>(smem + (q >> 3) * ATOM +
                                  tc::swz128(r, q & 7)) = out[m];
      }
      cur = nxt;
    }
    // this block's dscale partial: the warps' sums added in warp order
    float* xchg = reinterpret_cast<float*>(smem + DR_BYTES + STAGE);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float4* dst = reinterpret_cast<float4*>(
          xchg + wid * WIDTH + 8 * (lane + 32 * m));
      dst[0] = make_float4(dsc[m][0], dsc[m][1], dsc[m][2], dsc[m][3]);
      dst[1] = make_float4(dsc[m][4], dsc[m][5], dsc[m][6], dsc[m][7]);
    }
    __syncthreads();
    for (int c = tid; c < WIDTH; c += NT) {
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < NT / 32; ++wp) sum += xchg[wp * WIDTH + c];
      dsp[static_cast<long>(blockIdx.x) * WIDTH + c] = sum;
    }
  }
  // dr's generic writes, before wgmma reads them; the barrier also ends
  // the exchange's reads of stage 1
  tc::fence_proxy_async();
  __syncthreads();

  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  const int row0 = 16 * warp + (lane >> 2);
  for (int it = 0; it < n_it; ++it) {
    if (tid == 0 && it + 1 < n_it) load_w(it + 1);
    tc::mbar_wait(bar + 8 * (it & 1), (it >> 1) & 1);
    const int s = it % STEPS, j0 = it / STEPS * CH;
    const uint32_t st = sring + (it & 1) * STAGE;
    const uint64_t desc_a = tc::desc_sw128(sbase + s * ATOM);
    const uint64_t desc_w = tc::desc_sw128(st + 2 * wg * ATOM);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tc::wgmma_ss_m64n64k16(acc[j], desc_a + 2 * kk,
                               desc_w + j * (ATOM >> 4) + 2 * kk, 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc[0]);
    tc::fence_regs(acc[1]);
    __syncthreads();  // stage it % 2 is free
    if (s == STEPS - 1) {  // the chunk's da, through stage it % 2
      uint8_t* ot = smem + DR_BYTES + (it & 1) * STAGE;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = row0 + 8 * i;
            *reinterpret_cast<uint32_t*>(ot + (2 * wg + j) * ATOM +
                                         tc::swz128(r, t) + 4 * (lane & 3)) =
                tc::pack_bf16(acc[j][4 * t + 2 * i],
                              acc[j][4 * t + 2 * i + 1]);
            acc[j][4 * t + 2 * i] = acc[j][4 * t + 2 * i + 1] = 0.f;
          }
      tc::fence_proxy_async();
      __syncthreads();
      // thread 0 stores the atoms (TMA skips rows past N and columns
      // past K) and waits until they are read, before its next copy
      // into this stage
      if (tid == 0) {
#pragma unroll 1
        for (int a = 0; a < CH / 64 && j0 + 64 * a < K; ++a)
          tc::tma_store_2d(&tm_da, tc::smem_addr(ot) + a * ATOM,
                           j0 + 64 * a, n0);
        tc::tma_store_commit();
        tc::tma_store_wait_read();
      }
    }
  }
}

// the dw kernel
constexpr int DW_NT = 256;
constexpr int DW_TILE = 128;
constexpr int DW_STAGES = 3;
constexpr int DW_STAGE = 4 * ATOM;  // a: 2 atoms, then dresid: 2 atoms
constexpr int DW_BAR = DW_STAGES * DW_STAGE;  // mbarriers: the stages
constexpr size_t DW_SMEM = 1024 + DW_BAR + 8 * DW_STAGES;

__global__ void __launch_bounds__(DW_NT, 2)
    mrn_bwd_dw_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_dr,
                      float* __restrict__ dwp, int N, int K, int per) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(smem);
  const uint32_t bar = sbase + DW_BAR;  // + 8 s: stage s
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c0 = blockIdx.x * DW_TILE, k0 = blockIdx.y * DW_TILE;
  const int nb = blockIdx.z * per, ne = min(N, nb + per);
  const int steps = ne > nb ? (ne - nb + 63) / 64 : 0;

  // thread 0 copies rows nb + 64 t .. + 63 of a[:, k0:k0+128] and
  // dresid[:, c0:c0+128], two atoms each; rows past N arrive as zeros,
  // and a step never reaches past its slice (per is whole steps)
  auto load = [&](int t) {
    const uint32_t st = sbase + (t % DW_STAGES) * DW_STAGE;
    const uint32_t b = bar + 8 * (t % DW_STAGES);
    const int n = nb + 64 * t;
    tc::mbar_expect_tx(b, DW_STAGE);
    tc::tma_load_2d(st, &tm_a, k0, n, b);
    tc::tma_load_2d(st + ATOM, &tm_a, k0 + 64, n, b);
    tc::tma_load_2d(st + 2 * ATOM, &tm_dr, c0, n, b);
    tc::tma_load_2d(st + 3 * ATOM, &tm_dr, c0 + 64, n, b);
  };

  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) tc::mbar_init(bar + 8 * s, 1);
    tc::fence_mbar_init();
    for (int t = 0; t < DW_STAGES - 1 && t < steps; ++t) load(t);
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    // the stage refilled here was read by step t - 1, whose products
    // every warpgroup finished before the barrier that ended it
    if (tid == 0 && t + DW_STAGES - 1 < steps) load(t + DW_STAGES - 1);
    tc::mbar_wait(bar + 8 * (t % DW_STAGES), (t / DW_STAGES) & 1);
    const uint32_t st = sbase + (t % DW_STAGES) * DW_STAGE;
    const uint64_t desc_a = tc::desc_sw128(st + wg * ATOM);
    const uint64_t desc_b = tc::desc_sw128(st + 2 * ATOM);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // + 16 rows n a step
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tc::wgmma_ss_m64n64k16_tt(acc[j], desc_a + 128 * kk,
                                  desc_b + j * (ATOM >> 4) + 128 * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j) tc::fence_regs(acc[j]);
    __syncthreads();
  }

  float* out = dwp + static_cast<long>(blockIdx.z) * K * WIDTH;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
        const int c = c0 + 64 * j + 8 * t + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + static_cast<long>(k) * WIDTH + c) =
            make_float2(acc[j][4 * t + 2 * i], acc[j][4 * t + 2 * i + 1]);
      }
}

// dscale [d] = the sum of the n_parts rows of dsp, in a fixed order:
// thread (x, y) of a 32 x 8 block sums rows y, y + 8, ... of column 32 b
// + x, and the 8 sums are added in y order (rtt::launch_column_sum, one
// thread a column, is latency-bound over the 384 rows of N = 24576)
__global__ void __launch_bounds__(256)
    dscale_sum_kernel(const float* __restrict__ dsp,
                      float* __restrict__ dscale, int n_parts) {
  __shared__ float part[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + x;
  float sum = 0.f;
#pragma unroll 4
  for (int p = y; p < n_parts; p += 8)
    sum += dsp[static_cast<long>(p) * WIDTH + c];
  part[y][x] = sum;
  __syncthreads();
  if (y == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += part[i][x];
    dscale[c] = tot;
  }
}

int launch(const void* a, const void* w, const void* rout, const void* scale,
           const void* rstd, const void* drout, const void* dy, void* da,
           void* dw, void* dresid, void* dscale, void* dsp, void* dwp, int N,
           int K, cudaStream_t stream) {
  CUtensorMap tm[4];
  if (!tc::tmap_bf16_64x64(&tm[0], w, WIDTH, K, 2L * WIDTH) ||
      !tc::tmap_bf16_64x64(&tm[1], da, K, N, 2L * K) ||
      !tc::tmap_bf16_64x64(&tm[2], a, K, N, 2L * K) ||
      !tc::tmap_bf16_64x64(&tm[3], dresid, WIDTH, N, 2L * WIDTH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mrn_bwd_da_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mrn_bwd_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DW_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (N + BM - 1) / BM;
  mrn_bwd_da_kernel<<<n_blk, NT, SMEM, stream>>>(
      tm[0], tm[1], static_cast<const bf16*>(rout),
      static_cast<const bf16*>(scale), static_cast<const float*>(rstd),
      static_cast<const bf16*>(drout), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dresid), static_cast<float*>(dsp), N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // slice z of N: rows [z per, (z + 1) per), whole 64-row steps
  const int per = (n_blk + kSplits - 1) / kSplits * BM;
  mrn_bwd_dw_kernel<<<dim3(WIDTH / DW_TILE, K / DW_TILE, kSplits), DW_NT,
                      DW_SMEM, stream>>>(tm[2], tm[3],
                                         static_cast<float*>(dwp), N, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = rtt::launch_column_sum(static_cast<const float*>(dwp),
                                  static_cast<bf16*>(dw), kSplits,
                                  static_cast<long>(K) * WIDTH, stream);
  if (rc) return rc;
  dscale_sum_kernel<<<WIDTH / 32, 256, 0, stream>>>(
      static_cast<const float*>(dsp), static_cast<float*>(dscale), n_blk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_bwd

// ---------------------------------------------------------------------------
// bf16 at d = 1024, 1280: the row pass, then flash_ce_tc.cuh's wgmma GEMM
// for both products
// ---------------------------------------------------------------------------
//
// The fused da kernel keeps a 64 x d bf16 dr in shared memory beside its
// w ring; at d = 1280 the two no longer fit, so the wide widths take the
// row pass alone (mrn_bwd_rows_kernel, dresid and the dscale partials),
// then da = dresid w^T (both operands K-major, kLogits' layouts) and the
// kSplits slices of dw = a^T dresid (both MN-major, kDw's), each slice an
// f32 partial that the column sum adds in slice order and casts once, as
// at d = 768.  No atomics.

namespace wide_bwd {

using bf16 = __nv_bfloat16;

template <int D>
int launch(const void* a, const void* w, const void* rout, const void* scale,
           const void* rstd, const void* drout, const void* dy, void* da,
           void* dw, void* dresid, void* dscale, void* dsp, void* dwp, int N,
           int K, cudaStream_t stream) {
  const int n_blk = (N + ROWS - 1) / ROWS;
  mrn_bwd_rows_kernel<bf16, D><<<n_blk, THREADS, 0, stream>>>(
      static_cast<const bf16*>(rout), static_cast<const bf16*>(scale),
      static_cast<const float*>(rstd), static_cast<const bf16*>(drout),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dresid),
      static_cast<float*>(dsp), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // da [N, K] = dresid [N, D] w^T, w [K, D]
  CUtensorMap ta, tb;
  if (!tc_ce::tmap(&ta, dresid, D, N, D) || !tc_ce::tmap(&tb, w, D, K, D))
    return static_cast<int>(cudaErrorInvalidValue);
  tc_ce::Epi ep{};
  ep.M = N;
  ep.tiles_m = (N + tc_ce::BM - 1) / tc_ce::BM;
  ep.tiles_n = K / tc_ce::BN;
  ep.steps = D / tc_ce::BK;
  ep.o16 = static_cast<bf16*>(da);
  ep.ld = K;
  ep.mode = tc_ce::kBF16;
  int rc = tc_ce::launch_gemm<tc_ce::kLogits, tc_ce::kStore>(ta, tb, ta, ep,
                                                             stream);
  if (rc) return rc;
  // dw slice z [K, D] = a[rows of z]^T dresid[rows of z], whole 64-row
  // steps, into dwp[z] (f32)
  const int per = (n_blk + kSplits - 1) / kSplits * ROWS;
  const int n_slices = (N + per - 1) / per;
  for (int z = 0; z < n_slices; ++z) {
    const long r0 = static_cast<long>(z) * per;
    const int rows = static_cast<int>(N - r0 < per ? N - r0 : per);
    if (!tc_ce::tmap(&ta, static_cast<const bf16*>(a) + r0 * K, K, rows, K) ||
        !tc_ce::tmap(&tb, static_cast<const bf16*>(dresid) + r0 * D, D, rows,
                     D))
      return static_cast<int>(cudaErrorInvalidValue);
    tc_ce::Epi ew{};
    ew.M = K;
    ew.tiles_m = K / tc_ce::BM;
    ew.tiles_n = D / tc_ce::BN;
    ew.steps = (rows + tc_ce::BK - 1) / tc_ce::BK;
    ew.o32 = static_cast<float*>(dwp) + static_cast<long>(z) * K * D;
    ew.ld = D;
    ew.mode = tc_ce::kF32;
    rc = tc_ce::launch_gemm<tc_ce::kDw, tc_ce::kStore>(ta, tb, ta, ew,
                                                       stream);
    if (rc) return rc;
  }
  rc = rtt::launch_column_sum(static_cast<const float*>(dwp),
                              static_cast<bf16*>(dw), n_slices,
                              static_cast<long>(K) * D, stream);
  if (rc) return rc;
  return rtt::launch_column_sum(static_cast<const float*>(dsp),
                                static_cast<float*>(dscale), n_blk, D,
                                stream);
}

}  // namespace wide_bwd

}  // namespace

// da [N, K], dw [K, d], dresid [N, d] in the storage dtype, dscale [d] f32.
// Scratch (f32): dsp of ceil(N / 64) x d, dwp of kSplits (7) x K x d.
// bf16 runs on the tensor cores and takes K a multiple of 128, reading
// and writing 16-byte vectors (every pointer 16-byte aligned); f32 on
// the CUDA cores, K a multiple of 16; both K <= 1536 and d in {768,
// 1024, 1280}.
extern "C" int matmul_residual_norm_bwd(
    const void* a, const void* w, const void* rout, const void* scale,
    const void* rstd, const void* drout, const void* dy, void* da, void* dw,
    void* dresid, void* dscale, void* dsp, void* dwp, int N, int K, int d,
    int dtype, void* stream) {
  if (N <= 0) return 0;
  if (K <= 0 || K > 1536) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == rtt::kBF16 && K % tc_bwd::DW_TILE == 0;
  const bool f32 = dtype == rtt::kF32 && K % 16 == 0;
#define RTT_MRN_BWD_ARGS                                                   \
  a, w, rout, scale, rstd, drout, dy, da, dw, dresid, dscale, dsp, dwp, N, \
      K, st
  if (bf && d == WIDTH) return tc_bwd::launch(RTT_MRN_BWD_ARGS);
  if (bf && d == 1024) return wide_bwd::launch<1024>(RTT_MRN_BWD_ARGS);
  if (bf && d == 1280) return wide_bwd::launch<1280>(RTT_MRN_BWD_ARGS);
  if (f32 && d == WIDTH) return launch_f32<WIDTH>(RTT_MRN_BWD_ARGS);
  if (f32 && d == 1024) return launch_f32<1024>(RTT_MRN_BWD_ARGS);
  if (f32 && d == 1280) return launch_f32<1280>(RTT_MRN_BWD_ARGS);
#undef RTT_MRN_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
