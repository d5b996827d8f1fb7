// The bf16 flash-CE kernels on Hopper tensor cores, shared by
// flash_ce_fwd.cu and flash_ce_bwd.cu: one wgmma GEMM kernel fed by TMA
// for the three products of the pair, with the epilogues that turn each
// logits tile into statistics or dl, and the row passes around them.
//
// The GEMM (ce_gemm_kernel): a block owns one 128 x 128 output tile, two
// warpgroups of m64n128 accumulators (64 registers a thread).  Thread 0
// copies K chunks of 64 by TMA into a ring of STAGES stages of 32 KB
// (A and B two 64 x 64 boxes each, 128-byte swizzle), counted on one
// mbarrier a stage; the warpgroups keep one wgmma group in flight while
// the next stage's copy is issued.  Two blocks share an SM (99 KB of
// shared memory each), so one block's epilogue runs under the other's
// products.  Tiles are rastered in groups of GROUP row tiles, so the
// blocks resident at one time read the same few B tiles and a few A
// tiles from L2, and each operand comes from device memory about once.
// Ragged edges: TMA zero-fills rows and columns past a tensor's end and
// clips its stores there; the epilogues mask the rest.  Nothing is
// summed across blocks with atomics.
//
// The three products, by KIND (operand layouts as they lie in memory):
//   kLogits  S = y w^T     A = y [rows][d] K-major, B = w [V][d] K-major
//   kDx      dy = dl w     A = dl [rows][Vp] K-major, B = w MN-major
//   kDw      dw = dl^T y   A = dl MN-major, B = y [rows][d] MN-major
// and the epilogues, by EPI:
//   kStats   per (row, vocab tile): the row max and sum of exp over the
//            tile's columns < V into partials, and the true logit where
//            the target falls in the tile (flash_ce_fwd.cu)
//   kDl      dl = bf16((exp(s - lse) - onehot) srow), 0 past V, through
//            shared memory and TMA stores (flash_ce_bwd.cu)
//   kStore   the f32 tile stored, added to an f32 partial, or rounded to
//            bf16 (alone or after that addition), by Epi::mode
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace tc_ce {

namespace tc = rtt::tc;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;          // two warpgroups
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int ATOM = 64 * 128;   // one 64 x 64 bf16 box, 8 KB
constexpr int STAGE = 4 * ATOM;  // A: 2 boxes, then B: 2 boxes
constexpr int BAR = STAGES * STAGE;
constexpr size_t SMEM = 1024 + BAR + 8 * STAGES;
constexpr int GROUP = 16;        // row tiles per raster group
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kLogits = 0, kDx = 1, kDw = 2 };
enum EpiKind { kStats = 0, kDl = 1, kStore = 2 };
// kStore's modes.  A "split" f32 keeps its high 16 bits in o16 and its
// low 16 bits in lo, so that a running f32 sum lives in a bf16 output
// and half as many bytes again, and its last addition is rounded to
// bf16 in place.
enum StoreMode {
  kF32 = 0,        // o32 = acc
  kBF16 = 1,       // o16 = bf16(acc)
  kSplit = 2,      // (o16, lo) = acc
  kAddSplit = 3,   // (o16, lo) = (o16, lo) + acc
  kAddBF16 = 4,    // o16 = bf16((o16, lo) + acc)
};

struct Epi {
  int M;        // valid output rows (logits: rows of x or of the chunk)
  int V;        // valid vocab columns (kStats, kDl)
  int tiles_m, tiles_n, steps;
  const int* tgt;      // [M] (kStats, kDl)
  const float* lse;    // [M] (kDl)
  const float* srow;   // [M] (kDl)
  float* pm;           // [tiles_n][M] row max partials (kStats)
  float* pl;           // [tiles_n][M] sum-exp partials (kStats)
  float* tru;          // [M] true logits (kStats)
  float* o32;          // kStore: f32 out
  bf16* o16;           // kStore: bf16 out, or a split f32's high halves
  uint16_t* lo;        // kStore: a split f32's low halves
  int ld;              // kStore: row stride of the outputs
  int mode;            // kStore: StoreMode
};

// block b's output tile (tm, tn): GROUP row tiles at a time, the rows
// fastest, then every column tile of the group
__device__ __forceinline__ void tile_of(int b, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per = GROUP * tiles_n;
  const int grp = b / per, base = grp * GROUP;
  const int gs = min(GROUP, tiles_m - base);
  const int loc = b - grp * per;
  tm = base + loc % gs;
  tn = loc / gs;
}

template <int KIND, int EPI>
__global__ void __launch_bounds__(NT, 2)
    ce_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c, const Epi ep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(smem);
  const uint32_t bar = sbase + BAR;  // + 8 s: stage s
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int tm, tn;
  tile_of(blockIdx.x, ep.tiles_m, ep.tiles_n, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int steps = ep.steps;

  // thread 0 copies K chunk t: A's two boxes (rows m0, m0 + 64 of the
  // tile; for kDw, its two 64-column atoms), then B's
  auto load = [&](int t) {
    const uint32_t st = sbase + (t % STAGES) * STAGE;
    const uint32_t b = bar + 8 * (t % STAGES);
    const int k0 = t * BK;
    tc::mbar_expect_tx(b, STAGE);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (KIND == kDw)
        tc::tma_load_2d(st + h * ATOM, &tm_a, m0 + 64 * h, k0, b);
      else
        tc::tma_load_2d(st + h * ATOM, &tm_a, k0, m0 + 64 * h, b);
      if constexpr (KIND == kLogits)
        tc::tma_load_2d(st + (2 + h) * ATOM, &tm_b, k0, n0 + 64 * h, b);
      else
        tc::tma_load_2d(st + (2 + h) * ATOM, &tm_b, n0 + 64 * h, k0, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(bar + 8 * s, 1);
    tc::fence_mbar_init();
    for (int t = 0; t < STAGES - 1 && t < steps; ++t) load(t);
  }

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    tc::mbar_wait(bar + 8 * (t % STAGES), (t / STAGES) & 1);
    const uint32_t st = sbase + (t % STAGES) * STAGE;
    tc::wgmma_fence();
    if constexpr (KIND == kLogits) {
      const uint64_t da = tc::desc_sw128(st + wg * ATOM);
      const uint64_t db = tc::desc_sw128(st + 2 * ATOM);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_ss_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    } else if constexpr (KIND == kDx) {
      const uint64_t da = tc::desc_sw128(st + wg * ATOM);
      const uint64_t db = tc::desc_sw128_mn(st + 2 * ATOM, ATOM);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_ss_m64n128k16_tb(acc, da + 2 * kk, db + 128 * kk);
    } else {
      const uint64_t da = tc::desc_sw128(st + wg * ATOM);
      const uint64_t db = tc::desc_sw128_mn(st + 2 * ATOM, ATOM);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_ss_m64n128k16_tt(acc, da + 128 * kk, db + 128 * kk);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // step t - 1's products are done
    __syncthreads();      // ... in both warpgroups: its stage is free
    if (tid == 0 && t + STAGES - 1 < steps) load(t + STAGES - 1);
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);

  // this thread's two rows of the tile: r0 + 8 i (read after the
  // products, so that they hold no registers through the K loop)
  const int rloc = 64 * wg + 16 * warp + (lane >> 2);
  int tg[2] = {-1, -1};
  float lse[2] = {0.f, 0.f}, srow[2] = {0.f, 0.f};
  if constexpr (EPI != kStore) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + rloc + 8 * i;
      if (r < ep.M) {
        tg[i] = ep.tgt[r];
        if constexpr (EPI == kDl) {
          lse[i] = ep.lse[r];
          srow[i] = ep.srow[r];
        }
      }
    }
  }

  // acc[4 j + 2 i + e] is S[m0 + rloc + 8 i][n0 + 8 j + 2 (lane % 4) + e]
  const int cq = 2 * (lane & 3);
  if constexpr (EPI == kStats) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + rloc + 8 * i;
      float mx = rtt::kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * j + cq + e < ep.V)
            mx = fmaxf(mx, acc[4 * j + 2 * i + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mxs = mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + cq + e;
          const float s = acc[4 * j + 2 * i + e];
          if (col < ep.V) {
            sum += tc::exp2_approx(fmaf(s, kLog2e, -mxs));
            if (col == tg[i]) ep.tru[r] = s;  // tg[i] < 0 past M
          }
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((lane & 3) == 0 && r < ep.M) {
        const long p = static_cast<long>(tn) * ep.M + r;
        ep.pm[p] = mx;
        ep.pl[p] = sum;
      }
    }
  } else if constexpr (EPI == kDl) {
    // dl into shared memory as two 64-column atoms of 128 swizzled rows
    // (the ring is free: every product has been waited for)
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rloc + 8 * i;
      const float ls = lse[i] * kLog2e;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + cq + e;
          const float p = col < ep.V
                              ? tc::exp2_approx(fmaf(acc[4 * j + 2 * i + e],
                                                     kLog2e, -ls))
                              : 0.f;
          v[e] = (p - (col == tg[i] ? 1.f : 0.f)) * srow[i];
        }
        *reinterpret_cast<uint32_t*>(smem + (j >> 3) * 2 * ATOM +
                                     tc::swz128(r, j & 7) + 4 * (lane & 3)) =
            tc::pack_bf16(v[0], v[1]);
      }
    }
    tc::fence_proxy_async();
    __syncthreads();
    // TMA skips rows past the chunk; columns reach the padded width
    if (tid == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          tc::tma_store_2d(&tm_c, sbase + h * 2 * ATOM + q * ATOM,
                           n0 + 64 * h, m0 + 64 * q);
      tc::tma_store_commit();
      tc::tma_store_wait_read();
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + rloc + 8 * i;
      if (r >= ep.M) continue;
      const long row = static_cast<long>(r) * ep.ld;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long o = row + n0 + 8 * j + cq;
        float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        uint32_t* hi = reinterpret_cast<uint32_t*>(ep.o16 + o);
        uint32_t* lo = reinterpret_cast<uint32_t*>(ep.lo + o);
        if (ep.mode == kAddSplit || ep.mode == kAddBF16) {
          const uint32_t h = *hi, l = *lo;
          v.x = __uint_as_float((h << 16) | (l & 0xFFFFu)) + v.x;
          v.y = __uint_as_float((h & 0xFFFF0000u) | (l >> 16)) + v.y;
        }
        if (ep.mode == kF32) {
          *reinterpret_cast<float2*>(ep.o32 + o) = v;
        } else if (ep.mode == kSplit || ep.mode == kAddSplit) {
          const uint32_t x = __float_as_uint(v.x), y = __float_as_uint(v.y);
          *hi = (x >> 16) | (y & 0xFFFF0000u);
          *lo = (x & 0xFFFFu) | (y << 16);
        } else {
          *hi = tc::pack_bf16(v.x, v.y);
        }
      }
    }
  }
}

template <int KIND, int EPI>
int launch_gemm(const CUtensorMap& a, const CUtensorMap& b,
                const CUtensorMap& c, const Epi& ep, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_gemm_kernel<KIND, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_gemm_kernel<KIND, EPI>
      <<<ep.tiles_m * ep.tiles_n, NT, SMEM, stream>>>(a, b, c, ep);
  return static_cast<int>(cudaGetLastError());
}

// the tensor map of rows x cols bf16 elements `ld` apart, in 64 x 64
// boxes; false when the driver refuses it
inline bool tmap(CUtensorMap* m, const void* base, int cols, int rows,
                 long ld) {
  return tc::tmap_bf16_64x64(m, base, static_cast<uint64_t>(cols),
                             static_cast<uint64_t>(rows),
                             static_cast<uint64_t>(ld) * 2);
}

constexpr int MAX_D = 1280;    // the widest model width the kernels take
constexpr int MAX_CHUNKS = MAX_D / 256;  // 16-byte chunks a lane holds

// The norm prologue as a row pass, one warp a row, 16-byte vectors: y =
// bf16(x * rstd * scale) with rstd = 1 / sqrt(mean(x^2) + eps) computed
// (STATS, the forward; written to rstd) or read (the backward's saved
// rstd).  d is a multiple of 64.
template <bool STATS>
__global__ void __launch_bounds__(256)
    ce_norm_rows_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ scale, bf16* __restrict__ y,
                        float* __restrict__ rstd, int N, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (n >= N) return;
  const int nch = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long>(n) * d);
  uint4 v[MAX_CHUNKS];
  float ss = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_CHUNKS; ++m) {
    const int c = lane + 32 * m;
    if (c < nch) {
      v[m] = xr[c];
      if constexpr (STATS) {
        float f[8];
        rtt::unpack16(v[m], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
      }
    }
  }
  float rs;
  if constexpr (STATS) {
    ss = rtt::warp_sum(ss);
    rs = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
    if (lane == 0) rstd[n] = rs;
  } else {
    rs = rstd[n];
  }
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<long>(n) * d);
#pragma unroll
  for (int m = 0; m < MAX_CHUNKS; ++m) {
    const int c = lane + 32 * m;
    if (c < nch) {
      float f[8], s[8];
      rtt::unpack16(v[m], f);
      rtt::unpack16(reinterpret_cast<const uint4*>(scale)[c], s);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] * rs * s[e];
      yr[c] = rtt::pack16(f);
    }
  }
}

}  // namespace tc_ce
}  // namespace
