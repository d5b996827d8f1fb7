// Flash-CE forward: streamed-logits cross-entropy statistics.
//
// Replaces: ray_tpu/ops/flash_ce.py:_fwd_kernel (via _fwd_pallas; public
// flash_ce_sum and flash_ce_norm_sum).
//
// Computes, for x [N, d], the head as w = head^T [V, d] (the tied
// embedding's own layout), targets [N] int32 (-1 masked), bf16 or f32:
//   y     = x, or with the prologue (NORM) y = (x * rstd * scale) rounded
//           to the storage dtype, rstd = 1 / sqrt(mean(x^2) + eps)
//   s     = y @ w^T                       (f32 accumulation)
//   lse   [N] = m + log(l): the row max m and sum-exp l over the vocab
//   true  [N] = s[row, target[row]] (0 for a masked row)
//   rstd  [N] (NORM only, f32)
// and never writes the [N, V] logits.  Vocab columns past V are masked
// out of the statistics, as the reference masks its padding.
//
// What bounds it on an H100: 2*N*d*V flops (1.9 TFLOP at N = 24576,
// d = 768, V = 50304) over ~(N*d + V*d)*2 bytes: far above the bf16 ridge,
// so the tensor cores bound it (~1.9 ms at 989 TFLOP/s).  A tiled
// product reads its operands again per tile from L2: at 128 x 128 tiles
// and K = 768, 64 flops a byte, ~30 GB of L2 reads a call.
//
// Two instantiations, chosen by dtype alone:
// - bf16 (flash_ce_tc.cuh): three kernels.  With the prologue, a row
//   pass writes y (bf16 [N, d], 38 MB at the main shape, never
//   vocab-sized) and rstd.  Then S = y w^T as a wgmma GEMM over (128-row
//   tile, 128-column vocab tile) pairs fed by TMA, whose epilogue takes
//   each row's max and sum of exp over the tile on the accumulator
//   fragment (columns >= V masked) into per-(vocab tile, row) partials
//   [V / 128, N], and writes the true logit from the one tile holding
//   the target.  A combine pass folds the partials in vocab-tile order
//   into lse.  Every output element has one writer; no atomics.  d is a
//   runtime multiple of 64 up to 1280 (the K loop), so every width of
//   the wrapper's list takes the same kernels.
// - f32: the first port's kernel on the CUDA cores (rtt::block_mma's f32
//   loop), d = 768: one block owns BM rows, keeps their y in shared
//   memory and streams the head one [BV, d] tile at a time, folding each
//   f32 score tile into running (max, sum-exp, true logit), so that it
//   is held to the plain version at summation-order bounds.
#include "flash_ce_tc.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Tiles;
template <> struct Tiles<float> {
  static constexpr int BM = 32, BV = 32;
};

template <typename T>
size_t smem_bytes(int d) {
  constexpr int BM = Tiles<T>::BM, BV = Tiles<T>::BV;
  const int ld = d + rtt::kPad<T>;
  return rtt::align128(sizeof(T) * BM * ld) +
         rtt::align128(sizeof(T) * BV * ld) +
         sizeof(float) * BM * (BV + 4);
}

// rows [r0, r0 + rows) of x into ys as y; with NORM each row is
// normalised first and its rstd written (rows < N).  Rows past N are 0.
template <typename T, bool NORM>
__device__ void load_y(T* ys, int ld, const T* __restrict__ x, int r0,
                       int rows, int N, int d, const T* __restrict__ scale,
                       float eps, float* __restrict__ rstd_out) {
  if constexpr (!NORM) {
    rtt::copy_rows(ys, ld, x, r0, rows, N, d);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += WARPS) {
      const int n = r0 + r;
      T* yr = ys + r * ld;
      if (n >= N) {
        for (int c = lane; c < d; c += 32) yr[c] = rtt::from_f32<T>(0.f);
        continue;
      }
      const T* xr = x + static_cast<long>(n) * d;
      float ss = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float v = rtt::to_f32(xr[c]);
        ss += v * v;
      }
      ss = rtt::warp_sum(ss);
      const float rstd = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
      if (lane == 0) rstd_out[n] = rstd;
      for (int c = lane; c < d; c += 32)
        yr[c] = rtt::from_f32<T>(rtt::to_f32(xr[c]) * rstd *
                                 rtt::to_f32(scale[c]));
    }
  }
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(THREADS)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ tgt, const T* __restrict__ scale,
                  float* __restrict__ lse, float* __restrict__ tru,
                  float* __restrict__ rstd, int N, int d, int V, float eps) {
  constexpr int BM = Tiles<T>::BM, BV = Tiles<T>::BV;
  constexpr int RPW = BM / WARPS;  // rows per warp
  constexpr int CPL = BV / 32;     // score columns per lane
  constexpr int LDS = BV + 4;
  const int ld = d + rtt::kPad<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);  // [BM][ld]
  T* hs = reinterpret_cast<T*>(smem + rtt::align128(sizeof(T) * BM * ld));
  float* S = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(hs) +
      rtt::align128(sizeof(T) * BV * ld));  // [BM][LDS]

  const int r0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_y<T, NORM>(ys, ld, x, r0, BM, N, d, scale, eps, rstd);

  float m[RPW], l[RPW], t[RPW];
  int tg[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int n = r0 + warp * RPW + i;
    m[i] = rtt::kNegInf;
    l[i] = 0.f;
    t[i] = 0.f;
    tg[i] = n < N ? tgt[n] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // ys written; the last tile's readers of hs, S done
    rtt::copy_rows(hs, ld, w, v0, BV, V, d);
    __syncthreads();
    rtt::block_mma<false, true>(S, LDS, ys, ld, hs, ld, BM, BV, d, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* sr = S + (warp * RPW + i) * LDS;
      float sv[CPL];
      float rmax = rtt::kNegInf, tv = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = v0 + lane + 32 * j;
        sv[j] = col < V ? sr[lane + 32 * j] : rtt::kNegInf;
        rmax = fmaxf(rmax, sv[j]);
        if (col == tg[i]) tv += sv[j];
      }
      rmax = rtt::warp_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) psum += expf(sv[j] - m_new);
      psum = rtt::warp_sum(psum);
      tv = rtt::warp_sum(tv);  // at most one lane holds the target
      l[i] = l[i] * expf(m[i] - m_new) + psum;
      m[i] = m_new;
      t[i] += tv;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int n = r0 + warp * RPW + i;
      if (n < N) {
        lse[n] = m[i] + logf(fmaxf(l[i], 1e-30f));
        tru[n] = t[i];
      }
    }
  }
}

template <typename T, bool NORM>
int launch(const void* x, const void* w, const void* tgt, const void* scale,
           void* lse, void* tru, void* rstd, int N, int d, int V, float eps,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + Tiles<T>::BM - 1) / Tiles<T>::BM;
  ce_fwd_kernel<T, NORM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(tgt), static_cast<const T*>(scale),
      static_cast<float*>(lse), static_cast<float*>(tru),
      static_cast<float*>(rstd), N, d, V, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the row pass, the logits GEMM with its statistics epilogue, the
// combine pass
// ---------------------------------------------------------------------------

namespace tc_fwd {

using namespace tc_ce;

// lse [n] from the [n_tiles][N] partials, folded in vocab-tile order;
// the true logit of a masked row (or of a target outside the vocab,
// which no tile holds) is 0
__global__ void __launch_bounds__(256)
    ce_combine_kernel(const float* __restrict__ pm,
                      const float* __restrict__ pl,
                      const int* __restrict__ tgt, float* __restrict__ lse,
                      float* __restrict__ tru, int N, int V, int n_tiles) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = pm[n], l = pl[n];
#pragma unroll 4
  for (int t = 1; t < n_tiles; ++t) {
    const float mt = pm[static_cast<long>(t) * N + n];
    const float lt = pl[static_cast<long>(t) * N + n];
    const float mn = fmaxf(m, mt);
    l = l * expf(m - mn) + lt * expf(mt - mn);
    m = mn;
  }
  lse[n] = m + logf(fmaxf(l, 1e-30f));
  const int tg = tgt[n];
  if (tg < 0 || tg >= V) tru[n] = 0.f;
}

// the workspace: y [N, d] bf16 with the prologue, then the partials
size_t y_bytes(int N, int d, int norm) {
  return norm ? (static_cast<size_t>(N) * d * 2 + 255) / 256 * 256 : 0;
}
size_t workspace(int N, int d, int V, int norm) {
  const size_t nvt = (V + BN - 1) / BN;
  return y_bytes(N, d, norm) + 2 * nvt * static_cast<size_t>(N) * 4;
}

int launch(const void* x, const void* w, const void* tgt, const void* scale,
           void* lse, void* tru, void* rstd, void* ws, int N, int d, int V,
           float eps, int norm, cudaStream_t stream) {
  const bf16* y = static_cast<const bf16*>(x);
  uint8_t* wsp = static_cast<uint8_t*>(ws);
  if (norm) {
    bf16* yw = reinterpret_cast<bf16*>(wsp);
    ce_norm_rows_kernel<true><<<(N + 7) / 8, 256, 0, stream>>>(
        y, static_cast<const bf16*>(scale), yw, static_cast<float*>(rstd), N,
        d, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    y = yw;
  }
  const int nvt = (V + BN - 1) / BN;
  float* pm = reinterpret_cast<float*>(wsp + y_bytes(N, d, norm));
  float* pl = pm + static_cast<size_t>(nvt) * N;
  CUtensorMap ta, tb;
  if (!tmap(&ta, y, d, N, d) || !tmap(&tb, w, d, V, d))
    return static_cast<int>(cudaErrorInvalidValue);
  Epi ep{};
  ep.M = N;
  ep.V = V;
  ep.tiles_m = (N + BM - 1) / BM;
  ep.tiles_n = nvt;
  ep.steps = d / BK;
  ep.tgt = static_cast<const int*>(tgt);
  ep.pm = pm;
  ep.pl = pl;
  ep.tru = static_cast<float*>(tru);
  int rc = launch_gemm<kLogits, kStats>(ta, tb, ta, ep, stream);
  if (rc) return rc;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      pm, pl, static_cast<const int*>(tgt), static_cast<float*>(lse),
      static_cast<float*>(tru), N, V, nvt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_fwd

}  // namespace

// bytes of the workspace flash_ce_fwd takes for this shape (0 for f32)
extern "C" long long flash_ce_fwd_workspace(int N, int d, int V, int norm,
                                            int dtype) {
  if (dtype != rtt::kBF16 || N <= 0) return 0;
  return static_cast<long long>(tc_fwd::workspace(N, d, V, norm));
}

// norm != 0 selects the final-norm prologue (scale [d], rstd [N] out);
// otherwise scale and rstd are not read.  bf16 takes d a multiple of 64
// up to 1280, every pointer 16-byte aligned, and ws of
// flash_ce_fwd_workspace bytes; f32 takes d = 768 and no workspace.
extern "C" int flash_ce_fwd(const void* x, const void* w, const void* tgt,
                            const void* scale, void* lse, void* tru,
                            void* rstd, void* ws, int N, int d, int V,
                            float eps, int norm, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && d % 64 == 0 && d > 0 && d <= tc_ce::MAX_D)
    return tc_fwd::launch(x, w, tgt, scale, lse, tru, rstd, ws, N, d, V, eps,
                          norm, st);
  if (dtype == rtt::kF32 && d == 768) {
    if (norm)
      return launch<float, true>(x, w, tgt, scale, lse, tru, rstd, N, d, V,
                                 eps, st);
    return launch<float, false>(x, w, tgt, scale, lse, tru, rstd, N, d, V,
                                eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
