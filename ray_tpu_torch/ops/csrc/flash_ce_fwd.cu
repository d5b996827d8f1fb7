// Flash-CE forward: streamed-logits cross-entropy statistics.
//
// Replaces: ray_tpu/ops/flash_ce.py:_fwd_kernel (via _fwd_pallas; public
// flash_ce_sum and flash_ce_norm_sum).
//
// Computes, for x [N, d], the head as w = head^T [V, d] (the tied
// embedding's own layout), targets [N] int32 (-1 masked), bf16 or f32:
//   y     = x, or with the prologue (NORM) y = (x * rstd * scale) rounded
//           to the storage dtype, rstd = 1 / sqrt(mean(x^2) + eps)
//   s     = y @ w^T                       (f32 accumulation, per vocab tile)
//   lse   [N] = m + log(l): online row max m and sum-exp l over the vocab
//   true  [N] = s[row, target[row]] (0 for a masked row)
//   rstd  [N] (NORM only, f32)
// and never writes the [N, V] logits: each vocab tile lives in shared
// memory only.  Vocab columns past V (the ragged last tile) are masked to
// -1e30 before the statistics, as the reference masks its padding.
//
// What bounds it on an H100: 2*N*d*V flops (1.9 TFLOP at N = 24576,
// d = 768, V = 50304) over ~(N*d + V*d)*2 bytes: far above the bf16 ridge,
// so the tensor cores bound it (~1.9 ms at 989 TFLOP/s).
//
// What the design does about it: one block owns BM rows, keeps their
// (normalised) y in shared memory for the whole vocab sweep, and streams
// the head one [BV, d] tile at a time; the tile product runs on bf16 WMMA
// fragments with f32 accumulation (rtt::block_mma; 16 warps, one 16x16
// score tile each at bf16), and each warp folds its rows of the f32 score
// tile into running (max, sum-exp, true logit) held in registers.
// Nothing vocab-sized leaves the SM.  wgmma with TMA-fed, double-buffered
// head tiles is later work.
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Tiles;
template <> struct Tiles<__nv_bfloat16> {
  static constexpr int BM = 64, BV = 64;
};
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

template <typename T>
int dispatch(const void* x, const void* w, const void* tgt, const void* scale,
             void* lse, void* tru, void* rstd, int N, int d, int V, float eps,
             int norm, cudaStream_t st) {
  if (norm)
    return launch<T, true>(x, w, tgt, scale, lse, tru, rstd, N, d, V, eps, st);
  return launch<T, false>(x, w, tgt, scale, lse, tru, rstd, N, d, V, eps, st);
}

}  // namespace

// norm != 0 selects the final-norm prologue (scale [d], rstd [N] out);
// otherwise scale and rstd are not read.
extern "C" int flash_ce_fwd(const void* x, const void* w, const void* tgt,
                            const void* scale, void* lse, void* tru,
                            void* rstd, int N, int d, int V, float eps,
                            int norm, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (d != 768 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return dispatch<__nv_bfloat16>(x, w, tgt, scale, lse, tru, rstd, N, d, V,
                                   eps, norm, st);
  if (dtype == rtt::kF32)
    return dispatch<float>(x, w, tgt, scale, lse, tru, rstd, N, d, V, eps,
                           norm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
