// Flash-CE backward: dx, dhead (and with the prologue, dscale) without
// the [N, V] logits.
//
// Replaces: ray_tpu/ops/flash_ce.py:_bwd_kernel (via _bwd_pallas).
//
// Computes, for the forward's inputs and its saved lse [N] (and rstd [N]
// with the prologue), with srow [N] = d(sum_nll) where the target is live
// and 0 where it is masked:
//   s     = y @ w^T                         (recomputed per tile, f32 acc)
//   dl    = ((exp(s - lse) - onehot(target)) * srow), rounded to the
//           storage dtype (flash_ce.py:329); padded vocab columns give 0
//   dy    = dl @ w                         (f32 accumulation)
//   dw    = dl^T @ y                       (dhead^T [V, d], f32 accumulation)
// Without the prologue dx = dy.  With it (flash_ce.py:341-349), per row
//   xhat = x * rstd, dxhat = dy * scale,
//   dx = rstd * (dxhat - xhat * mean(dxhat * xhat)),
// and dscale = sum over rows of dy * xhat.
//
// Cross-block reductions, all deterministic (no atomics):
// - dx needs a sum over the vocab, dw a sum over the rows.  On the TPU one
//   sequential grid carried dx in VMEM and emitted dw as per-row-block
//   partials ([N/1024, d, V], summed by XLA).  Hopper blocks run in no
//   order, so the work splits in two kernels, each owning its output:
//   ce_dx_kernel owns BM rows and sweeps the vocab, accumulating their dx;
//   ce_dw_kernel owns BV vocab rows and sweeps the rows, accumulating
//   their dw.  Each recomputes the logits tile, which
//   costs one extra N*d*V product (5 in all, against the reference's 4),
//   and buys a dw with no partials in device memory and no atomics.
// - dscale: ce_dx_kernel writes one [d] partial per row block; a column
//   sum adds them in block order.
//
// What bounds it on an H100: the four products of 2*N*d*V flops each
// (7.6 TFLOP at the main-path shape, ~7.7 ms at 989 TFLOP/s); the recompute
// of s is the fifth.  The tiles run on bf16 WMMA fragments with f32
// accumulation.  Each block is 16 warps: the score tile (few output
// tiles, K = d = 768) is split along K over all of them
// (rtt::block_mma_ksplit, the parts added where dl is formed), and the
// [32, d] accumulator of dx or dw stays in each warp's register
// fragments for the whole sweep (6 tiles per warp) instead of making a
// round trip through shared memory per step.  f32 operands take
// CUDA-core FMAs with the accumulator in shared memory.
#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 768;  // d, the one model width
constexpr int PARTS = 4;    // K slices of the score tile

// BM rows x BV vocab columns per logits tile, for each kernel and type
template <typename T> struct Tiles;
template <> struct Tiles<__nv_bfloat16> {
  static constexpr int DX_BM = 32, DX_BV = 32, DW_BV = 32, DW_BM = 32;
};
template <> struct Tiles<float> {
  static constexpr int DX_BM = 16, DX_BV = 32, DW_BV = 16, DW_BM = 16;
};

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// shared-memory layout of one kernel: rows x d of y, vocab x d of w,
// the f32 score parts, dl in the storage type, the f32 accumulator, and
// the per-row lse / srow / target of the rows in flight
template <typename T>
struct Layout {
  int ld, ldl, lds, lda, sstride;
  size_t y, w, s, dl, acc, lse, srow, tgt, total;
  __host__ __device__ Layout(int rows, int vocab, int acc_rows) {
    ld = WIDTH + rtt::kPad<T>;
    ldl = vocab + rtt::kPad<T>;
    lds = vocab + 4;
    lda = WIDTH + 4;
    sstride = rows * lds;
    y = 0;
    w = y + rtt::align128(sizeof(T) * rows * ld);
    s = w + rtt::align128(sizeof(T) * vocab * ld);
    dl = s + rtt::align128(sizeof(float) * PARTS * sstride);
    acc = dl + rtt::align128(sizeof(T) * rows * ldl);
    lse = acc + rtt::align128(sizeof(float) * acc_rows * lda);
    srow = lse + rtt::align128(sizeof(float) * rows);
    tgt = srow + rtt::align128(sizeof(float) * rows);
    total = tgt + rtt::align128(sizeof(int) * rows);
  }
};

// rows [r0, r0 + rows) of x into ys as y (normalised with the saved rstd
// under NORM), and their lse, srow, target into shared memory; rows past
// N are zero with srow 0 and target -1, so they contribute nothing
template <typename T, bool NORM>
__device__ void load_rows(T* ys, int ld, float* lse_s, float* srow_s,
                          int* tgt_s, const T* __restrict__ x,
                          const float* __restrict__ lse,
                          const float* __restrict__ srow,
                          const int* __restrict__ tgt,
                          const T* __restrict__ scale,
                          const float* __restrict__ rstd, int r0, int rows,
                          int N) {
  if constexpr (NORM)
    rtt::norm_rows(ys, ld, x, rstd, scale, r0, rows, N, WIDTH);
  else
    rtt::copy_rows(ys, ld, x, r0, rows, N, WIDTH);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int n = r0 + r;
    lse_s[r] = n < N ? lse[n] : 0.f;
    srow_s[r] = n < N ? srow[n] : 0.f;
    tgt_s[r] = n < N ? tgt[n] : -1;
  }
}

// the score tile s = y w^T, its K split over the warps
template <typename T>
__device__ __forceinline__ void scores(float* S, const Layout<T>& L,
                                       const T* ys, const T* hs, int rows,
                                       int vocab) {
  rtt::block_mma_ksplit<PARTS, false, true>(S, L.lds, L.sstride, ys, L.ld,
                                            hs, L.ld, rows, vocab, WIDTH);
}

// dl[r][c] for the rows x vocab tile at vocab offset v0 (row-major [rows]
// [ldl], storage type), from the parts of the f32 scores
template <typename T>
__device__ __forceinline__ void form_dl(T* dl, const Layout<T>& L,
                                        const float* S, const float* lse_s,
                                        const float* srow_s,
                                        const int* tgt_s, int rows, int vocab,
                                        int v0, int V) {
  for (int i = threadIdx.x; i < rows * vocab; i += blockDim.x) {
    const int r = i / vocab, c = i % vocab;
    const int col = v0 + c;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) s += S[p * L.sstride + r * L.lds + c];
    const float prob = col < V ? expf(s - lse_s[r]) : 0.f;
    const float onehot = col == tgt_s[r] ? 1.f : 0.f;
    dl[r * L.ldl + c] = rtt::from_f32<T>((prob - onehot) * srow_s[r]);
  }
}

// The [M = 32, WIDTH] accumulator of a bf16 kernel as register fragments:
// warp w owns the 16x16 tiles w, w + WARPS, ... (6 of them).
constexpr int ACC_TILES = 2 * (WIDTH / 16) / WARPS;

struct FragAcc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[ACC_TILES];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < ACC_TILES; ++i) nvcuda::wmma::fill_fragment(f[i], 0.f);
  }

  __device__ __forceinline__ static int m0(int i) {
    return ((threadIdx.x / 32 + WARPS * i) / (WIDTH / 16)) * 16;
  }
  __device__ __forceinline__ static int n0(int i) {
    return ((threadIdx.x / 32 + WARPS * i) % (WIDTH / 16)) * 16;
  }

  // += A [32][K] B [K][WIDTH], B row-major; A row-major or (A_COL) the
  // transpose of a row-major [K][32]
  template <bool A_COL>
  __device__ __forceinline__ void mma(const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb,
                                      int K) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_COL, wmma::col_major,
                                         wmma::row_major>::type;
    for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
      for (int i = 0; i < ACC_TILES; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb;
        wmma::load_matrix_sync(
            fa, A_COL ? A + k0 * lda + m0(i) : A + m0(i) * lda + k0, lda);
        wmma::load_matrix_sync(fb, B + k0 * ldb + n0(i), ldb);
        wmma::mma_sync(f[i], fa, fb, f[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < ACC_TILES; ++i)
      nvcuda::wmma::store_matrix_sync(C + m0(i) * ldc + n0(i), f[i], ldc,
                                      nvcuda::wmma::mem_row_major);
  }
};

template <typename T, bool NORM>
__global__ void __launch_bounds__(THREADS)
    ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ tgt, const float* __restrict__ lse,
                 const float* __restrict__ srow, const T* __restrict__ scale,
                 const float* __restrict__ rstd, T* __restrict__ dx,
                 float* __restrict__ dsp, int N, int V) {
  constexpr int BM = Tiles<T>::DX_BM, BV = Tiles<T>::DX_BV;
  constexpr int d = WIDTH;
  const Layout<T> L(BM, BV, BM);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem + L.y);
  T* hs = reinterpret_cast<T*>(smem + L.w);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* dl = reinterpret_cast<T*>(smem + L.dl);
  float* acc = reinterpret_cast<float*>(smem + L.acc);  // dy [BM][lda]
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* srow_s = reinterpret_cast<float*>(smem + L.srow);
  int* tgt_s = reinterpret_cast<int*>(smem + L.tgt);

  const int r0 = blockIdx.x * BM;
  load_rows<T, NORM>(ys, L.ld, lse_s, srow_s, tgt_s, x, lse, srow, tgt, scale,
                     rstd, r0, BM, N);
  FragAcc frag;
  if constexpr (kTensorCores<T>)
    frag.zero();
  else
    for (int i = threadIdx.x; i < BM * L.lda; i += blockDim.x) acc[i] = 0.f;

  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // rows loaded; the last tile's readers of hs, dl done
    rtt::copy_rows(hs, L.ld, w, v0, BV, V, d);
    __syncthreads();
    scores(S, L, ys, hs, BM, BV);
    __syncthreads();
    form_dl(dl, L, S, lse_s, srow_s, tgt_s, BM, BV, v0, V);
    __syncthreads();
    // dy[BM][d] += dl[BM][BV] @ w_tile[BV][d]
    if constexpr (kTensorCores<T>)
      frag.mma<false>(dl, L.ldl, hs, L.ld, BV);
    else
      rtt::block_mma<false, false>(acc, L.lda, dl, L.ldl, hs, L.ld, BM, d, BV,
                                   true);
  }
  if constexpr (kTensorCores<T>) frag.store(acc, L.lda);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += WARPS) {
    const int n = r0 + r;
    float* dy = acc + r * L.lda;
    if (n >= N) {
      for (int c = lane; c < d; c += 32) dy[c] = 0.f;
      continue;
    }
    T* out = dx + static_cast<long>(n) * d;
    if constexpr (!NORM) {
      for (int c = lane; c < d; c += 32) out[c] = rtt::from_f32<T>(dy[c]);
    } else {
      const T* xr = x + static_cast<long>(n) * d;
      const float rs = rstd[n];
      float dot = 0.f;
      for (int c = lane; c < d; c += 32)
        dot += dy[c] * rtt::to_f32(scale[c]) * (rtt::to_f32(xr[c]) * rs);
      const float mean = rtt::warp_sum(dot) / static_cast<float>(d);
      for (int c = lane; c < d; c += 32) {
        const float xhat = rtt::to_f32(xr[c]) * rs;
        const float dxhat = dy[c] * rtt::to_f32(scale[c]);
        out[c] = rtt::from_f32<T>(rs * (dxhat - xhat * mean));
        dy[c] = dy[c] * xhat;  // this row's share of dscale
      }
    }
  }
  if constexpr (NORM) {
    __syncthreads();
    // the block's dscale partial: its rows summed in row order
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += acc[r * L.lda + c];
      dsp[static_cast<long>(blockIdx.x) * d + c] = s;
    }
  }
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(THREADS)
    ce_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ tgt, const float* __restrict__ lse,
                 const float* __restrict__ srow, const T* __restrict__ scale,
                 const float* __restrict__ rstd, T* __restrict__ dw, int N,
                 int V) {
  constexpr int BM = Tiles<T>::DW_BM, BV = Tiles<T>::DW_BV;
  constexpr int d = WIDTH;
  const Layout<T> L(BM, BV, BV);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem + L.y);
  T* hs = reinterpret_cast<T*>(smem + L.w);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* dl = reinterpret_cast<T*>(smem + L.dl);
  float* acc = reinterpret_cast<float*>(smem + L.acc);  // dw tile [BV][lda]
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* srow_s = reinterpret_cast<float*>(smem + L.srow);
  int* tgt_s = reinterpret_cast<int*>(smem + L.tgt);

  const int v0 = blockIdx.x * BV;
  rtt::copy_rows(hs, L.ld, w, v0, BV, V, d);
  FragAcc frag;
  if constexpr (kTensorCores<T>)
    frag.zero();
  else
    for (int i = threadIdx.x; i < BV * L.lda; i += blockDim.x) acc[i] = 0.f;

  for (int r0 = 0; r0 < N; r0 += BM) {
    __syncthreads();  // hs loaded; the last step's readers of ys, dl done
    load_rows<T, NORM>(ys, L.ld, lse_s, srow_s, tgt_s, x, lse, srow, tgt,
                       scale, rstd, r0, BM, N);
    __syncthreads();
    scores(S, L, ys, hs, BM, BV);
    __syncthreads();
    form_dl(dl, L, S, lse_s, srow_s, tgt_s, BM, BV, v0, V);
    __syncthreads();
    // dw_tile[BV][d] += dl^T[BV][BM] @ y[BM][d]
    if constexpr (kTensorCores<T>)
      frag.mma<true>(dl, L.ldl, ys, L.ld, BM);
    else
      rtt::block_mma<true, false>(acc, L.lda, dl, L.ldl, ys, L.ld, BV, d, BM,
                                  true);
  }
  if constexpr (kTensorCores<T>) frag.store(acc, L.lda);
  __syncthreads();
  for (int i = threadIdx.x; i < BV * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    if (v0 + r < V)
      dw[static_cast<long>(v0 + r) * d + c] =
          rtt::from_f32<T>(acc[r * L.lda + c]);
  }
}

template <typename T, bool NORM>
int launch(const void* x, const void* w, const void* tgt, const void* lse,
           const void* srow, const void* scale, const void* rstd, void* dx,
           void* dw, void* dsp, void* dscale, int N, int d, int V,
           cudaStream_t stream) {
  using TT = Tiles<T>;
  const size_t smem_dx = Layout<T>(TT::DX_BM, TT::DX_BV, TT::DX_BM).total;
  const size_t smem_dw = Layout<T>(TT::DW_BM, TT::DW_BV, TT::DW_BV).total;
  cudaError_t err = cudaFuncSetAttribute(
      ce_dx_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dx));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ce_dw_kernel<T, NORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dw));
  if (err != cudaSuccess) return static_cast<int>(err);

  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* tp = static_cast<const int*>(tgt);
  const float* lp = static_cast<const float*>(lse);
  const float* sp = static_cast<const float*>(srow);
  const T* scp = static_cast<const T*>(scale);
  const float* rp = static_cast<const float*>(rstd);
  const int n_blk = (N + TT::DX_BM - 1) / TT::DX_BM;
  ce_dx_kernel<T, NORM><<<n_blk, THREADS, smem_dx, stream>>>(
      xp, wp, tp, lp, sp, scp, rp, static_cast<T*>(dx),
      static_cast<float*>(dsp), N, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_dw_kernel<T, NORM><<<(V + TT::DW_BV - 1) / TT::DW_BV, THREADS, smem_dw,
                          stream>>>(xp, wp, tp, lp, sp, scp, rp,
                                    static_cast<T*>(dw), N, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NORM)
    return rtt::launch_column_sum(static_cast<const float*>(dsp),
                                  static_cast<float*>(dscale), n_blk, d,
                                  stream);
  return 0;
}

template <typename T>
int dispatch(const void* x, const void* w, const void* tgt, const void* lse,
             const void* srow, const void* scale, const void* rstd, void* dx,
             void* dw, void* dsp, void* dscale, int N, int d, int V, int norm,
             cudaStream_t st) {
  if (norm)
    return launch<T, true>(x, w, tgt, lse, srow, scale, rstd, dx, dw, dsp,
                           dscale, N, d, V, st);
  return launch<T, false>(x, w, tgt, lse, srow, scale, rstd, dx, dw, dsp,
                          dscale, N, d, V, st);
}

}  // namespace

// dx [N, d] and dw = dhead^T [V, d] in the storage dtype.  With norm != 0
// (the prologue): scale [d] and rstd [N] are read, dsp is f32 scratch of
// at least ceil(N / 16) x d, and dscale [d] (f32) is written.
extern "C" int flash_ce_bwd(const void* x, const void* w, const void* tgt,
                            const void* lse, const void* srow,
                            const void* scale, const void* rstd, void* dx,
                            void* dw, void* dsp, void* dscale, int N, int d,
                            int V, int norm, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (d != WIDTH || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return dispatch<__nv_bfloat16>(x, w, tgt, lse, srow, scale, rstd, dx, dw,
                                   dsp, dscale, N, d, V, norm, st);
  if (dtype == rtt::kF32)
    return dispatch<float>(x, w, tgt, lse, srow, scale, rstd, dx, dw, dsp,
                           dscale, N, d, V, norm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
