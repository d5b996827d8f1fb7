// Flash-CE backward: dx, dhead (and with the prologue, dscale) without
// the [N, V] logits.
//
// Replaces: ray_tpu/ops/flash_ce.py:_bwd_kernel (via _bwd_pallas).
//
// Computes, for the forward's inputs and its saved lse [N] (and rstd [N]
// with the prologue), with srow [N] = d(sum_nll) where the target is live
// and 0 where it is masked:
//   s     = y @ w^T                         (recomputed, f32 acc)
//   dl    = ((exp(s - lse) - onehot(target)) * srow), rounded to the
//           storage dtype (flash_ce.py:329); padded vocab columns give 0
//   dy    = dl @ w                         (f32 accumulation)
//   dw    = dl^T @ y                       (dhead^T [V, d], f32 accumulation)
// Without the prologue dx = dy.  With it (flash_ce.py:341-349), per row
//   xhat = x * rstd, dxhat = dy * scale,
//   dx = rstd * (dxhat - xhat * mean(dxhat * xhat)),
// and dscale = sum over rows of dy * xhat.
//
// What bounds it on an H100: three products of 2*N*d*V flops each (5.7
// TFLOP at the main-path shape, ~5.8 ms at 989 TFLOP/s).
//
// Two instantiations, chosen by dtype alone:
// - bf16 (flash_ce_tc.cuh): the three products as wgmma GEMMs fed by
//   TMA, over row chunks of at most CHUNK_BYTES of dl (2 chunks of 12288
//   rows at the main shape, 1.24 GB of dl each; the reference's own
//   transient there is its [N/1024, d, V] bf16 dhead partials, 1.85 GB).
//   Per chunk: S = y w^T recomputed, its epilogue forming dl in bf16
//   into device memory ([rows, Vp], Vp = V rounded up to the 128-column
//   tile, the padding written as zeros); dy = dl w over the vocab, each
//   128 x 128 tile of dy owned by one block; dw = dl^T y over the
//   chunk's rows, each tile of dw owned by one block, added to the
//   earlier chunks' f32 sum in chunk order and rounded to bf16 once at
//   the last (the running f32 sum split in two 16-bit halves, the high
//   ones in dw itself, so it costs 77 MB and not 155).  With the
//   prologue a row pass writes the chunk's y (bf16) first, the dy product
//   writes f32, and a second row pass takes the norm backward with one
//   dscale partial per 64 rows, summed in a fixed order at the end.  No
//   atomics anywhere: two calls on the same inputs give the same bits.
//   d is a runtime multiple of 128 (the dy and dw column tiles) up to
//   1280 (the row passes hold a row in registers).
// - f32: the first port's kernels on the CUDA cores, d = 768, so that it
//   is held to the plain version at summation-order bounds.  ce_dx_kernel
//   owns BM rows and sweeps the vocab, ce_dw_kernel owns BV vocab rows
//   and sweeps the rows, each recomputing the logits tile (its K split
//   over the warps, rtt::block_mma_ksplit) with the accumulator in shared
//   memory; ce_dx_kernel writes one [d] dscale partial per row block and
//   a column sum adds them in block order.
#include <algorithm>

#include "flash_ce_tc.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 768;  // d, the one model width
constexpr int PARTS = 4;    // K slices of the score tile

// BM rows x BV vocab columns per logits tile, for each kernel
template <typename T> struct Tiles;
template <> struct Tiles<float> {
  static constexpr int DX_BM = 16, DX_BV = 32, DW_BV = 16, DW_BM = 16;
};

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
    rtt::block_mma<false, false>(acc, L.lda, dl, L.ldl, hs, L.ld, BM, d, BV,
                                 true);
  }
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
    rtt::block_mma<true, false>(acc, L.lda, dl, L.ldl, ys, L.ld, BV, d, BM,
                                true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BV * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    if (v0 + r < V)
      dw[static_cast<long>(v0 + r) * d + c] =
          rtt::from_f32<T>(acc[r * L.lda + c]);
  }
}

template <bool NORM>
int launch_f32(const void* x, const void* w, const void* tgt,
               const void* lse, const void* srow, const void* scale,
               const void* rstd, void* dx, void* dw, void* dsp, void* dscale,
               int N, int d, int V, cudaStream_t stream) {
  using T = float;
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

// the f32 kernels' dscale scratch: one [d] partial per dx row block
size_t f32_workspace(int N, int d, int norm) {
  return norm ? static_cast<size_t>(N + Tiles<float>::DX_BM - 1) /
                    Tiles<float>::DX_BM * d * 4
              : 0;
}

// ---------------------------------------------------------------------------
// bf16: wgmma GEMMs over row chunks, and the row passes of the prologue
// ---------------------------------------------------------------------------

namespace tc_bwd {

using namespace tc_ce;

// the most bytes of dl one chunk holds (the reference's dhead partials
// at the main shape take 1.85 GB)
constexpr size_t CHUNK_BYTES = 1850000000;
constexpr int DS_ROWS = 64;  // rows per dscale partial

// rows per chunk and the number of chunks: as few chunks as the budget
// allows, of equal whole row tiles
struct Chunks {
  int rows, count;
  long vp;  // padded vocab width of dl
  Chunks(int N, int V) {
    vp = static_cast<long>((V + BN - 1) / BN) * BN;
    const long most =
        std::max<long>(BM, static_cast<long>(CHUNK_BYTES / (2 * vp)) / BM * BM);
    count = static_cast<int>((N + most - 1) / most);
    rows = static_cast<int>(((N + count - 1) / count + BM - 1) / BM * BM);
    count = (N + rows - 1) / rows;
  }
};

inline size_t up256(size_t b) { return (b + 255) / 256 * 256; }

// the workspace, in order: a chunk's y [rows, d] bf16 and dy [rows, d]
// f32 (prologue), dl [rows, Vp] bf16, the low halves [V, d] of the f32 dw
// sum whose high halves live in dw itself (more than one chunk), the
// dscale partials [N / 64, d] f32 (prologue)
struct Workspace {
  size_t y, dy, dl, lo, dsp, total;
  Workspace(int N, int d, int V, int norm) {
    const Chunks c(N, V);
    const size_t rd = static_cast<size_t>(c.rows) * d;
    y = 0;
    dy = y + (norm ? up256(rd * 2) : 0);
    dl = dy + (norm ? up256(rd * 4) : 0);
    lo = dl + up256(static_cast<size_t>(c.rows) * c.vp * 2);
    dsp = lo + (c.count > 1 ? up256(static_cast<size_t>(V) * d * 2) : 0);
    total = dsp + (norm ? up256(static_cast<size_t>((N + DS_ROWS - 1) /
                                                    DS_ROWS) * d * 4)
                        : 0);
  }
};

// The norm backward as a row pass: dx = rstd (dxhat - xhat mean(dxhat
// xhat)) from the f32 dy, one warp a row, NCH 16-byte chunks a lane; a
// block of 8 warps takes DS_ROWS rows and writes their dscale partial,
// the warps' sums added in warp order.
template <int NCH>
__global__ void __launch_bounds__(256)
    ce_norm_bwd_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ scale,
                       const float* __restrict__ rstd,
                       const float* __restrict__ dy, bf16* __restrict__ dx,
                       float* __restrict__ dsp, int N, int d) {
  extern __shared__ float part[];  // [8][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = d / 8;
  float s[NCH][8], dsc[NCH][8];
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int c = lane + 32 * m;
    if (c < nch) rtt::unpack16(reinterpret_cast<const uint4*>(scale)[c], s[m]);
#pragma unroll
    for (int e = 0; e < 8; ++e) dsc[m][e] = 0.f;
  }
  for (int r = warp; r < DS_ROWS; r += 8) {
    const long n = static_cast<long>(blockIdx.x) * DS_ROWS + r;
    if (n >= N) break;
    const uint4* xr = reinterpret_cast<const uint4*>(x + n * d);
    const float4* gr = reinterpret_cast<const float4*>(dy + n * d);
    const float rs = rstd[n];
    float xh[NCH][8], g[NCH][8], dot = 0.f;
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const int c = lane + 32 * m;
      if (c >= nch) continue;
      rtt::unpack16(xr[c], xh[m]);
      const float4 g0 = gr[2 * c], g1 = gr[2 * c + 1];
      g[m][0] = g0.x; g[m][1] = g0.y; g[m][2] = g0.z; g[m][3] = g0.w;
      g[m][4] = g1.x; g[m][5] = g1.y; g[m][6] = g1.z; g[m][7] = g1.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[m][e] *= rs;
        dot += g[m][e] * s[m][e] * xh[m][e];
        dsc[m][e] += g[m][e] * xh[m][e];
      }
    }
    const float mean = rtt::warp_sum(dot) / static_cast<float>(d);
    uint4* dr = reinterpret_cast<uint4*>(dx + n * d);
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const int c = lane + 32 * m;
      if (c >= nch) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        g[m][e] = rs * (g[m][e] * s[m][e] - xh[m][e] * mean);
      dr[c] = rtt::pack16(g[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    const int c = lane + 32 * m;
    if (c >= nch) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[warp * d + 8 * c + e] = dsc[m][e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += 256) {
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) sum += part[wp * d + c];
    dsp[static_cast<long>(blockIdx.x) * d + c] = sum;
  }
}

// dscale [d] = the sum of the n_parts rows of dsp in a fixed order:
// thread (x, y) of a 32 x 8 block sums rows y, y + 8, ... of column 32 b
// + x, and the 8 sums are added in y order
__global__ void __launch_bounds__(256)
    ce_dscale_sum_kernel(const float* __restrict__ dsp,
                         float* __restrict__ dscale, int n_parts, int d) {
  __shared__ float part[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + x;
  float sum = 0.f;
#pragma unroll 4
  for (int p = y; p < n_parts; p += 8)
    sum += dsp[static_cast<long>(p) * d + c];
  part[y][x] = sum;
  __syncthreads();
  if (y == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += part[i][x];
    dscale[c] = tot;
  }
}

template <int NCH>
int launch_norm_bwd_nch(const bf16* x, const bf16* scale,
                        const float* rstd, const float* dy, bf16* dx,
                        float* dsp, int N, int d, cudaStream_t stream) {
  const int smem = 8 * d * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ce_norm_bwd_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_norm_bwd_kernel<NCH><<<(N + DS_ROWS - 1) / DS_ROWS, 256, smem, stream>>>(
      x, scale, rstd, dy, dx, dsp, N, d);
  return static_cast<int>(cudaGetLastError());
}

int launch_norm_bwd(const bf16* x, const bf16* scale, const float* rstd,
                    const float* dy, bf16* dx, float* dsp, int N, int d,
                    cudaStream_t stream) {
  const int nch = (d / 8 + 31) / 32;  // 16-byte chunks a lane
  if (nch <= 3)
    return launch_norm_bwd_nch<3>(x, scale, rstd, dy, dx, dsp, N, d, stream);
  if (nch == 4)
    return launch_norm_bwd_nch<4>(x, scale, rstd, dy, dx, dsp, N, d, stream);
  return launch_norm_bwd_nch<MAX_CHUNKS>(x, scale, rstd, dy, dx, dsp, N,
                                         d, stream);
}

int launch(const void* x, const void* w, const void* tgt, const void* lse,
           const void* srow, const void* scale, const void* rstd, void* dx,
           void* dw, void* dscale, void* ws, int N, int d, int V, int norm,
           cudaStream_t stream) {
  const Chunks ch(N, V);
  const Workspace L(N, d, V, norm);
  uint8_t* wsp = static_cast<uint8_t*>(ws);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* sb = static_cast<const bf16*>(scale);
  const float* rs = static_cast<const float*>(rstd);
  bf16* dxb = static_cast<bf16*>(dx);
  bf16* yc = reinterpret_cast<bf16*>(wsp + L.y);
  float* dyc = reinterpret_cast<float*>(wsp + L.dy);
  bf16* dl = reinterpret_cast<bf16*>(wsp + L.dl);
  uint16_t* lo = reinterpret_cast<uint16_t*>(wsp + L.lo);
  float* dsp = reinterpret_cast<float*>(wsp + L.dsp);
  CUtensorMap tw;
  if (!tmap(&tw, w, d, V, d)) return static_cast<int>(cudaErrorInvalidValue);
  const int nvt = static_cast<int>(ch.vp / BN);
  for (int c = 0; c < ch.count; ++c) {
    const int r0 = c * ch.rows, rows = std::min(ch.rows, N - r0);
    const long off = static_cast<long>(r0) * d;
    // the chunk's y: the rows of x, or with the prologue their norm
    const bf16* y = xb + off;
    if (norm) {
      ce_norm_rows_kernel<false><<<(rows + 7) / 8, 256, 0, stream>>>(
          xb + off, sb, yc, const_cast<float*>(rs + r0), rows, d, 0.f);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      y = yc;
    }
    CUtensorMap ty, tdl;
    if (!tmap(&ty, y, d, rows, d) ||
        !tmap(&tdl, dl, static_cast<int>(ch.vp), rows, ch.vp))
      return static_cast<int>(cudaErrorInvalidValue);
    // dl = bf16((exp(y w^T - lse) - onehot) srow) for the chunk's rows
    Epi e{};
    e.M = rows;
    e.V = V;
    e.tiles_m = (rows + BM - 1) / BM;
    e.tiles_n = nvt;
    e.steps = d / BK;
    e.tgt = static_cast<const int*>(tgt) + r0;
    e.lse = static_cast<const float*>(lse) + r0;
    e.srow = static_cast<const float*>(srow) + r0;
    int rc = launch_gemm<kLogits, kDl>(ty, tw, tdl, e, stream);
    if (rc) return rc;
    // dy = dl w: f32 for the norm backward, else dx itself
    Epi ex{};
    ex.M = rows;
    ex.tiles_m = (rows + BM - 1) / BM;
    ex.tiles_n = d / BN;
    ex.steps = static_cast<int>(ch.vp / BK);
    ex.ld = d;
    ex.mode = norm ? kF32 : kBF16;
    ex.o32 = dyc;
    ex.o16 = dxb + off;
    rc = launch_gemm<kDx, kStore>(tdl, tw, tdl, ex, stream);
    if (rc) return rc;
    // the norm backward of the chunk's rows and their dscale partials
    // (chunks are whole 128-row tiles, so the 64-row blocks line up)
    if (norm) {
      rc = launch_norm_bwd(xb + off, sb, rs + r0, dyc, dxb + off,
                           dsp + static_cast<long>(r0 / DS_ROWS) * d, rows,
                           d, stream);
      if (rc) return rc;
    }
    // dw (+)= dl^T y, summed over the chunks in order in f32 (split
    // between dw's bf16 halves and lo) and rounded to bf16 at the last
    Epi ew{};
    ew.M = V;
    ew.tiles_m = nvt;
    ew.tiles_n = d / BN;
    ew.steps = (rows + BK - 1) / BK;
    ew.ld = d;
    const bool first = c == 0, last = c == ch.count - 1;
    ew.mode = first ? (last ? kBF16 : kSplit) : (last ? kAddBF16 : kAddSplit);
    ew.o16 = static_cast<bf16*>(dw);
    ew.lo = lo;
    rc = launch_gemm<kDw, kStore>(tdl, ty, tdl, ew, stream);
    if (rc) return rc;
  }
  if (!norm) return 0;
  ce_dscale_sum_kernel<<<d / 32, 256, 0, stream>>>(
      dsp, static_cast<float*>(dscale), (N + DS_ROWS - 1) / DS_ROWS, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_bwd

}  // namespace

// bytes of the workspace flash_ce_bwd takes for this shape
extern "C" long long flash_ce_bwd_workspace(int N, int d, int V, int norm,
                                            int dtype) {
  if (N <= 0) return 0;
  if (dtype == rtt::kBF16)
    return static_cast<long long>(tc_bwd::Workspace(N, d, V, norm).total);
  return static_cast<long long>(f32_workspace(N, d, norm));
}

// rows of one chunk of the bf16 backward (tc_bwd::Chunks) for this shape,
// 0 for f32, which takes no chunks; for reports and checks, no launch
extern "C" long long flash_ce_bwd_chunk_rows(int N, int d, int V, int norm,
                                             int dtype) {
  if (N <= 0 || V <= 0 || dtype != rtt::kBF16) return 0;
  return tc_bwd::Chunks(N, V).rows;
}

// dx [N, d] and dw = dhead^T [V, d] in the storage dtype; with norm != 0
// (the prologue) scale [d] and rstd [N] are read and dscale [d] (f32) is
// written.  ws holds flash_ce_bwd_workspace bytes.  bf16 takes d a
// multiple of 128 up to 1280, every pointer 16-byte aligned; f32 takes
// d = 768.
extern "C" int flash_ce_bwd(const void* x, const void* w, const void* tgt,
                            const void* lse, const void* srow,
                            const void* scale, const void* rstd, void* dx,
                            void* dw, void* dscale, void* ws, int N, int d,
                            int V, int norm, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && d % 128 == 0 && d > 0 && d <= tc_ce::MAX_D)
    return tc_bwd::launch(x, w, tgt, lse, srow, scale, rstd, dx, dw, dscale,
                          ws, N, d, V, norm, st);
  if (dtype == rtt::kF32 && d == WIDTH) {
    if (norm)
      return launch_f32<true>(x, w, tgt, lse, srow, scale, rstd, dx, dw, ws,
                              dscale, N, d, V, st);
    return launch_f32<false>(x, w, tgt, lse, srow, scale, rstd, dx, dw, ws,
                             dscale, N, d, V, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
