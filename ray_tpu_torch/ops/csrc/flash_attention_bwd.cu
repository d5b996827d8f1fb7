// Causal flash-attention backward.
//
// Replaces: ray_tpu/ops/attention.py:_bwd (bodies _bwd_fused_kernel,
// _bwd_dq_kernel, _bwd_dkv_kernel) and its lane-packed twin _bwd_pack2
// (body _bwd_pack2_kernel).  Pack2 is a TPU lane layout with no Hopper
// meaning, so one kernel serves both.  Instantiated for head_dim 64.
//
// Computes, for q, k, v, o, do [B, S, H, D] (model layout, bf16 or f32) and
// the forward's lse [B, H, S] (f32), with the reference's rounding points
// (attention.py:187-201, :634-642):
//   delta = rowsum(do * o)                          (f32, flash_delta_kernel)
//   s     = q k^T * scale, causal;  p = exp(s - lse)          (f32)
//   dp    = do v^T;  ds = p * (dp - delta) * scale            (f32)
//   dv    = p^T do,  dk = ds^T q,  dq = ds k   with p and ds rounded to the
//           storage dtype before each product, f32 accumulation
// With the RoPE tables cos2, sinm [S, D], q and k are rotated as they are
// loaded (attention.py:_rot), so the scores and products see the rotated
// q and k, and dq and dk take the transposed rotation _rot_t (:158),
// g * cos2 - roll(g, D/2) * sinm, on their f32 sums before the store.
//
// The cross-block reductions, and the choice made for them: dk and dv
// are sums over the q rows, dq a sum over the k rows.  The TPU kernel
// carried dk/dv in VMEM across a sequential sweep of q blocks; Hopper
// blocks run in no order, so that carry does not translate.  Here each
// gradient has one owner and is never reduced across blocks:
// flash_dkv_kernel owns one 64-row k tile and walks the live q tiles
// (those at or below the diagonal), and flash_dq_kernel owns one 64-row q
// tile and walks the live k tiles.  The score and dp tiles are computed
// in both (7 tile products per live pair instead of 5), and in exchange
// there are no f32 atomics into dq: the result is deterministic and
// equal from run to run.  Causally dead tiles are never loaded.
//
// What bounds it on an H100: at [24, 1024, 12, 64] the work is ~2.5x the
// forward's flops over ~8 S*H*D-sized tensors, compute-bound on paper;
// like the forward, this first kernel runs on CUDA-core FMAs (each
// thread a 4x4 micro-tile of the score tile and 4 x D/16 of its
// gradients), so its own FMA rate bounds it.  Tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 micro-tiles

template <int D>
constexpr size_t smem_bytes() {
  // four [64][D+1] f32 operand tiles, two [64][65] f32 tiles of p / ds
  // (the dq kernel uses one), two [64] row statistics
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (BK + 1) + 2 * 64);
}

// delta[b, h, s] = sum_d do * o: one warp per (b, s, h) row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int S, int H) {
  const long row = static_cast<long>(blockIdx.x) * (THREADS / 32) +
                   (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += rtt::to_f32(dout[row * D + c]) * rtt::to_f32(o[row * D + c]);
  acc = rtt::warp_sum(acc);
  if (lane == 0) {
    const long h = row % H, s = (row / H) % S, b = row / (static_cast<long>(H) * S);
    delta[(b * H + h) * S + s] = acc;
  }
}

// the transposed rotation of one thread's 4 x D/16 f32 sums for a row at
// position pos (columns tx + 16 j; the partner column c + D/2 is the same
// thread's j + D/32), then the store in the storage type
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void store_row(T* out, const float (&g)[D / 16],
                                          const T* cos2, const T* sinm,
                                          int pos, int tx) {
  constexpr int DJ = D / 16;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int c = tx + 16 * j;
    float val = g[j];
    if constexpr (ROPE) {
      const long t = static_cast<long>(pos) * D + c;
      val = __fsub_rn(__fmul_rn(g[j], rtt::to_f32(cos2[t])),
                      __fmul_rn(g[(j + DJ / 2) % DJ], rtt::to_f32(sinm[t])));
    }
    out[c] = rtt::from_f32<T>(val);
  }
}

// one thread's 4x4 block of A B^T over D: a rows 4ty + i of As, b rows
// tx + 16 j of Bs (both [64][D+1])
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* As,
                                         const float* Bs, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[(4 * ty + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// rows [r0, r0 + 64) of x [B, S, H, D] at (b, h) into xs [64][D+1] as f32
// (rotated under ROPE), zero past S
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void load_tile(float* xs, const T* __restrict__ x,
                                          long base, long rs, int r0, int S,
                                          const T* cos2, const T* sinm) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    xs[r * (D + 1) + c] =
        r0 + r < S
            ? rtt::load_rot<T, D, ROPE>(x + base + (r0 + r) * rs, cos2, sinm,
                                        r0 + r, c)
            : 0.f;
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const T* __restrict__ cos2, const T* __restrict__ sinm,
                    T* __restrict__ dq, int S, int H, float scale) {
  constexpr int DP = D + 1, PP = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][DP]
  float* dos = qs + BQ * DP;   // [BQ][DP]
  float* ks = dos + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* ds_s = vs + BK * DP;  // [BQ][PP]
  float* lse_s = ds_s + BQ * PP;
  float* dl_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const long srow = (static_cast<long>(b) * H + h) * S;

  load_tile<T, D, ROPE>(qs, q, base, rs, q0, S, cos2, sinm);
  load_tile<T, D, false>(dos, dout, base, rs, q0, S, cos2, sinm);
  for (int r = tid; r < BQ; r += THREADS) {
    lse_s[r] = q0 + r < S ? lse[srow + q0 + r] : 0.f;
    dl_s[r] = q0 + r < S ? delta[srow + q0 + r] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = q_last / BK + 1;  // causal: k tiles with k0 <= q_last
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers of ks, vs, ds_s are done
    load_tile<T, D, ROPE>(ks, k, base, rs, k0, S, cos2, sinm);
    load_tile<T, D, false>(vs, v, base, rs, k0, S, cos2, sinm);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
    dot_tile<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj <= qi && kj < S && qi < S;
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * PP + tx + 16 * j] =
            rtt::round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], c[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds_s[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) c[j] = ks[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += a[i] * c[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi < S)
      store_row<T, D, ROPE>(dq + base + qi * rs, acc[i], cos2, sinm, qi, tx);
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const T* __restrict__ cos2, const T* __restrict__ sinm,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                     float scale) {
  constexpr int DP = D + 1, PP = BQ + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;            // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* qs = vs + BK * DP;    // [BQ][DP]
  float* dos = qs + BQ * DP;   // [BQ][DP]
  float* pt = dos + BQ * DP;   // p^T  [BK][PP]
  float* dst = pt + BK * PP;   // ds^T [BK][PP]
  float* lse_s = dst + BK * PP;
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const long srow = (static_cast<long>(b) * H + h) * S;

  load_tile<T, D, ROPE>(ks, k, base, rs, k0, S, cos2, sinm);
  load_tile<T, D, false>(vs, v, base, rs, k0, S, cos2, sinm);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = k0 / BQ; qt < n_qt; ++qt) {  // causal: q tiles from k0 on
    const int q0 = qt * BQ;
    __syncthreads();  // the last tile's readers of qs, dos, pt, dst are done
    load_tile<T, D, ROPE>(qs, q, base, rs, q0, S, cos2, sinm);
    load_tile<T, D, false>(dos, dout, base, rs, q0, S, cos2, sinm);
    for (int r = tid; r < BQ; r += THREADS) {
      lse_s[r] = q0 + r < S ? lse[srow + q0 + r] : 0.f;
      dl_s[r] = q0 + r < S ? delta[srow + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed tiles: this thread's k rows 4ty + i against q rows
    // tx + 16 j
    float st[4][4], dpt[4][4];
    dot_tile<D>(st, ks, qs, ty, tx);
    dot_tile<D>(dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, qc = q0 + c;
        const bool live = kr <= qc && qc < S && kr < S;
        const float p = live ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        pt[(4 * ty + i) * PP + c] = rtt::round_to<T>(p);
        dst[(4 * ty + i) * PP + c] =
            rtt::round_to<T>(p * (dpt[i][j] - dl_s[c]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float a[4], g[4], cd[DJ], cq[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = pt[(4 * ty + i) * PP + qq];
        g[i] = dst[(4 * ty + i) * PP + qq];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        cd[j] = dos[qq * DP + tx + 16 * j];
        cq[j] = qs[qq * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] += a[i] * cd[j];
          adk[i][j] += g[i] * cq[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + 4 * ty + i;
    if (kr < S) {
      store_row<T, D, ROPE>(dk + base + kr * rs, adk[i], cos2, sinm, kr, tx);
      store_row<T, D, false>(dv + base + kr * rs, adv[i], cos2, sinm, kr, tx);
    }
  }
}

template <typename T, int D, bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* cos2,
           const void* sinm, void* dq, void* dk, void* dv, void* delta, int B,
           int S, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D, ROPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_dkv_kernel<T, D, ROPE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const T* cp = static_cast<const T*>(cos2);
  const T* sp = static_cast<const T*>(sinm);
  float* dlp = static_cast<float*>(delta);

  const long rows = static_cast<long>(B) * S * H;
  const int per_block = THREADS / 32;
  flash_delta_kernel<T, D>
      <<<static_cast<int>((rows + per_block - 1) / per_block), THREADS, 0,
         stream>>>(static_cast<const T*>(o), dop, dlp, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + 63) / 64, H, B);
  flash_dq_kernel<T, D, ROPE><<<grid, THREADS, smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, cp, sp, static_cast<T*>(dq), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<T, D, ROPE><<<grid, THREADS, smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, cp, sp, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, const void* cos2,
             const void* sinm, void* dq, void* dk, void* dv, void* delta,
             int B, int S, int H, float scale, cudaStream_t st) {
  if (cos2 != nullptr)
    return launch<T, 64, true>(q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv,
                               delta, B, S, H, scale, st);
  return launch<T, 64, false>(q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv,
                              delta, B, S, H, scale, st);
}

}  // namespace

// dq, dk, dv [B, S, H, D] in the storage dtype; delta is f32 scratch of
// B * H * S.  cos2 and sinm [S, D] select the in-kernel RoPE (null: none).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* cos2, const void* sinm,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int S, int H, int D, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, cos2, sinm, dq, dk,
                                   dv, delta, B, S, H, scale, st);
  if (dtype == rtt::kF32)
    return dispatch<float>(q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv,
                           delta, B, S, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
