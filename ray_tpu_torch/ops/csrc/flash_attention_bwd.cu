// Flash-attention backward, causal or not.
//
// Replaces: ray_tpu/ops/attention.py:_bwd (bodies _bwd_fused_kernel,
// _bwd_dq_kernel, _bwd_dkv_kernel) and its lane-packed twin _bwd_pack2
// (body _bwd_pack2_kernel).  Pack2 is a TPU lane layout with no Hopper
// meaning, so one entry point serves both.  Instantiated for head_dim 64
// (GPT-2's), 16 (GPTConfig.tiny's) and 128 (Llama's, Mistral's,
// Qwen2's).
//
// Computes, for q, k, v, o, do [B, S, H, D] (model layout, bf16 or f32) and
// the forward's lse [B, H, S] (f32), with the reference's rounding points
// (attention.py:187-201, :634-642):
//   delta = rowsum(do * o)                                      (f32)
//   s     = q k^T * scale [causal];  p = exp(s - lse)         (f32)
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
// gradient has one owner and is never reduced across blocks: a dk/dv
// kernel owns one 64-row k tile and walks the live q tiles (causal:
// those at or below the diagonal; otherwise all), and a dq kernel owns
// one 64-row q tile and walks the live k tiles.  The score and dp tiles
// are computed in both (7 tile products per live pair instead of 5), and
// in exchange there are no f32 atomics into dq: the result is
// deterministic and equal from run to run.  Causally dead tiles are
// never loaded.
//
// What bounds it on an H100: at [24, 1024, 12, 64] the work is ~2.5x the
// forward's flops over ~8 S*H*D-sized tensors, bound by the bf16 tensor
// cores.
//
// Two designs, chosen by dtype and head dim:
// - bf16 at head_dim 64 and 128: flash_dq_tc_kernel / flash_dkv_tc_kernel
//   on the tensor cores (mma.sync m16n8k16, below).
// - f32, and bf16 at head_dim 16: flash_dq_kernel / flash_dkv_kernel,
//   CUDA-core FMAs in f32 with the storage dtype's rounding points (each
//   thread a 4x4 micro-tile of the score tile and 4 x D/16 of its
//   gradients); in f32 held to the plain version at summation-order
//   bounds.
// CAUSAL, a template flag of every kernel, selects the mask; without it
// (causal=False) the dq kernels mask the last key tile's columns past S
// explicitly (see the tensor-core notes below for the dk/dv side).
#include "common.cuh"
#include "hopper.cuh"

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

// delta[b, h, s] = sum_d do * o: one thread per (b, s, h) row, summed
// over d in dot_tile's order, so that a row whose o is its one key's v
// (the first row) has dp - delta = 0 exactly and a dq of exactly 0
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int S, int H) {
  const long row = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c)
    acc += rtt::to_f32(dout[row * D + c]) * rtt::to_f32(o[row * D + c]);
  const long h = row % H, s = (row / H) % S, b = row / (static_cast<long>(H) * S);
  delta[(b * H + h) * S + s] = acc;
}

// the partner sums of one thread's 4 x D/16 f32 sums under the D/2 roll:
// column c + D/2 of a row is the same thread's j + D/32 when a thread
// holds two or more columns (D >= 32), and at D = 16 the one column of
// the thread tx ^ 8, lane ^ 8 of the same warp.  Called by every thread
// of the block (the shuffle), before any row is dropped.
template <int D>
__device__ __forceinline__ void partner_sums(const float (&g)[D / 16],
                                             float (&gp)[D / 16]) {
  constexpr int DJ = D / 16;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    if constexpr (DJ >= 2)
      gp[j] = g[(j + DJ / 2) % DJ];
    else
      gp[j] = __shfl_xor_sync(0xffffffffu, g[j], 8);
  }
}

// the transposed rotation of one thread's 4 x D/16 f32 sums g for a row
// at position pos (columns tx + 16 j; gp their partner_sums), then the
// store in the storage type
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void store_row(T* out, const float (&g)[D / 16],
                                          const float (&gp)[D / 16],
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
                      __fmul_rn(gp[j], rtt::to_f32(sinm[t])));
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

template <typename T, int D, bool ROPE, bool CAUSAL>
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
  // causal: the k tiles with k0 <= q_last; otherwise all of them
  const int n_kt = CAUSAL ? q_last / BK + 1 : (S + BK - 1) / BK;
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
        const bool live = (!CAUSAL || kj <= qi) && kj < S && qi < S;
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
    float gp[DJ];
    partner_sums<D>(acc[i], gp);
    if (qi < S)
      store_row<T, D, ROPE>(dq + base + qi * rs, acc[i], gp, cos2, sinm, qi,
                            tx);
  }
}

template <typename T, int D, bool ROPE, bool CAUSAL>
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
  // causal: the q tiles from k0 on; otherwise all of them
  for (int qt = CAUSAL ? k0 / BQ : 0; qt < n_qt; ++qt) {
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
        const bool live = (!CAUSAL || kr <= qc) && qc < S && kr < S;
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
    float gp[DJ];
    partner_sums<D>(adk[i], gp);
    if (kr < S) {
      store_row<T, D, ROPE>(dk + base + kr * rs, adk[i], gp, cos2, sinm, kr,
                            tx);
      store_row<T, D, false>(dv + base + kr * rs, adv[i], adv[i], cos2, sinm,
                             kr, tx);
    }
  }
}

template <typename T, int D, bool ROPE, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* cos2,
           const void* sinm, void* dq, void* dk, void* dv, void* delta, int B,
           int S, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D, ROPE, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_dkv_kernel<T, D, ROPE, CAUSAL>,
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
  flash_delta_kernel<T, D>
      <<<static_cast<int>((rows + THREADS - 1) / THREADS), THREADS, 0,
         stream>>>(static_cast<const T*>(o), dop, dlp, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + 63) / 64, H, B);
  flash_dq_kernel<T, D, ROPE, CAUSAL><<<grid, THREADS, smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, cp, sp, static_cast<T*>(dq), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<T, D, ROPE, CAUSAL><<<grid, THREADS, smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, cp, sp, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool CAUSAL>
int dispatch_cuda_cores(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        const void* cos2, const void* sinm, void* dq,
                        void* dk, void* dv, void* delta, int B, int S, int H,
                        float scale, cudaStream_t st) {
  if (cos2 != nullptr)
    return launch<T, D, true, CAUSAL>(q, k, v, o, dout, lse, cos2, sinm, dq,
                                      dk, dv, delta, B, S, H, scale, st);
  return launch<T, D, false, CAUSAL>(q, k, v, o, dout, lse, cos2, sinm, dq,
                                     dk, dv, delta, B, S, H, scale, st);
}

// ---------------------------------------------------------------------------
// bf16: warp MMA (mma.sync m16n8k16) with register-resident tiles
// ---------------------------------------------------------------------------
//
// Both kernels: a block of 4 warps (128 threads) owns 64 rows, each warp
// 16 of them, and walks 64-row tiles of the other side.  Every product
// runs on the tensor cores with f32 accumulators in registers: operands
// come from shared memory through ldmatrix (plain for a B stored [n][k],
// .trans for a B stored [k][n]), and p and ds go from the accumulators of
// one product, rounded to bf16, straight into the A registers of the
// next (no shared-memory round trip).
//
// flash_dq_tc_kernel, owning a q tile:  S = Q K^T, dP = dO V^T; p and ds
//   on the fragments with lse and delta per row (registers); dQ += dS K.
//   It takes delta = rowsum(dO * O) itself, on the tensor cores, and
//   writes it for the dk/dv kernel (the f32 path's flash_delta_kernel
//   has no bf16 launch; row_dots says why).
// flash_dkv_tc_kernel, owning a k tile: S^T = K Q^T, dP^T = V dO^T; p^T
//   and ds^T with lse and delta per q column (staged in shared memory per
//   q tile); dV += P^T dO, dK += dS^T Q.
// Under CAUSAL only the diagonal tile pair is masked.  Rows past S are
// zero-filled on load and their lse/delta read as 0: a q row past S then
// has p = 1 and ds = 0 against a zero dO row, so it adds exactly 0 to dk
// and dv; a key past S appears only in the diagonal tile, where the
// causal mask drops it; rows past S are never stored.  Without CAUSAL
// the dq kernel masks the columns past S of its last key tile (p = 0,
// so ds = 0); the dk/dv kernel needs no mask: its keys past S are its
// own rows, never stored, and its q columns past S add exactly 0 as
// above.
// Loads: cp.async with zero fill, 2 stages (the next tile's copy overlaps
// this tile's products).  Rows are padded to D + 8 bf16 (144 bytes at
// D = 64, 272 at 128), so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups.  RoPE rotates the landed rows in place before the
// block barrier (ldmatrix reads through the generic proxy, so no proxy
// fence).  dq and dk take _rot_t at the store: column c + D/2's partner
// is the same thread's accumulator in n-tile j + D/16, so the rotation
// needs no shuffle.  At D = 128 the score tiles are the same 64 x 64;
// the products over D take twice the k steps, and dQ += dS K, dV, dK
// twice the n tiles (the dk/dv kernel's two [16][128] accumulators a
// warp: 128 registers of a thread's 255).  The grid runs the
// longest tiles first (the last q tiles for dq, the first k tiles for
// dk/dv), with the tiles of a head adjacent in the grid so that the
// blocks in flight together share that head's rows in L2.

namespace tc_bwd {

using namespace rtt;

constexpr int THREADS = 128;                 // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// The shapes at head dim D (64 or 128): rows padded to D + 8 bf16 (144
// or 272 bytes, an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads fall in 8 distinct bank groups); dq's tiles Q, dO, O,
// K x 2, V x 2; dk/dv's K, V, Q x 2, dO x 2, then lse and delta x 2
// stages (64 f32 each); under RoPE the table rows of the tile each
// iteration rotates (64 rows of cos2 | sinm, 4 D bytes each).
template <int D>
struct Geo {
  static constexpr int LD = D + 8;              // padded row, in bf16
  static constexpr int TILE = 64 * LD * 2;      // one [64][LD] bf16 tile
  static constexpr int CH = D / 16;             // RoPE chunk pairs a row
  static constexpr int NJ = D / 8;              // 8-column tiles of D
  static constexpr size_t SMEM_DQ = 7 * TILE;
  static constexpr size_t SMEM_DKV = 6 * TILE + 4 * 64 * 4;
  static constexpr int TTILE = 64 * 4 * D;
};
template <bool ROPE, int D>
constexpr size_t smem_bytes(size_t tiles) {
  return tiles + (ROPE ? Geo<D>::TTILE : 0);
}

// byte offset of element (r, c) of a padded tile
template <int D>
__device__ __forceinline__ uint32_t off(int r, int c) {
  return (r * Geo<D>::LD + c) * 2;
}

// rows [r0, r0 + 64) of x at (b, h) into the tile at dst, zero past S;
// thread t copies chunks j and j + D / 16 of row r, (r, j) = divmod(t +
// 128 i, D / 16), the pairs its RoPE rotates (columns c and c + D / 2)
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* x, long base,
                                          long rs, int r0, int S) {
  constexpr int CH = Geo<D>::CH;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const unsigned p = threadIdx.x + THREADS * i;
    const int r = p / CH, j = p % CH;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* src = x + base + (ok ? (r0 + r) * rs : 0);
    tc::cp_async16(dst + off<D>(r, 8 * j), src + 8 * j, ok);
    tc::cp_async16(dst + off<D>(r, 8 * j + D / 2), src + 8 * j + D / 2, ok);
  }
}

// byte offset of chunk c of table row r's half (0 cos2, 1 sinm); odd
// rows swap chunk groups so one 8-thread phase hits distinct banks
template <int D>
__device__ __forceinline__ uint32_t tab(int r, int half, int c) {
  return r * (4 * D) + half * (2 * D) + ((c ^ ((r & 1) << 2)) << 4);
}

// this thread's chunks of the RoPE table rows [r0, r0 + 64) into the
// table tile at dst: the rows a later rotate_tile<true> reads
template <int D>
__device__ __forceinline__ void load_table(uint32_t dst,
                                           const __nv_bfloat16* cos2,
                                           const __nv_bfloat16* sinm, int r0,
                                           int S) {
  constexpr int CH = Geo<D>::CH;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const unsigned p = threadIdx.x + THREADS * i;
    const int r = p / CH, j = p % CH;
    const bool ok = r0 + r < S;
    const long row = ok ? (r0 + r) * static_cast<long>(D) : 0;
#pragma unroll
    for (int c = j; c < 2 * CH; c += CH) {
      tc::cp_async16(dst + tab<D>(r, 0, c), cos2 + row + 8 * c, ok);
      tc::cp_async16(dst + tab<D>(r, 1, c), sinm + row + 8 * c, ok);
    }
  }
}

// the RoPE of this thread's landed chunks of a tile, in place, with the
// table rows from the table tile or (once per block) device memory
template <bool FROM_SMEM, int D>
__device__ __forceinline__ void rotate_tile(uint8_t* tile,
                                            const uint8_t* table,
                                            const __nv_bfloat16* cos2,
                                            const __nv_bfloat16* sinm, int r0,
                                            int S) {
  constexpr int CH = Geo<D>::CH;
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const unsigned p = threadIdx.x + THREADS * i;
    const int r = p / CH, j = p % CH;
    if (r0 + r >= S) continue;
    uint4& lo = *reinterpret_cast<uint4*>(tile + off<D>(r, 8 * j));
    uint4& hi = *reinterpret_cast<uint4*>(tile + off<D>(r, 8 * j + D / 2));
    if constexpr (FROM_SMEM) {
      auto t = [&](int half, int c) {
        return *reinterpret_cast<const uint4*>(table + tab<D>(r, half, c));
      };
      rope_chunks(lo, hi, t(0, j), t(0, j + CH), t(1, j), t(1, j + CH));
    } else {
      rope_chunks<D>(lo, hi, cos2, sinm, r0 + r, j);
    }
  }
}

// c[16][64] = A B^T over D for this warp's 16 rows of A [64][LD] and all
// 64 rows of B [64][LD] (both k = d contiguous): c[j][2 i + e] is row
// lane / 4 + 8 i, column 8 j + 2 (lane % 4) + e
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], uint32_t sa,
                                        uint32_t sb, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, sa + off<D>(16 * warp + (lane & 15),
                                   16 * kk + 8 * (lane >> 4)));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, sb + off<D>(16 * jj + 8 * (lane >> 4) + (lane & 7),
                                     16 * kk + 8 * ((lane >> 3) & 1)));
      tc::mma_m16n8k16(c[2 * jj], a, b[0], b[1]);
      tc::mma_m16n8k16(c[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// c[16][D] += A B for A this warp's 16 x 64 (k) in registers (a[kk] the
// k-step kk) and B [64 (k)][LD] in shared memory (n = d contiguous)
template <int D>
__device__ __forceinline__ void mma_ab(float (&c)[D / 8][4],
                                       const uint32_t (&a)[4][4], uint32_t sb,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, sb + off<D>(16 * kk + 8 * ((lane >> 3) & 1) +
                                               (lane & 7),
                                           16 * jj + 8 * (lane >> 4)));
      tc::mma_m16n8k16(c[2 * jj], a[kk], b[0], b[1]);
      tc::mma_m16n8k16(c[2 * jj + 1], a[kk], b[2], b[3]);
    }
}

// this thread's rows of a [64][D] f32 accumulator (row r0 + row0 + 8 i,
// columns 8 j + col0 + {0, 1}) to out [B, S, H, D] in bf16, under ROPE
// with the transposed rotation at each row's position: column c + D / 2's
// partner is the same thread's accumulator in n-tile j + D / 16, so the
// rotation needs no shuffle
template <bool ROPE, int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&g)[D / 8][4],
                                           long base, long rs, int r0,
                                           int row0, int col0, int S,
                                           const __nv_bfloat16* cos2,
                                           const __nv_bfloat16* sinm) {
  constexpr int NJ = Geo<D>::NJ;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = r0 + row0 + 8 * i;
    if (pos >= S) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(out + base + pos * rs + col0);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v0 = g[j][2 * i], v1 = g[j][2 * i + 1];
      if constexpr (ROPE) {
        const long t = pos * static_cast<long>(D) + 8 * j + col0;
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cos2 + t));
        const float2 s = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sinm + t));
        const int pj = (j + NJ / 2) % NJ;  // column c + D / 2 (mod D)
        v0 = __fsub_rn(__fmul_rn(v0, c.x), __fmul_rn(g[pj][2 * i], s.x));
        v1 = __fsub_rn(__fmul_rn(v1, c.y), __fmul_rn(g[pj][2 * i + 1], s.y));
      }
      row[4 * j] = tc::pack_bf16(v0, v1);
    }
  }
}

// delta = rowsum(dO * O) for this warp's 16 rows of dO and O [64][LD],
// on the tensor cores: the diagonal of the warp's 16 x 16 block of
// dO O^T.  It is taken with the operand positions and k order of
// mma_abt's dP = dO V^T, so where o = v exactly (the first row of a
// sequence attends to one key) delta equals dp bit for bit and ds, and
// with it the analytically zero dq of that row, is exactly 0.
template <int D>
__device__ __forceinline__ void row_dots(float (&dl)[2], uint32_t sa,
                                         uint32_t sb, int warp, int lane) {
  float c[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    tc::ldmatrix_x4(a, sa + off<D>(16 * warp + (lane & 15),
                                   16 * kk + 8 * (lane >> 4)));
    tc::ldmatrix_x4(b, sb + off<D>(16 * warp + 8 * (lane >> 4) + (lane & 7),
                                   16 * kk + 8 * ((lane >> 3) & 1)));
    tc::mma_m16n8k16(c[0], a, b[0], b[1]);
    tc::mma_m16n8k16(c[1], a, b[2], b[3]);
  }
  // row lane / 4 + 8 i meets its own column in n-tile i at column lane / 4,
  // held by quad lane (lane / 4) / 2 at index 2 i + (lane / 4) % 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float cand = (lane >> 2) & 1 ? c[i][2 * i + 1] : c[i][2 * i];
    dl[i] = __shfl_sync(0xffffffffu, cand, (lane & ~3) | (lane >> 3));
  }
}

// Also writes delta [B, H, S] for flash_dkv_tc_kernel, launched after it.
template <bool ROPE, bool CAUSAL, int D>
__global__ void __launch_bounds__(THREADS)
    flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta,
                       const __nv_bfloat16* __restrict__ cos2,
                       const __nv_bfloat16* __restrict__ sinm,
                       __nv_bfloat16* __restrict__ dq, int S, int H,
                       float scale) {
  using G = Geo<D>;
  constexpr int TILE = G::TILE;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  // tiles at s0 + TILE * t: t = 0 Q, 1 dO, 2 O, 3 + st K stage st, 5 + st V

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest q tiles first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const long srow = (static_cast<long>(b) * H + h) * S;
  const float sl2 = scale * kLog2e;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  // causal: the k tiles up to the diagonal (qt); otherwise all, the last
  // masked at S when S % 64 != 0
  const int n_kt = CAUSAL ? qt + 1 : (S + 63) / 64;
  const int kt_edge = S & 63 ? n_kt - 1 : n_kt;  // no edge tile: none

  load_tile<D>(s0, q, base, rs, q0, S);
  load_tile<D>(s0 + TILE, dout, base, rs, q0, S);
  load_tile<D>(s0 + 2 * TILE, o, base, rs, q0, S);
  load_tile<D>(s0 + 3 * TILE, k, base, rs, 0, S);
  load_tile<D>(s0 + 5 * TILE, v, base, rs, 0, S);
  if constexpr (ROPE) load_table<D>(s0 + G::SMEM_DQ, cos2, sinm, 0, S);
  tc::cp_async_commit();

  float lse2[2], dl[2];  // this thread's two rows: lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    lse2[i] = qi < S ? lse[srow + qi] * kLog2e : 0.f;
  }
  float acc[G::NJ][4];
#pragma unroll
  for (int j = 0; j < G::NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    tc::cp_async_wait<0>();  // this tile landed
    if constexpr (ROPE) {
      if (kt == 0)
        rotate_tile<false, D>(smem_tc, nullptr, cos2, sinm, q0, S);
      rotate_tile<true, D>(smem_tc + TILE * (3 + st), smem_tc + G::SMEM_DQ,
                           cos2, sinm, kt * 64, S);
    }
    // the next tile into the other stage (read by the previous iteration,
    // whose closing barrier every thread has passed), and its table rows
    // over this tile's, which this thread alone has read
    if (kt + 1 < n_kt) {
      load_tile<D>(s0 + TILE * (4 - st), k, base, rs, (kt + 1) * 64, S);
      load_tile<D>(s0 + TILE * (6 - st), v, base, rs, (kt + 1) * 64, S);
      if constexpr (ROPE)
        load_table<D>(s0 + G::SMEM_DQ, cos2, sinm, (kt + 1) * 64, S);
      tc::cp_async_commit();
    }
    __syncthreads();
    if (kt == 0) {
      row_dots<D>(dl, s0 + TILE, s0 + 2 * TILE, warp, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 8 * i;
        if ((lane & 3) == 0 && qi < S) delta[srow + qi] = dl[i];
      }
    }

    const uint32_t sk = s0 + TILE * (3 + st);
    float s[8][4], dp[8][4];
    mma_abt<D>(s, s0, sk, warp, lane);
    mma_abt<D>(dp, s0 + TILE, s0 + TILE * (5 + st), warp, lane);
    const bool diag = CAUSAL && kt == qt;
    const bool edge = !CAUSAL && kt == kt_edge;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * i + e;
          float p = tc::exp2_approx(s[j][x] * sl2 - lse2[i]);
          if (diag && 8 * j + col0 + e > row0 + 8 * i) p = 0.f;
          if (edge && kt * 64 + 8 * j + col0 + e >= S) p = 0.f;
          s[j][x] = p * (dp[j][x] - dl[i]) * scale;  // ds
        }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::a_from_acc(a[kk], &s[2 * kk][0]);
    mma_ab<D>(acc, a, sk, lane);  // dQ += dS K
    __syncthreads();  // every read of this stage is done before its refill
  }
  store_rows<ROPE, D>(dq, acc, base, rs, q0, row0, col0, S, cos2, sinm);
}

template <bool ROPE, bool CAUSAL, int D>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ cos2,
                        const __nv_bfloat16* __restrict__ sinm,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int S, int H,
                        float scale) {
  using G = Geo<D>;
  constexpr int TILE = G::TILE;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  // tiles at s0 + TILE * t: t = 0 K, 1 V, 2 + st Q stage st, 4 + st dO;
  // then lse [2][64] and delta [2][64] (f32)
  const uint32_t s_stats = s0 + 6 * TILE;
  const float* stats = reinterpret_cast<const float*>(smem_tc + 6 * TILE);

  const int kt = blockIdx.x;  // the first k tiles have the most q tiles
  const int h = blockIdx.y, b = blockIdx.z, k0 = kt * 64;
  const int n_qt = (S + 63) / 64;
  const int qt0 = CAUSAL ? kt : 0;  // causal: the q tiles from the diagonal
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const long srow = (static_cast<long>(b) * H + h) * S;
  const float sl2 = scale * kLog2e;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // q tile qt's rows of q and dO, and its lse and delta (thread t copies
  // element t % 64 of lse for t < 64, of delta otherwise), into stage st
  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * 64, c = threadIdx.x & 63;
    load_tile<D>(s0 + TILE * (2 + st), q, base, rs, q0, S);
    load_tile<D>(s0 + TILE * (4 + st), dout, base, rs, q0, S);
    if constexpr (ROPE) load_table<D>(s0 + G::SMEM_DKV, cos2, sinm, q0, S);
    const bool ok = q0 + c < S;
    const float* src = (threadIdx.x < 64 ? lse : delta) + srow + (ok ? q0 + c : 0);
    tc::cp_async4(s_stats + (threadIdx.x < 64 ? 0 : 512) + st * 256 + c * 4,
                  src, ok);
  };

  load_tile<D>(s0, k, base, rs, k0, S);
  load_tile<D>(s0 + TILE, v, base, rs, k0, S);
  load_q_tile(qt0, 0);
  tc::cp_async_commit();

  float adk[G::NJ][4], adv[G::NJ][4];
#pragma unroll
  for (int j = 0; j < G::NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) adk[j][x] = adv[j][x] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    tc::cp_async_wait<0>();  // this tile landed
    if constexpr (ROPE) {
      if (qt == qt0)
        rotate_tile<false, D>(smem_tc, nullptr, cos2, sinm, k0, S);
      rotate_tile<true, D>(smem_tc + TILE * (2 + st), smem_tc + G::SMEM_DKV,
                           cos2, sinm, qt * 64, S);
    }
    // the next tile, as in flash_dq_tc_kernel
    if (qt + 1 < n_qt) {
      load_q_tile(qt + 1, st ^ 1);
      tc::cp_async_commit();
    }
    __syncthreads();

    const uint32_t sq = s0 + TILE * (2 + st), sdo = s0 + TILE * (4 + st);
    float sT[8][4], dpT[8][4];  // [k rows][q columns]
    mma_abt<D>(sT, s0, sq, warp, lane);
    mma_abt<D>(dpT, s0 + TILE, sdo, warp, lane);
    const float* ls = stats + st * 64;
    const float* dls = stats + 128 + st * 64;
    const bool diag = CAUSAL && qt == kt;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + col0 + e;
        const float lc = ls[c] * kLog2e, dc = dls[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 2 * i + e;
          float p = tc::exp2_approx(sT[j][x] * sl2 - lc);
          if (diag && row0 + 8 * i > c) p = 0.f;
          dpT[j][x] = p * (dpT[j][x] - dc) * scale;  // ds^T
          sT[j][x] = p;
        }
      }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::a_from_acc(pa[kk], &sT[2 * kk][0]);
      tc::a_from_acc(da[kk], &dpT[2 * kk][0]);
    }
    mma_ab<D>(adv, pa, sdo, lane);  // dV += P^T dO
    mma_ab<D>(adk, da, sq, lane);   // dK += dS^T Q
    __syncthreads();  // every read of this stage is done before its refill
  }
  store_rows<ROPE, D>(dk, adk, base, rs, k0, row0, col0, S, cos2, sinm);
  store_rows<false, D>(dv, adv, base, rs, k0, row0, col0, S, cos2, sinm);
}

template <bool ROPE, bool CAUSAL, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* cos2,
           const void* sinm, void* dq, void* dk, void* dv, void* delta, int B,
           int S, int H, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem_dq = smem_bytes<ROPE, D>(Geo<D>::SMEM_DQ);
  constexpr size_t smem_dkv = smem_bytes<ROPE, D>(Geo<D>::SMEM_DKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_tc_kernel<ROPE, CAUSAL, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_dkv_tc_kernel<ROPE, CAUSAL, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const bf16* cp = static_cast<const bf16*>(cos2);
  const bf16* sp = static_cast<const bf16*>(sinm);
  float* dlp = static_cast<float*>(delta);

  const dim3 grid((S + 63) / 64, H, B);
  flash_dq_tc_kernel<ROPE, CAUSAL, D><<<grid, THREADS, smem_dq, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), dop, lp, dlp, cp, sp,
      static_cast<bf16*>(dq), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_tc_kernel<ROPE, CAUSAL, D><<<grid, THREADS, smem_dkv, stream>>>(
      qp, kp, vp, dop, lp, dlp, cp, sp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_bwd

template <bool CAUSAL>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, const void* cos2,
             const void* sinm, void* dq, void* dk, void* dv, void* delta,
             int B, int S, int H, int D, float scale, int dtype,
             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (dtype == rtt::kBF16 && D == 64) {
    if (cos2 != nullptr)
      return tc_bwd::launch<true, CAUSAL, 64>(q, k, v, o, dout, lse, cos2,
                                              sinm, dq, dk, dv, delta, B, S,
                                              H, scale, st);
    return tc_bwd::launch<false, CAUSAL, 64>(q, k, v, o, dout, lse, cos2,
                                             sinm, dq, dk, dv, delta, B, S,
                                             H, scale, st);
  }
  if (dtype == rtt::kBF16 && D == 128) {
    if (cos2 != nullptr)
      return tc_bwd::launch<true, CAUSAL, 128>(q, k, v, o, dout, lse, cos2,
                                               sinm, dq, dk, dv, delta, B, S,
                                               H, scale, st);
    return tc_bwd::launch<false, CAUSAL, 128>(q, k, v, o, dout, lse, cos2,
                                              sinm, dq, dk, dv, delta, B, S,
                                              H, scale, st);
  }
  if (dtype == rtt::kBF16 && D == 16)
    return dispatch_cuda_cores<bf16, 16, CAUSAL>(
        q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv, delta, B, S, H, scale,
        st);
  if (dtype == rtt::kF32 && D == 16)
    return dispatch_cuda_cores<float, 16, CAUSAL>(
        q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv, delta, B, S, H, scale,
        st);
  if (dtype == rtt::kF32 && D == 64)
    return dispatch_cuda_cores<float, 64, CAUSAL>(
        q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv, delta, B, S, H, scale,
        st);
  if (dtype == rtt::kF32 && D == 128)
    return dispatch_cuda_cores<float, 128, CAUSAL>(
        q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv, delta, B, S, H, scale,
        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dq, dk, dv [B, S, H, D] in the storage dtype; delta is f32 scratch of
// B * H * S.  cos2 and sinm [S, D] select the in-kernel RoPE (null:
// none); causal 1 masks keys after each query, 0 attends to all S.  D is
// 16, 64 or 128.  bf16 at D = 64 and 128 runs on the tensor cores, the
// rest on the CUDA cores; there is no other switch.  The bf16 kernels read
// 16-byte vectors: q, k, v, dout, cos2 and sinm 16-byte aligned.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* cos2, const void* sinm,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int S, int H, int D, float scale,
                                   int dtype, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return dispatch<true>(q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv,
                          delta, B, S, H, D, scale, dtype, st);
  return dispatch<false>(q, k, v, o, dout, lse, cos2, sinm, dq, dk, dv,
                         delta, B, S, H, D, scale, dtype, st);
}
