// Causal flash-attention forward for prefill and training.
//
// Replaces: ray_tpu/ops/attention.py:_fwd_kernel (via _fwd) and its
// two-head lane-packed sibling _fwd_pack2_kernel (via _fwd_pack2).  The
// pack2 layout exists to fill the TPU's 128-lane matrix unit at
// head_dim 64; Hopper has no such lane constraint, so one entry point
// serves both, at every head count.  It is instantiated for head_dim 64
// (GPT-2's) and 16 (GPTConfig.tiny's); other head dims come with their
// configurations.
//
// Computes, for q, k, v [B, S, H, D] (the model layout, bf16 or f32):
//   o   [B, S, H, D] = softmax(q k^T * scale, causal) v   (storage dtype)
//   lse [B, H, S]    = row logsumexp of the scaled scores (f32, saved for
//                      flash_attention_bwd.cu)
// with the reference's rounding points: scores and statistics in f32,
// p rounded to the value dtype before P.V, l summed from unrounded p.
// With the RoPE tables cos2, sinm [S, D] (the training path's fused RoPE,
// attention.py:_rot :151), q and k are rotated as they are loaded: in
// f32, then rounded to the storage dtype, as the reference rotates its
// blocks inside the kernel.
//
// What bounds it on an H100: the work is 4 S^2/2 H D flops over
// ~4 S H D * 2 bytes, about S/4 flops per byte, so above S ~ 1200 it is
// bound by the bf16 tensor cores and below that by memory.
//
// Two designs, chosen by dtype and head dim:
// - bf16 at head_dim 64: flash_fwd_tc_kernel, on the tensor cores
//   (below).
// - f32, and bf16 at head_dim 16 (a tiny model's, where a 16-wide
//   product would leave a wgmma tile mostly empty): flash_fwd_kernel,
//   CUDA-core FMAs in f32 with the storage dtype's rounding points.  In
//   f32 it is
//   held to the plain version at summation-order bounds (TF32 tensor
//   cores would not be).  One block per (64-row q tile, head, batch)
//   walks the k tiles up to the diagonal; each thread owns a 4x4
//   micro-tile of the 64x64 score block and 4 x D/16 of the output.
// Both keep the running max/sum and the output accumulator on chip,
// never write the [S, S] scores, never load a causally dead tile, and
// mask rows past S in-kernel, so every length takes the kernel.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 micro-tiles

template <int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D+1 floats a row (no bank conflicts on the
  // column walk), v unpadded, p padded to BK+1
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ cos2,
                     const T* __restrict__ sinm, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DP]
  float* ks = qs + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;   // [BK][D]
  float* ps = vs + BK * D;    // [BQ][PP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx + 16j, output dims tx + 16j
  const int ty = tid >> 4;   // rows 4ty .. 4ty+3
  const long rs = static_cast<long>(H) * D;  // sequence stride
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] = q0 + r < S ? rtt::load_rot<T, D, ROPE>(
                                      q + base + (q0 + r) * rs, cos2, sinm,
                                      q0 + r, c)
                                : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rtt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = q_last / BK + 1;  // causal: k tiles with k0 <= q_last
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of ks/vs/ps are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < S;
      ks[r * DP + c] = ok ? rtt::load_rot<T, D, ROPE>(
                                k + base + (k0 + r) * rs, cos2, sinm, k0 + r,
                                c)
                          : 0.f;
      vs[r * D + c] = ok ? rtt::to_f32(v[base + (k0 + r) * rs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool live[4];
      float rmax = rtt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        live[j] = kj <= qi && kj < S;
        s[i][j] = live[j] ? s[i][j] * scale : rtt::kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 16 threads of a row are lanes of one aligned half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        ps[(4 * ty + i) * PP + tx + 16 * j] = rtt::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], c[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) c[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += p[i] * c[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi < S) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        o[base + qi * rs + tx + 16 * j] = rtt::from_f32<T>(acc[i][j] / lc);
      if (tx == 0)
        lse[(static_cast<long>(b) * H + h) * S + qi] = m[i] + logf(lc);
    }
  }
}

template <typename T, int D, bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* cos2,
           const void* sinm, void* o, void* lse, int B, int S, int H,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, ROPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, ROPE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(cos2),
      static_cast<const T*>(sinm), static_cast<T*>(o),
      static_cast<float*>(lse), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_cuda_cores(const void* q, const void* k, const void* v,
                        const void* cos2, const void* sinm, void* o,
                        void* lse, int B, int S, int H, float scale,
                        cudaStream_t st) {
  if (cos2 != nullptr)
    return launch<T, D, true>(q, k, v, cos2, sinm, o, lse, B, S, H, scale,
                              st);
  return launch<T, D, false>(q, k, v, cos2, sinm, o, lse, B, S, H, scale,
                             st);
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) with register-resident accumulators
// ---------------------------------------------------------------------------
//
// A block is WG warpgroups (128 threads each), each owning 64 q rows of
// one (batch, head); the block walks the 64-key tiles up to its last
// row's diagonal, and a warpgroup stops at its own diagonal, the one
// tile it masks (the others skip the mask arithmetic).  The grid runs a
// head's q tiles side by side, longest first, so the blocks in flight
// share that head's K and V in L2 and causal imbalance leaves no tail.
//
// WG is chosen by RoPE alone:
// - without RoPE (serving: q and k arrive rotated), WG = 1: the prefill
//   shapes ([1, S <= 1024, 12, 64]) give few blocks (192 at S = 1024
//   with 64 rows, 96 with 128), and a 41 KB block lets four share an SM,
//   so one block's softmax overlaps another's products;
// - with RoPE (training), WG = 2: each block rotates every K tile it
//   loads, so two warpgroups sharing a tile halve that work per row.
//
// Per k tile, per warpgroup:
//   S = Q K^T    wgmma m64n64k16 x 4 (over D), bf16 from shared memory,
//                both K-major, f32 accumulators in registers;
//   online softmax on the accumulator fragment (a thread holds two rows:
//                quad shuffles for row max, the sum deferred to the end),
//                the O accumulator rescaled in registers;
//   O += P V     wgmma with A from registers: the f32 S fragment rounded
//                to bf16 and repacked 16 keys at a time (no shared-memory
//                round trip); V is B in its [key][d] rows, MN-major, so
//                the transpose bit is set.
// Loads: cp.async with zero fill into a 2-stage K/V ring.  Tile kt + 1
// is copied at the start of iteration kt and landed (and rotated) while
// the P V product of tile kt runs, so the copy has S and the softmax to
// arrive and the rotation hides behind the tensor cores; one block
// barrier per tile then publishes it and frees tile kt's stage.  Not
// TMA: a 2-D tensor map over (B S) x (H D) would fill the rows
// past S with the next batch's rows instead of zeros, and the in-place
// RoPE needs each thread to own the chunks it rotates (and their table
// rows, copied beside the tile so the rotation reads shared memory).
// Rows are 128 bytes (D = 64 bf16), stored with the 128-byte swizzle that
// wgmma's descriptors read.
//
// Ordering: wgmma reads shared memory through the async proxy, so after
// the copies land and the RoPE writes its rotated rows back, each thread
// fences (fence.proxy.async) before the barrier that publishes the tile.
// wgmma.fence precedes each product group whose registers were written
// since (S is overwritten, O rescaled, P repacked), and the softmax reads
// S only after wgmma.wait_group 0.

namespace tc_fwd {

using namespace rtt;

constexpr int BN = 64;             // keys of a tile
constexpr int D = 64;
constexpr int TILE = 64 * 128;     // a [64][64] bf16 tile, 128-byte rows
constexpr int TTILE = 64 * 256;    // RoPE table rows of a tile: cos2 | sinm
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a block of WG warpgroups (64 WG q rows), in bytes from
// its 1024-aligned base: Q, K stages 0/1, V stages 0/1, then under RoPE
// the K stages' table rows; plus the slack that aligns the base.
template <int WG, bool ROPE>
struct Smem {
  static constexpr int K = WG * TILE;       // + stage * TILE
  static constexpr int V = K + 2 * TILE;    // + stage * TILE
  static constexpr int T = V + 2 * TILE;    // + stage * TTILE
  static constexpr size_t BYTES = 1024 + T + (ROPE ? 2 * TTILE : 0);
};

// byte offset of 16-byte chunk c of row r in a swizzled tile (rows of
// consecutive tiles follow each other: the pattern repeats every 8 rows)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// byte offset of chunk c of table row r's half (0 cos2, 1 sinm); odd
// rows swap their chunk halves, so the two rows that one 8-thread
// phase of a 16-byte access touches fall on distinct banks
__device__ __forceinline__ uint32_t tab(int r, int half, int c) {
  return r * 256 + half * 128 + ((c ^ ((r & 1) << 2)) << 4);
}

// rows [r0, r0 + ROWS) of x at (b, h) into the swizzled tile at shared
// address dst, zero past S, by the block's NT threads.  Thread t copies
// chunks j and j + 4 of row r, (r, j) = divmod(t + NT i, 4): the pairs
// the RoPE rotates, so a thread rotates only what it copied and needs no
// barrier in between.
template <int NT, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* x, long base,
                                          long rs, int r0, int S) {
#pragma unroll
  for (int i = 0; i < ROWS * 4 / NT; ++i) {
    const int p = threadIdx.x + NT * i, r = p >> 2, j = p & 3;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* src = x + base + (ok ? (r0 + r) * rs : 0);
    tc::cp_async16(dst + swz(r, j), src + 8 * j, ok);
    tc::cp_async16(dst + swz(r, j + 4), src + 8 * j + 32, ok);
  }
}

// the same thread's chunks of the RoPE table rows [r0, r0 + 64) into the
// table tile at dst, beside the K tile they rotate: the rotation then
// reads shared memory, not device memory, inside the loop
template <int NT>
__device__ __forceinline__ void load_table(uint32_t dst,
                                           const __nv_bfloat16* cos2,
                                           const __nv_bfloat16* sinm, int r0,
                                           int S) {
#pragma unroll
  for (int i = 0; i < 256 / NT; ++i) {
    const int p = threadIdx.x + NT * i, r = p >> 2, j = p & 3;
    const bool ok = r0 + r < S;
    const long row = ok ? (r0 + r) * 64L : 0;
#pragma unroll
    for (int c = j; c < 8; c += 4) {
      tc::cp_async16(dst + tab(r, 0, c), cos2 + row + 8 * c, ok);
      tc::cp_async16(dst + tab(r, 1, c), sinm + row + 8 * c, ok);
    }
  }
}

// the RoPE of this thread's landed chunks of a tile, in place, with the
// table rows from the table tile or, for Q (once a block), device memory
template <int NT, int ROWS, bool FROM_SMEM>
__device__ __forceinline__ void rotate_tile(uint8_t* tile,
                                            const uint8_t* table,
                                            const __nv_bfloat16* cos2,
                                            const __nv_bfloat16* sinm, int r0,
                                            int S) {
#pragma unroll
  for (int i = 0; i < ROWS * 4 / NT; ++i) {
    const int p = threadIdx.x + NT * i, r = p >> 2, j = p & 3;
    if (r0 + r >= S) continue;
    uint4& lo = *reinterpret_cast<uint4*>(tile + swz(r, j));
    uint4& hi = *reinterpret_cast<uint4*>(tile + swz(r, j + 4));
    if constexpr (FROM_SMEM) {
      auto t = [&](int half, int c) {
        return *reinterpret_cast<const uint4*>(table + tab(r, half, c));
      };
      rope_chunks(lo, hi, t(0, j), t(0, j + 4), t(1, j), t(1, j + 4));
    } else {
      rope_chunks(lo, hi, cos2, sinm, r0 + r, j);
    }
  }
}

template <bool ROPE, int WG>
__global__ void __launch_bounds__(128 * WG)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ cos2,
                        const __nv_bfloat16* __restrict__ sinm,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int S, int H, float scale) {
  constexpr int NT = 128 * WG, BM = 64 * WG;
  using L = Smem<WG, ROPE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sq = tc::smem_addr(smem);

  // q tiles vary fastest, so the blocks in flight together share their
  // heads' K and V in L2; within a head the longest tiles go first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BM;
  const int wg = threadIdx.x >> 7;  // this warpgroup's rows: q0 + 64 wg ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2
  // this thread's accumulator rows (+ 8 i) within its warpgroup's 64 and
  // first column (+ 8 j + e)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  // causal: the block walks the key tiles up to its last row's; this
  // warpgroup's own last tile is its diagonal, the one it masks
  const int n_kt = (q0 + BM - 1) / BN + 1;
  const int kt_diag = (q0 + 64 * wg) / BN;

  // key tile t (and under RoPE its table rows) into stage t % 2
  auto load_kv = [&](int t) {
    const int stg = t & 1;
    load_tile<NT, BN>(sq + L::K + stg * TILE, k, base, rs, t * BN, S);
    load_tile<NT, BN>(sq + L::V + stg * TILE, v, base, rs, t * BN, S);
    if constexpr (ROPE)
      load_table<NT>(sq + L::T + stg * TTILE, cos2, sinm, t * BN, S);
    tc::cp_async_commit();
  };
  // this thread's part of tile t landed, rotated and fenced for wgmma
  auto land_kv = [&](int t) {
    tc::cp_async_wait<0>();
    if constexpr (ROPE)
      rotate_tile<NT, BN, true>(smem + L::K + (t & 1) * TILE,
                                smem + L::T + (t & 1) * TTILE, cos2, sinm,
                                t * BN, S);
    tc::fence_proxy_async();
  };

  load_tile<NT, BM>(sq, q, base, rs, q0, S);
  load_kv(0);  // Q rides with tile 0
  land_kv(0);
  if constexpr (ROPE) {
    rotate_tile<NT, BM, false>(smem, nullptr, cos2, sinm, q0, S);
    tc::fence_proxy_async();
  }
  __syncthreads();

  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint64_t desc_q = tc::desc_sw128(sq + wg * TILE);

  // Tile kt is landed and rotated when iteration kt begins.  The
  // iteration starts the copy of tile kt + 1 into the other stage (read
  // by the previous iteration, now done), computes on tile kt, then
  // lands and rotates tile kt + 1, whose copy has had the products to
  // arrive; its one barrier, at its end, publishes that tile and frees
  // tile kt's stage.
  for (int kt = 0; kt < n_kt; ++kt) {
    const int stg = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1);
    if (kt <= kt_diag) {  // past it a warpgroup has no live key
      // S = Q K^T
      const uint64_t desc_k = tc::desc_sw128(sq + L::K + stg * TILE);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // +32 bytes along K a step
        tc::wgmma_ss_m64n64k16(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(s);

      // online softmax in log2 units; the max is taken on the raw scores
      // (scale > 0) and the scale folded into exp2's argument
      if (kt == kt_diag) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + col0 + e > row0 + 8 * i)
                s[4 * j + 2 * i + e] = kNegInf;
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * sl2);
        alpha[i] = tc::exp2_approx(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            s[x] = tc::exp2_approx(fmaf(s[x], sl2, -m[i]));
            l[i] += s[x];  // this thread's share; the quad sums at the end
          }
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] *= alpha[(x >> 1) & 1];

      // O += P V, P from registers, 16 keys (2048 bytes of V) a step
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) tc::a_from_acc(pa[kk], &s[8 * kk]);
      const uint64_t desc_v = tc::desc_sw128(sq + L::V + stg * TILE);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        tc::wgmma_rs_m64n64k16_tb(acc, pa[kk], desc_v + 128 * kk);
      tc::wgmma_commit();
      // tile kt + 1 lands and rotates on the CUDA cores while the tensor
      // cores run P V (it touches neither acc, pa nor stage kt's V)
      if (kt + 1 < n_kt) land_kv(kt + 1);
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
    } else if (kt + 1 < n_kt) {
      land_kv(kt + 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = q0 + 64 * wg + row0 + 8 * i;
    if (qi < S) {
      const float lc = fmaxf(l[i], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + base + qi * rs + col0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[4 * j] = tc::pack_bf16(acc[4 * j + 2 * i] / lc,
                                    acc[4 * j + 2 * i + 1] / lc);
      if ((lane & 3) == 0)
        lse[(static_cast<long>(b) * H + h) * S + qi] = m[i] * kLn2 + logf(lc);
    }
  }
}

template <bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* cos2,
           const void* sinm, void* o, void* lse, int B, int S, int H,
           float scale, cudaStream_t stream) {
  constexpr int WG = ROPE ? 2 : 1;  // see the design notes above
  constexpr size_t smem = Smem<WG, ROPE>::BYTES;
  auto* kernel = flash_fwd_tc_kernel<ROPE, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + 64 * WG - 1) / (64 * WG), H, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, 128 * WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(cos2),
      static_cast<const bf16*>(sinm), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_fwd

}  // namespace

// cos2 and sinm [S, D] (storage dtype) select the in-kernel RoPE; pass
// null for both to take q and k as they are.  D is 64 or 16.  bf16 at
// D = 64 runs on the tensor cores, the rest on the CUDA cores; there is
// no other switch.  The bf16
// kernel reads 16-byte vectors: q, k, v, cos2 and sinm 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* cos2,
                                   const void* sinm, void* o, void* lse,
                                   int B, int S, int H, int D, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && D == 64) {
    if (cos2 != nullptr)
      return tc_fwd::launch<true>(q, k, v, cos2, sinm, o, lse, B, S, H,
                                  scale, st);
    return tc_fwd::launch<false>(q, k, v, cos2, sinm, o, lse, B, S, H, scale,
                                 st);
  }
  if (dtype == rtt::kBF16 && D == 16)
    return dispatch_cuda_cores<__nv_bfloat16, 16>(q, k, v, cos2, sinm, o,
                                                  lse, B, S, H, scale, st);
  if (dtype == rtt::kF32 && D == 64)
    return dispatch_cuda_cores<float, 64>(q, k, v, cos2, sinm, o, lse, B, S,
                                          H, scale, st);
  if (dtype == rtt::kF32 && D == 16)
    return dispatch_cuda_cores<float, 16>(q, k, v, cos2, sinm, o, lse, B, S,
                                          H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
