// Causal flash-attention forward for prefill.
//
// Replaces: ray_tpu/ops/attention.py:_fwd_kernel (via _fwd) and its
// two-head lane-packed sibling _fwd_pack2_kernel (via _fwd_pack2).  The
// pack2 layout exists to fill the TPU's 128-lane matrix unit at
// head_dim 64; Hopper has no such lane constraint, so one kernel
// serves both, at every head count.  It is instantiated for head_dim 64
// (GPT-2's) only; other head dims come with their configurations.
//
// Computes, for q, k, v [B, S, H, D] (the model layout, bf16 or f32):
//   o   [B, S, H, D] = softmax(q k^T * scale, causal) v   (storage dtype)
//   lse [B, H, S]    = row logsumexp of the scaled scores (f32, for the
//                      backward that a later slice ports)
// with the reference's rounding points: scores and statistics in f32,
// p rounded to the value dtype before P.V, l summed from unrounded p.
//
// What bounds it on an H100: at the prefill shapes ([1, S<=1024, 12,
// 64]) the work is ~4*S^2/2*H*D flops over ~4*S*H*D*2 bytes, i.e. about
// S/4 flops per byte, so above S ~ 1200 it is compute-bound on the
// tensor cores and below that memory-bound; in practice this simple
// kernel is bound by its own CUDA-core FMA throughput, not by either.
//
// What the design does about it: one block per (64-row q tile, head,
// batch) walks the k tiles up to the diagonal only (causally dead tiles
// are never loaded), keeps the running max/sum and the output
// accumulator in registers, and never writes the [S, S] scores to
// device memory.  Each thread owns a 4x4 micro-tile of the 64x64 score
// block and a 4 x D/16 micro-tile of the output, so every shared-memory
// load feeds 4 FMAs.  Rows past S (the ragged edge of buckets 32 and
// 64, or any S) are masked in-kernel, so every bucket takes the kernel.
// Tensor cores (wgmma) and TMA pipelining are later work.
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
    qs[r * DP + c] =
        q0 + r < S ? rtt::to_f32(q[base + (q0 + r) * rs + c]) : 0.f;
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
      ks[r * DP + c] = ok ? rtt::to_f32(k[base + (k0 + r) * rs + c]) : 0.f;
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, int D, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, S, H, scale, st);
  if (dtype == rtt::kF32)
    return launch<float, 64>(q, k, v, o, lse, B, S, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
