// Single-token decode attention against a padded per-slot context.
//
// Replaces: ray_tpu/ops/attention.py:_decode_kernel (via
// decode_attention), model-dtype variant.
//
// Computes, for q [B, H, D], k, v [B, S, H, D] (bf16 or f32; D = 64,
// GPT-2's head_dim, is the one instantiation) and lengths [B] int32:
//   o[b, h] = softmax(q[b,h] . k[b, :len, h] * scale) v[b, :len, h]
// with len = lengths[b] clamped to [0, S], scores and statistics in
// f32, p rounded to the value dtype before P.V, and l clamped at 1e-30
// as the reference does.
//
// What bounds it on an H100: bytes.  Each position costs 4*D flops
// against 2*D*sizeof(T) bytes of K and V, one flop per byte in bf16,
// far below the ~295 flops/byte where the tensor cores would matter.
// The least time is the valid K/V bytes over the memory rate.
//
// What the design does about it: it reads only what it needs.  One
// block per (head, batch row); its eight warps stride over 32-position
// strips below lengths[b] only, so positions >= lengths[b] (garbage
// pages, padded tails) are never read at all, and a short sequence
// costs what its length costs.  Each lane scores one position of the
// strip with 16-byte loads of its K row, a warp-wide online softmax
// updates (max, sum), and the strip's P.V reads V rows coalesced across
// the lanes.  The eight warps' partial (max, sum, acc) merge once
// through shared memory.  Splitting long contexts across blocks
// (flash-decoding) and reading pages through the page table are later
// work.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, int S, int H, float scale) {
  constexpr int DL = D / 32;             // output dims per lane
  constexpr int VN = rtt::Vec16<T>::N;   // elements per 16-byte load
  __shared__ float qs[D];
  __shared__ float wm[WARPS];
  __shared__ float wl[WARPS];
  __shared__ float wacc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long rs = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;

  for (int i = tid; i < D; i += THREADS)
    qs[i] = rtt::to_f32(q[(static_cast<long>(b) * H + h) * D + i]);
  __syncthreads();

  const int len = min(max(lengths[b], 0), S);
  float m = rtt::kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int j = 0; j < DL; ++j) acc[j] = 0.f;

  for (int c0 = 32 * warp; c0 < len; c0 += 32 * WARPS) {
    const int p = c0 + lane;
    const bool valid = p < len;
    float s = rtt::kNegInf;
    if (valid) {
      const uint4* kr = reinterpret_cast<const uint4*>(k + base + p * rs);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < D / VN; ++t) {
        float f[VN];
        rtt::unpack16(kr[t], f);
#pragma unroll
        for (int e = 0; e < VN; ++e) dot += qs[t * VN + e] * f[e];
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, rtt::warp_max(s));
    const float alpha = expf(m - m_new);
    const float pf = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + rtt::warp_sum(pf);
    m = m_new;
    const float pr = rtt::round_to<T>(pf);
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[j] *= alpha;
    const int n = min(32, len - c0);  // warp-uniform
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float pi = __shfl_sync(0xffffffffu, pr, i);
      const T* vr = v + base + (c0 + i) * rs;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[j] += pi * rtt::to_f32(vr[lane + 32 * j]);
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DL; ++j) wacc[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (tid < D) {
    float M = rtt::kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(wm[w] - M);
      L += wl[w] * f;
      A += wacc[w][tid] * f;
    }
    o[(static_cast<long>(b) * H + h) * D + tid] =
        rtt::from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int S, int H, float scale, cudaStream_t stream) {
  decode_kernel<T, D><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int S,
                                int H, int D, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, o, B, S, H, scale, st);
  if (dtype == rtt::kF32)
    return launch<float, 64>(q, k, v, lengths, o, B, S, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
