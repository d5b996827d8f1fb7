// Single-token decode attention against a padded per-slot context.
//
// Replaces: ray_tpu/ops/attention.py:_decode_kernel (via
// decode_attention), model-dtype variant; the int8 variant
// (decode_attention_int8) is the second kernel below.
//
// Computes, for q [B, H, D], k, v [B, S, H, D] (bf16 or f32; D is 64,
// GPT-2's head_dim, or 16, GPTConfig.tiny's) and lengths [B] int32:
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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, int S, int H, float scale) {
  constexpr int DL = (D + 31) / 32;      // output dims per lane, at most
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
      for (int j = 0; j < DL; ++j)
        if (D % 32 == 0 || lane + 32 * j < D)
          acc[j] += pi * rtt::to_f32(vr[lane + 32 * j]);
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DL; ++j)
    if (D % 32 == 0 || lane + 32 * j < D) wacc[warp][lane + 32 * j] = acc[j];
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

// The int8 variant: the same attention over an int8 context.
//
// Replaces: ray_tpu/ops/attention.py:_decode_kernel with quantized=True
// (decode_attention called with k_scale/v_scale, the kv_dtype="int8"
// cache).  K and V arrive as int8 codes [B, S, H, D] with one f32 scale
// per (position, head), ks, vs [B, S, H]; the Pallas body
// (attention.py:1341-1344, 1358-1360) dequantizes inside its strip:
//   q f32;  k = code * ks, v = code * vs in f32;  scores, max and sum f32;
//   p stays f32 before P.V (p.astype(v.dtype) with v in f32);  l clamped
//   at 1e-30;  o in q's dtype T.
// Here the scale is factored out of each product, ks * (q . code) and
// (p * vs) * code: the same terms, summed in another order.
//
// Bound: bytes, 2 * (D + 4) per valid (position, head) against 4 * D in
// bf16.  Same structure as decode_kernel: one block per (head, row),
// eight warps striding 32-position strips below lengths[b] only, so the
// garbage page's codes and scales (NaN included) are never read.  A lane
// scores its position from D / 16 16-byte loads of the D-code K row and
// one scale; for P.V each lane reads two neighbouring codes of the V row
// (one 2-byte load, output dims 2*lane and 2*lane + 1; at D = 16 lanes
// 0-7 only), and p * vs of the position comes by shuffle from the lane
// that scored it.
//
// int8 -> f32 without the conversion unit (I2F runs at a quarter of the
// FMA rate): byte i of w, offset to unsigned by flipping its sign bit, is
// placed under the exponent of 2^23 (0x4B000000), which reads as the
// float 2^23 + 128 + code; subtracting 2^23 + 128 leaves the code, exactly.
__device__ __forceinline__ float i8_to_f32(unsigned w, int i) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                    0x7540u + i)) - 8388736.f;
}

__device__ __forceinline__ void unpack16_i8(const uint4& raw, float (&f)[16]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = i8_to_f32(w[i / 4], i % 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       int S, int H, float scale) {
  static_assert(D % 16 == 0 && D <= 64, "two V codes a lane, 16 a load");
  constexpr bool ALL = D == 64;  // every lane holds two output dims
  __shared__ float qs[D];
  __shared__ float wm[WARPS];
  __shared__ float wl[WARPS];
  __shared__ float wacc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long rs = static_cast<long>(H) * D;   // codes per position
  const long base = static_cast<long>(b) * S * rs + static_cast<long>(h) * D;
  const long sbase = static_cast<long>(b) * S * H + h;

  for (int i = tid; i < D; i += THREADS)
    qs[i] = rtt::to_f32(q[(static_cast<long>(b) * H + h) * D + i]);
  __syncthreads();

  const int len = min(max(lengths[b], 0), S);
  float m = rtt::kNegInf, l = 0.f, acc0 = 0.f, acc1 = 0.f;

  for (int c0 = 32 * warp; c0 < len; c0 += 32 * WARPS) {
    const int p = c0 + lane;
    const bool valid = p < len;
    float s = rtt::kNegInf, vsc = 0.f;
    if (valid) {
      const uint4* kr = reinterpret_cast<const uint4*>(k + base + p * rs);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        float f[16];
        unpack16_i8(kr[t], f);
#pragma unroll
        for (int e = 0; e < 16; ++e) dot += qs[t * 16 + e] * f[e];
      }
      s = dot * ks[sbase + static_cast<long>(p) * H] * scale;
      vsc = vs[sbase + static_cast<long>(p) * H];
    }
    const float m_new = fmaxf(m, rtt::warp_max(s));
    const float alpha = expf(m - m_new);
    const float pf = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + rtt::warp_sum(pf);
    m = m_new;
    const float pv = pf * vsc;      // 0 for an invalid lane: vsc unread
    acc0 *= alpha;
    acc1 *= alpha;
    const int n = min(32, len - c0);  // warp-uniform
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float pi = __shfl_sync(0xffffffffu, pv, i);
      if (!ALL && 2 * lane >= D) continue;
      const unsigned c = *reinterpret_cast<const unsigned short*>(
          v + base + (c0 + i) * rs + 2 * lane);
      acc0 += pi * i8_to_f32(c, 0);
      acc1 += pi * i8_to_f32(c, 1);
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  if (ALL || 2 * lane < D) {
    wacc[warp][2 * lane] = acc0;
    wacc[warp][2 * lane + 1] = acc1;
  }
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
int launch_int8(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* lengths, void* o, int B, int S,
                int H, float scale, cudaStream_t stream) {
  decode_int8_kernel<T, D><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<T*>(o), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int S,
                                int H, int D, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == rtt::kBF16 && D == 64)
    return launch<bf16, 64>(q, k, v, lengths, o, B, S, H, scale, st);
  if (dtype == rtt::kBF16 && D == 16)
    return launch<bf16, 16>(q, k, v, lengths, o, B, S, H, scale, st);
  if (dtype == rtt::kF32 && D == 64)
    return launch<float, 64>(q, k, v, lengths, o, B, S, H, scale, st);
  if (dtype == rtt::kF32 && D == 16)
    return launch<float, 16>(q, k, v, lengths, o, B, S, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, o [B, H, D] in dtype; k, v int8 codes [B, S, H, D] (16-byte aligned);
// k_scale, v_scale [B, S, H] f32; lengths [B] int32.
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* lengths,
                                     void* o, int B, int S, int H, int D,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == rtt::kBF16 && D == 64)
    return launch_int8<bf16, 64>(q, k, v, k_scale, v_scale, lengths, o, B, S,
                                 H, scale, st);
  if (dtype == rtt::kBF16 && D == 16)
    return launch_int8<bf16, 16>(q, k, v, k_scale, v_scale, lengths, o, B, S,
                                 H, scale, st);
  if (dtype == rtt::kF32 && D == 64)
    return launch_int8<float, 64>(q, k, v, k_scale, v_scale, lengths, o, B,
                                  S, H, scale, st);
  if (dtype == rtt::kF32 && D == 16)
    return launch_int8<float, 16>(q, k, v, k_scale, v_scale, lengths, o, B,
                                  S, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
