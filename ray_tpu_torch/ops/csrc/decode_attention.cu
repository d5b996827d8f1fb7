// Single-token decode attention, read straight from the paged KV cache
// (or from a padded per-slot context), split across blocks.
//
// Replaces: ray_tpu/ops/attention.py:_decode_kernel (body :1319, reached
// from decode_attention :1387, pl.pallas_call :1477), in both of its
// modes: the model dtype (decode_attention below) and quantized=True,
// int8 codes with per-(position, head) f32 scales (decode_attention_int8).
//
// Computes, for q [B, H, D] (bf16 or f32; D is 64, GPT-2's head_dim, 16,
// GPTConfig.tiny's, or 128, Llama's, Mistral's and Qwen2's) and lengths
// [B] int32:
//   o[b, h] = softmax(q[b,h] . k[b, :len, h] * scale) v[b, :len, h]
// with len = lengths[b] clamped to the context's capacity, scores and
// statistics in f32, l clamped at 1e-30, and no read at or past len.
// In the model dtype p is rounded to it before P.V; the int8 mode keeps p
// in f32 and factors the scales out of the products, ks * (q . code) and
// (p * vs) * code: the Pallas body's terms (:1341-1344, :1358-1360),
// summed in another order.
//
// Where position p of row b lives (one body, two input modes):
//   padded: k [B, S, H, D], row b * S + p (page_table null, ps = S);
//   paged:  k_pages [P, ps, H, D], row page_table[b][p / ps] * ps + p % ps,
//           the engine's cache layer read in place.  A table entry is read
//           only for positions below len, so entries from ceil(len / ps)
//           on (the scheduler's GARBAGE_PAGE) are never touched.
// Scales (int8) are [rows, H] f32 over the same rows.
//
// What bounds it on an H100: bytes.  Each valid position costs 4*D flops
// against 2*D*sizeof(T) bytes of K and V, one flop per byte in bf16, far
// below the ~295 flops/byte where tensor cores would matter (and GPT-2
// has one query row per (row, head): no grouped heads to share a tile).
// At the main shape, [8, 1024, 12, 64] bf16 with lengths 1, 1024, 37,
// 128, 129, 500, 777, 1000 (3596 valid positions), the least time is
// 11.05 MB / 3.35 TB/s = 3.3 us; int8 moves 2*(D + 4) bytes a position,
// 6.2 MB, 1.8 us.
//
// The design keeps enough bytes in flight and enough blocks busy:
// - Split (flash-decoding).  A block of 4 warps owns one (split, head,
//   row): SPLIT = 128 consecutive positions, 32 a warp.  The grid is
//   (ceil(capacity / SPLIT), H, B), and a block past ceil(len / SPLIT)
//   returns at once, so the live blocks follow the valid context, not
//   H x B.
// - Loads.  A lane reads 16 bytes of a head row: LPP lanes cover one
//   position's row (bf16 D = 64: 8 lanes, 4 positions a warp-wide load;
//   int8: 4 lanes, 8 positions), and each lane starts all of its K and V
//   loads for the warp's 32 positions before it uses any of them (bf16:
//   8 + 8 loads of 16 bytes in flight a lane).  Scores are reduced by
//   shuffles within each LPP-lane group; for P.V each lane accumulates
//   its own 16 bytes' dimensions over its positions in f32 registers, and
//   the groups merge once, by shuffles, at the end.  The int8 codes
//   become f32 by a byte permute (i8_to_f32), not by I2F.
// - Combine.  The four warps merge (m, l, acc) through shared memory in
//   warp order.  A row with one split writes o directly; otherwise each
//   split writes f32 (acc[D], m, l) to the workspace [B, H, splits, D + 2]
//   and decode_combine_kernel folds them in split order.  No atomics: two
//   calls agree bit for bit.  One C entry point launches both kernels,
//   the combine as a programmatic dependent launch (griddepcontrol), so
//   its launch overlaps the split kernel.
//
// Measured (python3 chip_smoke.py --decode, NVIDIA H100 80GB HBM3 at
// 700 W, inputs warm in L2; PERF.md section 6 row 5 has the rest):
//   bf16, smoke lengths: 0.0091 ms padded, 0.0096 paged (page 128); the
//     masked SDPA 0.0188, gather_pages + SDPA 0.0368; bound 0.0033.
//   bf16, every row 1024: 0.0112 / 0.0129 (bound 0.0075).
//   int8, smoke lengths: 0.0089 / 0.0092 (bound 0.0018); full 0.0092 /
//     0.0100 (bound 0.0040).
// At these sizes one wave of blocks runs one chain of dependent reads
// (length, table entry, K/V, partials), so the fixed cost of the two
// launches, not the bytes, sets most of the time; the one-block-per-
// (head, row) kernel this replaces took 0.0325 (bf16) and 0.0202 (int8).
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SPLIT = 128;            // positions a block owns
constexpr int WPOS = SPLIT / WARPS;   // positions a warp owns

// Where a row's positions live: through a page table of max_pages
// entries of ps positions each, or (table null) at b * ps + p, a padded
// context being one page of ps = S positions a row.
struct Context {
  const int* table;   // [B, max_pages] int32, or null
  int ps;
  int max_pages;

  __device__ __forceinline__ long row(int b, int p) const {
    if (table == nullptr) return static_cast<long>(b) * ps + p;
    const int page = table[static_cast<long>(b) * max_pages + p / ps];
    return static_cast<long>(page) * ps + p % ps;
  }
  __device__ __forceinline__ int length(const int* lengths, int b) const {
    return min(max(lengths[b], 0), ps * max_pages);
  }
};

__host__ __device__ constexpr int splits_for(int capacity) {
  return (capacity + SPLIT - 1) / SPLIT;
}

// int8 -> f32 without the conversion unit (I2F runs at a quarter of the
// FMA rate): byte i of w, offset to unsigned by flipping its sign bit, is
// placed under the exponent of 2^23 (0x4B000000), which reads as the
// float 2^23 + 128 + code; subtracting 2^23 + 128 leaves the code, exactly.
__device__ __forceinline__ float i8_to_f32(unsigned w, int i) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                    0x7540u + i)) - 8388736.f;
}

// 16 int8 codes as f32 (rtt::unpack16 takes 4 f32 or 8 bf16 values)
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[16]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = i8_to_f32(w[i / 4], i % 4);
}
using rtt::unpack16;

// One (split, head, row) of SPLIT positions.  T is q's and o's dtype; Q
// selects int8 codes KV with scales ks, vs (otherwise KV = T and ks, vs
// are not read).
template <typename T, int D, bool Q>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const void* __restrict__ kp,
                        const void* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ lengths, Context ctx,
                        T* __restrict__ o, float* __restrict__ ws, int H,
                        float scale) {
  using KV = typename std::conditional<Q, int8_t, T>::type;
  constexpr int VN = 16 / sizeof(KV);   // elements a 16-byte load holds
  constexpr int LPP = D / VN;           // lanes a position's row takes
  constexpr int PPL = 32 / LPP;         // positions a warp-wide load takes
  constexpr int IT = WPOS / PPL;        // loads of K (and of V) a lane
  static_assert(D % VN == 0 && 32 % LPP == 0 && WPOS % PPL == 0,
                "a head row is a whole number of 16-byte lane loads");
  const KV* k = static_cast<const KV*>(kp);
  const KV* v = static_cast<const KV*>(vp);
  __shared__ float wm[WARPS];
  __shared__ float wl[WARPS];
  __shared__ float wacc[WARPS][D];

  // let the combine kernel's blocks be scheduled now: they wait for this
  // grid's end (griddepcontrol.wait) before they read its partials
  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long ob = (static_cast<long>(b) * H + h) * D;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPP;   // which 16 bytes of the head row
  const int g = lane / LPP;   // which position of a warp-wide load
  // q first: its load does not wait for the length
  float qf[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) qf[e] = rtt::to_f32(q[ob + c * VN + e]);
  const int len = ctx.length(lengths, b);
  const int nsplit = splits_for(len);
  if (split >= nsplit) {
    // an empty row attends to nothing: o = 0, as the plain version gives
    if (len == 0 && split == 0 && tid < D)
      o[ob + tid] = rtt::from_f32<T>(0.f);
    return;
  }
  const long rs = static_cast<long>(H) * D;   // elements a position row
  const int p0 = split * SPLIT + warp * WPOS + g;

  // start every K and V load (and scale load) of the warp's positions
  uint4 kr[IT], vr[IT];
  float ksc[IT], vsc[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = p0 + it * PPL;
    kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
    ksc[it] = vsc[it] = 0.f;
    if (p < len) {
      const long r = ctx.row(b, p);
      kr[it] = reinterpret_cast<const uint4*>(k + r * rs + h * D)[c];
      vr[it] = reinterpret_cast<const uint4*>(v + r * rs + h * D)[c];
      if constexpr (Q) {
        ksc[it] = ks[r * H + h];
        vsc[it] = vs[r * H + h];
      }
    }
  }

  // scores: a lane's 16 bytes, then the LPP lanes of its group
  float s[IT];
  float m = rtt::kNegInf;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    float f[VN];
    unpack16(kr[it], f);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) dot += qf[e] * f[e];
#pragma unroll
    for (int off = LPP / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const bool valid = p0 + it * PPL < len;
    s[it] = valid ? (Q ? dot * ksc[it] * scale : dot * scale) : rtt::kNegInf;
    m = fmaxf(m, s[it]);
  }
  m = rtt::warp_max(m);

  // P.V: each lane its VN dimensions over its positions
  float l = 0.f, acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const bool valid = p0 + it * PPL < len;
    const float pf = valid ? expf(s[it] - m) : 0.f;
    l += pf;
    // an invalid position's V was never loaded (zeros) and its p is 0
    const float pv = Q ? pf * vsc[it] : rtt::round_to<T>(pf);
    float f[VN];
    unpack16(vr[it], f);
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] += pv * f[e];
  }
  // merge the PPL position groups of the warp (lanes c, c + LPP, ...)
#pragma unroll
  for (int off = 16; off >= LPP; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < VN; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }

  // merge the warps in warp order
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < VN; ++e) wacc[warp][c * VN + e] = acc[e];
  }
  __syncthreads();
  if (tid >= D) return;
  float M = rtt::kNegInf;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float f = expf(wm[w] - M);   // 0 for a warp past len
    L += wl[w] * f;
    A += wacc[w][tid] * f;
  }
  if (nsplit == 1) {
    o[ob + tid] = rtt::from_f32<T>(A / fmaxf(L, 1e-30f));
    return;
  }
  float* part = ws + ((static_cast<long>(b) * H + h) * gridDim.x + split)
                         * (D + 2);
  part[tid] = A;
  if (tid == 0) {
    part[D] = M;
    part[D + 1] = L;
  }
}

// Rows of more than one split: fold the splits' (acc, m, l) in split
// order, one pass with a running max.  One block of D threads a (head,
// row), launched as the split kernel's programmatic dependent: it reads
// the lengths while the split kernel runs, then waits for that grid's
// end (every thread, so this grid never ends before the split grid).
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const int* __restrict__ lengths, Context ctx,
                          const float* __restrict__ ws, T* __restrict__ o,
                          int H, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nsplit = splits_for(ctx.length(lengths, b));
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (nsplit < 2) return;   // written by the split kernel
  const float* part = ws + (static_cast<long>(b) * H + h) * splits * (D + 2);
  float M = rtt::kNegInf, L = 0.f, A = 0.f;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) {
    const float* pi = part + i * (D + 2);
    const float mi = pi[D], li = pi[D + 1], ai = pi[tid];
    const float Mn = fmaxf(M, mi);
    const float fo = expf(M - Mn), fi = expf(mi - Mn);
    L = L * fo + li * fi;
    A = A * fo + ai * fi;
    M = Mn;
  }
  o[(static_cast<long>(b) * H + h) * D + tid] =
      rtt::from_f32<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D, bool Q>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* table, void* o,
           void* ws, int B, int H, int ps, int max_pages, float scale,
           cudaStream_t stream) {
  const Context ctx{static_cast<const int*>(table), ps, max_pages};
  const int splits = splits_for(ps * max_pages);
  if (splits == 0) return static_cast<int>(cudaErrorInvalidValue);
  decode_split_kernel<T, D, Q><<<dim3(splits, H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths), ctx,
      static_cast<T*>(o), static_cast<float*>(ws), H, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err || splits < 2) return err;
  // the combine as a programmatic dependent launch: its launch and its
  // read of the lengths overlap the split kernel's tail
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_combine_kernel<T, D>, static_cast<const int*>(lengths),
      ctx, static_cast<const float*>(ws), static_cast<T*>(o), H, splits));
}

template <bool Q>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, const void* table, void* o,
             void* ws, int B, int H, int D, int ps, int max_pages,
             float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == rtt::kBF16 && D == 64)
    return launch<bf16, 64, Q>(q, k, v, ks, vs, lengths, table, o, ws, B, H,
                               ps, max_pages, scale, st);
  if (dtype == rtt::kBF16 && D == 16)
    return launch<bf16, 16, Q>(q, k, v, ks, vs, lengths, table, o, ws, B, H,
                               ps, max_pages, scale, st);
  if (dtype == rtt::kF32 && D == 64)
    return launch<float, 64, Q>(q, k, v, ks, vs, lengths, table, o, ws, B,
                                H, ps, max_pages, scale, st);
  if (dtype == rtt::kF32 && D == 16)
    return launch<float, 16, Q>(q, k, v, ks, vs, lengths, table, o, ws, B,
                                H, ps, max_pages, scale, st);
  // D = 128: a position's row is 256 bytes in bf16 (16 lanes, 2 positions
  // a warp-wide load), 512 in f32 (the whole warp, one position), 128 in
  // int8 (8 lanes, 4 positions); the block's D threads merge the warps
  if (dtype == rtt::kBF16 && D == 128)
    return launch<bf16, 128, Q>(q, k, v, ks, vs, lengths, table, o, ws, B, H,
                                ps, max_pages, scale, st);
  if (dtype == rtt::kF32 && D == 128)
    return launch<float, 128, Q>(q, k, v, ks, vs, lengths, table, o, ws, B,
                                 H, ps, max_pages, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 elements of the workspace decode_attention(_int8) takes for B rows
// of H heads of head dim D over a context of `capacity` positions (S
// padded, max_pages * page_size paged); 0 when no row can have two splits
extern "C" long long decode_attention_workspace(int B, int H, int D,
                                                int capacity) {
  const int splits = splits_for(capacity);
  if (splits < 2 || B <= 0 || H <= 0) return 0;
  return static_cast<long long>(B) * H * splits * (D + 2);
}

// q, o [B, H, D] in dtype; lengths [B] int32.  table null: k, v are the
// padded context [B, ps, H, D] (max_pages 1).  Otherwise k, v are the
// pages [P, ps, H, D] and table [B, max_pages] int32.  k and v 16-byte
// aligned; ws of decode_attention_workspace f32 elements.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* table,
                                void* o, void* ws, int B, int H, int D,
                                int ps, int max_pages, float scale, int dtype,
                                void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, lengths, table, o, ws, B,
                         H, D, ps, max_pages, scale, dtype, stream);
}

// The same over int8 codes k, v with k_scale, v_scale [rows, H] f32 (rows
// as k's: B * ps padded, P * ps paged).
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* lengths,
                                     const void* table, void* o, void* ws,
                                     int B, int H, int D, int ps,
                                     int max_pages, float scale, int dtype,
                                     void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, lengths, table, o, ws, B,
                        H, D, ps, max_pages, scale, dtype, stream);
}
