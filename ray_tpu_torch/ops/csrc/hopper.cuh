// Register-level tensor-core and asynchronous-copy primitives for the
// bf16 kernels (flash_attention_fwd.cu, flash_attention_bwd.cu,
// matmul_residual_norm.cu, matmul_residual_norm_bwd.cu, flash_ce_fwd.cu,
// flash_ce_bwd.cu): cp.async with
// zero fill, the async-proxy fence, warpgroup MMA (wgmma) with its
// shared-memory descriptors, TMA tile copies (cp.async.bulk.tensor) with
// their mbarriers and host-side tensor maps, warp MMA (mma.sync
// m16n8k16) and ldmatrix.
// The wgmma m64n64k16 variants, by where A and B live and which of them
// is MN-major (the transpose bits):
//   wgmma_ss_m64n64k16      A, B in shared memory, both K-major
//   wgmma_ss_m64n64k16_tb   A K-major, B MN-major (rows k, n contiguous)
//   wgmma_ss_m64n64k16_tt   A and B MN-major (rows k, m or n contiguous)
//   wgmma_rs_m64n64k16_tb   A in registers, B MN-major
// and at n128 (flash_ce_fwd.cu, flash_ce_bwd.cu), a 64 x 128 accumulator
// of 64 registers a thread:
//   wgmma_ss_m64n128k16     both K-major (B: 128 rows n of 128 bytes)
//   wgmma_ss_m64n128k16_tb  B MN-major, two 64-column atoms (desc_sw128_mn)
//   wgmma_ss_m64n128k16_tt  A and B MN-major, B two atoms
// Everything here is sm_90a inline PTX; the accumulators stay in
// registers, in the layouts documented at each function.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows
// stored with the 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8)),
// the layout desc_sw128 describes
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously; with ok false the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when ok is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy shared-memory writes (cp.async
// results, in-place RoPE) before later async-proxy reads (wgmma operands);
// a block barrier after it extends that to the other threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit (one MUFU.EX2, ~2 ulp; results
// below 2^-126 flush to 0): the online softmax's exponential, whose
// throughput rivals the tensor cores' at head_dim 64
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to bf16 (nearest even) in one 32-bit register,
// the first in the low half: an MMA operand pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// wgmma (one warpgroup, 128 threads)
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile stored as rows of 128 bytes
// (64 bf16) with the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)), its base 1024-byte aligned.  Both byte offsets are
// 1024 (one 8-row swizzle atom), which is the 8-row stride for a K-major
// operand and the 8-row stride along K for an MN-major one whose MN
// extent is a single 128-byte atom (the other offset is then unused).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptor of an MN-major operand wider than one swizzle atom:
// atoms of [k rows][64 columns] (128-byte rows, swizzled), `atom_bytes`
// apart.  The leading byte offset is the stride between the atoms along
// MN, the stride byte offset (1024) that between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t saddr,
                                                  uint32_t atom_bytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(atom_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it (call after wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RTT_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define RTT_WGMMA_OUT32(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// D[64][64] (f32) (+)= A[64][16] B[16][64], A and B bf16 in shared memory,
// both K-major (A rows m, B rows n, each with k contiguous).  Thread t of
// the warpgroup (warp w, lane l) holds d[4 j + 2 i + e] = D[16 w + l / 4 +
// 8 i][8 j + 2 (l % 4) + e].  accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same product with B MN-major: B stored as rows k of 64 n (one
// 128-byte swizzle atom wide), so a k16 step advances the B descriptor
// by 16 rows (2048 bytes, + 128 in its 16-byte units) and a wider B is
// one instruction per 64-column atom.  It always accumulates.
__device__ __forceinline__ void wgmma_ss_m64n64k16_tb(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same with A MN-major as well: A stored as rows k of 64 m, its k16
// step + 128 like B's (the product a^T b of two row-major [k][64] tiles)
__device__ __forceinline__ void wgmma_ss_m64n64k16_tt(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// D[64][64] += A[64][16] B[16][64] with A in registers and B in shared
// memory MN-major (rows k, n contiguous: the transpose bit).  Thread t
// holds a[0] = A[16 w + l / 4][2 (l % 4) + {0, 1}], a[1] the same 8 rows
// further, a[2] and a[3] the same at k + 8: the accumulator layout of a
// 64 x 16 slice of a previous product, rounded to bf16 and packed.
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define RTT_WGMMA_D64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define RTT_WGMMA_OUT64(d)                                                 \
  RTT_WGMMA_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D[64][128] (f32) += A[64][16] B[16][128], A and B bf16 in shared
// memory, both K-major (B: 128 rows n, k contiguous, 8-row groups 1024
// bytes apart).  Thread t (warp w, lane l) holds d[4 j + 2 i + e] =
// D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e], j < 16.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RTT_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same with B MN-major: B as two atoms of [16 k rows][64 n] within
// atoms of 64 k rows (desc_sw128_mn); a k16 step advances B by 2048
// bytes (+ 128 in 16-byte units).
__device__ __forceinline__ void wgmma_ss_m64n128k16_tb(float (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RTT_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : RTT_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same with A MN-major as well (one 64-column atom, rows k; a k16
// step + 128 like B's): the product a^T b of a [k][64] and a [k][128].
__device__ __forceinline__ void wgmma_ss_m64n128k16_tt(float (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RTT_WGMMA_D64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : RTT_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef RTT_WGMMA_D32
#undef RTT_WGMMA_OUT32
#undef RTT_WGMMA_D64
#undef RTT_WGMMA_OUT64

// ---------------------------------------------------------------------------
// TMA (cp.async.bulk.tensor) and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (the
// TMA unit that completes their transactions); a block barrier after it
// extends that to the other threads
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete.  A copy that never
// lands traps after ~2^34 cycles (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// box (c0, c1) of a 2-D tensor map (c0 the inner, contiguous coordinate)
// into shared memory at dst; completion counted in bytes on bar.  Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// shared memory at src to box (c0, c1) of a 2-D tensor map; elements
// outside the tensor are not written.  Tracked by the bulk group.
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A 2-D bf16 tensor map over `outer` rows of `inner` elements, `row_bytes`
// apart, copied in boxes of 64 x 64 with the 128-byte swizzle (the layout
// desc_sw128 and swz128 describe).  The driver's encoder is looked up
// once through the runtime, so nothing links against libcuda.  False when
// it is missing or refuses the tensor (base and row_bytes must be
// 16-byte multiples).
inline bool tmap_bf16_64x64(CUtensorMap* map, const void* base,
                            uint64_t inner, uint64_t outer,
                            uint64_t row_bytes) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 and ldmatrix (one warp)
// ---------------------------------------------------------------------------

// C[16][8] (f32) += A[16][16] B[16][8] (bf16).  Lane l holds c[2 i + e] =
// C[l / 4 + 8 i][2 (l % 4) + e]; a[0] = A[l / 4][2 (l % 4) + {0, 1}],
// a[1] rows + 8, a[2] and a[3] the same at k + 8; b[0] = B[2 (l % 4) +
// {0, 1}][l / 4], b[1] at k + 8.
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8, and receives r[m] = M_m[l / 4][2 (l % 4) + {0, 1}]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, transposed: r[m] = M_m[2 (l % 4) + {0, 1}][l / 4]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// An A operand of 16 rows x 16 k from a previous product's accumulators,
// rounded to bf16: c points at the 8 values of two adjacent 8-column
// tiles (c[0..3] columns 0-7, c[4..7] columns 8-15, in the layout of
// mma_m16n8k16's C and of wgmma's D), whose columns become this
// product's k.  The same repacking serves wgmma's register A.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

}  // namespace tc
}  // namespace rtt
