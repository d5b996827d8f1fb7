// Register-level tensor-core and asynchronous-copy primitives for the
// bf16 attention kernels (flash_attention_fwd.cu, flash_attention_bwd.cu):
// cp.async with zero fill, the async-proxy fence, warpgroup MMA (wgmma)
// with its shared-memory descriptors, warp MMA (mma.sync m16n8k16) and
// ldmatrix.  Everything here is sm_90a inline PTX; the accumulators stay
// in registers, in the layouts documented at each function.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rtt {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

#undef RTT_WGMMA_D32
#undef RTT_WGMMA_OUT32

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
