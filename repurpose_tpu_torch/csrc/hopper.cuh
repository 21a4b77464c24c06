// Hopper (sm_90a) building blocks shared by the tensor-core kernels (the
// attention kernels through flash_fwd_tc.cuh / flash_bwd_tc.cuh, and
// int8_matmul.cu): shared-memory addresses, mbarriers, TMA and bulk copies,
// wgmma m64n64k16 (bf16 in, float32 accumulators in registers) and
// m64n128k32 (s8 in, int32 accumulators), the accumulator-to-A-operand
// repack, and the tensor maps of strided [B, T, H, 64] bf16 views and of
// int8 matrices. Everything lives in namespace `hopper`.
//
// The layouts below were checked on the card with the long-T backward: TMA 4D
// tensor maps with CU_TENSOR_MAP_SWIZZLE_128B write exactly the layout of a
// wgmma 128B-swizzle descriptor with SBO 1024 (8-row groups).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12050
#error "the tensor-core kernels need the CUDA 12.5 toolkit or newer"
#endif

namespace hopper {

#define WG_D32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_D32_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

constexpr int ROWS = 64;  // rows of every TMA box and wgmma tile here (m64)
constexpr int TC_DH = 64;  // head width of the tensor-core kernels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the phase of parity `parity` of `bar` has completed. The loop
// lives inside one asm statement, so the compiler sees no divergent branch
// before the wgmma that follow (it would serialise them); it traps (the
// launch then fails) after 2**28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 268435456;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 64 rows t0.. of head h, batch row b, of a [B, T, H, 64] view into a
// 128-byte-swizzled [64, 64] tile; completes on `bar`.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// The box at (c0, c1) (innermost first) of a 2D tensor map into `dst`;
// completes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16); completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Makes this thread's ordinary stores to shared memory visible to the async
// proxy (wgmma and TMA read it there); a barrier among the readers follows.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) among `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at barrier `id` without waiting (the waiters use named_barrier
// with the same count).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers an asynchronous wgmma reads or writes at this point.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// Descriptor of a 128-byte-swizzled bf16 tile with 128-byte rows (as TMA
// writes it), 8-row groups 1024 bytes apart. K-major use (Dh the reduction
// axis): lbo is unused, a k16 slice starts 32 bytes further. MN-major use
// (rows the reduction axis, the transposed B operand): groups of 8 reduction
// rows are `sbo` = 1024 apart, a k16 slice starts 2048 bytes further, and
// the 64 columns are one swizzle span (lbo unused). Checked on the card.
constexpr unsigned SW_GROUP = 1024;
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}
constexpr uint64_t K_STEP = 32 >> 4;    // descriptor step of a k16 slice, K-major
constexpr uint64_t MN_STEP = 2048 >> 4;  // and MN-major

// d += A . B^T over one k16 slice (d = A . B^T with accumulate = 0), A
// [64, 16] and B [64, 16] K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B over one k16 slice, A [64, 16] bf16 in registers (the m16n8k16
// A layout per warp) and B [16, 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 64 int32 accumulators of m64n128 (s8 products): the operand list of
// wgmma_s8, in the m64nN accumulator layout (acc_to_a's note below).
#define WG_R64(d)                                                                            \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),        \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),             \
      "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),          \
      "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),          \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),          \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),          \
      "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),          \
      "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),          \
      "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),          \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),          \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define WG_R64_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += A . B^T over one k32 slice of int8 (d = A . B^T with accumulate = 0),
// exact in int32: A [64, 32] and B [128, 32] s8, both K-major in shared
// memory (8-bit wgmma has no transpose flag, so B must be stored K-major
// too). One 128-byte swizzle row holds 128 int8, four k32 slices: a slice
// starts 32 bytes further (K_STEP), as a bf16 k16 slice does.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_R64_LIST
      ", %64, %65, p;\n}\n"
      : WG_R64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void reg_fence(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Two floats as a bf16 pair (lo in the low half): rounded to nearest even,
// or, with EXACT (both already hold bf16 values), their upper halves by one
// byte permute.
template <bool EXACT>
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  if constexpr (EXACT) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Accumulator layout of m64nN: thread (warp w, lane l) holds rows
// r = 16w + l/4 and r + 8, columns c = 8n + 2(l%4) and c + 1 of block n:
// d[4n + 0, 1] = (r, c / c + 1), d[4n + 2, 3] = (r + 8, c / c + 1). The A
// operand of a k16 slice kk holds the blocks 2kk and 2kk + 1 the same way,
// so a 64 x 64 accumulator becomes four bf16 slices in place.
template <bool EXACT>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16<EXACT>(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16<EXACT>(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16<EXACT>(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16<EXACT>(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (nothing links against libcuda)
// with cudaGetDriverEntryPointByVersion, which CUDA 12.5 introduced.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a [B, T, H, 64] bf16 view (element strides sb, st, sh of
// batch, token and head; contiguous head dim): boxes of 64 rows of one head,
// with the 128-byte swizzle the wgmma descriptors expect; rows past T read
// as 0. Returns 0, or a CUDA error for a view no tensor map can describe.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int T_len, int H,
                       long long sb, long long st, long long sh) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {TC_DH, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {TC_DH, 1, ROWS, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A tensor map over a row-major [rows, cols] int8 matrix whose rows are
// `row_bytes` apart (a multiple of 16, and the base 16-byte aligned: TMA's
// rule): boxes of [box_rows, 128] bytes with the 128-byte swizzle, each
// 128-byte row one swizzle row, as an 8-bit K-major wgmma operand is read;
// bytes outside the matrix read as 0. Returns 0, or a CUDA error.
inline int encode_int8_rows(CUtensorMap* map, const void* base, long long rows, long long cols,
                            long long row_bytes, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
