// Hopper (sm_90a) building blocks shared by the port's kernel sources:
// shared-memory addressing, mbarriers, TMA loads and stores, wgmma
// descriptors, the m64n128k16 bf16 products (A from shared memory or from
// registers) and the m64n{64,128}k32 s8 products, and the host-side
// tensor-map encoder. Each source that
// includes this header gets its own copies (anonymous namespace); the
// kernels themselves stay in their sources.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

// ------------------------------------------------------------ primitives --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Dynamic shared memory rounded up to the 1024-byte alignment that the
// 128-byte swizzle pattern of TMA and wgmma needs.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  const unsigned pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return smem_raw + pad;
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         u64* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((u64)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            u64* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"((u64)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The cluster-wide barrier (every thread of every block of the cluster).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"((u64)map) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"((u64)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier over one consumer warpgroup (ids 1, 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in 128-byte swizzle:
// 8-row groups 1024 B apart (stride byte offset); the leading offset is
// unused for this layout. One k16 step is +32 B on the start address.
__device__ __forceinline__ u64 sw128_desc(const void* tile) {
  return (u64)((smem_u32(tile) & 0x3FFFFu) >> 4) | ((u64)1 << 16) |
         ((u64)(1024 >> 4) << 32) | ((u64)1 << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CRT_WGMMA_D64                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define CRT_WGMMA_D64_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15,"                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23,"                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31,"                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39,"                                 \
  "%40, %41, %42, %43, %44, %45, %46, %47,"                                 \
  "%48, %49, %50, %51, %52, %53, %54, %55,"                                 \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, fp32 accumulate; thread
// t of the warpgroup holds D[16 w + t/4 % 8 (+8)][8 j + 2 (t % 4) (+1)] in
// d[4 j ..], w = warp of the warpgroup.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], u64 da,
                                                 u64 db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      CRT_WGMMA_D64_LIST ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CRT_WGMMA_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same product with A from registers: thread t of warp w holds, as
// bf16 pairs (lower column in the low half), a[0] = A[16 w + g][2 c, 2 c +
// 1], a[1] = A[16 w + g + 8][2 c ..], a[2] = A[16 w + g][2 c + 8 ..], a[3] =
// A[16 w + g + 8][2 c + 8 ..], g = t / 4 % 8, c = t % 4.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const unsigned (&a)[4],
                                                    u64 db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      CRT_WGMMA_D64_LIST ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : CRT_WGMMA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// wgmma descriptor of a K-major tile of 64-byte rows in 64-byte swizzle
// (64 int8 per row): 8-row groups 512 B apart; the leading offset is
// unused for this layout. One k32 step of int8 is +32 B on the start
// address. The tile starts on a 512-byte boundary.
__device__ __forceinline__ u64 sw64_desc(const void* tile) {
  return (u64)((smem_u32(tile) & 0x3FFFFu) >> 4) | ((u64)1 << 16) |
         ((u64)(512 >> 4) << 32) | ((u64)2 << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define CRT_R8(i)                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),               \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// s8 x s8 products with exact s32 accumulation, both operands K-major in
// shared memory (8-bit wgmma has no transpose): D[64 x N] += A[64 x 32]
// B[32 x N]. Thread t of warp w holds D[16 w + t/4 % 8 (+8)][8 j + 2 (t %
// 4) (+1)] in d[4 j ..], as for the fp32 products above.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], u64 da,
                                                    u64 db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      CRT_WGMMA_D64_LIST ", %64, %65, 1;\n"
      : CRT_R8(0), CRT_R8(8), CRT_R8(16), CRT_R8(24), CRT_R8(32),
        CRT_R8(40), CRT_R8(48), CRT_R8(56)
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], u64 da,
                                                   u64 db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1;\n"
      : CRT_R8(0), CRT_R8(8), CRT_R8(16), CRT_R8(24)
      : "l"(da), "l"(db));
}

#undef CRT_R8
#undef CRT_WGMMA_D64
#undef CRT_WGMMA_D64_LIST

// ------------------------------------------------------------------ host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, inner] tensor read or written in boxes of [box_rows,
// box_inner] (128-byte swizzle unless stated); elements past the edge read
// as zero.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
             const void* base, int inner, int rows, int box_inner,
             int box_rows,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// An NHWC int8 tensor [B, H, W, C] read in boxes of [1, rows, W, box_c]
// (whole image rows); pixels outside the image, and channels past C, read
// as zero.
int make_map_rows(CUtensorMap* map, const void* base, int B, int H, int W,
                  int C, int rows, int box_c, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                 (cuuint64_t)H * W * C};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)W,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The current device's SM count (-1 if it cannot be read).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace
