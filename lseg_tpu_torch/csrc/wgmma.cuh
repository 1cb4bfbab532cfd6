// The Hopper tile engine shared by the attention kernels: warpgroup
// matrix products (wgmma), the Tensor Memory Accelerator (TMA) tile load
// and 1-D bulk copies (also B19's and B3's), mbarriers, and the host-side
// tensor-map encoder.
//
// Tiles are bf16 with 64 columns (128 bytes a row: one head of 64), laid
// out in shared memory by TMA's 128-byte swizzle and read by wgmma through
// a descriptor of the same swizzle. A tile's base must be 1024-byte
// aligned (the swizzle pattern spans 8 rows of 128 bytes).
//
// Products are m64n64k16 bf16 -> fp32. The accumulator of one warpgroup
// (64 x 64 fp32) is `float acc[8][4]` per thread, laid out as mma.sync's
// m16n8 C fragment repeated over 8 column tiles: warp w of the group owns
// rows 16w..16w+15; thread lane holds rows g = lane / 4 and g + 8, columns
// nt * 8 + 2 * (lane % 4) + {0, 1} for nt = 0..7. The register A operand
// of the RS form is mma.sync's m16k16 A fragment of the same rows, so a
// score tile packed to bf16 (`pack_a`) feeds the next product unchanged.

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

#include "lseg_common.cuh"

namespace lseg {
namespace {
namespace wg {

constexpr int TILE = 64;                 // rows and bf16 columns of a tile
constexpr int TILE_BYTES = TILE * TILE * 2;  // 8192

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a 128-byte-swizzled tile at `p`: 8-row groups 1024 bytes
// apart (the stride byte offset). The leading byte offset is unused by
// these layouts (one swizzle atom spans the product's K, or its N, of 64).
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// K-major operand (rows contiguous along the reduced dim): k-step kk of 16
// columns is 32 bytes further along each swizzled row.
__device__ __forceinline__ uint64_t desc_kstep(uint64_t d, int kk) {
  return d + static_cast<uint64_t>(kk * 2);
}

// MN-major operand (the reduced dim runs down the rows, read transposed):
// k-step kk of 16 rows is 2048 bytes further.
__device__ __forceinline__ uint64_t desc_rowstep(uint64_t d, int kk) {
  return d + static_cast<uint64_t>(kk * 128);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define LSEG_WG_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define LSEG_WG_ACC(d)                                                      \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (+)= A . B, A and B from shared memory (SS). A is K-major; B is
// K-major (TB = 0: stored as N rows contiguous along K) or MN-major
// (TB = 1: stored as K rows contiguous along N). scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LSEG_WG_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : LSEG_WG_ACC(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d += A . B with A (64 x 16 bf16) from registers (RS), as mma.sync's A
// fragment of each warp's 16 rows.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[8][4],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LSEG_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LSEG_WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

#undef LSEG_WG_D32
#undef LSEG_WG_ACC

// d = A . B^T over the 64-deep reduced dim of two K-major tiles: 4
// k-steps issued as one commit group, not waited for.
__device__ __forceinline__ void product_abt(float (&d)[8][4], uint64_t da,
                                            uint64_t db) {
  fence_acc(d);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss<0>(d, desc_kstep(da, kk), desc_kstep(db, kk), kk > 0);
  commit();
}

// The A fragments of a 64 x 64 fp32 accumulator tile cast to bf16: k-step
// kk takes column tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// d += P . B, P (64 x 64) from registers, B an MN-major tile whose rows
// run along the reduced dim; issued, not waited for.
__device__ __forceinline__ void product_pb(float (&d)[8][4],
                                           const uint32_t (&a)[4][4],
                                           uint64_t db) {
  fence_acc(d);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<1>(d, a[kk], desc_rowstep(db, kk), 1);
  commit();
}

// ---- mbarrier and TMA ------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete. A barrier that never
// completes (a copy that was never issued) traps after some 2^30 polls,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 bf16 tile of a 3-D map (columns, rows, images) at column c,
// row r, image i into `dst`; completion counts its bytes on `bar`. Rows
// past the map's end are zero-filled (and counted).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int r, int i) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(r), "r"(i)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory at `src` into
// shared memory at `dst` by one bulk copy, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) of shared memory at `src` to device memory at
// `dst` by one bulk copy of this thread's bulk group (commit and wait with
// cp.async.bulk.commit_group / wait_group).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// Named barrier over the first `threads` threads of the block (id >= 1;
// id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- host: the tensor map --------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no link to libcuda; null where the driver lacks it.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a row-major bf16 array (images, rows, cols) with 64 x 64
// boxes of one image, 128-byte swizzle, zero fill past the edges. Needs a
// 16-byte aligned base and cols % 8 == 0. Returns 0 or a CUDA error code.
//
// The encoder needs a current context. A host thread that has not yet
// made one current (a fresh thread of the caller's, such as an autograd
// worker whose device was already the default) gets the primary context
// of the array's device bound, and the map is encoded again.
inline int make_map(CUtensorMap* map, const void* base, int cols, int rows,
                    int images) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(images)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(cols) * 2 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {TILE, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  auto encode = [&] {
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    cudaPointerAttributes at;
    if (cudaPointerGetAttributes(&at, base) == cudaSuccess &&
        cudaSetDevice(at.device) == cudaSuccess)
      r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory above the 48 KB default, set once per kernel.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace wg
}  // namespace
}  // namespace lseg
