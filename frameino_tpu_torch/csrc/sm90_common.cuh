// Hopper (sm_90a) building blocks in inline PTX, shared by the kernels that
// take their tiles by TMA and multiply them with wgmma:
//   - mbarriers: init, arrive, arrive with an expected byte count, parity
//     wait;
//   - TMA: 3-D tensor-map loads and 1-D bulk loads that complete on an
//     mbarrier, 3-D reduce-adds from shared memory (bulk groups), and the
//     host-side encoding of a [batch, rows, cols] int8, bf16 or fp32 map
//     (found through the CUDA runtime, so no -lcuda);
//   - wgmma: shared-memory descriptors for the 128- and 64-byte swizzles
//     and for unswizzled operands, fence / commit / wait, m64nNk16 f32 +=
//     bf16 x bf16 with A from shared memory or from registers, B from
//     shared memory, either K-major or MN-major (the transpose bits), and
//     m64nNk32 s32 += s8 x s8 (N = 128, 160, 256) with both operands
//     K-major in shared memory (integer wgmma has no transpose bits);
//   - setmaxnreg, named barriers, the generic -> async proxy fence.
//
// Tile layout. Every tile lives in shared memory as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: a box of 64 bf16 (128 bytes) by R rows, row r
// at byte r * 128, its 16-byte chunk c stored at chunk c ^ (r % 8). A D =
// 128 tile is two such boxes ("column blocks") one after the other. Every
// tile starts on a 1024-byte boundary, so that the swizzle phase of a row is
// r % 8 and the descriptors below can address it by plain byte offsets:
//   - K-major operand (rows = M or N, the depth contiguous): 8-row groups
//     1024 bytes apart (SBO); the k-th 16-deep slice of a column block starts
//     32 * k bytes into it;
//   - MN-major operand (rows = depth, M or N contiguous): 8-row groups of the
//     depth 1024 bytes apart (SBO), 64-wide M/N atoms one column block apart
//     (LBO); the k-th 16-deep slice starts 2048 * k bytes in.
// An fp32 box of the same swizzle is 32 columns wide (128 bytes a row).
// An int8 row of 128 bytes is one such box as it stands (the k-th 32-deep
// slice starts 32 * k bytes in); an int8 row of 64 bytes takes the 64-byte
// swizzle (CU_TENSOR_MAP_SWIZZLE_64B): row r at byte r * 64, its chunk c
// at c ^ ((r / 2) % 4), 8-row groups 512 bytes apart.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed (the k-th
// completion, k = 1, 2, ..., has parity (k - 1) & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Box at coordinates (c0 = column, c1 = row, c2 = batch) of a 3-D map into
// shared memory; completes `bytes` of `bar`'s expected count. Rows past the
// tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Adds the box at `src` (shared memory, laid out as a load of the same box
// would leave it) into the tensor at (c0, c1, c2), element by element; rows
// past the tensor's end are dropped. Joins this thread's open bulk group.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk groups have read their shared memory
// (which may then be overwritten) ...
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... or have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `smem_addr` (see the top).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// ... of a 64-byte-swizzled one (8-row groups `sbo_bytes` apart, rows of 64
// bytes; its tile must start on a 512-byte boundary) ...
__device__ __forceinline__ uint64_t desc_sw64(uint32_t smem_addr,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return (desc_sw128(smem_addr, lbo_bytes, sbo_bytes) & ~(3ull << 62)) |
         (2ull << 62);
}

// ... and of an unswizzled one (8-row x 16-byte core matrices, those
// adjacent in the depth `lbo_bytes` apart, in M or N `sbo_bytes` apart).
__device__ __forceinline__ uint64_t desc_plain(uint32_t smem_addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return desc_sw128(smem_addr, lbo_bytes, sbo_bytes) & ~(3ull << 62);
}

// The descriptor `d` moved `bytes` (a multiple of 16) on in shared memory:
// the start address is its low 14 bits, so only the low word changes.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return (d & 0xFFFFFFFF00000000ull) |
         (static_cast<uint32_t>(d) + (bytes >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program: an accumulator is read only
// after the wait that completes it, and a register A operand stays live
// (unclobbered) until that wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define SM90_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_F16(d, i) \
  SM90_F4(d, i), SM90_F4(d, i + 4), SM90_F4(d, i + 8), SM90_F4(d, i + 12)
#define SM90_F32(d) SM90_F16(d, 0), SM90_F16(d, 16)
#define SM90_F64(d) SM90_F16(d, 0), SM90_F16(d, 16), SM90_F16(d, 32), SM90_F16(d, 48)
#define SM90_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SM90_R16(d, i) \
  SM90_R4(d, i), SM90_R4(d, i + 4), SM90_R4(d, i + 8), SM90_R4(d, i + 12)
#define SM90_R64(d) SM90_R16(d, 0), SM90_R16(d, 16), SM90_R16(d, 32), SM90_R16(d, 48)
#define SM90_R80(d) SM90_R64(d), SM90_R16(d, 64)
#define SM90_R128(d)                                                \
  SM90_R64(d), SM90_R16(d, 64), SM90_R16(d, 80), SM90_R16(d, 96), \
      SM90_R16(d, 112)

#define SM90_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define SM90_D80                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79}"
#define SM90_D128                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (64 x N fp32, the accumulator layout: row 16 * warp + lane / 4 (+ 8),
// column 8 * j + 2 * (lane % 4) (+ 1) in d[4 j + {0, 1, 2, 3}]) =
// scale_d * d + A (64 x 16, descriptor a) * B (16 x N, descriptor b).
// kTransA / kTransB: 0 = K-major, 1 = MN-major.
template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void mma_ss<64, 0, 0>(float (&d)[32], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_F32(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_ss<64, 1, 1>(float (&d)[32], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : SM90_F32(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_ss<128, 0, 0>(float (&d)[64], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_F64(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// d (64 x N int32, the accumulator layout of mma_ss) = scale_d * d + A
// (64 x 32 int8, descriptor a) * B (32 x N int8, descriptor b), both
// K-major. The int32 sums are exact.
template <int N>
__device__ __forceinline__ void mma_ss_s8(uint32_t (&d)[N / 2], uint64_t a,
                                          uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void mma_ss_s8<128>(uint32_t (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64
      ", %64, %65, p;\n}\n"
      : SM90_R64(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_ss_s8<160>(uint32_t (&d)[80], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 " SM90_D80
      ", %80, %81, p;\n}\n"
      : SM90_R80(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_ss_s8<256>(uint32_t (&d)[128], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " SM90_D128
      ", %128, %129, p;\n}\n"
      : SM90_R128(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// d (64 x N fp32) = scale_d * d + A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A fragment of each warp's 16 rows, which is also the layout
// of two neighbouring 8-column blocks of an accumulator) * B (descriptor).
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_rs<64, 1>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_rs<128, 1>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_rs<8, 0>(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

#undef SM90_F4
#undef SM90_F16
#undef SM90_F32
#undef SM90_F64
#undef SM90_D32
#undef SM90_D64
#undef SM90_D80
#undef SM90_D128
#undef SM90_R4
#undef SM90_R16
#undef SM90_R64
#undef SM90_R80
#undef SM90_R128

// ---------------------------------------------------------------------------
// registers, barriers, proxies
// ---------------------------------------------------------------------------

// Both must be executed by every thread of a warpgroup, on a path that the
// warpgroup never leaves (one if / else over the roles, no reconvergence).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads (a multiple
// of 32).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory stores of this thread become visible to the async proxy
// (wgmma, TMA) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (so the library
// needs no -lcuda); null where it is not available.
static inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : static_cast<EncodeTiledFn>(nullptr);
  }();
  return fn;
}

// Map of a contiguous [batch, rows, cols] tensor of int8 (elem_bytes 1),
// bf16 (2) or fp32 (4) whose box is `swizzle_bytes` (128 or 64) of columns
// (128 bytes: 128 int8, 64 bf16, 32 fp32) by `box_rows` rows of one batch
// entry, swizzled by as many bytes; reads past `rows` fill zeros and writes
// past it are dropped (never the next batch entry's rows). Returns 0, or -1
// without the encoder, or -(CUresult + 1).
static inline int encode_rows_map(CUtensorMap* map, const void* base,
                                  int elem_bytes, int batch, int rows,
                                  int cols, int box_rows,
                                  int swizzle_bytes = 128) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * elem_bytes,
      static_cast<cuuint64_t>(rows) * cols * elem_bytes};
  const cuuint32_t box[3] = {
      static_cast<cuuint32_t>(swizzle_bytes / elem_bytes),
      static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r) - 1;
}

}  // namespace sm90
