// Shared pieces of the experiment flash forwards (flash_variants.cu,
// flash_packed.cu): the tile constants, the bf16 packing helpers, the
// mma.sync wrappers and the shared-memory tile loaders. They repeat the
// structure of flash_fwd.cu (one block of 4 warps per 64 q rows, 64-key
// tiles staged synchronously in shared memory, mma.sync products), so that
// a variant's time differs from K3's by its switch and nothing else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flashx {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kOnesBf16x2 = 0x3f803f80u;  // (1.0, 1.0) in bf16

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Round each bf16 of a pair to bf16(float(x) * scale): the TPU wrapper's
// `q * jnp.asarray(scale * log2e, q.dtype)`.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return pack_bf16x2(__bfloat162float(v.x) * scale,
                     __bfloat162float(v.y) * scale);
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of a [rows, kRowBytes]-byte matrix into
// shared memory (row stride kRowBytes + 16 bytes, which keeps the mma
// fragment loads free of bank conflicts); rows at or past `rows` are
// zero-filled.
template <int kRowBytes>
__device__ __forceinline__ void load_tile_bytes(unsigned char* dst,
                                                const unsigned char* src,
                                                int row0, int rows) {
  constexpr int kVecs = kRowBytes / 16;  // 16-byte vectors per row
  constexpr int kStride = kRowBytes + 16;
  for (int i = threadIdx.x; i < kBlockN * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kRowBytes)[c];
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 16) = val;
  }
}

// max / sum over the four threads of an mma group, which hold one row
// between them
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

}  // namespace flashx
