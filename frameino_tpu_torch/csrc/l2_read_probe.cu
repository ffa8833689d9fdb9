// A measurement kernel, on no path of the port: reads 128-byte rows of a
// buffer in a hashed order, the way K13 (ms_deform_attn.cu) reads its
// bilinear corners (a quarter-warp of 8 lanes a row, a float4 a lane), but
// through L2 only (ld.global.cg). On a buffer that stays in the 50 MB L2
// (K13's value tensor at OneFormer's shape is 21.7 MB), bytes over time is
// the card's L2 read rate for this access, which gives K13 a second
// yardstick beside its byte bound: its corner reads over that rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 32;        // 128 bytes
constexpr int kLanesPerRow = kRowFloats / 4;

__global__ void __launch_bounds__(kThreads)
l2_read_kernel(const float* __restrict__ buf, int n_rows, int reads,
               float* __restrict__ out) {
  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const int j = threadIdx.x % kLanesPerRow;
  // one linear congruential stream a quarter-warp: its 8 lanes read the
  // same row
  uint32_t h = static_cast<uint32_t>(t / kLanesPerRow) * 2654435761u + 1u;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int k = 0; k < reads; ++k) {
    h = h * 1664525u + 1013904223u;
    const long r = static_cast<long>(
        (static_cast<uint64_t>(h) * static_cast<uint32_t>(n_rows)) >> 32);
    const float4 v = __ldcg(
        reinterpret_cast<const float4*>(buf + r * kRowFloats) + j);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[t] = acc.x + acc.y + acc.z + acc.w;
}

}  // namespace

// buf: [n_rows, 32] fp32 on the card, 16-byte aligned; out: blocks * 256
// floats. Each quarter-warp reads ``reads`` rows: blocks * 32 * reads rows
// of 128 bytes in all. Returns cudaGetLastError() after the launch.
extern "C" int l2_read_probe_fp32(const void* buf, int n_rows, int reads,
                                  void* out, int blocks, void* stream) {
  if (n_rows <= 0 || reads <= 0 || blocks <= 0 ||
      reinterpret_cast<uintptr_t>(buf) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  l2_read_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), n_rows, reads,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
