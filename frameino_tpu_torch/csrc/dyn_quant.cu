// Dynamic per-row int8 quantization for Hopper (sm_90a): bf16 rows in,
// int8 codes and one fp32 scale per row out.
//
// Replaces the Pallas TPU kernel _dyn_quant_kernel of
// frameino_tpu/ops/dyn_quant.py (wrapper dynamic_quantize_rows), the
// activation quantizer of the w8a8 dense (ops/linear.py::dense_int8):
//
//   s  = max(amax(|x|) * fp32(1/127), 1e-12)
//   xq = round_half_even(x / s)
//
// The numerics are those of JAX's jitted formula, bit for bit: the absmax
// is exact in fp32, the scale MULTIPLIES by the fp32-rounded 1/127 (XLA
// rewrites the division by a constant), and x / s is an IEEE division
// (nvcc's default -prec-div=true; this file must not be built with
// --use_fast_math). __float2int_rn rounds half to even, as jnp.round and
// torch.round do; roundf would round half away from zero.
//
// Design. The work is a read of N x D bf16 and a write of N x D int8 plus
// N scales: 3 bytes per element, bound by HBM bandwidth. One block per
// row. Pass 1 reads the row in 16-byte vectors (8 bf16) and reduces |x|
// to its max with warp shuffles, then across warps in shared memory.
// Pass 2 reads the row again, from L2 (a row is 6-28 KB at the path's
// widths), and writes 8 codes per 8-byte store. A width that is not a
// multiple of 8 takes the scalar loops; no row is padded and nothing is
// written past a row's end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, to fp32
constexpr float kScaleFloor = 1e-12f;
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(__float2int_rn(v / s));
}

__global__ void dyn_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                      int8_t* __restrict__ xq,
                                      float* __restrict__ scale, int d) {
  __shared__ float warp_max[kMaxWarps];
  __shared__ float row_scale;
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  int8_t* qr = xq + row * d;
  const bool vec = (d % 8) == 0;  // rows start 16-byte aligned

  // pass 1: absmax of the row
  float amax = 0.0f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / 8; i += blockDim.x) {
      const uint4 u = xv[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        amax = fmaxf(amax, fabsf(bf16_bits_to_float(w[j] & 0xffffu)));
        amax = fmaxf(amax, fabsf(bf16_bits_to_float(w[j] >> 16)));
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      m = fmaxf(m, warp_max[w]);
    }
    const float s = fmaxf(m * kInv127, kScaleFloor);
    row_scale = s;
    scale[row] = s;
  }
  __syncthreads();
  const float s = row_scale;

  // pass 2: codes
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint2* qv = reinterpret_cast<uint2*>(qr);
    for (int i = threadIdx.x; i < d / 8; i += blockDim.x) {
      const uint4 u = xv[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = static_cast<uint8_t>(
            quantize(bf16_bits_to_float(w[j] & 0xffffu), s));
        const uint32_t hi = static_cast<uint8_t>(
            quantize(bf16_bits_to_float(w[j] >> 16), s));
        packed[j / 2] |= (lo | (hi << 8)) << (16 * (j % 2));
      }
      qv[i] = make_uint2(packed[0], packed[1]);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      qr[i] = quantize(__bfloat162float(xr[i]), s);
    }
  }
}

}  // namespace

// x [n, d] contiguous bf16 (16-byte aligned) -> xq [n, d] int8, scale [n]
// fp32. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an empty shape).
extern "C" int dyn_quant_rows_bf16(const void* x, void* xq, void* scale,
                                   int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // 128 threads cover a 3,072-wide row in three 16-byte loads each; wider
  // rows (the FFN's 12,288 and 14,336) take 256
  const int threads = d > 4096 ? 256 : 128;
  dyn_quant_rows_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(scale), d);
  return static_cast<int>(cudaGetLastError());
}
