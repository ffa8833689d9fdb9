// Multi-scale deformable attention forward for Hopper (sm_90a), fp32.
//
// Replaces the reference's native kernel native/ms_deform_attn.cpp
// (ms_deform_attn_forward, bound by ctypes in frameino_tpu/native) and its
// XLA twin frameino_tpu/ops/ms_deform_attn.py::ms_deform_attn, the sampling
// step of OneFormer's six deformable encoder layers (Deformable DETR):
//
//   out[b, q, h, :] = sum_{l, p} w[b, q, h, l, p]
//                     * bilinear(value[b, level l, :, h, :], loc[b, q, h, l, p])
//
// with grid_sample(align_corners=False) coordinates, x = loc_x * W_l - 0.5,
// y = loc_y * H_l - 0.5 (each rounded twice, as JAX and the plain version
// round them), and zero padding: a corner outside the level adds nothing.
// The arithmetic per sample is the plain version's: the four
// corner weights (1 - fx)(1 - fy), fx(1 - fy), (1 - fx)fy, fx fy, the
// corners summed, times the attention weight, the samples of a level summed
// before the level is added to the output.
//
// Design. One warp per (b, q, h); the lanes hold the D channels (lane d,
// d + 32, ...), so a corner is one coalesced read of a value row (D = 32
// fp32: one 128-byte line). Every lane reads the sample's location and
// weight (a broadcast load). The L * P samples accumulate in fp32
// registers; the output row is written once. At OneFormer's shapes the
// value tensor (21,168 rows x 8 heads x 32 fp32 = 21.7 MB) stays in the
// H100's 50 MB L2, which serves the ~1 GB of corner reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float corner(const float* __restrict__ v,
                                        int ix, int iy, int hl, int wl,
                                        long row_stride) {
  if (ix < 0 || ix >= wl || iy < 0 || iy >= hl) return 0.0f;
  return __ldg(v + (static_cast<long>(iy) * wl + ix) * row_stride);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ weight,
                      float* __restrict__ out, Levels lv, int n_rows, int S,
                      int H, int D, int Q, int L, int P) {
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_rows) return;
  // warp = (b * Q + q) * H + h
  const int h = warp % H;
  const int b = warp / (H * Q);
  const long row_stride = static_cast<long>(H) * D;  // a value row over S
  const float* loc_r = loc + static_cast<long>(warp) * L * P * 2;
  const float* w_r = weight + static_cast<long>(warp) * L * P;
  float* out_r = out + static_cast<long>(warp) * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const float* vb = value + (static_cast<long>(b) * S + lv.start[l])
                                    * row_stride
                        + static_cast<long>(h) * D + (active ? d : 0);
      float lvl = 0.0f;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        // rounded twice, as the plain version rounds them: a fused
        // multiply-add would move x by an ulp (1.5e-5 at W = 168), and the
        // sample by that much times the neighbouring values' difference
        const float x = __fsub_rn(__fmul_rn(__ldg(loc_r + 2 * i), wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(__ldg(loc_r + 2 * i + 1), hl),
                                  0.5f);
        const float a = __ldg(w_r + i);
        const float x0f = floorf(x), y0f = floorf(y);
        const float fx = x - x0f, fy = y - y0f;
        const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
        float s = 0.0f;
        if (active) {
          s = corner(vb, x0, y0, hl, wl, row_stride) * ((1 - fx) * (1 - fy))
              + corner(vb, x0 + 1, y0, hl, wl, row_stride) * (fx * (1 - fy))
              + corner(vb, x0, y0 + 1, hl, wl, row_stride) * ((1 - fx) * fy)
              + corner(vb, x0 + 1, y0 + 1, hl, wl, row_stride) * (fx * fy);
        }
        lvl += s * a;
      }
      acc += lvl;
    }
    if (active) out_r[d] = acc;
  }
}

}  // namespace

// value [B, S, H, D], loc [B, Q, H, L, P, 2], weight [B, Q, H, L, P] and
// out [B, Q, H * D], contiguous fp32 on the card; levels: host int32 [L, 2]
// (H_l, W_l), level l's rows starting at the sum of the earlier levels'.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take: more than kMaxLevels levels, levels that
// do not add up to S, or more rows than the grid holds).
extern "C" int ms_deform_attn_fp32(const void* value, const void* loc,
                                   const void* weight, void* out,
                                   const int* levels, int B, int S, int H,
                                   int D, int Q, int L, int P, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || Q <= 0 || P <= 0 || L <= 0 ||
      L > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[2 * l];
    lv.w[l] = levels[2 * l + 1];
    lv.start[l] = static_cast<int>(start);
    if (lv.h[l] <= 0 || lv.w[l] <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    start += static_cast<long>(lv.h[l]) * lv.w[l];
  }
  const long n_rows = static_cast<long>(B) * Q * H;
  const long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (start != S || blocks >= (1L << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ms_deform_attn_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(weight), static_cast<float*>(out), lv,
      static_cast<int>(n_rows), S, H, D, Q, L, P);
  return static_cast<int>(cudaGetLastError());
}
