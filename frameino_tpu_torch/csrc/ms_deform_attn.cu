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
// The arithmetic per sample is the plain version's, each product and sum
// rounded on its own (no contraction into a fused multiply-add): the four
// corner weights (1 - fx)(1 - fy), fx(1 - fy), (1 - fx)fy, fx fy, the
// corner products summed left to right, times the attention weight, the
// samples of a level summed in order before the level is added.
//
// What bounds it. At OneFormer's shape ([1, 21168, 8, 32], 3 levels x 4
// points) the inputs and the output are 67.7 MB, but the bilinear corners
// are 1.04 GB of 128-byte value rows, gathered from a value tensor (21.7 MB)
// that stays in the 50 MB L2: the kernel is bound by how many corner reads
// it keeps in flight, and by how many of them L1 serves.
//
// Design.
// 1. Work order for reuse: a block takes kQueriesPerBlock consecutive
//    queries of one head (blocks ordered query tile, then head, so the
//    blocks in flight cover whole rows of the locations, weights and
//    output). In the encoder, query q samples near its own pixel, so a
//    block's queries read overlapping value rows, and the kernel asks for
//    the largest L1 (no shared memory).
// 2. Sample metadata once per quarter-warp: a quarter-warp (8 lanes) holds
//    one query; lane j loads samples j, j + 8, ... (locations and weights,
//    coalesced), computes the corner row, the in-bounds mask and the
//    fractions, and the lanes read them from it with __shfl_sync.
// 3. Many corners in flight: a lane holds kVec channels (a float4 where D
//    is a multiple of 4), so 8 lanes read one 128-byte corner row and a
//    warp instruction reads four queries' corners. The corners of a group
//    of kGroup samples (8 loads a lane) are issued before any is summed.
//    A D over 32 takes several passes of 32 channels.
// (L, P) = (3, 4), OneFormer's, is a template instance with the sample
// loops unrolled; any other L (up to kMaxLevels) and P take the
// runtime-shape instance, and a D that is not a multiple of 4 (or
// unaligned tensors) the scalar one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kQueriesPerWarp = 4;                         // a quarter-warp each
constexpr int kLanesPerQuery = 32 / kQueriesPerWarp;       // 8
constexpr int kQueriesPerBlock = kWarpsPerBlock * kQueriesPerWarp;  // 32
constexpr int kGroup = 2;        // samples whose corners are loaded together
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <int kVec>
struct Lanes;

template <>
struct Lanes<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Lanes<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
};

// ((v0 w0 + v1 w1) + v2 w2) + v3 w3, each step rounded: the plain version's
__device__ __forceinline__ float bilinear(float v0, float v1, float v2,
                                          float v3, float w0, float w1,
                                          float w2, float w3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v0, w0), __fmul_rn(v1, w1)),
                             __fmul_rn(v2, w2)),
                   __fmul_rn(v3, w3));
}

__device__ __forceinline__ float4 bilinear(float4 v0, float4 v1, float4 v2,
                                           float4 v3, float w0, float w1,
                                           float w2, float w3) {
  return make_float4(bilinear(v0.x, v1.x, v2.x, v3.x, w0, w1, w2, w3),
                     bilinear(v0.y, v1.y, v2.y, v3.y, w0, w1, w2, w3),
                     bilinear(v0.z, v1.z, v2.z, v3.z, w0, w1, w2, w3),
                     bilinear(v0.w, v1.w, v2.w, v3.w, w0, w1, w2, w3));
}

// acc + s * a, the product rounded before the sum
__device__ __forceinline__ float axpy(float acc, float s, float a) {
  return __fadd_rn(acc, __fmul_rn(s, a));
}

__device__ __forceinline__ float4 axpy(float4 acc, float4 s, float a) {
  return make_float4(axpy(acc.x, s.x, a), axpy(acc.y, s.y, a),
                     axpy(acc.z, s.z, a), axpy(acc.w, s.w, a));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// kL, kP: the levels and points of the unrolled instance, 0 at runtime
template <int kL, int kP, int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ weight,
                      float* __restrict__ out, Levels lv, int S, int H,
                      int D, int Q, int L_rt, int P_rt, int tiles) {
  using V = typename Lanes<kVec>::T;
  const int P = kP > 0 ? kP : P_rt;
  const int LP = (kL > 0 ? kL : L_rt) * P;
  // block = (b * tiles + tile) * H + h
  const int h = blockIdx.x % H;
  const int tile = (blockIdx.x / H) % tiles;
  const int b = blockIdx.x / (H * tiles);
  const int lane = threadIdx.x % 32;
  const int j = lane % kLanesPerQuery;   // the lane within its quarter-warp
  const int q = tile * kQueriesPerBlock
                + (threadIdx.x / 32) * kQueriesPerWarp
                + lane / kLanesPerQuery;
  // a quarter-warp past the last query works on the last one (every lane
  // takes part in the shuffles) and writes nothing
  const bool live = q < Q;
  const long row = (static_cast<long>(b) * Q + (live ? q : Q - 1)) * H + h;
  const float* loc_r = loc + row * LP * 2;
  const float* w_r = weight + row * LP;
  const long row_stride = static_cast<long>(H) * D;  // a value row over S
  const float* vb = value + static_cast<long>(b) * S * row_stride
                    + static_cast<long>(h) * D;

  for (int d0 = 0; d0 < D; d0 += kLanesPerQuery * kVec) {
    const int d = d0 + j * kVec;
    const bool on = live && d < D;
    V acc = Lanes<kVec>::zero(), lvl = Lanes<kVec>::zero();
#pragma unroll
    for (int r0 = 0; r0 < LP; r0 += kLanesPerQuery) {
      // lane j's sample, i = r0 + j: its corner (x0, y0) as a value row of
      // the batch, the in-bounds bits of its four corners, its fractions
      // and its attention weight
      int corner = 0, inside = 0;
      float fx = 0.f, fy = 0.f, a = 0.f;
      if (r0 + j < LP) {
        const int i = r0 + j;
        const int l = i / P;
        const int hl = lv.h[l], wl = lv.w[l];
        // rounded twice, as the plain version rounds them: a fused
        // multiply-add would move x by an ulp (1.5e-5 at W = 168), and the
        // sample by that much times the neighbouring values' difference
        const float x = __fsub_rn(__fmul_rn(__ldg(loc_r + 2 * i), wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(__ldg(loc_r + 2 * i + 1), hl),
                                  0.5f);
        a = __ldg(w_r + i);
        const float x0f = floorf(x), y0f = floorf(y);
        fx = __fsub_rn(x, x0f);
        fy = __fsub_rn(y, y0f);
        const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
        const bool xa = x0 >= 0 && x0 < wl, xb = x0 >= -1 && x0 + 1 < wl;
        const bool ya = y0 >= 0 && y0 < hl, yb = y0 >= -1 && y0 + 1 < hl;
        inside = (xa && ya) | (xb && ya) << 1 | (xa && yb) << 2
                 | (xb && yb) << 3;
        corner = inside ? lv.start[l] + y0 * wl + x0 : 0;
      }
#pragma unroll
      for (int g0 = 0; g0 < kLanesPerQuery; g0 += kGroup) {
        V v[kGroup][4];
        float gx[kGroup], gy[kGroup], ga[kGroup];
        // every corner of the group's samples in flight...
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int i = r0 + g0 + g;
          const int src = g0 + g;
          const int c = __shfl_sync(kFull, corner, src, kLanesPerQuery);
          const int m = __shfl_sync(kFull, inside, src, kLanesPerQuery)
                        & (on && i < LP ? 0xf : 0);
          gx[g] = __shfl_sync(kFull, fx, src, kLanesPerQuery);
          gy[g] = __shfl_sync(kFull, fy, src, kLanesPerQuery);
          ga[g] = __shfl_sync(kFull, a, src, kLanesPerQuery);
          const long wl = i < LP ? lv.w[i / P] : 0;
          const float* p = vb + static_cast<long>(c) * row_stride + d;
          v[g][0] = m & 1 ? Lanes<kVec>::load(p) : Lanes<kVec>::zero();
          v[g][1] = m & 2 ? Lanes<kVec>::load(p + row_stride)
                          : Lanes<kVec>::zero();
          v[g][2] = m & 4 ? Lanes<kVec>::load(p + wl * row_stride)
                          : Lanes<kVec>::zero();
          v[g][3] = m & 8 ? Lanes<kVec>::load(p + (wl + 1) * row_stride)
                          : Lanes<kVec>::zero();
        }
        // ...then summed in the plain version's order
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int i = r0 + g0 + g;
          if (i < LP) {
            const float ux = __fsub_rn(1.f, gx[g]), uy = __fsub_rn(1.f, gy[g]);
            const V s = bilinear(v[g][0], v[g][1], v[g][2], v[g][3],
                                 __fmul_rn(ux, uy), __fmul_rn(gx[g], uy),
                                 __fmul_rn(ux, gy[g]),
                                 __fmul_rn(gx[g], gy[g]));
            lvl = axpy(lvl, s, ga[g]);
            if ((i + 1) % P == 0) {   // the level's last point
              acc = add(acc, lvl);
              lvl = Lanes<kVec>::zero();
            }
          }
        }
      }
    }
    if (on) Lanes<kVec>::store(out + row * D + d, acc);
  }
}

template <int kL, int kP, int kVec>
int launch(const float* value, const float* loc, const float* weight,
           float* out, const Levels& lv, int B, int S, int H, int D, int Q,
           int L, int P, cudaStream_t stream) {
  auto* kernel = ms_deform_attn_kernel<kL, kP, kVec>;
  static bool carved = false;   // the largest L1: the kernel has no shared
  if (!carved) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return static_cast<int>(e);
    carved = true;
  }
  const int tiles = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const long blocks = static_cast<long>(B) * tiles * H;
  if (blocks >= (1L << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      value, loc, weight, out, lv, S, H, D, Q, L, P, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value [B, S, H, D], loc [B, Q, H, L, P, 2], weight [B, Q, H, L, P] and
// out [B, Q, H * D], contiguous fp32 on the card; levels: host int32 [L, 2]
// (H_l, W_l), level l's rows starting at the sum of the earlier levels'.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take: more than kMaxLevels levels, levels that
// do not add up to S, or more blocks than the grid holds).
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
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(value);
  const auto* lc = static_cast<const float*>(loc);
  const auto* w = static_cast<const float*>(weight);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(value) % 16 == 0
                    && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec4) return launch<0, 0, 1>(v, lc, w, o, lv, B, S, H, D, Q, L, P, st);
  if (L == 3 && P == 4) {
    return launch<3, 4, 4>(v, lc, w, o, lv, B, S, H, D, Q, L, P, st);
  }
  return launch<0, 0, 4>(v, lc, w, o, lv, B, S, H, D, Q, L, P, st);
}
