// Head-pair-packed flash-attention forward for head_dim 64 on Hopper
// (sm_90a): bf16 in/out, fp32 softmax statistics and accumulation.
//
// Replaces the Pallas TPU kernel `_packed_kernel` of
// scripts/bench_attn_d64.py (`packed_flash`). Rows are packed
// [B*H/2, S, 128] = [head A | head B]: two heads of 64 side by side. The
// TPU kernel runs QK^T and P.V of the pair as single 128-deep contractions
// against block-diagonal K and V tiles that are half zeros, because its
// matrix unit contracts 128 deep. mma.sync contracts 16 deep, so there is
// nothing to fill: this kernel reads the same packed rows, runs head A's
// QK^T over lanes 0-63 and head B's over lanes 64-127, keeps two
// independent (m, l) pairs and two 64-wide accumulators per row, and
// writes the packed output row. What computes is what the TPU kernel
// computes: two online softmaxes in the exp2 domain (q scaled by
// softmax_scale * log2(e) in bf16), l as a lane sum of fp32 p, the output
// as acc * (1 / l).
//
// Design. As flash_fwd.cu at D = 128: one block of 4 warps per (head
// pair, 64-row q tile), 64-key tiles of 256-byte rows staged synchronously
// in shared memory, 16 q rows a warp. The two heads of a warp run one
// after the other over the same staged tile, so the S registers are shared
// and a block makes half as many tile loads, barriers and blocks as two
// D = 64 blocks of K3 would. What the card answers is whether that beats
// K3 on [B*H, S, 64]. Ragged q and k edges are masked in the kernel.
//
// What bounds it on the H100: operations (6.2 TFLOP against 0.8 GB at
// B = 2, H = 48, S = 15,906); in practice the tensor cores' instruction
// rate and the shared-memory loads that feed mma.sync.

#include "flash_common.cuh"

namespace {

using namespace flashx;

constexpr int kHeadDim = 64;
constexpr int kRow = 2 * kHeadDim;  // packed row width
constexpr int kStride = kRow + 8;   // shared-memory row stride, bf16

__global__ void __launch_bounds__(kThreads)
    flash_packed_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int sq, int skv,
                        float q_scale) {
  constexpr int kKSteps = kHeadDim / 16;  // QK^T depth steps of one head
  constexpr int kSTiles = kBlockN / 8;
  constexpr int kPSteps = kBlockN / 16;
  constexpr int kOTiles = kHeadDim / 8;   // n-tiles of one head's output
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const int pair = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* q8 =
      reinterpret_cast<const unsigned char*>(q + (size_t)pair * sq * kRow);
  const unsigned char* k8 =
      reinterpret_cast<const unsigned char*>(k + (size_t)pair * skv * kRow);
  const unsigned char* v8 =
      reinterpret_cast<const unsigned char*>(v + (size_t)pair * skv * kRow);
  o += (size_t)pair * sq * kRow;

  // packed q tile -> shared (borrowing the k buffer) -> A fragments: depth
  // steps 0-3 are head A's lanes, 4-7 head B's
  load_tile_bytes<2 * kRow>(reinterpret_cast<unsigned char*>(k_s), q8, m0, sq);
  __syncthreads();
  const int r_lo = warp * 16 + g;
  uint32_t qf[2 * kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < 2 * kKSteps; ++kk) {
    const __nv_bfloat16* lo = k_s + r_lo * kStride + kk * 16 + t * 2;
    const __nv_bfloat16* hi = lo + 8 * kStride;
    qf[kk][0] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(lo), q_scale);
    qf[kk][1] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(hi), q_scale);
    qf[kk][2] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(lo + 8), q_scale);
    qf[kk][3] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(hi + 8), q_scale);
  }
  __syncthreads();

  // per head: running max, partial row sums and the 64-wide accumulator
  float m_lo[2] = {kNegInf, kNegInf}, m_hi[2] = {kNegInf, kNegInf};
  float l_lo[2] = {0.0f, 0.0f}, l_hi[2] = {0.0f, 0.0f};
  float acc[2][kOTiles][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    load_tile_bytes<2 * kRow>(reinterpret_cast<unsigned char*>(k_s), k8, n0, skv);
    load_tile_bytes<2 * kRow>(reinterpret_cast<unsigned char*>(v_s), v8, n0, skv);
    __syncthreads();
    const bool ragged = n0 + kBlockN > skv;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // S_h = q_h K_h^T for 16 rows x 64 keys
      float s[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) {
          const __nv_bfloat16* kb =
              k_s + (j * 8 + g) * kStride + h * kHeadDim + kk * 16 + t * 2;
          mma_16816(s[j], qf[h * kKSteps + kk],
                    *reinterpret_cast<const uint32_t*>(kb),
                    *reinterpret_cast<const uint32_t*>(kb + 8));
        }
      }

      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) s[j][e] = kNegInf;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
      const float mn_lo = fmaxf(m_lo[h], group_max(mx_lo));
      const float mn_hi = fmaxf(m_hi[h], group_max(mx_hi));
      const float a_lo = exp2f(m_lo[h] - mn_lo), a_hi = exp2f(m_hi[h] - mn_hi);
      m_lo[h] = mn_lo;
      m_hi[h] = mn_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        s[j][0] = exp2f(s[j][0] - mn_lo);
        s[j][1] = exp2f(s[j][1] - mn_lo);
        s[j][2] = exp2f(s[j][2] - mn_hi);
        s[j][3] = exp2f(s[j][3] - mn_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      l_lo[h] = a_lo * l_lo[h] + sum_lo;
      l_hi[h] = a_hi * l_hi[h] + sum_hi;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        acc[h][j][0] *= a_lo;
        acc[h][j][1] *= a_lo;
        acc[h][j][2] *= a_hi;
        acc[h][j][3] *= a_hi;
      }

      // acc_h += bf16(P_h) V_h
#pragma unroll
      for (int kp = 0; kp < kPSteps; ++kp) {
        const uint32_t pa[4] = {pack_bf16x2(s[2 * kp][0], s[2 * kp][1]),
                                pack_bf16x2(s[2 * kp][2], s[2 * kp][3]),
                                pack_bf16x2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                                pack_bf16x2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
        const __nv_bfloat16* vrow =
            v_s + (kp * 16 + t * 2) * kStride + h * kHeadDim + g;
#pragma unroll
        for (int j = 0; j < kOTiles; ++j) {
          const __nv_bfloat16* vb = vrow + j * 8;
          mma_16816(acc[h][j], pa, pack_raw(vb[0], vb[kStride]),
                    pack_raw(vb[8 * kStride], vb[9 * kStride]));
        }
      }
    }
    __syncthreads();  // before the next tile overwrites k_s / v_s
  }

  const int row_lo = m0 + r_lo, row_hi = row_lo + 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv_lo = 1.0f / group_sum(l_lo[h]);
    const float inv_hi = 1.0f / group_sum(l_hi[h]);
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      const int col = h * kHeadDim + j * 8 + t * 2;
      if (row_lo < sq) {
        *reinterpret_cast<uint32_t*>(o + (size_t)row_lo * kRow + col) =
            pack_bf16x2(acc[h][j][0] * inv_lo, acc[h][j][1] * inv_lo);
      }
      if (row_hi < sq) {
        *reinterpret_cast<uint32_t*>(o + (size_t)row_hi * kRow + col) =
            pack_bf16x2(acc[h][j][2] * inv_hi, acc[h][j][3] * inv_hi);
      }
    }
  }
}

}  // namespace

// q [pairs, sq, 128], k/v [pairs, skv, 128], o [pairs, sq, 128]: contiguous
// bf16, each row [head A | head B]; q is scaled in the kernel by q_scale
// (rounded to bf16). Returns cudaGetLastError() after the launch.
extern "C" int flash_packed_bf16(const void* q, const void* k, const void* v,
                                 void* o, int pairs, int sq, int skv,
                                 float q_scale, void* stream) {
  dim3 grid((sq + kBlockM - 1) / kBlockM, pairs);
  flash_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      skv, q_scale);
  return static_cast<int>(cudaGetLastError());
}
