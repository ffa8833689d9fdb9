// Experiment flash-attention forwards for Hopper (sm_90a): one kernel
// template, two switches, three bodies. bf16 output, fp32 softmax
// statistics and accumulation, non-causal, no backward.
//
// Replaces the bf16-logit Pallas TPU kernels of
// scripts/bench_flash_variants.py (the int8-logit ones, _kernel_v3 and
// _kernel_v123, are csrc/flash_int8.cu):
//   _kernel_v1    online softmax, row sum l by a ones column   <online, ones>
//   _kernel_v2    p = exp2(s - bound), l by a lane sum         <static, lanes>
//   _kernel_v12   p = exp2(s - bound), l by a ones column      <static, ones>
//
// The switches, as the TPU kernels define them:
//   ones column   The TPU appends a column of ones to V, so that the P.V
//                 product also yields sum_j bf16(p_ij). Here nothing is
//                 materialised: one more n = 8 accumulator tile of the P.V
//                 mma takes a constant B fragment (1.0 in column 0). The
//                 arithmetic is the TPU's: l sums the bf16-ROUNDED p in
//                 fp32 on the tensor cores, and in the online body is
//                 rescaled by alpha with the accumulator. The lane-sum
//                 bodies sum the fp32 p.
//   static bound  p = exp2(s - bound) with bound >= every logit, read from
//                 device memory: no running max, no rescale. There is NO
//                 floor under the exponent (K1 in flash_fwd.cu has one; the
//                 script's kernel does not): a logit far under the bound
//                 underflows to 0.
//
// Design. The structure of flash_fwd.cu, on purpose: one block of 4 warps
// per (batch*head, 64-row q tile), 16 q rows a warp, a loop over 64-key
// tiles staged synchronously in shared memory, S reused in registers as
// the A operand of P.V. A body's time then differs from K3's by its switch
// alone, which is what the experiment asks. The TPU kernels pad the
// sequence to a block multiple and mask padded keys with -1e30 before the
// exp2; here the ragged last key tile is masked the same way (p is exactly
// 0), rows past the end load as zeros and are not stored, and nothing is
// padded.
//
// What bounds them on the H100: operations. At [96, 15906, 64] the two
// products are 6.2 TFLOP against 0.8 GB of traffic; with mma.sync and
// synchronous loads the limit in practice is the tensor cores' instruction
// rate plus the shared-memory loads feeding it, as for K3.

#include "flash_common.cuh"

namespace {

using namespace flashx;

template <int D, bool kStatic, bool kOnes>
__global__ void __launch_bounds__(kThreads)
    flash_variant_kernel(const void* __restrict__ q_ptr,
                         const void* __restrict__ k_ptr,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         const float* __restrict__ bound_ptr, int sq, int skv,
                         float q_scale) {
  constexpr int kQKBytes = 2 * D;              // bytes of one q or k row
  constexpr int kQKStride = kQKBytes + 16;     // shared-memory row stride
  constexpr int kVStride = D + 8;              // in bf16 elements
  constexpr int kKSteps = kQKBytes / 32;       // QK^T depth steps
  constexpr int kSTiles = kBlockN / 8;         // n-tiles of one S tile
  constexpr int kPSteps = kBlockN / 16;        // P.V depth steps
  constexpr int kOTiles = D / 8;               // n-tiles of the output
  __shared__ __align__(16) unsigned char k_s[kBlockN * kQKStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kVStride];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const unsigned char* q = static_cast<const unsigned char*>(q_ptr) +
                           (size_t)bh * sq * kQKBytes;
  const unsigned char* k = static_cast<const unsigned char*>(k_ptr) +
                           (size_t)bh * skv * kQKBytes;
  const unsigned char* vb8 =
      reinterpret_cast<const unsigned char*>(v + (size_t)bh * skv * D);
  o += (size_t)bh * sq * D;

  // q tile -> shared (borrowing the k buffer) -> A fragments in registers
  load_tile_bytes<kQKBytes>(k_s, q, m0, sq);
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this thread's two rows: r_lo, r_lo + 8
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const unsigned char* lo = k_s + r_lo * kQKStride + kk * 32 + t * 4;
    const unsigned char* hi = lo + 8 * kQKStride;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(hi);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
#pragma unroll
    for (int r = 0; r < 4; ++r) qf[kk][r] = scale_bf16x2(qf[kk][r], q_scale);
  }
  __syncthreads();

  const float bound = kStatic ? *bound_ptr : 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max (online bodies)
  float l_lo = 0.0f, l_hi = 0.0f;        // lane-sum bodies: partial row sums
  float accl[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // ones-column bodies: l tile
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // B fragment of the ones column: 1.0 at every depth in column 0, which
  // the threads of group 0 hold
  const uint32_t ones_b = (g == 0) ? kOnesBf16x2 : 0u;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    load_tile_bytes<kQKBytes>(k_s, k, n0, skv);
    load_tile_bytes<2 * D>(reinterpret_cast<unsigned char*>(v_s), vb8, n0, skv);
    __syncthreads();

    // S for 16 rows x 64 keys per warp
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const unsigned char* kb = k_s + (j * 8 + g) * kQKStride + kk * 32 + t * 4;
        mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                  *reinterpret_cast<const uint32_t*>(kb + 16));
      }
    }

    // keys past the end: -1e30 before the exp2, so p is exactly 0
    if (n0 + kBlockN > skv) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + j * 8 + t * 2 + (e & 1) >= skv) s[j][e] = kNegInf;
        }
      }
    }

    if constexpr (kStatic) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - bound);
        if constexpr (!kOnes) {
          l_lo += s[j][0] + s[j][1];
          l_hi += s[j][2] + s[j][3];
        }
      }
    } else {
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
      const float mn_lo = fmaxf(m_lo, group_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, group_max(mx_hi));
      const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        s[j][0] = exp2f(s[j][0] - mn_lo);
        s[j][1] = exp2f(s[j][1] - mn_lo);
        s[j][2] = exp2f(s[j][2] - mn_hi);
        s[j][3] = exp2f(s[j][3] - mn_hi);
        if constexpr (!kOnes) {
          sum_lo += s[j][0] + s[j][1];
          sum_hi += s[j][2] + s[j][3];
        }
      }
      if constexpr (kOnes) {
        accl[0] *= a_lo;
        accl[1] *= a_lo;
        accl[2] *= a_hi;
        accl[3] *= a_hi;
      } else {
        l_lo = a_lo * l_lo + sum_lo;
        l_hi = a_hi * l_hi + sum_hi;
      }
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
    }

    // acc += bf16(P) V: two S n-tiles form one A fragment; with the ones
    // column, the same A fragment against the constant tile gives l
#pragma unroll
    for (int kp = 0; kp < kPSteps; ++kp) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16x2(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16x2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16x2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      const __nv_bfloat16* vrow = v_s + (kp * 16 + t * 2) * kVStride + g;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        const __nv_bfloat16* vb = vrow + j * 8;
        mma_16816(acc[j], pa, pack_raw(vb[0], vb[kVStride]),
                  pack_raw(vb[8 * kVStride], vb[9 * kVStride]));
      }
      if constexpr (kOnes) mma_16816(accl, pa, ones_b, ones_b);
    }
    __syncthreads();  // before the next tile overwrites k_s / v_s
  }

  if constexpr (kOnes) {
    // column 0 of the l tile is in the first thread of each group
    l_lo = __shfl_sync(kFull, accl[0], lane & ~3);
    l_hi = __shfl_sync(kFull, accl[2], lane & ~3);
  } else {
    l_lo = group_sum(l_lo);
    l_hi = group_sum(l_hi);
  }
  const int row_lo = m0 + r_lo, row_hi = row_lo + 8;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + t * 2;
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(o + (size_t)row_lo * D + col) =
          pack_bf16x2(acc[j][0] / l_lo, acc[j][1] / l_lo);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(o + (size_t)row_hi * D + col) =
          pack_bf16x2(acc[j][2] / l_hi, acc[j][3] / l_hi);
    }
  }
}

template <int D, bool kStatic, bool kOnes>
void launch(const void* q, const void* k, const void* v, void* o,
            const float* bound, int bh, int sq, int skv, float q_scale,
            cudaStream_t stream) {
  dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_variant_kernel<D, kStatic, kOnes><<<grid, kThreads, 0, stream>>>(
      q, k, static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      bound, sq, skv, q_scale);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const float* bound, int bh, int sq, int skv, int body,
                float q_scale, cudaStream_t s) {
  switch (body) {
    case 1: launch<D, false, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s); break;
    case 2: launch<D, true, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s); break;
    case 12: launch<D, true, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [bh, sq, D], k/v [bh, skv, D], o [bh, sq, D]: contiguous bf16; q is
// scaled in the kernel by q_scale (rounded to bf16). body: 1 = online
// softmax + ones column (v1), 2 = static bound + lane sum (v2), 12 = static
// bound + ones column (v12); bound (bodies 2, 12): one fp32 on the device.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported head_dim or body).
extern "C" int flash_variant_bf16(const void* q, const void* k, const void* v,
                                  void* o, const float* bound, int bh, int sq,
                                  int skv, int head_dim, int body,
                                  float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_bf16<128>(q, k, v, o, bound, bh, sq, skv, body, q_scale, s);
  if (head_dim == 64) return launch_bf16<64>(q, k, v, o, bound, bh, sq, skv, body, q_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
