// Non-causal flash-attention forward for Hopper (sm_90a), bf16 in/out,
// fp32 softmax statistics and accumulation.
//
// Replaces two Pallas TPU kernels of frameino_tpu/ops/attention.py:
//   - _flash_fwd_kernel (online softmax in the exp2 domain; q pre-scaled
//     by softmax_scale * log2(e) in q's dtype): kStatic = false;
//   - _flash_fwd_kernel_static (no running max: p = exp2(max(s - bound,
//     -120)) with bound >= every logit, read from device memory):
//     kStatic = true.
//
// Design. One block of 4 warps per (batch*head, 64-row q tile); each warp
// owns 16 q rows. The TPU kernel's sequential third grid axis (k blocks)
// becomes a loop inside the block over 64-key tiles staged in shared
// memory, and the fp32 m/l/acc VMEM scratch becomes registers. Products
// are mma.sync m16n8k16 bf16 -> fp32. The S accumulator of QK^T is laid
// out exactly like the A operand of P.V, so P never leaves registers.
// Ragged q and k edges are masked in the kernel: rows past the end load
// as zeros, key columns past the end get p = 0 (after the exp2 in the
// static variant, as on the TPU), and out-of-range q rows are not stored.
// No padded copies are made.
//
// What bounds it on the H100: at the slice's self-attention shape
// (48 heads x 5,460 x 5,460, D = 128) the two products are ~0.73 TFLOP
// against ~200 MB of q/k/v traffic, so it is bound by tensor-core issue
// and by the shared-memory loads that feed mma.sync. This first version
// loads tiles synchronously (no cp.async / TMA pipeline) and uses
// mma.sync, not wgmma; rows are padded by 8 bf16 in shared memory so the
// fragment loads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr float kExpFloor = -120.0f;

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

// Copy rows [row0, row0 + 64) of a [rows, D] bf16 matrix into shared
// memory (row stride D + 8); rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kBlockN * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

template <int D, bool kStatic>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     const float* __restrict__ bound_ptr, int sq, int skv,
                     float q_scale) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;        // QK^T depth steps
  constexpr int kSTiles = kBlockN / 8;   // n-tiles of one S tile
  constexpr int kPSteps = kBlockN / 16;  // P.V depth steps
  constexpr int kOTiles = D / 8;         // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN * kStride];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  q += (size_t)bh * sq * D;
  k += (size_t)bh * skv * D;
  v += (size_t)bh * skv * D;
  o += (size_t)bh * sq * D;

  // q tile -> shared (borrowing the k buffer) -> A fragments in registers
  load_tile<D>(ks, q, m0, sq);
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this thread's two rows: r_lo, r_lo + 8
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* lo = ks + r_lo * kStride + kk * 16 + t * 2;
    const __nv_bfloat16* hi = lo + 8 * kStride;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(hi);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(hi + 8);
    if (!kStatic) {
#pragma unroll
      for (int r = 0; r < 4; ++r) qf[kk][r] = scale_bf16x2(qf[kk][r], q_scale);
    }
  }
  __syncthreads();

  const float bound = kStatic ? *bound_ptr : 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max (online variant)
  float l_lo = 0.0f, l_hi = 0.0f;        // per-thread partial row sums
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    load_tile<D>(ks, k, n0, skv);
    load_tile<D>(vs, v, n0, skv);
    __syncthreads();

    // S = q K^T for 16 rows x 64 keys per warp
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kStride + kk * 16 + t * 2;
        mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                  *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    const bool ragged = n0 + kBlockN > skv;
    if (kStatic) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaxf(s[j][e] - bound, kExpFloor));
          if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) p = 0.0f;
          s[j][e] = p;
        }
        l_lo += s[j][0] + s[j][1];
        l_hi += s[j][2] + s[j][3];
      }
    } else {
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
      // the four threads of a group hold one row between them
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
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
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      l_lo = a_lo * l_lo + sum_lo;
      l_hi = a_hi * l_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
    }

    // acc += bf16(P) V: two S n-tiles form one A fragment
#pragma unroll
    for (int kp = 0; kp < kPSteps; ++kp) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16x2(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16x2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16x2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      const __nv_bfloat16* vrow = vs + (kp * 16 + t * 2) * kStride + g;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        const __nv_bfloat16* vb = vrow + j * 8;
        mma_16816(acc[j], pa, pack_raw(vb[0], vb[kStride]),
                  pack_raw(vb[8 * kStride], vb[9 * kStride]));
      }
    }
    __syncthreads();  // before the next tile overwrites ks / vs
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
  const int row_lo = m0 + r_lo, row_hi = row_lo + 8;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + t * 2;
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(o + (size_t)row_lo * D + col) =
          pack_bf16x2(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(o + (size_t)row_hi * D + col) =
          pack_bf16x2(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
    }
  }
}

template <int D, bool kStatic>
void launch(const void* q, const void* k, const void* v, void* o,
            const float* bound, int bh, int sq, int skv, float q_scale,
            cudaStream_t stream) {
  dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D, kStatic><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), bound,
      sq, skv, q_scale);
}

}  // namespace

// q [bh, sq, D], k/v [bh, skv, D], o [bh, sq, D]: contiguous bf16.
// static_bound != 0: the exp2(max(s - *bound, -120)) variant, q already
// scaled; else online softmax, q scaled in-kernel by q_scale.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported head_dim).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const float* bound, int bh, int sq,
                              int skv, int head_dim, int static_bound,
                              float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    if (static_bound) launch<128, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
    else launch<128, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
  } else if (head_dim == 64) {
    if (static_bound) launch<64, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
    else launch<64, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
