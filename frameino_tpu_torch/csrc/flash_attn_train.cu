// K6: non-causal flash attention for training on Hopper (sm_90a), forward
// and backward, bf16 in/out, fp32 softmax statistics and accumulation.
//
// Replaces frameino_tpu/ops/attention.py:flash_attention_train (JAX's
// bundled Pallas TPU flash attention, forward + dQ/dK/dV kernels, with the
// ragged tails padded to a 512 multiple and given their own segment id).
//
// What it computes, per batch*head, with c = scale * log2(e):
//   forward   s = c * (q k^T) in fp32, p = exp2(s - m), l = sum p,
//             o = bf16(p) v / l, lse = (m + log2 l) * ln 2   (natural log)
//   backward  D_i = rowsum(dO o) in fp32; p = exp2(c * (q k^T) - lse log2 e)
//             dV = bf16(p)^T dO;  dP = dO v^T;  dS = p (dP - D_i)
//             dQ = scale * bf16(dS) k;  dK = scale * bf16(dS)^T q
//
// Design. The TPU kernels walk a sequential grid axis and keep their
// accumulators in VMEM scratch; Hopper blocks run in no order, so each
// block loops itself over the other sequence and keeps its accumulators in
// registers. Products are mma.sync m16n8k16 bf16 -> fp32; an accumulator
// tile is laid out exactly like an A operand, so p and dS go from the
// accumulators into the next product without touching shared memory.
//   - forward: one block of 4 warps per (batch*head, 64 q rows), a loop over
//     64-key tiles with an online softmax (K3's loop with the scale on the
//     fp32 logits), writing o and the row log-sum-exp;
//   - backward: a row-dot kernel for D_i; one block per (batch*head, 64
//     keys) that loops over 32-row q tiles and accumulates dK and dV; one
//     block per (batch*head, 64 q rows) that loops over 32-key tiles and
//     accumulates dQ. S and P are recomputed in both, so no atomics are
//     needed and the result does not depend on scheduling.
// Ragged lengths are masked in the kernels, with no padded copies: rows past
// the end load as zeros, keys at or past Skv get p = 0, and rows at or past
// Sq (keys at or past Skv for dK/dV) are never stored.
//
// What bounds it on the H100: at the Wan training shape (24 heads x 5,460
// tokens, D = 128) the forward is 0.37 TFLOP and the backward 0.92 TFLOP
// against ~0.1 GB of traffic, so both are bound by tensor-core issue and by
// the shared-memory loads that feed mma.sync. This first version loads tiles
// synchronously (no cp.async / TMA ring) and uses mma.sync, not wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// A fragment (16 rows x 16 depth) of a row-major tile in shared memory:
// rows r, r + 8 of this thread's group, depth columns k0 + 2t (+ 8).
template <int kStride>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r,
                                       int k0, int t) {
  const __nv_bfloat16* lo = tile + r * kStride + k0 + t * 2;
  const __nv_bfloat16* hi = lo + 8 * kStride;
  a[0] = ld32(lo);
  a[1] = ld32(hi);
  a[2] = ld32(lo + 8);
  a[3] = ld32(hi + 8);
}

// Copy rows [row0, row0 + kRows) of a [rows, D] bf16 matrix into shared
// memory (row stride D + 8, which keeps fragment loads free of bank
// conflicts); rows at or past `rows` are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

// acc[j] += a (16 x 16 depth rows of the k dimension) * tile, where the tile
// in shared memory is [k][n] row-major (k = the rows being summed over):
// b0 = tile[k0 + 2t, +1][n], b1 = tile[k0 + 2t + 8, +9][n], n = j*8 + g.
template <int D, int kStride>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int k0,
                                         int g, int t) {
  const __nv_bfloat16* row = tile + (k0 + t * 2) * kStride + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const __nv_bfloat16* b = row + j * 8;
    mma_16816(acc[j], a, pack_raw(b[0], b[kStride]),
              pack_raw(b[8 * kStride], b[9 * kStride]));
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int sq, int skv, float c) {
  constexpr int kBlockM = 64, kBlockN = 64;
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
  lse += (size_t)bh * sq;

  // q tile -> shared (borrowing the k buffer) -> A fragments in registers
  load_rows<D, kBlockM>(ks, q, m0, sq);
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this thread's two rows: r_lo, r_lo + 8
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a<kStride>(qf[kk], ks, r_lo, kk * 16, t);
  __syncthreads();

  float m_lo = kNegInf, m_hi = kNegInf;  // running max (log2 units)
  float l_lo = 0.0f, l_hi = 0.0f;        // per-thread partial row sums
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    load_rows<D, kBlockN>(ks, k, n0, skv);
    load_rows<D, kBlockN>(vs, v, n0, skv);
    __syncthreads();

    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kStride + kk * 16 + t * 2;
        mma_16816(s[j], qf[kk], ld32(kb), ld32(kb + 8));
      }
    }

    // scale the fp32 logits; keys past the end get -inf
    const bool ragged = n0 + kBlockN > skv;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv)
                      ? kNegInf : s[j][e] * c;
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

    // acc += bf16(P) V: two S n-tiles form one A fragment
#pragma unroll
    for (int kp = 0; kp < kPSteps; ++kp) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16x2(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16x2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16x2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      mma_rows<D, kStride>(acc, pa, vs, kp * 16, g, t);
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
  if (t == 0) {
    if (row_lo < sq) lse[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
    if (row_hi < sq) lse[row_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D_i = sum_d dO[i, d] * o[i, d] in fp32, one warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        float* __restrict__ di, int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162* op =
      reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * D);
  const __nv_bfloat162* dp =
      reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D);
  float sum = 0.0f;
#pragma unroll
  for (int i = lane; i < D / 2; i += 32) {
    const float2 a = __bfloat1622float2(op[i]);
    const float2 b = __bfloat1622float2(dp[i]);
    sum += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) di[row] = sum;
}

// dK and dV of one 64-key tile; each warp owns 16 keys and loops over the
// queries in 32-row tiles. Shared memory (dynamic): K, V [64][D + 8],
// q, dO [32][D + 8], and the q tile's lse (log2 units) and D_i.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int skv,
                         float c, float scale) {
  constexpr int kBlockN = 64, kBlockM = 32;
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kSTiles = kBlockM / 8;   // q n-tiles of one S^T tile
  constexpr int kPSteps = kBlockM / 16;  // depth steps over the q tile
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockN * kStride;
  __nv_bfloat16* qs = vs + kBlockN * kStride;
  __nv_bfloat16* os = qs + kBlockM * kStride;
  float* lse_s = reinterpret_cast<float*>(os + kBlockM * kStride);
  float* di_s = lse_s + kBlockM;

  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  di += (size_t)bh * sq;
  k += (size_t)bh * skv * D;
  v += (size_t)bh * skv * D;
  dk += (size_t)bh * skv * D;
  dv += (size_t)bh * skv * D;

  load_rows<D, kBlockN>(ks, k, n0, skv);
  load_rows<D, kBlockN>(vs, v, n0, skv);
  const int kr = warp * 16 + g;  // this thread's key rows kr, kr + 8

  float dk_acc[kOTiles][4], dv_acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.0f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.0f;
  }

  for (int m0 = 0; m0 < sq; m0 += kBlockM) {
    __syncthreads();  // every warp is done with the previous q tile
    load_rows<D, kBlockM>(qs, q, m0, sq);
    load_rows<D, kBlockM>(os, dout, m0, sq);
    if (threadIdx.x < kBlockM) {
      const int r = m0 + threadIdx.x;
      lse_s[threadIdx.x] = r < sq ? lse[r] * kLog2e : 0.0f;
      di_s[threadIdx.x] = r < sq ? di[r] : 0.0f;
    }
    __syncthreads();

    // S^T = K q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
    float st[kSTiles][4], dpt[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.0f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ka[4], va[4];
      load_a<kStride>(ka, ks, kr, kk * 16, t);
      load_a<kStride>(va, vs, kr, kk * 16, t);
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const __nv_bfloat16* qb = qs + (j * 8 + g) * kStride + kk * 16 + t * 2;
        const __nv_bfloat16* ob = os + (j * 8 + g) * kStride + kk * 16 + t * 2;
        mma_16816(st[j], ka, ld32(qb), ld32(qb + 8));
        mma_16816(dpt[j], va, ld32(ob), ld32(ob + 8));
      }
    }

    // P^T = exp2(c s - lse), queries past the end 0; dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float p = (m0 + col < sq) ? exp2f(st[j][e] * c - lse_s[col]) : 0.0f;
        dpt[j][e] = p * (dpt[j][e] - di_s[col]);
        st[j][e] = p;
      }
    }

    // dV += bf16(P^T) dO, dK += bf16(dS^T) q over the 32 queries
#pragma unroll
    for (int kp = 0; kp < kPSteps; ++kp) {
      const uint32_t pa[4] = {pack_bf16x2(st[2 * kp][0], st[2 * kp][1]),
                              pack_bf16x2(st[2 * kp][2], st[2 * kp][3]),
                              pack_bf16x2(st[2 * kp + 1][0], st[2 * kp + 1][1]),
                              pack_bf16x2(st[2 * kp + 1][2], st[2 * kp + 1][3])};
      const uint32_t da[4] = {pack_bf16x2(dpt[2 * kp][0], dpt[2 * kp][1]),
                              pack_bf16x2(dpt[2 * kp][2], dpt[2 * kp][3]),
                              pack_bf16x2(dpt[2 * kp + 1][0], dpt[2 * kp + 1][1]),
                              pack_bf16x2(dpt[2 * kp + 1][2], dpt[2 * kp + 1][3])};
      mma_rows<D, kStride>(dv_acc, pa, os, kp * 16, g, t);
      mma_rows<D, kStride>(dk_acc, da, qs, kp * 16, g, t);
    }
  }

  const int key_lo = n0 + kr, key_hi = key_lo + 8;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + t * 2;
    if (key_lo < skv) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)key_lo * D + col) =
          pack_bf16x2(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + (size_t)key_lo * D + col) =
          pack_bf16x2(dv_acc[j][0], dv_acc[j][1]);
    }
    if (key_hi < skv) {
      *reinterpret_cast<uint32_t*>(dk + (size_t)key_hi * D + col) =
          pack_bf16x2(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + (size_t)key_hi * D + col) =
          pack_bf16x2(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// dQ of one 64-row q tile; each warp owns 16 rows, holds their q and dO
// A fragments in registers, and loops over the keys in 32-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di,
                       __nv_bfloat16* __restrict__ dq, int sq, int skv,
                       float c, float scale) {
  constexpr int kBlockM = 64, kBlockN = 32;
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kSTiles = kBlockN / 8;
  constexpr int kPSteps = kBlockN / 16;
  constexpr int kOTiles = D / 8;
  // K and V tiles; together they also stage the 64-row q and dO tiles
  __shared__ __align__(16) __nv_bfloat16 kv[2 * kBlockN * kStride];
  __nv_bfloat16* ks = kv;
  __nv_bfloat16* vs = kv + kBlockN * kStride;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  di += (size_t)bh * sq;
  k += (size_t)bh * skv * D;
  v += (size_t)bh * skv * D;

  const int r_lo = warp * 16 + g;
  uint32_t qf[kKSteps][4], of[kKSteps][4];
  load_rows<D, kBlockM>(kv, q, m0, sq);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a<kStride>(qf[kk], kv, r_lo, kk * 16, t);
  __syncthreads();
  load_rows<D, kBlockM>(kv, dout, m0, sq);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a<kStride>(of[kk], kv, r_lo, kk * 16, t);

  const int row_lo = m0 + r_lo, row_hi = row_lo + 8;
  const float lse_lo = row_lo < sq ? lse[row_lo] * kLog2e : 0.0f;
  const float lse_hi = row_hi < sq ? lse[row_hi] * kLog2e : 0.0f;
  const float di_lo = row_lo < sq ? di[row_lo] : 0.0f;
  const float di_hi = row_hi < sq ? di[row_hi] : 0.0f;

  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, kBlockN>(ks, k, n0, skv);
    load_rows<D, kBlockN>(vs, v, n0, skv);
    __syncthreads();

    float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kStride + kk * 16 + t * 2;
        const __nv_bfloat16* vb = vs + (j * 8 + g) * kStride + kk * 16 + t * 2;
        mma_16816(s[j], qf[kk], ld32(kb), ld32(kb + 8));
        mma_16816(dp[j], of[kk], ld32(vb), ld32(vb + 8));
      }
    }

    // P = exp2(c s - lse), keys past the end 0; dS = P (dP - D)
    const bool ragged = n0 + kBlockN > skv;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = e < 2 ? lse_lo : lse_hi;
        const float d = e < 2 ? di_lo : di_hi;
        float p = exp2f(s[j][e] * c - l);
        if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) p = 0.0f;
        s[j][e] = p * (dp[j][e] - d);
      }
    }

    // dQ += bf16(dS) K over the 32 keys
#pragma unroll
    for (int kp = 0; kp < kPSteps; ++kp) {
      const uint32_t da[4] = {pack_bf16x2(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16x2(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16x2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16x2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      mma_rows<D, kStride>(acc, da, ks, kp * 16, g, t);
    }
  }

#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + t * 2;
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(dq + (size_t)row_lo * D + col) =
          pack_bf16x2(acc[j][0] * scale, acc[j][1] * scale);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(dq + (size_t)row_hi * D + col) =
          pack_bf16x2(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

typedef const __nv_bfloat16* cbf;

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int bh, int sq, int skv, float scale, cudaStream_t stream) {
  dim3 grid((sq + 63) / 64, bh);
  attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<cbf>(q), static_cast<cbf>(k), static_cast<cbf>(v),
      static_cast<__nv_bfloat16*>(o), lse, sq, skv, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* di, int bh, int sq, int skv, float scale,
               cudaStream_t stream) {
  const int rows = bh * sq;
  attn_bwd_dot_kernel<D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<cbf>(o), static_cast<cbf>(dout), di, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  constexpr int kStride = D + 8;
  const int smem = (2 * 64 + 2 * 32) * kStride * 2 + 2 * 32 * 4;
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem));
  if (err) return err;
  dim3 grid_kv((skv + 63) / 64, bh);
  attn_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<cbf>(q), static_cast<cbf>(k), static_cast<cbf>(v),
      static_cast<cbf>(dout), lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, skv, scale * kLog2e, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  dim3 grid_q((sq + 63) / 64, bh);
  attn_bwd_dq_kernel<D><<<grid_q, kThreads, 0, stream>>>(
      static_cast<cbf>(q), static_cast<cbf>(k), static_cast<cbf>(v),
      static_cast<cbf>(dout), lse, di, static_cast<__nv_bfloat16*>(dq), sq,
      skv, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o [bh, sq, D], k/v [bh, skv, D] contiguous bf16; lse [bh, sq] fp32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim).
extern "C" int attn_train_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int bh, int sq,
                                   int skv, int head_dim, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_fwd<128>(q, k, v, o, lse, bh, sq, skv, scale, s);
  if (head_dim == 64) return launch_fwd<64>(q, k, v, o, lse, bh, sq, skv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout/dq like q, dk/dv like k (bf16); di [bh, sq] fp32 scratch. Launches
// the row-dot, dK/dV and dQ kernels in that order on `stream`.
extern "C" int attn_train_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* di, int bh, int sq,
                                   int skv, int head_dim, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, di, bh, sq, skv, scale, s);
  if (head_dim == 64)
    return launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, di, bh, sq, skv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
