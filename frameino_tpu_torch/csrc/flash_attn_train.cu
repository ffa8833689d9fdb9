// K6: non-causal flash attention for training on Hopper (sm_90a), forward
// and backward, bf16 in/out, fp32 softmax statistics and accumulation.
//
// Replaces frameino_tpu/ops/attention.py:893 (flash_attention_train: JAX's
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
// What bounds it on the H100: at the Wan training shape (24 heads x 5,460
// tokens, D = 128) the forward is 0.37 TFLOP and the backward 0.92 TFLOP
// against ~0.1 GB of traffic: both are bound by the tensor cores (0.37 and
// 0.93 ms at 989 TFLOP/s), so what matters is keeping them issuing.
// wgmma is the only way to their full rate; it reads its B operand (and A,
// where it is not in registers) straight from shared memory, so the tiles
// must arrive there without occupying the threads that multiply.
//
// Design. Each block is warp-specialised: warpgroup 0 is the producer (one
// thread issues every TMA load; the warpgroup gives its registers away with
// setmaxnreg), the other warpgroups are consumers that run wgmma on tiles
// that have landed and keep every accumulator in registers. Tiles move
// through a 2-stage ring of shared-memory buffers guarded by mbarriers
// (full: the TMA bytes arrived; empty: every consumer thread is done with
// the stage). The TMA maps are 3-D over [batch*head, S, D] with 128-byte
// swizzle (sm90_common.cuh), so a ragged tail tile reads zeros and never
// the next head's rows, and the wgmma descriptors address the same swizzle.
//   - forward (attn_fwd_kernel): a block per (batch*head, 128 q rows), two
//     consumer warpgroups of 64 rows; a loop over 128-key tiles: S = Q K^T
//     (wgmma, both operands in shared memory), the online softmax in
//     registers, O += bf16(P) V with P straight from the S accumulator as
//     the register A operand and V MN-major (transpose bit);
//   - backward: a pre-kernel (attn_bwd_pre_kernel) computes D_i, stages
//     lse * log2(e) and D_i in 64-padded rows (padding lse = +inf, so the
//     padded rows' p is 0) and zeroes an fp32 dQ accumulator; the main
//     kernel (attn_bwd_kernel) runs one block per (batch*head, 64 or 128
//     keys), one consumer warpgroup per 64 keys with K and V resident in
//     shared memory, and streams 64-row q tiles (q, dO, lse, D_i) through
//     the ring. Per q tile it computes the five products once each:
//     S^T = K q^T and dP^T = V dO^T (shared-memory operands), P^T and dS^T
//     in registers, dV += bf16(P^T) dO and dK += bf16(dS^T) q (register A,
//     MN-major B), and, after bf16(dS^T) is stored to shared memory and a
//     named barrier, dQ_tile = dS K (A MN-major from shared memory, B = K
//     MN-major), each warpgroup taking 64 of dQ's D columns over all the
//     block's keys. That share is added into the fp32 accumulator by TMA
//     reduce-adds from a swizzled shared-memory stage at 128 keys a block,
//     by float4 atomics at 64 (where the stage would cost the second block
//     an SM); a post-kernel (attn_bwd_post_kernel) writes dQ =
//     bf16(scale * acc). The key blocks' dQ shares are the kernel's only
//     cross-block traffic: 2.9 GB of fp32 adds at the Wan self shape.
//     dK and dV are each block's own and do not depend on scheduling (bit
//     for bit reproducible); dQ's fp32 sums land in scheduling order, so
//     its low bits may differ between runs.
// Ragged lengths are masked in the kernels, with no padded copies: rows past
// the end load as zeros, keys at or past Skv get p = 0, and rows at or past
// Sq (keys at or past Skv for dK/dV) are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kRowBytes = 128;   // one row of a 64-column swizzled box

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// The register A operand of k-step kk from an accumulator of 8-column
// blocks: columns 16 kk .. 16 kk + 15 are blocks 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kk) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdLayout {
  static constexpr int kRows = 128;               // q rows a block; keys a tile
  static constexpr int kBlock = kRows * kRowBytes;  // one 64-column block
  static constexpr int kTile = kBlock * (D / 64);   // one [128, D] tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                // 2 stages
  static constexpr int kV = 3 * kTile;            // 2 stages
  static constexpr int kBars = 5 * kTile;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int kBytes = kBars + 7 * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(3 * kWG, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int sq, int skv, float c) {
  using L = FwdLayout<D>;
  constexpr int kCB = D / 64;      // column blocks of a tile
  constexpr int kKSteps = D / 16;  // QK^T depth steps
  constexpr int kOTiles = D / 8;   // 8-column blocks of O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 3;
  uint64_t* empty = bars + 5;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * L::kRows;
  const int n_tiles = (skv + L::kRows - 1) / L::kRows;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2 * kWG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int cb = 0; cb < kCB; ++cb)
        tma_load_3d(smem + L::kQ + cb * L::kBlock, &tm_q, q_full, 64 * cb, m0,
                    bh);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n & 1;
        if (n >= 2) mbar_wait(empty + s, ((n >> 1) - 1) & 1);
        mbar_expect_tx(k_full + s, L::kTile);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load_3d(smem + L::kK + s * L::kTile + cb * L::kBlock, &tm_k,
                      k_full + s, 64 * cb, n * L::kRows, bh);
        mbar_expect_tx(v_full + s, L::kTile);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load_3d(smem + L::kV + s * L::kTile + cb * L::kBlock, &tm_v,
                      v_full + s, 64 * cb, n * L::kRows, bh);
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_addr = smem_u32(smem + L::kQ) + 64 * w * kRowBytes;
    const uint32_t k_addr = smem_u32(smem + L::kK);
    const uint32_t v_addr = smem_u32(smem + L::kV);

    float m_lo = kNegInf, m_hi = kNegInf;  // running max (log2 units)
    float l_lo = 0.0f, l_hi = 0.0f;        // per-thread partial row sums
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n & 1;
      const uint32_t ph = (n >> 1) & 1;
      const int n0 = n * L::kRows;

      // S = Q K^T: 64 rows x 128 keys
      float sc[64];
      mbar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t off = (kk >> 2) * L::kBlock + (kk & 3) * 32;
        mma_ss<128, 0, 0>(sc, desc_sw128(q_addr + off, 16, 1024),
                          desc_sw128(k_addr + s * L::kTile + off, 16, 1024),
                          kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale the fp32 logits; keys past the end get -inf
      const bool ragged = n0 + L::kRows > skv;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + j * 8 + t * 2 + (e & 1);
          sc[4 * j + e] = (ragged && key >= skv) ? kNegInf : sc[4 * j + e] * c;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
      for (int j = 0; j < 16; ++j) {
        sc[4 * j + 0] = exp2f(sc[4 * j + 0] - mn_lo);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn_lo);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn_hi);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn_hi);
        sum_lo += sc[4 * j + 0] + sc[4 * j + 1];
        sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_lo = a_lo * l_lo + sum_lo;
      l_hi = a_hi * l_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        acc[4 * j + 0] *= a_lo;
        acc[4 * j + 1] *= a_lo;
        acc[4 * j + 2] *= a_hi;
        acc[4 * j + 3] *= a_hi;
      }

      // O += bf16(P) V: P from the S accumulator, V MN-major
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
      mbar_wait(v_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        mma_rs<D, 1>(acc, pa[kk],
                     desc_sw128(v_addr + s * L::kTile + kk * 2048, L::kBlock,
                                1024),
                     1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + s);
    }

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
    const int row_lo = m0 + 64 * w + 16 * warp + g, row_hi = row_lo + 8;
    __nv_bfloat16* o_bh = o + (size_t)bh * sq * D;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      const int col = j * 8 + t * 2;
      if (row_lo < sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (size_t)row_lo * D + col) =
            pack_bf16x2(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
      }
      if (row_hi < sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (size_t)row_hi * D + col) =
            pack_bf16x2(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
      }
    }
    if (t == 0) {
      float* lse_bh = lse + (size_t)bh * sq;
      if (row_lo < sq) lse_bh[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (row_hi < sq) lse_bh[row_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdM = 64;  // q rows of a streamed tile

// One warp per padded row (bh, i), i < sq_pad: D_i = sum_d dO o in fp32 and
// lse * log2(e), or 0 and +inf past sq; zeroes the row of the fp32 dQ
// accumulator. stats: [2, bh, sq_pad] (lse2, D_i).
template <int D>
__global__ void __launch_bounds__(kWG)
    attn_bwd_pre_kernel(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ stats, float* __restrict__ dq_acc,
                        int bh, int sq, int sq_pad) {
  const int r = blockIdx.x * (kWG / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= bh * sq_pad) return;
  const int b = r / sq_pad, i = r % sq_pad;
  float* lse2 = stats;
  float* di = stats + (size_t)bh * sq_pad;
  if (i >= sq) {
    if (lane == 0) {
      lse2[r] = __int_as_float(0x7f800000);  // +inf: p = 0 on padded rows
      di[r] = 0.0f;
    }
    return;
  }
  const size_t row = (size_t)b * sq + i;
  const __nv_bfloat162* op =
      reinterpret_cast<const __nv_bfloat162*>(o + row * D);
  const __nv_bfloat162* dp =
      reinterpret_cast<const __nv_bfloat162*>(dout + row * D);
  float sum = 0.0f;
#pragma unroll
  for (int k = lane; k < D / 2; k += 32) {
    const float2 a = __bfloat1622float2(op[k]);
    const float2 b2 = __bfloat1622float2(dp[k]);
    sum += a.x * b2.x + a.y * b2.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float4* acc = reinterpret_cast<float4*>(dq_acc + row * D);
#pragma unroll
  for (int k = lane; k < D / 4; k += 32) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane == 0) {
    lse2[r] = lse[row] * kLog2e;
    di[r] = sum;
  }
}

template <int D, int kCWG>
struct BwdLayout {
  static constexpr int kKeys = 64 * kCWG;              // keys a block
  static constexpr int kKVBlock = kKeys * kRowBytes;   // a column block of K/V
  static constexpr int kKV = kKVBlock * (D / 64);      // K or V
  static constexpr int kQBlock = kBwdM * kRowBytes;    // a column block of q
  static constexpr int kQT = kQBlock * (D / 64);       // a q or dO tile
  static constexpr int kDS = kKeys * kRowBytes;        // bf16 dS^T [keys][64 q]
  // with two consumer warpgroups dS alternates between two buffers, so one
  // warpgroup's stores never meet the other's dQ product still reading
  static constexpr int kDSBufs = kCWG;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;                   // 2 stages
  static constexpr int kDO = 2 * kKV + 2 * kQT;        // 2 stages
  static constexpr int kDSOff = 2 * kKV + 4 * kQT;
  // fp32 dQ chunk (64 q x 64 columns, two swizzled 32-column boxes) of each
  // warpgroup, staged for the TMA reduce-add (128 keys a block only: at 64
  // it would cost the second block an SM, and the atomics stay)
  static constexpr int kDQChunk = kBwdM * 64 * 4;
  static constexpr int kDQOff = kDSOff + kDSBufs * kDS;
  static constexpr int kStats = kDQOff + (kCWG == 2 ? kCWG * kDQChunk : 0);  // lse2[2][64], di[2][64]
  static constexpr int kBars = kStats + 4 * kBwdM * 4;   // kv_full, full[2], empty[2]
  static constexpr int kBytes = kBars + 5 * 8 + 1024;    // + alignment slack
};

// dK, dV of kCWG * 64 keys, and their share of dQ, over all q tiles.
template <int D, int kCWG>
__global__ void __launch_bounds__((kCWG + 1) * kWG, 3 - kCWG)
    attn_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ stats,
                    float* __restrict__ dq_acc,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int bh_count, int sq,
                    int sq_pad, int skv, float c, float scale) {
  using L = BwdLayout<D, kCWG>;
  constexpr int kCB = D / 64;
  constexpr int kKSteps = D / 16;           // depth steps of S^T and dP^T
  constexpr int kQSteps = kBwdM / 16;       // depth steps of dV and dK
  constexpr int kDQSteps = L::kKeys / 16;   // depth steps of dQ
  constexpr int kDQChunks = kCB / kCWG;     // 64-column dQ chunks a warpgroup
  static_assert(kCB % kCWG == 0, "dQ's columns split evenly");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* lse2_s = reinterpret_cast<float*>(smem + L::kStats);
  float* di_s = lse2_s + 2 * kBwdM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * L::kKeys;
  const int n_tiles = (sq + kBwdM - 1) / kBwdM;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCWG * kWG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
      for (int cb = 0; cb < kCB; ++cb) {
        tma_load_3d(smem + L::kK + cb * L::kKVBlock, &tm_k, kv_full, 64 * cb,
                    n0, bh);
        tma_load_3d(smem + L::kV + cb * L::kKVBlock, &tm_v, kv_full, 64 * cb,
                    n0, bh);
      }
      const float* lse2 = stats + (size_t)bh * sq_pad;
      const float* di = stats + (size_t)(bh_count + bh) * sq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it & 1;
        const int m0 = it * kBwdM;
        if (it >= 2) mbar_wait(empty + s, ((it >> 1) - 1) & 1);
        mbar_expect_tx(full + s, 2 * L::kQT + 2 * kBwdM * 4);
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_3d(smem + L::kQ + s * L::kQT + cb * L::kQBlock, &tm_q,
                      full + s, 64 * cb, m0, bh);
          tma_load_3d(smem + L::kDO + s * L::kQT + cb * L::kQBlock, &tm_do,
                      full + s, 64 * cb, m0, bh);
        }
        bulk_load(lse2_s + s * kBwdM, lse2 + m0, kBwdM * 4, full + s);
        bulk_load(di_s + s * kBwdM, di + m0, kBwdM * 4, full + s);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----------------------------------------
    setmaxnreg_inc<(kCWG == 2 ? 240 : 232)>();
    const int w = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kr = 64 * w + 16 * warp + g;  // this thread's key rows kr, kr + 8
    const bool key_lo = n0 + kr < skv, key_hi = n0 + kr + 8 < skv;
    const uint32_t k_addr = smem_u32(smem + L::kK);
    const uint32_t v_addr = smem_u32(smem + L::kV);
    const uint32_t q_addr = smem_u32(smem + L::kQ);
    const uint32_t do_addr = smem_u32(smem + L::kDO);
    const uint32_t ds_addr = smem_u32(smem + L::kDSOff);
    uint8_t* ds_smem = smem + L::kDSOff;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      const int m0 = it * kBwdM;
      const uint32_t qs = q_addr + s * L::kQT, dos = do_addr + s * L::kQT;

      // S^T = K_w q^T, dP^T = V_w dO^T: 64 keys x 64 queries
      float st[32], dpt[32];
      mbar_wait(full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t kv_off =
            (kk >> 2) * L::kKVBlock + 64 * w * kRowBytes + (kk & 3) * 32;
        const uint32_t q_off = (kk >> 2) * L::kQBlock + (kk & 3) * 32;
        mma_ss<64, 0, 0>(st, desc_sw128(k_addr + kv_off, 16, 1024),
                         desc_sw128(qs + q_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t kv_off =
            (kk >> 2) * L::kKVBlock + 64 * w * kRowBytes + (kk & 3) * 32;
        const uint32_t q_off = (kk >> 2) * L::kQBlock + (kk & 3) * 32;
        mma_ss<64, 0, 0>(dpt, desc_sw128(v_addr + kv_off, 16, 1024),
                         desc_sw128(dos + q_off, 16, 1024), kk > 0);
      }
      wgmma_commit();

      // P^T = exp2(c s - lse2), 0 for keys past the end (padded q rows
      // have lse2 = +inf); dS^T = P^T (dP^T - D_i)
      const float* lse2_t = lse2_s + s * kBwdM;
      const float* di_t = di_s + s * kBwdM;
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2_t + 8 * j + 2 * t);
        st[4 * j + 0] = key_lo ? exp2f(st[4 * j + 0] * c - l2.x) : 0.0f;
        st[4 * j + 1] = key_lo ? exp2f(st[4 * j + 1] * c - l2.y) : 0.0f;
        st[4 * j + 2] = key_hi ? exp2f(st[4 * j + 2] * c - l2.x) : 0.0f;
        st[4 * j + 3] = key_hi ? exp2f(st[4 * j + 3] * c - l2.y) : 0.0f;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - d2.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d2.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d2.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d2.y);
      }
      uint32_t pa[kQSteps][4], da[kQSteps][4];
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        pack_a(pa[kk], st, kk);
        pack_a(da[kk], dpt, kk);
      }

      // bf16(dS^T) -> shared memory, [keys][64 q] swizzled: key row kr
      // (kr % 8 = g), q chunk j at chunk j ^ g
      const int buf = L::kDSBufs == 2 ? (it & 1) : 0;
      uint8_t* ds_buf = ds_smem + buf * L::kDS;
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        const int j0 = 2 * kk, j1 = 2 * kk + 1;
        *reinterpret_cast<uint32_t*>(ds_buf + kr * kRowBytes + ((j0 ^ g) << 4) + 4 * t) = da[kk][0];
        *reinterpret_cast<uint32_t*>(ds_buf + (kr + 8) * kRowBytes + ((j0 ^ g) << 4) + 4 * t) = da[kk][1];
        *reinterpret_cast<uint32_t*>(ds_buf + kr * kRowBytes + ((j1 ^ g) << 4) + 4 * t) = da[kk][2];
        *reinterpret_cast<uint32_t*>(ds_buf + (kr + 8) * kRowBytes + ((j1 ^ g) << 4) + 4 * t) = da[kk][3];
      }
      fence_proxy_async();

      // dV += bf16(P^T) dO, dK += bf16(dS^T) q: register A, MN-major B
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk)
        mma_rs<D, 1>(dv_acc, pa[kk], desc_sw128(dos + kk * 2048, L::kQBlock, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk)
        mma_rs<D, 1>(dk_acc, da[kk], desc_sw128(qs + kk * 2048, L::kQBlock, 1024), 1);
      wgmma_commit();

      // every warpgroup's dS^T is in shared memory, and every dQ staging
      // buffer has been read by the last tile's reduce-add
      if (kCWG == 2 && tid == 0) bulk_wait_read();
      named_bar_sync(1, kCWG * kWG);

      // dQ[:, chunk] = dS K over the block's keys: A = dS (MN-major: the
      // buffer's rows are keys, q contiguous), B = K (MN-major)
      const uint32_t dsb = ds_addr + buf * L::kDS;
      const int row_lo = m0 + 16 * warp + g, row_hi = row_lo + 8;
#pragma unroll
      for (int h = 0; h < kDQChunks; ++h) {
        const int chunk = w * kDQChunks + h;
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDQSteps; ++kk) {
          mma_ss<64, 1, 1>(dq, desc_sw128(dsb + kk * 2048, L::kDS, 1024),
                           desc_sw128(k_addr + chunk * L::kKVBlock + kk * 2048,
                                      L::kKVBlock, 1024),
                           kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        if constexpr (kCWG == 2) {
          // stage the chunk in the layout of two 32-column fp32 boxes
          // (16-byte chunk c of row r at c ^ (r % 8)), and one thread adds
          // it into dq_acc with two TMA reduce-adds (rows past sq dropped)
          uint8_t* stage = smem + L::kDQOff + w * L::kDQChunk;
          const int r = 16 * warp + g;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 2 * (j & 3) + (t >> 1);
            uint8_t* p = stage + (j >> 2) * (L::kDQChunk / 2) + r * kRowBytes +
                         ((c ^ g) << 4) + (t & 1) * 8;
            *reinterpret_cast<float2*>(p) = make_float2(dq[4 * j], dq[4 * j + 1]);
            *reinterpret_cast<float2*>(p + 8 * kRowBytes) =
                make_float2(dq[4 * j + 2], dq[4 * j + 3]);
          }
          fence_proxy_async();
          named_bar_sync(2 + w, kWG);
          if (tid == 0) {
            tma_reduce_add_3d(&tm_dq, stage, 64 * chunk, m0, bh);
            tma_reduce_add_3d(&tm_dq, stage + L::kDQChunk / 2, 64 * chunk + 32,
                              m0, bh);
            bulk_commit();
          }
        } else {
          // lanes t and t ^ 1 swap halves, so that an even lane adds four
          // columns of row_lo and an odd lane four of row_hi: one float4
          // atomic an 8-column block instead of two float2
          const bool odd = t & 1;
          const int row = odd ? row_hi : row_lo;
          float* acc = dq_acc + ((size_t)bh * sq + row) * D + 64 * chunk + 2 * (t & 2);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float x = __shfl_xor_sync(
                0xffffffffu, odd ? dq[4 * j] : dq[4 * j + 2], 1);
            const float y = __shfl_xor_sync(
                0xffffffffu, odd ? dq[4 * j + 1] : dq[4 * j + 3], 1);
            const float4 add = odd ? make_float4(x, y, dq[4 * j + 2], dq[4 * j + 3])
                                   : make_float4(dq[4 * j], dq[4 * j + 1], x, y);
            if (row < sq) atomicAdd(reinterpret_cast<float4*>(acc + 8 * j), add);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty + s);
    }

    if (kCWG == 2 && tid == 0) bulk_wait();  // the last reduce-add is done
    const int key_row_lo = n0 + kr, key_row_hi = key_row_lo + 8;
    __nv_bfloat16* dk_bh = dk + (size_t)bh * skv * D;
    __nv_bfloat16* dv_bh = dv + (size_t)bh * skv * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (key_lo) {
        *reinterpret_cast<uint32_t*>(dk_bh + (size_t)key_row_lo * D + col) =
            pack_bf16x2(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv_bh + (size_t)key_row_lo * D + col) =
            pack_bf16x2(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key_hi) {
        *reinterpret_cast<uint32_t*>(dk_bh + (size_t)key_row_hi * D + col) =
            pack_bf16x2(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv_bh + (size_t)key_row_hi * D + col) =
            pack_bf16x2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

// dq = bf16(scale * dq_acc), four elements a thread.
__global__ void __launch_bounds__(256)
    attn_bwd_post_kernel(const float4* __restrict__ acc,
                         uint2* __restrict__ dq, size_t n4, float scale) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 a = acc[i];
  dq[i] = make_uint2(pack_bf16x2(a.x * scale, a.y * scale),
                     pack_bf16x2(a.z * scale, a.w * scale));
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int skv, float scale,
               cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_rows_map(&tq, q, 2, bh, sq, D, L::kRows);
  if (!err) err = encode_rows_map(&tk, k, 2, bh, skv, D, L::kRows);
  if (!err) err = encode_rows_map(&tv, v, 2, bh, skv, D, L::kRows);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes));
  if (err) return err;
  dim3 grid((sq + L::kRows - 1) / L::kRows, bh);
  attn_fwd_kernel<D><<<grid, 3 * kWG, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, skv,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kCWG>
int launch_bwd_main(const CUtensorMap& tq, const void* k, const void* v,
                    const CUtensorMap& tdo, const float* stats, float* dq_acc,
                    void* dk, void* dv, int bh, int sq, int sq_pad, int skv,
                    float scale, cudaStream_t stream) {
  using L = BwdLayout<D, kCWG>;
  CUtensorMap tk, tv, tdq;
  int err = encode_rows_map(&tk, k, 2, bh, skv, D, L::kKeys);
  if (!err) err = encode_rows_map(&tv, v, 2, bh, skv, D, L::kKeys);
  if (!err) err = encode_rows_map(&tdq, dq_acc, 4, bh, sq, D, kBwdM);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      attn_bwd_kernel<D, kCWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes));
  if (err) return err;
  dim3 grid((skv + L::kKeys - 1) / L::kKeys, bh);
  attn_bwd_kernel<D, kCWG><<<grid, (kCWG + 1) * kWG, L::kBytes, stream>>>(
      tq, tk, tv, tdo, tdq, stats, dq_acc, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bh, sq, sq_pad, skv, scale * kLog2e,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* dq_acc, float* stats, int bh, int sq, int skv,
               int keys_per_block, float scale, cudaStream_t stream) {
  const int sq_pad = (sq + kBwdM - 1) / kBwdM * kBwdM;
  const int rows = bh * sq_pad;
  attn_bwd_pre_kernel<D><<<(rows + 3) / 4, kWG, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats, dq_acc, bh, sq,
      sq_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  CUtensorMap tq, tdo;
  err = encode_rows_map(&tq, q, 2, bh, sq, D, kBwdM);
  if (!err) err = encode_rows_map(&tdo, dout, 2, bh, sq, D, kBwdM);
  if (err) return err;
  if (keys_per_block == 128 && D == 128) {
    err = launch_bwd_main<D, (D == 128 ? 2 : 1)>(tq, k, v, tdo, stats, dq_acc,
                                                 dk, dv, bh, sq, sq_pad, skv,
                                                 scale, stream);
  } else if (keys_per_block == 64) {
    err = launch_bwd_main<D, 1>(tq, k, v, tdo, stats, dq_acc, dk, dv, bh, sq,
                                sq_pad, skv, scale, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;

  const size_t n4 = (size_t)bh * sq * D / 4;
  attn_bwd_post_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), n4,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o [bh, sq, D], k/v [bh, skv, D] contiguous bf16; lse [bh, sq] fp32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim; a negative value if a TMA map cannot be encoded).
extern "C" int attn_train_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int bh, int sq,
                                   int skv, int head_dim, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_fwd<128>(q, k, v, o, lse, bh, sq, skv, scale, s);
  if (head_dim == 64) return launch_fwd<64>(q, k, v, o, lse, bh, sq, skv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout/dq like q, dk/dv like k (bf16); dq_acc [bh, sq, D] fp32 and stats
// [2, bh, sq rounded up to 64] fp32 scratch; keys_per_block 128 (head_dim
// 128 only) or 64. Launches the pre, main and post kernels in that order on
// `stream`.
extern "C" int attn_train_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* dq_acc, float* stats,
                                   int bh, int sq, int skv, int head_dim,
                                   int keys_per_block, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, stats,
                           bh, sq, skv, keys_per_block, scale, s);
  if (head_dim == 64)
    return launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, stats, bh,
                          sq, skv, keys_per_block, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) that a kernel launches with: kernel 0 is the
// forward, 1 the backward main kernel at 64 keys a block, 2 at 128 (head_dim
// 128 only); -1 for anything else.
extern "C" int attn_train_smem_bytes(int head_dim, int kernel) {
  if (head_dim == 128) {
    if (kernel == 0) return FwdLayout<128>::kBytes;
    if (kernel == 1) return BwdLayout<128, 1>::kBytes;
    if (kernel == 2) return BwdLayout<128, 2>::kBytes;
  }
  if (head_dim == 64) {
    if (kernel == 0) return FwdLayout<64>::kBytes;
    if (kernel == 1) return BwdLayout<64, 1>::kBytes;
  }
  return -1;
}
