// K8: the head-pair-packed flash-attention forward for head_dim 64 on
// Hopper (sm_90a): bf16 in/out, fp32 softmax statistics and accumulation,
// non-causal, no backward.
//
// Replaces the Pallas TPU kernel `_packed_kernel` of
// scripts/bench_attn_d64.py (`packed_flash`). Rows are packed
// [B*H/2, S, 128] = [head A | head B]: two heads of 64 side by side. The
// TPU kernel runs QK^T and P.V of the pair as single 128-deep contractions
// against block-diagonal K and V tiles that are half zeros, because its
// matrix unit contracts 128 deep. wgmma contracts 16 deep, so nothing is
// filled: each head's products read only its own 64 lanes. What is
// computed is what the TPU kernel computes: q scaled once in bf16 by
// q_scale = bf16(64^-0.5 * log2 e); two independent online softmaxes a
// row in the exp2 domain, each with its running max m and l a lane sum of
// fp32 p; O = bf16(P) V accumulated in fp32; o = O / l written to the
// head's 64 lanes. Keys at or past Skv get s = -1e30 (the TPU's mask) on
// the last key tile only; there is no floor under the exponent.
//
// What bounds it on the H100: at [48 pairs, 15906, 128] the two products
// (6.22 TFLOP: 6.29 ms at 989 TFLOP/s) and, as high, the exp2s (one a
// logit, 16 a clock per SM: 6.28 ms). So the softmax of one head runs
// under the products of the other, and a logit costs as few instructions
// as it can (the ragged mask on the last key tile only, the wgmma
// descriptors built once and moved by byte offsets).
//
// Design: csrc/flash_variants.cu's (K9/K10) at D = 128, on
// csrc/sm90_common.cuh: a packed row is a D = 128 row, stored as two
// 64-column blocks of 128-byte swizzled rows (head A is column block 0,
// head B column block 1), and the 3-D TMA maps run over [pairs, S, 128].
// A block is persistent (one an SM over the (pair, q tile) tiles) and
// warp-specialised. Warpgroup 0 is the producer: its thread 0 issues every
// TMA load (Q tiles of 128 rows into two buffers, the next tile's Q as soon
// as the consumers are done with that buffer; 128-key K and V tiles into a
// 2-stage ring, all that fits beside the Q buffers), and its warps 1-3
// rescale each landed Q tile in shared memory in place and release it to
// the consumers through a second barrier. The two consumer warpgroups (64
// q rows each, both heads) take turns over named barriers to issue their
// batches. One S tile (64 rows x 128 keys, 64 registers a thread) lives at
// a time, beside both heads' O (32 + 32) and bf16 P (32 + 32), so the heads
// take turns inside a consumer, each head's softmax under the other head's
// P V:
//   batch 1 of key tile n:  S_B,n = Q_B K_B,n^T  |  O_A += P_A,n V_A,n
//       wait for S_B,n alone; head B's softmax of tile n;
//   batch 2 of key tile n:  S_A,n+1 = Q_A K_A,n+1^T  |  O_B += P_B,n V_B,n
//       wait for S_A,n+1 (and P_A,n V_A,n); head A's softmax of tile
//       n + 1; wait for P_B,n V_B,n;
// each product a commit group of its own (S: 4 wgmma m64n128k16 over the
// head's column block, both operands K-major; P V: 8 m64n64k16, P from
// registers, V MN-major by the transpose bit). The first batch of a q tile
// (S_A,0) and its last (P_B V_B alone) are peeled. No wgmma of a batch
// sits under a branch, and every register a batch reads or writes is
// defined before its fence and read only after the wait that completes it.
// P_A V_A stays in flight from batch 1 into batch 2 (its registers are not
// touched there before the wait), but nothing crosses the loop's back
// edge: a P_B V_B left in flight into the next iteration made ptxas
// serialise every wgmma of the kernel. The TMA maps
// are 3-D, so a ragged tile reads zeros and never the next pair's rows;
// rows at or past Sq are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kRowBytes = 128;   // one row of a 64-column swizzled box
constexpr int kN = 128;          // keys a tile
constexpr int kHeadDim = 64;
constexpr int kRow = 2 * kHeadDim;  // a packed row, bf16
constexpr int kCWG = 2;          // consumer warpgroups of 64 q rows
constexpr int kStages = 2;       // stages of the K/V ring
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr int kSchedBar = 1;   // named barriers 1..: the consumers' turns

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mbar_wait / mbar_arrive on a barrier's shared-window address, for the
// producer warps' few registers.
__device__ __forceinline__ void mbar_wait_u32(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_u32(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The 16 bytes of bf16 at shared address `addr`, each x replaced by
// bf16(float(x) * s) (`s2`: the bf16 pair (s, s)): a bf16 product of two
// bf16 values is their exact product rounded once.
__device__ __forceinline__ void scale_16b(uint32_t addr, uint32_t s2) {
  const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(&s2);
  uint32_t v[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 x = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&v[j]), s);
    v[j] = *reinterpret_cast<uint32_t*>(&x);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Shared memory of a block: two Q buffers of kQRows packed rows, the K and
// V rings, then the mbarriers. A packed tile is two column blocks (head A,
// head B) of 128-byte rows one after the other; every tile starts on a
// 1024-byte boundary (the swizzle phase of a row is then row % 8).
struct Layout {
  static constexpr int kQRows = 64 * kCWG;
  static constexpr int kQBlock = kQRows * kRowBytes;  // one head's columns
  static constexpr int kQTile = 2 * kQBlock;
  static constexpr int kKVBlock = kN * kRowBytes;
  static constexpr int kKVTile = 2 * kKVBlock;
  static constexpr int kQ = 0;                          // 2 buffers
  static constexpr int kK = 2 * kQTile;                 // kStages
  static constexpr int kV = kK + kStages * kKVTile;     // kStages
  static constexpr int kBars = kV + kStages * kKVTile;  // q_full[2],
                                                        // q_empty[2],
                                                        // q_ready[2],
                                                        // kStages each of
                                                        // k_full, v_full,
                                                        // k_empty, v_empty
  static constexpr int kBytes = kBars + (6 + 4 * kStages) * 8 + 1024;
};

// The register A operand of k-step kk from an accumulator of 8-column
// blocks: columns 16 kk .. 16 kk + 15 are blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[64],
                                       int kk) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// S = Q K^T of one head over one key tile: 64 rows x 128 keys, depth 64,
// both operands K-major at the head's column block (the k-th 16-deep slice
// 32 k bytes into it).
__device__ __forceinline__ void issue_s(float (&sc)[64], uint64_t q,
                                        uint64_t k) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    mma_ss<128, 0, 0>(sc, desc_add(q, kk * 32), desc_add(k, kk * 32),
                      kk > 0);
}

// O += bf16(P) V of one head over one key tile, V MN-major at the head's
// column block (the k-th 16-key slice 2048 k bytes into it).
__device__ __forceinline__ void issue_pv(float (&acc)[32],
                                         const uint32_t (&pa)[8][4],
                                         uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
    mma_rs<64, 1>(acc, pa[kk], desc_add(v, kk * 2048), 1);
}

// One head's online softmax of an S tile (64 rows x 128 keys from n0),
// then its O rescaled by alpha and bf16(P) packed as the register A
// operand of P V. Keys at or past Skv first get s = -1e30, on the last key
// tile only (the TPU's mask: their exp2 is then exactly 0). l is this
// thread's partial row sums of fp32 p.
__device__ __forceinline__ void softmax_head(float (&sc)[64], float (&acc)[32],
                                             uint32_t (&pa)[8][4],
                                             float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, int n0,
                                             int skv, int t) {
  if (n0 + kN > skv) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + j * 8 + t * 2 + (e & 1) >= skv) sc[4 * j + e] = kNegInf;
      }
    }
  }
  float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // the four threads of a group hold one row between them
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  const float al_lo = ex2(m_lo - mn_lo), al_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j + 0] = ex2(sc[4 * j + 0] - mn_lo);
    sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn_lo);
    sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn_hi);
    sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn_hi);
    sum_lo += sc[4 * j + 0] + sc[4 * j + 1];
    sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l_lo = al_lo * l_lo + sum_lo;
  l_hi = al_hi * l_hi + sum_hi;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    acc[4 * j + 0] *= al_lo;
    acc[4 * j + 1] *= al_lo;
    acc[4 * j + 2] *= al_hi;
    acc[4 * j + 3] *= al_hi;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
}

// o = O / l of one head into its 64 lanes of the packed rows (rows at or
// past Sq are not stored).
__device__ __forceinline__ void store_head(__nv_bfloat16* o_pair,
                                           const float (&acc)[32], float l_lo,
                                           float l_hi, int row_lo, int sq,
                                           int col0, int t) {
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int col = col0 + j * 8 + t * 2;
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(o_pair + (size_t)row_lo * kRow + col) =
          pack_bf16x2(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(o_pair + (size_t)row_hi * kRow + col) =
          pack_bf16x2(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
    }
  }
}

__global__ void __launch_bounds__((kCWG + 1) * kWG, 1)
    flash_packed_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int pairs, int sq,
                        int skv, uint32_t q_scale2) {
  using L = Layout;
  // registers a thread of the producer warpgroup keeps (24 beside two
  // consumers of 240) and a consumer's: what the block was launched with
  // (65536 / threads, rounded down to a multiple of 8, for every thread)
  // less the producer's, shared by the consumers in multiples of 8, at
  // most 240. setmaxnreg.inc waits for registers the block does not have,
  // so this must not round up.
  constexpr int kProducerRegs = 24;
  constexpr int kThreads = (kCWG + 1) * kWG;
  constexpr int kPool = 65536 / kThreads / 8 * 8 * kThreads;
  constexpr int kShare = (kPool - kProducerRegs * kWG) / (kCWG * kWG) / 8 * 8;
  constexpr int kRegs = kShare > 240 ? 240 : kShare;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* q_ready = bars + 4;  // the rescaled Q
  uint64_t* k_full = bars + 6;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int n_q = (sq + L::kQRows - 1) / L::kQRows;
  const int n_kv = (skv + kN - 1) / kN;
  const int n_tiles = pairs * n_q;
  // (warp-uniform for the compiler: the descriptors below then stay in
  // uniform registers)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kCWG * kWG);
      mbar_init(q_ready + s, kWG - 32);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kCWG * kWG);
      mbar_init(v_empty + s, kCWG * kWG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) {
      // warps 1-3 rescale each landed Q tile in place, off the consumers'
      // path (16 bytes a thread at a time, shared-window addresses, the
      // scale read from the kernel's parameters: the warpgroup has 24
      // registers, and a register held through the loop spills)
      const uint32_t q0 = smem_u32(smem + L::kQ);
      const uint32_t full0 = smem_u32(q_full), ready0 = smem_u32(q_ready);
      const int mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
      for (int local = 0; local < mine; ++local) {
        const uint32_t b = local & 1;
        mbar_wait_u32(full0 + 8 * b, (local >> 1) & 1);
        for (uint32_t a = q0 + b * L::kQTile + 16 * (threadIdx.x - 32);
             a < q0 + (b + 1) * L::kQTile; a += 16 * (kWG - 32))
          scale_16b(a, q_scale2);
        fence_proxy_async();  // for the consumers' wgmmas
        mbar_arrive_u32(ready0 + 8 * b);
      }
    }
    if (threadIdx.x == 0) {
      // the Q of the block's local-th tile, into buffer local % 2 once
      // the consumers are done with its previous tile's products
      auto load_q = [&](int local, int tile) {
        const int buf = local & 1;
        if (local >= 2) mbar_wait(q_empty + buf, ((local >> 1) - 1) & 1);
        mbar_expect_tx(q_full + buf, L::kQTile);
        for (int h = 0; h < 2; ++h)
          tma_load_3d(smem + L::kQ + buf * L::kQTile + h * L::kQBlock, &tm_q,
                      q_full + buf, kHeadDim * h, (tile % n_q) * L::kQRows,
                      tile / n_q);
      };
      int local = 0, it = 0;
      if (blockIdx.x < n_tiles) load_q(0, blockIdx.x);
      for (int tile = blockIdx.x; tile < n_tiles;
           tile += gridDim.x, ++local) {
        const int pair = tile / n_q;
        for (int n = 0; n < n_kv; ++n, ++it) {
          const int s = it % kStages;
          const uint32_t ph = ((it / kStages) - 1) & 1;
          if (it >= kStages) mbar_wait(k_empty + s, ph);
          mbar_expect_tx(k_full + s, L::kKVTile);
          for (int h = 0; h < 2; ++h)
            tma_load_3d(smem + L::kK + s * L::kKVTile + h * L::kKVBlock,
                        &tm_k, k_full + s, kHeadDim * h, n * kN, pair);
          if (it >= kStages) mbar_wait(v_empty + s, ph);
          mbar_expect_tx(v_full + s, L::kKVTile);
          for (int h = 0; h < 2; ++h)
            tma_load_3d(smem + L::kV + s * L::kKVTile + h * L::kKVBlock,
                        &tm_v, v_full + s, kHeadDim * h, n * kN, pair);
          if (n == 0 && tile + (int)gridDim.x < n_tiles)
            load_q(local + 1, tile + gridDim.x);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each, both heads --------------------------
    setmaxnreg_inc<kRegs>();
    const int w = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    // descriptors of head A's column block of this consumer's Q rows in
    // buffer 0 and of stage 0 of the K and V rings; head B, the other
    // buffer and stages are byte offsets from them
    const uint64_t q_desc =
        desc_sw128(smem_u32(smem + L::kQ + 64 * w * kRowBytes), 16, 1024);
    const uint64_t k_desc = desc_sw128(smem_u32(smem + L::kK), 16, 1024);
    const uint64_t v_desc =
        desc_sw128(smem_u32(smem + L::kV), L::kKVBlock, 1024);
    // the ring of turns starts with consumer 0
    if (w == kCWG - 1) named_bar_arrive(kSchedBar, 2 * kWG);

    int local = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int pair = tile / n_q;
      const int m0 = (tile % n_q) * L::kQRows;
      const int buf = local & 1;
      const uint64_t q_a = desc_add(q_desc, buf * L::kQTile);
      const uint64_t q_b = desc_add(q_a, L::kQBlock);
      mbar_wait(q_ready + buf, (local >> 1) & 1);

      // per head: running max, this thread's partial row sums, O and P
      float ma_lo = kNegInf, ma_hi = kNegInf, mb_lo = kNegInf,
            mb_hi = kNegInf;
      float la_lo = 0.0f, la_hi = 0.0f, lb_lo = 0.0f, lb_hi = 0.0f;
      float acc_a[32], acc_b[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_a[i] = acc_b[i] = 0.0f;
      float sc[64];  // S of one head, then p in place
      uint32_t pa_a[8][4], pa_b[8][4];
      // key tile j of this q tile sits in ring stage (it + j) % kStages
      auto stage = [&](int j) { return (it + j) % kStages; };
      auto phase = [&](int j) { return ((it + j) / kStages) & 1; };
      auto k_tile = [&](int j) {
        mbar_wait(k_full + stage(j), phase(j));
        return desc_add(k_desc, stage(j) * L::kKVTile);
      };
      auto v_tile = [&](int j) {
        mbar_wait(v_full + stage(j), phase(j));
        return desc_add(v_desc, stage(j) * L::kKVTile);
      };
      // a stage of the K (V) ring is free once the products reading it
      // have completed
      auto k_done = [&](int j) { mbar_arrive(k_empty + stage(j)); };
      auto v_done = [&](int j) { mbar_arrive(v_empty + stage(j)); };
      auto fence_a = [&] {
        fence_regs(acc_a);
        fence_regs(pa_a);
      };
      auto fence_b = [&] {
        fence_regs(acc_b);
        fence_regs(pa_b);
      };
      // A batch: every register it reads or writes is defined before the
      // fence and read only after the wait that completes it (else ptxas
      // serialises the wgmmas); the consumers take turns to issue.
      auto my_turn = [&] { named_bar_sync(kSchedBar + w, 2 * kWG); };
      // the start of a batch with no product in flight
      auto begin = [&] {
        my_turn();
        fence_regs(sc);
        fence_a();
        fence_b();
        wgmma_fence();
      };
      auto pass_turn = [&] {
        named_bar_arrive(kSchedBar + (w + 1) % kCWG, 2 * kWG);
      };
      auto softmax_a = [&](int n) {
        softmax_head(sc, acc_a, pa_a, ma_lo, ma_hi, la_lo, la_hi, n * kN,
                     skv, t);
      };
      auto softmax_b = [&](int n) {
        softmax_head(sc, acc_b, pa_b, mb_lo, mb_hi, lb_lo, lb_hi, n * kN,
                     skv, t);
      };
      // batch 1 of key tile n: S_B,n and O_A += P_A,n V_A,n, then head B's
      // softmax of tile n under P_A,n V_A,n, which is left in flight
      auto batch_1 = [&](int n, uint64_t kt, uint64_t vt) {
        begin();
        issue_s(sc, q_b, desc_add(kt, L::kKVBlock));
        wgmma_commit();
        issue_pv(acc_a, pa_a, vt);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        k_done(n);
        if (n == n_kv - 1) mbar_arrive(q_empty + buf);  // Q is read
        softmax_b(n);
      };

      // S_A,0 and head A's softmax; then per key tile n: batch 1, and
      // (but for the last) batch 2: S_A,n+1 and O_B += P_B,n V_B,n, with
      // head A's softmax of tile n + 1 under P_B,n V_B,n; then the last
      // tile's P_B V_B alone.
      uint64_t kt = k_tile(0);
      begin();
      issue_s(sc, q_a, kt);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_a(0);
      for (int n = 0; n < n_kv - 1; ++n) {
        const uint64_t vt = v_tile(n);
        batch_1(n, kt, vt);
        kt = k_tile(n + 1);
        my_turn();  // P_A,n V_A,n in flight: its registers are not touched
        fence_regs(sc);
        fence_b();
        wgmma_fence();
        issue_s(sc, q_a, kt);
        wgmma_commit();
        issue_pv(acc_b, pa_b, desc_add(vt, L::kKVBlock));
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        fence_a();
        softmax_a(n + 1);
        wgmma_wait<0>();
        fence_b();
        v_done(n);
      }
      const uint64_t vt = v_tile(n_kv - 1);
      batch_1(n_kv - 1, kt, vt);
      my_turn();
      fence_b();
      wgmma_fence();
      issue_pv(acc_b, pa_b, desc_add(vt, L::kKVBlock));
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_a();
      fence_b();
      v_done(n_kv - 1);
      it += n_kv;

      const int row_lo = m0 + 64 * w + 16 * warp + g;
      __nv_bfloat16* o_pair = o + (size_t)pair * sq * kRow;
      store_head(o_pair, acc_a, la_lo, la_hi, row_lo, sq, 0, t);
      store_head(o_pair, acc_b, lb_lo, lb_hi, row_lo, sq, kHeadDim, t);
    }
  }
}

// The bf16 pair (x, x), x rounded to nearest even (x finite).
uint32_t bf16x2_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  u = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return u | (u << 16);
}

// Once per process (its current device): the opt-in to the dynamic shared
// memory and the blocks an SM then holds.
struct LaunchInfo {
  int err;
  int blocks_per_sm;
};

LaunchInfo launch_info(int threads, int smem_bytes) {
  LaunchInfo info{static_cast<int>(cudaFuncSetAttribute(
                      flash_packed_kernel,
                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                      smem_bytes)),
                  0};
  if (info.err == 0) {
    info.err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info.blocks_per_sm, flash_packed_kernel, threads, smem_bytes));
  }
  if (info.err == 0 && info.blocks_per_sm < 1)
    info.err = static_cast<int>(cudaErrorInvalidConfiguration);
  return info;
}

}  // namespace

// q [pairs, sq, 128], k/v [pairs, skv, 128], o [pairs, sq, 128]: contiguous
// bf16, each row [head A | head B]; q is scaled in the kernel by q_scale
// (rounded to bf16). Returns cudaGetLastError() after the launch (a
// negative value if a TMA map cannot be encoded).
extern "C" int flash_packed_bf16(const void* q, const void* k, const void* v,
                                 void* o, int pairs, int sq, int skv,
                                 float q_scale, void* stream) {
  using L = Layout;
  constexpr int kThreads = (kCWG + 1) * kWG;
  static const LaunchInfo info = launch_info(kThreads, L::kBytes);
  if (info.err) return info.err;
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  CUtensorMap tq, tk, tv;
  err = encode_rows_map(&tq, q, 2, pairs, sq, kRow, L::kQRows);
  if (!err) err = encode_rows_map(&tk, k, 2, pairs, skv, kRow, kN);
  if (!err) err = encode_rows_map(&tv, v, 2, pairs, skv, kRow, kN);
  if (err) return err;
  const long long tiles =
      static_cast<long long>(pairs) * ((sq + L::kQRows - 1) / L::kQRows);
  const long long slots = static_cast<long long>(sms) * info.blocks_per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  flash_packed_kernel<<<grid, kThreads, L::kBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), pairs, sq, skv,
      bf16x2_bits(q_scale));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape: what = 0 gives the dynamic shared memory (bytes), 1 the
// consumer warpgroups, 2 the q rows a tile, 3 the stages of the K/V ring;
// -1 for anything else.
extern "C" int flash_packed_config(int what) {
  switch (what) {
    case 0: return Layout::kBytes;
    case 1: return kCWG;
    case 2: return Layout::kQRows;
    case 3: return kStages;
    default: return -1;
  }
}
