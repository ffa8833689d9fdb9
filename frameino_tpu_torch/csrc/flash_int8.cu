// K11 and K12: the int8-QK^T flash-attention forwards of the attention
// experiments on Hopper (sm_90a). int8 q/k codes with fp32 per-row scales,
// bf16 v and output, fp32 softmax statistics and accumulation, non-causal.
//
// Replaces two Pallas TPU kernels of scripts/bench_flash_variants.py:
//   - _kernel_v3 (K12, flash_v3): s = (fp32(q_i8 . k_i8) * qs[row]) *
//     ks[key], online softmax in the exp2 domain, l = sum p in fp32:
//     kStatic = false;
//   - _kernel_v123 (K11, flash_v3(static_ones=True)): the same logits, p =
//     exp2(s - bound) with bound >= every logit read from device memory (no
//     running max, and NO floor: a bound far above the logits underflows
//     every p, as in the plain version), l = sum bf16(p) by the ones column
//     (on the tensor cores, as the TPU appends a column of ones to V):
//     kStatic = true.
// The logit's products come in that order; K11 fuses the second into the
// subtraction of the bound (its s is not rounded on its own). Both: O =
// bf16(P) V accumulated in fp32, o = O / l. Keys at or past Skv give p = 0
// exactly (their zero-filled codes give a logit of 0, which K11 would
// otherwise count).
//
// What bounds it on the H100: at [48, 5590, 128] QK^T at the int8 rate
// (1,979 TOP/s) and P V at the bf16 rate (989 TFLOP/s) take 0.58 ms; at
// [96, 15906, 64] the exp2s (one a logit, 16 a clock per SM: 6.3 ms) bound
// it above the products (4.7 ms). In practice the softmax's instruction
// stream does (scripts/tune_flash_int8.py's probes): without the exp2s the
// time holds, without the softmax it falls to 1.15-1.22x the products. So
// the softmax of one warpgroup runs under another's products, and a logit
// costs as few instructions as it can: the int32 -> fp32 conversion is one
// I2FP, the ragged mask is applied on the last key tile only, and the
// wgmma descriptors are built once and moved by byte offsets.
//
// Design: csrc/flash_fwd.cu's (K1/K3), on csrc/sm90_common.cuh. A block is
// persistent (one an SM over the (batch*head, q tile) tiles) and warp-
// specialised. Warpgroup 0 is the producer: its thread 0 issues every TMA
// load (int8 Q tiles into two buffers; the int8 K tile and the bf16 V tile
// of 128 keys into a ring of kStages stages), its warp 1 copies the 128 key
// scales of each key tile into a ring of their own (kKsSlots slots, each
// freed as soon as the softmax that reads it is done) with plain loads: a
// [bh, S] fp32 row is no multiple of 16 bytes, which TMA and bulk copies
// need, and the scales are 1/64 (1/128) of the K bytes. The consumer
// warpgroups (2 at head_dim 128, 3 at 64; 64 q rows each) take turns to
// issue one batch a key tile: S_n = Q K_n^T by wgmma m64n128k32 s32.s8.s8
// (both operands K-major: an int8 row of 128 bytes is one 128-byte swizzle
// atom, one of 64 bytes takes the 64-byte swizzle), and O += bf16(P_{n-1})
// V_{n-1} (P from registers, V MN-major) with, for K11, l += bf16(P_{n-1})
// times a 16 x 8 tile of ones (m64n8k16: every column of that accumulator
// is the row sum). After the S product's wait each int32 of the accumulator
// becomes its fp32 logit in place: exactly (|s_i| <= 127 * 127 * 128 <
// 2^24), then times the row's qs (two registers a thread for the q tile)
// and the key's ks (read from the scale ring). No wgmma of a batch sits
// under a branch, and every register a batch reads or writes is defined
// before its fence and read only after its wait (else ptxas serialises
// every wgmma of the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kN = 128;          // keys a tile
constexpr int kVRowBytes = 128;  // one row of a 64-column bf16 V box
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr int kSchedBar = 1;   // named barriers 1..: the consumers' turns
constexpr int kKsSlots = 4;    // the ring of key scales, 128 fp32 a slot
constexpr uint32_t kOnesBf16x2 = 0x3f803f80u;  // (1.0, 1.0) in bf16
constexpr int kOnesBytes = 512;

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

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t u32(float x) { return __float_as_uint(x); }

// The fp32 logit of an int32 product: exact, then times qs, then times ks,
// each product rounded (no fused multiply-add).
__device__ __forceinline__ uint32_t logit(uint32_t s_i, float qs, float ks) {
  return u32(__fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(s_i)), qs),
                       ks));
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// The register A operand of k-step kk from an accumulator of 8-column
// blocks (fp32 bit patterns): columns 16 kk .. 16 kk + 15 are blocks 2 kk
// and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const uint32_t (&d)[64], int kk) {
  a[0] = pack_bf16x2(f32(d[8 * kk + 0]), f32(d[8 * kk + 1]));
  a[1] = pack_bf16x2(f32(d[8 * kk + 2]), f32(d[8 * kk + 3]));
  a[2] = pack_bf16x2(f32(d[8 * kk + 4]), f32(d[8 * kk + 5]));
  a[3] = pack_bf16x2(f32(d[8 * kk + 6]), f32(d[8 * kk + 7]));
}

// Consumer warpgroups a block: 2 at head_dim 128 (the S and O accumulators
// take 240 registers a thread), 3 at 64 (more of each tile is softmax).
template <int D>
constexpr int consumer_wgs() {
  return D == 64 ? 3 : 2;
}

// Stages of the K/V ring: the tiles of 128 keys are 48 KB at head_dim 128
// (three fit beside the Q buffers), 24 KB at 64.
template <int D>
constexpr int kv_stages() {
  return D == 64 ? 4 : 3;
}

// Shared memory of a block: two int8 Q buffers of 64 * kCWG rows, the K and
// V rings, the ring of key scales, the ones tile, then the mbarriers.
// Every tile starts on a 1024-byte boundary (the swizzle phase of a row is
// then a function of the row alone).
template <int D, int kCWG, int kStages>
struct Layout {
  static constexpr int kQRows = 64 * kCWG;
  static constexpr int kQTile = kQRows * D;      // int8, one swizzle atom a row
  static constexpr int kKTile = kN * D;          // int8
  static constexpr int kVBlock = kN * kVRowBytes;  // one 64-column bf16 block
  static constexpr int kVTile = kVBlock * (D / 64);
  static constexpr int kQ = 0;                           // 2 buffers
  static constexpr int kK = 2 * kQTile;                  // kStages
  static constexpr int kV = kK + kStages * kKTile;       // kStages
  static constexpr int kKs = kV + kStages * kVTile;      // kKsSlots x kN fp32
  static constexpr int kOnes = kKs + kKsSlots * kN * 4;  // bf16 ones
  static constexpr int kBars = kOnes + kOnesBytes;  // q_full[2], q_empty[2],
                                                    // kStages each of k_full,
                                                    // v_full, k_empty,
                                                    // v_empty, kKsSlots each
                                                    // of ks_full, ks_empty
  static constexpr int kBytes =
      kBars + (4 + 4 * kStages + 2 * kKsSlots) * 8 + 1024;
};

// Descriptor of an int8 K-major operand at `addr`: rows of D bytes, one
// swizzle atom each, 8-row groups 8 D bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  if constexpr (D == 128) {
    return desc_sw128(addr, 16, 8 * D);
  } else {
    return desc_sw64(addr, 16, 8 * D);
  }
}

// S = Q K^T over one key tile: 64 rows x 128 keys, depth D bytes, both
// operands K-major (the k-th 32-deep slice 32 k bytes in).
template <int D>
__device__ __forceinline__ void issue_s(uint32_t (&s)[64], uint64_t q,
                                        uint64_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    mma_ss_s8<128>(s, desc_add(q, 32 * kk), desc_add(k, 32 * kk), kk > 0);
}

// O += bf16(P) V over one key tile, V MN-major in shared memory; for K11
// also l += bf16(P) ones (every column of the 64 x 8 l tile is the row sum).
template <int D, bool kStatic>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], float (&l)[4],
                                         const uint32_t (&pa)[8][4],
                                         uint64_t v, uint64_t ones) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma_rs<D, 1>(acc, pa[kk], desc_add(v, kk * 2048), 1);
    if constexpr (kStatic) mma_rs<8, 0>(l, pa[kk], ones, 1);
  }
}

// The softmax of one S tile (64 rows x 128 keys from n0) in place: the
// int32 products become fp32 logits and then p. K11: p = exp2(s - bound);
// K12: the running max m, this thread's partial row sums l and the factor
// alpha by which the accumulator is to be rescaled.
template <bool kStatic>
__device__ __forceinline__ void softmax_tile(uint32_t (&sc)[64],
                                             uint32_t ks, float qs_lo,
                                             float qs_hi, float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& al_lo,
                                             float& al_hi, float bound,
                                             int n0, int skv, int t) {
  // K11's p or K12's logits of every key; then, on a ragged tile, keys at
  // or past Skv masked: p = 0, or -inf before K12's max
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // (in groups of four blocks: loads hoisted further take registers)
    if (j % 4 == 0 && j > 0) asm volatile("" ::: "memory");
    const float2 k2 = ld_shared_f2(ks + 4 * (8 * j + 2 * t));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = e < 2 ? qs_lo : qs_hi, k = e & 1 ? k2.y : k2.x;
      if (kStatic) {
        // (x qs) ks - bound with the second product fused into the
        // subtraction: one instruction a logit less than logit() - bound
        const float xq =
            __fmul_rn(__int2float_rn(static_cast<int>(sc[4 * j + e])), q);
        sc[4 * j + e] = u32(ex2(fmaf(xq, k, -bound)));
      } else {
        sc[4 * j + e] = logit(sc[4 * j + e], q, k);
      }
    }
  }
  if (n0 + kN > skv) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + j * 8 + t * 2 + (e & 1) >= skv)
          sc[4 * j + e] = u32(kStatic ? 0.0f : kNegInf);
      }
    }
  }
  if (!kStatic) {
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(f32(sc[4 * j]), f32(sc[4 * j + 1])));
      mx_hi = fmaxf(mx_hi, fmaxf(f32(sc[4 * j + 2]), f32(sc[4 * j + 3])));
    }
    // the four threads of a group hold one row between them
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    al_lo = ex2(m_lo - mn_lo);
    al_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(f32(sc[4 * j + 0]) - mn_lo);
      const float p1 = ex2(f32(sc[4 * j + 1]) - mn_lo);
      const float p2 = ex2(f32(sc[4 * j + 2]) - mn_hi);
      const float p3 = ex2(f32(sc[4 * j + 3]) - mn_hi);
      sc[4 * j + 0] = u32(p0);
      sc[4 * j + 1] = u32(p1);
      sc[4 * j + 2] = u32(p2);
      sc[4 * j + 3] = u32(p3);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
    }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
  }
}

// K12's rescale of the accumulator by alpha, then bf16(P) packed as the
// register A operand of P V.
template <int D, bool kStatic>
__device__ __forceinline__ void rescale_pack(float (&acc)[D / 2],
                                             uint32_t (&pa)[8][4],
                                             const uint32_t (&sc)[64],
                                             float al_lo, float al_hi) {
  if (!kStatic) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= al_lo;
      acc[4 * j + 1] *= al_lo;
      acc[4 * j + 2] *= al_hi;
      acc[4 * j + 3] *= al_hi;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
}

template <int D, bool kStatic, int kCWG, int kStages>
__global__ void __launch_bounds__((kCWG + 1) * kWG, 1)
    flash_int_qk_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o,
                        const float* __restrict__ qs,
                        const float* __restrict__ ks,
                        const float* __restrict__ bound_ptr, int bh, int sq,
                        int skv) {
  using L = Layout<D, kCWG, kStages>;
  constexpr int kCB = D / 64;      // 64-column blocks of a V tile
  constexpr int kOTiles = D / 8;   // 8-column blocks of O
  // registers a thread of the producer warpgroup keeps (24 beside two
  // consumers of 240; 32 beside three, which then still get 160), and a
  // consumer's: what the block was launched with (65536 / threads, rounded
  // down to a multiple of 8, for every thread) less the producer's, shared
  // by the consumers in multiples of 8, at most 240. setmaxnreg.inc waits
  // for registers the block does not have, so this must not round up.
  constexpr int kProducerRegs = kCWG == 2 ? 24 : 32;
  constexpr int kThreads = (kCWG + 1) * kWG;
  constexpr int kPool = 65536 / kThreads / 8 * 8 * kThreads;
  constexpr int kShare = (kPool - kProducerRegs * kWG) / (kCWG * kWG) / 8 * 8;
  constexpr int kRegs = kShare > 240 ? 240 : kShare;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  uint64_t* ks_full = v_empty + kStages;
  uint64_t* ks_empty = ks_full + kKsSlots;

  const int n_q = (sq + L::kQRows - 1) / L::kQRows;
  const int n_kv = (skv + kN - 1) / kN;
  const int n_tiles = bh * n_q;
  // (warp-uniform for the compiler: the descriptors below then stay in
  // uniform registers)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kCWG * kWG);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kCWG * kWG);
      mbar_init(v_empty + s, kCWG * kWG);
    }
    for (int s = 0; s < kKsSlots; ++s) {
      mbar_init(ks_full + s, 32);
      mbar_init(ks_empty + s, kCWG * kWG);
    }
    fence_mbar_init();
  }
  if (kStatic && threadIdx.x < kOnesBytes / 4) {
    // the B operand of the ones column, read by wgmma (the async proxy)
    reinterpret_cast<uint32_t*>(smem + L::kOnes)[threadIdx.x] = kOnesBf16x2;
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 1) {
      // warp 1: the key scales of each key tile (thread i copies keys i,
      // i + 32, i + 64, i + 96 of the tile; 0 past Skv) into slot it %
      // kKsSlots once the softmax that read the slot's last tile is done
      const int lane = threadIdx.x % 32;
      const uint32_t ks0 = smem_u32(smem + L::kKs) + 4 * lane;
      const uint32_t empty0 = smem_u32(ks_empty), full0 = smem_u32(ks_full);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const float* src = ks + (size_t)(tile / n_q) * skv + lane;
        for (int n0 = 0; n0 < skv; n0 += kN, ++it) {
          const int s = it % kKsSlots;
          if (it >= kKsSlots)
            mbar_wait_u32(empty0 + 8 * s, ((it / kKsSlots) - 1) & 1);
          float x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = n0 + lane + 32 * j < skv ? src[n0 + 32 * j] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                             ks0 + 4 * (s * kN + 32 * j)),
                         "f"(x[j])
                         : "memory");
          mbar_arrive_u32(full0 + 8 * s);
        }
      }
    }
    if (threadIdx.x == 0) {
      // the Q of the block's local-th tile, into buffer local % 2 once
      // the consumers are done with its previous tile's products
      auto load_q = [&](int local, int tile) {
        const int buf = local & 1;
        if (local >= 2) mbar_wait(q_empty + buf, ((local >> 1) - 1) & 1);
        mbar_expect_tx(q_full + buf, L::kQTile);
        tma_load_3d(smem + L::kQ + buf * L::kQTile, &tm_q, q_full + buf, 0,
                    (tile % n_q) * L::kQRows, tile / n_q);
      };
      int local = 0, it = 0;
      if (blockIdx.x < n_tiles) load_q(0, blockIdx.x);
      for (int tile = blockIdx.x; tile < n_tiles;
           tile += gridDim.x, ++local) {
        const int b = tile / n_q;
        for (int n = 0; n < n_kv; ++n, ++it) {
          const int s = it % kStages;
          const uint32_t ph = ((it / kStages) - 1) & 1;
          if (it >= kStages) mbar_wait(k_empty + s, ph);
          mbar_expect_tx(k_full + s, L::kKTile);
          tma_load_3d(smem + L::kK + s * L::kKTile, &tm_k, k_full + s, 0,
                      n * kN, b);
          if (it >= kStages) mbar_wait(v_empty + s, ph);
          mbar_expect_tx(v_full + s, L::kVTile);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load_3d(smem + L::kV + s * L::kVTile + cb * L::kVBlock,
                        &tm_v, v_full + s, 64 * cb, n * kN, b);
          if (n == 0 && tile + (int)gridDim.x < n_tiles)
            load_q(local + 1, tile + gridDim.x);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    setmaxnreg_inc<kRegs>();
    const int w = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    // descriptors of this consumer's Q rows of buffer 0, stage 0 of the K
    // and V rings and the ones tile; the others are byte offsets from them
    const uint64_t q_desc =
        desc_kmajor<D>(smem_u32(smem + L::kQ + 64 * w * D));
    const uint64_t k_desc = desc_kmajor<D>(smem_u32(smem + L::kK));
    const uint64_t v_desc =
        desc_sw128(smem_u32(smem + L::kV), L::kVBlock, 1024);
    const uint64_t ones = desc_plain(smem_u32(smem + L::kOnes), 128, 128);
    const uint32_t ks_s = smem_u32(smem + L::kKs);
    const float bound = kStatic ? *bound_ptr : 0.0f;  // read once a block
    // the ring of turns starts with consumer 0
    if (w == kCWG - 1) named_bar_arrive(kSchedBar, 2 * kWG);

    int local = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int b = tile / n_q;
      const int m0 = (tile % n_q) * L::kQRows;
      const int buf = local & 1;
      const uint64_t q = desc_add(q_desc, buf * L::kQTile);
      const int row_lo = m0 + 64 * w + 16 * warp + g, row_hi = row_lo + 8;
      // this thread's two row scales (0 past Sq: those rows are not stored)
      const float* qs_b = qs + (size_t)b * sq;
      const float qs_lo = row_lo < sq ? qs_b[row_lo] : 0.0f;
      const float qs_hi = row_hi < sq ? qs_b[row_hi] : 0.0f;
      mbar_wait(q_full + buf, (local >> 1) & 1);

      float m_lo = kNegInf, m_hi = kNegInf;  // running max (K12)
      float l_lo = 0.0f, l_hi = 0.0f;        // per-thread partial row sums
      float al_lo = 1.0f, al_hi = 1.0f;      // K12's rescale of acc
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float lt[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // K11's ones-column l tile
      uint32_t sc[64];  // S: int32 products, then fp32 logits and p in place
      uint32_t pa[8][4];
      // key tile j of this q tile sits in ring stage (it + j) % kStages
      auto stage = [&](int j) { return (it + j) % kStages; };
      auto phase = [&](int j) { return ((it + j) / kStages) & 1; };
      auto k_tile = [&](int j) {
        mbar_wait(k_full + stage(j), phase(j));
        return desc_add(k_desc, stage(j) * L::kKTile);
      };
      auto v_tile = [&](int j) {
        mbar_wait(v_full + stage(j), phase(j));
        return desc_add(v_desc, stage(j) * L::kVTile);
      };
      // a stage of the K (V and scales) ring is free once the products
      // (and softmax) reading it have completed
      auto k_done = [&](int j) { mbar_arrive(k_empty + stage(j)); };
      auto v_done = [&](int j) { mbar_arrive(v_empty + stage(j)); };
      auto fence_all = [&] {
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        if constexpr (kStatic) fence_regs(lt);
      };
      // A batch of products: every register it reads or writes is defined
      // before the fence and read only after the wait (else ptxas
      // serialises the wgmmas); the consumers take turns.
      auto begin = [&] {
        named_bar_sync(kSchedBar + w, 2 * kWG);
        fence_all();
        wgmma_fence();
      };
      auto end = [&] {
        wgmma_commit();
        named_bar_arrive(kSchedBar + (w + 1) % kCWG, 2 * kWG);
        wgmma_wait<0>();
        fence_all();
      };
      // the key scales of tile j sit in slot (it + j) % kKsSlots, free
      // again once this softmax has read them
      auto softmax = [&](int n) {
        const int slot = (it + n) % kKsSlots;
        mbar_wait(ks_full + slot, ((it + n) / kKsSlots) & 1);
        softmax_tile<kStatic>(sc, ks_s + slot * kN * 4, qs_lo, qs_hi, m_lo,
                              m_hi, l_lo, l_hi, al_lo, al_hi, bound, n * kN,
                              skv, t);
        mbar_arrive(ks_empty + slot);
      };

      // S_0 and its softmax; then, for each later key tile n, one batch of
      // S_n = Q K_n^T and O += bf16(P_{n-1}) V_{n-1} (and K11's l) and the
      // softmax of tile n; then the last tile's P V. The softmax of tile n
      // runs while P_{n-1} V_{n-1} is still in the tensor cores (the P V
      // products are their own commit group).
      uint64_t kt = k_tile(0);
      begin();
      issue_s<D>(sc, q, kt);
      end();
      k_done(0);
      if (n_kv == 1) mbar_arrive(q_empty + buf);  // Q is read
      softmax(0);
      rescale_pack<D, kStatic>(acc, pa, sc, al_lo, al_hi);
      for (int n = 1; n < n_kv; ++n) {
        const uint64_t vt = v_tile(n - 1);
        kt = k_tile(n);
        begin();
        issue_s<D>(sc, q, kt);
        wgmma_commit();
        issue_pv<D, kStatic>(acc, lt, pa, vt, ones);
        wgmma_commit();
        named_bar_arrive(kSchedBar + (w + 1) % kCWG, 2 * kWG);
        wgmma_wait<1>();
        fence_regs(sc);
        k_done(n);
        if (n == n_kv - 1) mbar_arrive(q_empty + buf);
        softmax(n);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        if constexpr (kStatic) fence_regs(lt);
        v_done(n - 1);
        rescale_pack<D, kStatic>(acc, pa, sc, al_lo, al_hi);
      }
      const uint64_t vt = v_tile(n_kv - 1);
      begin();
      issue_pv<D, kStatic>(acc, lt, pa, vt, ones);
      end();
      v_done(n_kv - 1);
      it += n_kv;

      if constexpr (kStatic) {
        // every column of the l tile holds its row's sum of bf16(p)
        l_lo = lt[0];
        l_hi = lt[2];
      } else {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      }
      const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
      __nv_bfloat16* o_bh = o + (size_t)b * sq * D;
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
    }
  }
}

// Once per instantiation (the process's current device): the opt-in to
// the dynamic shared memory and the blocks an SM then holds.
struct LaunchInfo {
  int err;
  int blocks_per_sm;
};

template <typename Kernel>
LaunchInfo launch_info(Kernel kernel, int threads, int smem_bytes) {
  LaunchInfo info{static_cast<int>(cudaFuncSetAttribute(
                      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                      smem_bytes)),
                  0};
  if (info.err == 0) {
    info.err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info.blocks_per_sm, kernel, threads, smem_bytes));
  }
  if (info.err == 0 && info.blocks_per_sm < 1)
    info.err = static_cast<int>(cudaErrorInvalidConfiguration);
  return info;
}

template <int D, bool kStatic>
int launch(const void* q, const float* qs, const void* k, const float* ks,
           const void* v, void* o, const float* bound, int bh, int sq,
           int skv, cudaStream_t stream) {
  constexpr int kCWG = consumer_wgs<D>();
  constexpr int kStages = kv_stages<D>();
  using L = Layout<D, kCWG, kStages>;
  const auto kernel = flash_int_qk_kernel<D, kStatic, kCWG, kStages>;
  constexpr int kThreads = (kCWG + 1) * kWG;
  static const LaunchInfo info = launch_info(kernel, kThreads, L::kBytes);
  if (info.err) return info.err;
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  CUtensorMap tq, tk, tv;
  // int8 rows of D bytes: one swizzle atom of D bytes
  err = encode_rows_map(&tq, q, 1, bh, sq, D, L::kQRows, D);
  if (!err) err = encode_rows_map(&tk, k, 1, bh, skv, D, kN, D);
  if (!err) err = encode_rows_map(&tv, v, 2, bh, skv, D, kN);
  if (err) return err;
  const long long tiles =
      static_cast<long long>(bh) * ((sq + L::kQRows - 1) / L::kQRows);
  const long long slots =
      static_cast<long long>(sms) * info.blocks_per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), qs, ks, bound, bh, sq, skv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [bh, sq, D], k [bh, skv, D]: contiguous int8 codes; qs [bh, sq], ks
// [bh, skv]: fp32 row scales (softmax scale * log2e folded into qs); v
// [bh, skv, D], o [bh, sq, D]: contiguous bf16. static_ones != 0: K11,
// exp2(s - *bound) with the ones column; else K12, online softmax with a
// lane sum. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported head_dim; a negative value if
// a TMA map cannot be encoded).
extern "C" int flash_variant_int8(const void* q, const float* qs,
                                  const void* k, const float* ks,
                                  const void* v, void* o, const float* bound,
                                  int bh, int sq, int skv, int head_dim,
                                  int static_ones, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    return static_ones
               ? launch<128, true>(q, qs, k, ks, v, o, bound, bh, sq, skv, s)
               : launch<128, false>(q, qs, k, ks, v, o, bound, bh, sq, skv, s);
  }
  if (head_dim == 64) {
    return static_ones
               ? launch<64, true>(q, qs, k, ks, v, o, bound, bh, sq, skv, s)
               : launch<64, false>(q, qs, k, ks, v, o, bound, bh, sq, skv, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape at a head_dim (64 or 128): what = 0 gives the dynamic
// shared memory (bytes), 1 the consumer warpgroups, 2 the q rows a tile, 3
// the stages of the K/V ring, 4 the swizzle of the int8 tiles (bytes); -1
// for anything else.
extern "C" int flash_int8_config(int head_dim, int what) {
  if (head_dim != 64 && head_dim != 128) return -1;
  const int cwg = head_dim == 64 ? consumer_wgs<64>() : consumer_wgs<128>();
  const int stages = head_dim == 64 ? kv_stages<64>() : kv_stages<128>();
  const int smem =
      head_dim == 64
          ? Layout<64, consumer_wgs<64>(), kv_stages<64>()>::kBytes
          : Layout<128, consumer_wgs<128>(), kv_stages<128>()>::kBytes;
  switch (what) {
    case 0: return smem;
    case 1: return cwg;
    case 2: return 64 * cwg;
    case 3: return stages;
    case 4: return head_dim;
    default: return -1;
  }
}
