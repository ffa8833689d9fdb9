// K9 and K10: the bf16-logit flash-attention forwards of the attention
// experiments on Hopper (sm_90a). bf16 q/k/v and output, fp32 softmax
// statistics and accumulation, non-causal, no backward.
//
// Replaces three Pallas TPU kernels of scripts/bench_flash_variants.py (the
// int8-logit ones, _kernel_v3 and _kernel_v123, are csrc/flash_int8.cu):
//   _kernel_v1   online softmax, row sum l by a ones column  <online, ones>
//   _kernel_v2   p = exp2(s - bound), l by a lane sum        <static, lanes>
//   _kernel_v12  p = exp2(s - bound), l by a ones column     <static, ones>
// over q pre-scaled as the wrapper _prep does: q becomes bf16(float(q) *
// q_scale), q_scale = bf16(softmax scale * log2 e), in the kernel.
//
// The switches, as the TPU kernels define them:
//   ones column   The TPU appends a column of ones to V, so that the P V
//                 product also yields sum_j bf16(p_ij). Here nothing is
//                 materialised: each P V k-step also multiplies bf16(P) by
//                 a 16 x 8 tile of ones (wgmma m64n8k16, every column of
//                 that accumulator is the row sum), so l sums the bf16-
//                 ROUNDED p in fp32 on the tensor cores; in the online body
//                 it is rescaled by alpha together with O (JAX's acc[:, D]).
//                 The lane-sum body sums the fp32 p.
//   static bound  p = exp2(s - bound) with bound >= every logit, read once
//                 from device memory: no running max, no rescale, and NO
//                 floor under the exponent (K1 in flash_fwd.cu has one; the
//                 script's kernels do not): a logit far under the bound
//                 underflows to 0, as in the plain version.
// Both: O = bf16(P) V accumulated in fp32, o = O / l. Keys at or past Skv
// give p = 0 exactly: their zero-filled K rows give a logit of 0, and
// exp2(0 - bound) is not 0, so their s becomes -1e30 before the exp2 (the
// TPU's mask), on the last key tile only.
//
// What bounds it on the H100: at [48, 5590, 128] the two products (0.768
// TFLOP: 0.776 ms at 989 TFLOP/s) above the exp2s (one a logit, 16 a clock
// per SM: 0.388 ms); at [96, 15906, 64] both at ~6.29 ms. In practice the
// softmax's instruction stream (scripts/tune_flash_int8.py's probes on the
// same design): so the softmax of one warpgroup runs under another's
// products, and a logit costs as few instructions as it can: the ragged
// mask is applied on the last key tile only and the wgmma descriptors are
// built once and moved by byte offsets.
//
// Design: csrc/flash_int8.cu's (K11/K12) with a bf16 S product, on
// csrc/sm90_common.cuh. A block is persistent (one an SM over the
// (batch*head, q tile) tiles) and warp-specialised. Warpgroup 0 is the
// producer: its thread 0 issues every TMA load (Q tiles into two buffers,
// the next tile's Q as soon as the consumers are done with that buffer;
// 128-key K and V tiles into a ring of kStages stages, a K (V) stage
// refilled as soon as the products reading it have completed), and its
// warps 1-3 rescale each landed Q tile in shared memory in place (a bf16 x
// bf16 product rounds once), fence the async proxy and release it to the
// consumers through a second barrier. The
// consumer warpgroups (2 at head_dim 128, whose S and O accumulators take
// 240 registers a thread; 3 at 64; 64 q rows each) take turns over named
// barriers to issue one batch a key tile: S_n = Q K_n^T (wgmma m64n128k16,
// both operands K-major in shared memory, 128-byte swizzle) and O +=
// bf16(P_{n-1}) V_{n-1} (P from registers, V MN-major by the transpose bit)
// with the ones column's l; the softmax of tile n runs while P_{n-1}
// V_{n-1} is still in the tensor cores. The TMA maps are 3-D over
// [batch*head, S, D], so a ragged tile reads zeros and never the next
// head's rows; rows at or past Sq are not stored. No wgmma of a batch sits
// under a branch, and every register a batch reads or writes is defined
// before its fence and read only after its wait (else ptxas serialises
// every wgmma of the kernel).

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
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr int kSchedBar = 1;   // named barriers 1..: the consumers' turns
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

// The register A operand of k-step kk from an accumulator of 8-column
// blocks: columns 16 kk .. 16 kk + 15 are blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[64],
                                       int kk) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// Consumer warpgroups a block: 2 at head_dim 128 (the S and O accumulators
// take 240 registers a thread), 3 at 64 (more of each tile is softmax).
template <int D>
constexpr int consumer_wgs() {
  return D == 64 ? 3 : 2;
}

// Stages of the K/V ring: a K and a V tile of 128 keys take 64 KB at
// head_dim 128 (two stages fit beside the Q buffers, three do not), 32 KB
// at 64.
template <int D>
constexpr int kv_stages() {
  return D == 64 ? 4 : 2;
}

// Shared memory of a block: two Q buffers of 64 * kCWG rows, the K and V
// rings, the ones tile, then the mbarriers. A tile of D columns is D / 64
// column blocks of 128-byte rows one after the other; every tile starts on
// a 1024-byte boundary (the swizzle phase of a row is then row % 8).
template <int D, int kCWG, int kStages>
struct Layout {
  static constexpr int kQRows = 64 * kCWG;
  static constexpr int kQBlock = kQRows * kRowBytes;  // one column block
  static constexpr int kQTile = kQBlock * (D / 64);
  static constexpr int kKVBlock = kN * kRowBytes;
  static constexpr int kKVTile = kKVBlock * (D / 64);
  static constexpr int kQ = 0;                          // 2 buffers
  static constexpr int kK = 2 * kQTile;                 // kStages
  static constexpr int kV = kK + kStages * kKVTile;     // kStages
  static constexpr int kOnes = kV + kStages * kKVTile;  // bf16 ones
  static constexpr int kBars = kOnes + kOnesBytes;  // q_full[2], q_empty[2],
                                                    // q_ready[2], kStages
                                                    // each of k_full,
                                                    // v_full, k_empty,
                                                    // v_empty
  static constexpr int kBytes = kBars + (6 + 4 * kStages) * 8 + 1024;
};

// S = Q K^T over one key tile: 64 rows x 128 keys, depth D, both operands
// K-major (the k-th 16-deep slice 32 (k % 4) bytes into column block k / 4).
template <int D, int kQBlock, int kKVBlock>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint64_t q,
                                        uint64_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<128, 0, 0>(sc, desc_add(q, (kk >> 2) * kQBlock + (kk & 3) * 32),
                      desc_add(k, (kk >> 2) * kKVBlock + (kk & 3) * 32),
                      kk > 0);
}

// O += bf16(P) V over one key tile, V MN-major in shared memory; with the
// ones column also l += bf16(P) ones.
template <int D, bool kOnes>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], float (&l)[4],
                                         const uint32_t (&pa)[8][4],
                                         uint64_t v, uint64_t ones) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma_rs<D, 1>(acc, pa[kk], desc_add(v, kk * 2048), 1);
    if constexpr (kOnes) mma_rs<8, 0>(l, pa[kk], ones, 1);
  }
}

// The softmax of one S tile (64 rows x 128 keys from n0) in place. Keys at
// or past Skv first get s = -1e30, on the last key tile only (the TPU's
// mask: their exp2 is then exactly 0). Static bodies: p = exp2(s - bound),
// and with lane sums this thread's partial row sums l; the online body:
// the running max m and the factor alpha by which the accumulators are to
// be rescaled.
template <bool kStatic, bool kOnes>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& al_lo,
                                             float& al_hi, float bound,
                                             int n0, int skv, int t) {
  if (n0 + kN > skv) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + j * 8 + t * 2 + (e & 1) >= skv) sc[4 * j + e] = kNegInf;
      }
    }
  }
  if constexpr (kStatic) {
    float a_lo = 0.0f, a_hi = 0.0f, b_lo = 0.0f, b_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] = ex2(sc[4 * j + e] - bound);
      if constexpr (!kOnes) {
        if (j & 1) {
          b_lo += sc[4 * j] + sc[4 * j + 1];
          b_hi += sc[4 * j + 2] + sc[4 * j + 3];
        } else {
          a_lo += sc[4 * j] + sc[4 * j + 1];
          a_hi += sc[4 * j + 2] + sc[4 * j + 3];
        }
      }
    }
    if constexpr (!kOnes) {
      l_lo += a_lo + b_lo;
      l_hi += a_hi + b_hi;
    }
  } else {
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
    al_lo = ex2(m_lo - mn_lo);
    al_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j + 0] = ex2(sc[4 * j + 0] - mn_lo);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn_lo);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn_hi);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn_hi);
    }
  }
}

// The online body's rescale of O and of the ones column's l by alpha, then
// bf16(P) packed as the register A operand of P V.
template <int D, bool kStatic>
__device__ __forceinline__ void rescale_pack(float (&acc)[D / 2],
                                             float (&lt)[4],
                                             uint32_t (&pa)[8][4],
                                             const float (&sc)[64],
                                             float al_lo, float al_hi) {
  if constexpr (!kStatic) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= al_lo;
      acc[4 * j + 1] *= al_lo;
      acc[4 * j + 2] *= al_hi;
      acc[4 * j + 3] *= al_hi;
    }
    lt[0] *= al_lo;
    lt[1] *= al_lo;
    lt[2] *= al_hi;
    lt[3] *= al_hi;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
}

template <int D, bool kStatic, bool kOnes, int kCWG, int kStages>
__global__ void __launch_bounds__((kCWG + 1) * kWG, 1)
    flash_variant_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o,
                      const float* __restrict__ bound_ptr, int bh, int sq,
                      int skv, uint32_t q_scale2) {
  // the three bodies of the TPU script; an online body sums l by the ones
  // column
  static_assert(kStatic || kOnes, "online softmax with lane sums: K3");
  using L = Layout<D, kCWG, kStages>;
  constexpr int kCB = D / 64;      // column blocks of a tile
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
  uint64_t* q_ready = bars + 4;  // the rescaled Q
  uint64_t* k_full = bars + 6;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

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
  if (kOnes && threadIdx.x < kOnesBytes / 4) {
    // the B operand of the ones column, read by wgmma (the async proxy)
    reinterpret_cast<uint32_t*>(smem + L::kOnes)[threadIdx.x] = kOnesBf16x2;
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) {
      // warps 1-3 rescale each landed Q tile in place, off the consumers'
      // path (16 bytes a thread at a time, shared-window addresses, the
      // scale read from the kernel's parameters: the warpgroup has 24 or 32
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
        for (int cb = 0; cb < kCB; ++cb)
          tma_load_3d(smem + L::kQ + buf * L::kQTile + cb * L::kQBlock, &tm_q,
                      q_full + buf, 64 * cb, (tile % n_q) * L::kQRows,
                      tile / n_q);
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
          mbar_expect_tx(k_full + s, L::kKVTile);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load_3d(smem + L::kK + s * L::kKVTile + cb * L::kKVBlock,
                        &tm_k, k_full + s, 64 * cb, n * kN, b);
          if (it >= kStages) mbar_wait(v_empty + s, ph);
          mbar_expect_tx(v_full + s, L::kKVTile);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load_3d(smem + L::kV + s * L::kKVTile + cb * L::kKVBlock,
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
        desc_sw128(smem_u32(smem + L::kQ + 64 * w * kRowBytes), 16, 1024);
    const uint64_t k_desc = desc_sw128(smem_u32(smem + L::kK), 16, 1024);
    const uint64_t v_desc =
        desc_sw128(smem_u32(smem + L::kV), L::kKVBlock, 1024);
    const uint64_t ones = desc_plain(smem_u32(smem + L::kOnes), 128, 128);
    const float bound = kStatic ? *bound_ptr : 0.0f;  // read once a block
    // the ring of turns starts with consumer 0
    if (w == kCWG - 1) named_bar_arrive(kSchedBar, 2 * kWG);

    int local = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int b = tile / n_q;
      const int m0 = (tile % n_q) * L::kQRows;
      const int buf = local & 1;
      const uint64_t q = desc_add(q_desc, buf * L::kQTile);
      mbar_wait(q_ready + buf, (local >> 1) & 1);

      float m_lo = kNegInf, m_hi = kNegInf;  // running max (online body)
      float l_lo = 0.0f, l_hi = 0.0f;        // lane sums: partial row sums
      float al_lo = 1.0f, al_hi = 1.0f;      // the online body's alpha
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float lt[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the ones column's l tile
      float sc[64];  // S, then p in place
      uint32_t pa[8][4];
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
      auto fence_all = [&] {
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        if constexpr (kOnes) fence_regs(lt);
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
      auto softmax = [&](int n) {
        softmax_tile<kStatic, kOnes>(sc, m_lo, m_hi, l_lo, l_hi, al_lo,
                                     al_hi, bound, n * kN, skv, t);
      };

      // S_0 and its softmax; then, for each later key tile n, one batch of
      // S_n = Q K_n^T and O += bf16(P_{n-1}) V_{n-1} (and the ones
      // column's l) and the softmax of tile n; then the last tile's P V.
      // The softmax of tile n runs while P_{n-1} V_{n-1} is still in the
      // tensor cores (the P V products are their own commit group).
      uint64_t kt = k_tile(0);
      begin();
      issue_s<D, L::kQBlock, L::kKVBlock>(sc, q, kt);
      end();
      k_done(0);
      if (n_kv == 1) mbar_arrive(q_empty + buf);  // Q is read
      softmax(0);
      rescale_pack<D, kStatic>(acc, lt, pa, sc, al_lo, al_hi);
      for (int n = 1; n < n_kv; ++n) {
        const uint64_t vt = v_tile(n - 1);
        kt = k_tile(n);
        begin();
        issue_s<D, L::kQBlock, L::kKVBlock>(sc, q, kt);
        wgmma_commit();
        issue_pv<D, kOnes>(acc, lt, pa, vt, ones);
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
        if constexpr (kOnes) fence_regs(lt);
        v_done(n - 1);
        rescale_pack<D, kStatic>(acc, lt, pa, sc, al_lo, al_hi);
      }
      const uint64_t vt = v_tile(n_kv - 1);
      begin();
      issue_pv<D, kOnes>(acc, lt, pa, vt, ones);
      end();
      v_done(n_kv - 1);
      it += n_kv;

      if constexpr (kOnes) {
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
      const int row_lo = m0 + 64 * w + 16 * warp + g, row_hi = row_lo + 8;
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

// The bf16 pair (x, x), x rounded to nearest even (x finite).
uint32_t bf16x2_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  u = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return u | (u << 16);
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

template <int D, bool kStatic, bool kOnes>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* bound, int bh, int sq, int skv, float q_scale,
           cudaStream_t stream) {
  constexpr int kCWG = consumer_wgs<D>();
  constexpr int kStages = kv_stages<D>();
  using L = Layout<D, kCWG, kStages>;
  const auto kernel = flash_variant_kernel<D, kStatic, kOnes, kCWG, kStages>;
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
  err = encode_rows_map(&tq, q, 2, bh, sq, D, L::kQRows);
  if (!err) err = encode_rows_map(&tk, k, 2, bh, skv, D, kN);
  if (!err) err = encode_rows_map(&tv, v, 2, bh, skv, D, kN);
  if (err) return err;
  const long long tiles =
      static_cast<long long>(bh) * ((sq + L::kQRows - 1) / L::kQRows);
  const long long slots =
      static_cast<long long>(sms) * info.blocks_per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), bound, bh, sq, skv,
      bf16x2_bits(q_scale));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const float* bound, int bh, int sq, int skv, int body,
                float q_scale, cudaStream_t s) {
  switch (body) {
    case 1: return launch<D, false, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
    case 2: return launch<D, true, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
    case 12: return launch<D, true, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [bh, sq, D], k/v [bh, skv, D], o [bh, sq, D]: contiguous bf16; q is
// scaled in the kernel by q_scale (rounded to bf16). body: 1 = online
// softmax + ones column (v1), 2 = static bound + lane sum (v2), 12 = static
// bound + ones column (v12); bound (bodies 2, 12): one fp32 on the device.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported head_dim or body; a negative value if a TMA map cannot
// be encoded).
extern "C" int flash_variant_bf16(const void* q, const void* k, const void* v,
                                  void* o, const float* bound, int bh, int sq,
                                  int skv, int head_dim, int body,
                                  float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_bf16<128>(q, k, v, o, bound, bh, sq, skv, body, q_scale, s);
  if (head_dim == 64) return launch_bf16<64>(q, k, v, o, bound, bh, sq, skv, body, q_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape at a head_dim (64 or 128): what = 0 gives the dynamic
// shared memory (bytes), 1 the consumer warpgroups, 2 the q rows a tile, 3
// the stages of the K/V ring; -1 for anything else.
extern "C" int flash_variants_config(int head_dim, int what) {
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
    default: return -1;
  }
}
