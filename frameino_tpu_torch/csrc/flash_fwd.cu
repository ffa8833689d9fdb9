// K1 and K3: non-causal flash-attention forward for serving on Hopper
// (sm_90a), bf16 in/out, fp32 softmax statistics and accumulation.
//
// Replaces two Pallas TPU kernels of frameino_tpu/ops/attention.py:
//   - _flash_fwd_kernel (K3; online softmax in the exp2 domain over a q
//     pre-scaled in its own dtype, q * bf16(scale * log2(e))): kStatic =
//     false; q becomes bf16(float(q) * q_scale) inside the kernel;
//   - _flash_fwd_kernel_static (K1; no running max: p = exp2(max(s -
//     bound, -120)) over an already scaled q, with bound >= every logit
//     read from device memory): kStatic = true. Keys at or past Skv get
//     p = 0 after the exp2 (their zero-filled logit is 0, and
//     exp2(max(-bound, -120)) is not 0).
// Both: l = sum p in fp32, O = bf16(P) V accumulated in fp32, o = O / l.
//
// What bounds it on the H100: the two products. At the Wan self-attention
// shape (48 heads x 5,460 tokens, D = 128) they are 0.73 TFLOP against
// ~0.2 GB of q/k/v/o traffic (0.74 ms at 989 TFLOP/s); at the CogVideoX
// shape (96 heads x 19,126, D = 64) 9.0 TFLOP (9.1 ms). At D = 64 the
// exp2s are a second floor of the same height: 3.5e10 of them at 16 a
// clock per SM is ~9.0 ms, so the softmax of one warpgroup has to run
// under another's products. K3 at the Wan cross shape (512 text keys) has
// only four key tiles a q tile, so the Q load and the first K tile of
// each q tile have to be hidden behind the previous tile's work.
//
// Design (the template is K6's forward, csrc/flash_attn_train.cu, on the
// helpers of csrc/sm90_common.cuh). Each block is warp-specialised and
// persistent: one block an SM walks the (batch*head, q tile) tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... Warpgroup 0 is the producer: one
// thread issues every TMA load (the warpgroup gives its registers away with
// setmaxnreg): Q tiles into two buffers, the next tile's Q as soon as the
// consumers are done with that buffer, and 128-key K and V tiles into a
// 2-stage ring that runs on across tiles, a K (V) stage refilled as soon
// as the products reading it have completed. The other kCWG warpgroups
// (2 at head_dim 128, whose accumulators take 240 registers a thread; 3
// at 64, which spend more of each tile in the softmax) are consumers of
// 64 q rows each. A consumer issues S_n = Q K_n^T (wgmma, both operands in
// shared memory, 128-byte swizzle) and O += bf16(P_{n-1}) V_{n-1} (P
// straight from the S accumulator as the register A operand, V MN-major
// by the transpose bit) as one batch, then runs the softmax of tile n
// while P_{n-1} V_{n-1} is still in the tensor cores. The consumers take
// turns to issue their batches (named barriers in a ring), so one
// warpgroup's softmax runs under another's products.
// For K3 the producer warpgroup's other three warps rescale each landed Q
// tile in shared memory in place (a bf16 x bf16 product rounds once:
// bf16(float(q) * q_scale)), fence the async proxy and release it to the
// consumers through a second barrier; with q_scale == 1 that pass is
// skipped. The TMA maps are 3-D over [batch*head, S, D]
// (encode_rows_map), so a ragged tail tile reads zeros and never the next
// head's rows; ragged keys are masked in the softmax and rows at or past
// Sq are never stored. No padded copies are made.
// No wgmma of a batch sits under a branch, and every register a batch
// reads or writes is defined before its fence and read only after its
// wait: else ptxas serialises every wgmma of the kernel (-Xptxas=-v says
// so).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kRowBytes = 128;   // one row of a 64-column swizzled box
constexpr int kN = 128;          // keys a tile
constexpr float kNegInf = -1e30f;  // as _NEG_INF on the TPU side
constexpr float kExpFloor = -120.0f;
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
// 24-register producer warps.
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
// bf16(float(x) * s): a bf16 product of two bf16 values is their exact
// product rounded once.
__device__ __forceinline__ void scale_16b(uint32_t addr, __nv_bfloat162 s) {
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

// Consumer warpgroups a block: 2 at head_dim 128 (the two accumulators
// take 240 registers a thread), 3 at 64 (more of each tile is softmax; two
// would spill).
template <int D>
constexpr int consumer_wgs() {
  return D == 64 ? 3 : 2;
}

// Shared memory of a block: two Q buffers of 64 * kCWG rows, then the K
// and V rings, then the mbarriers. Every tile starts on a 1024-byte
// boundary (the swizzle phase of a row is then row % 8).
template <int D, int kCWG>
struct Layout {
  static constexpr int kQRows = 64 * kCWG;
  static constexpr int kQBlock = kQRows * kRowBytes;  // one column block
  static constexpr int kQTile = kQBlock * (D / 64);
  static constexpr int kKVBlock = kN * kRowBytes;
  static constexpr int kKVTile = kKVBlock * (D / 64);
  static constexpr int kQ = 0;                    // 2 buffers
  static constexpr int kK = 2 * kQTile;           // 2 stages
  static constexpr int kV = kK + 2 * kKVTile;     // 2 stages
  static constexpr int kBars = kV + 2 * kKVTile;  // q_full[2], q_empty[2],
                                                  // k_full[2], v_full[2],
                                                  // k_empty[2], v_empty[2],
                                                  // q_ready[2]
  static constexpr int kBytes = kBars + 14 * 8 + 1024;  // + alignment slack
};

// The softmax of one S tile (64 rows x 128 keys from n0) in place: p in
// fp32, this thread's partial row sums l, and for K3 the running max m and
// the factor alpha by which the accumulator is to be rescaled.
template <bool kStatic>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& al_lo,
                                             float& al_hi, float bound,
                                             int n0, int skv, int t) {
  const bool ragged = n0 + kN > skv;
  if (kStatic) {
    float a_lo = 0.0f, a_hi = 0.0f, b_lo = 0.0f, b_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaxf(sc[4 * j + e] - bound, kExpFloor));
        if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) p = 0.0f;
        sc[4 * j + e] = p;
      }
      if (j & 1) {
        b_lo += sc[4 * j] + sc[4 * j + 1];
        b_hi += sc[4 * j + 2] + sc[4 * j + 3];
      } else {
        a_lo += sc[4 * j] + sc[4 * j + 1];
        a_hi += sc[4 * j + 2] + sc[4 * j + 3];
      }
    }
    l_lo += a_lo + b_lo;
    l_hi += a_hi + b_hi;
  } else {
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv)
          sc[4 * j + e] = kNegInf;
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
    al_lo = ex2(m_lo - mn_lo);
    al_hi = ex2(m_hi - mn_hi);
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
  }
}

// K3's rescale of the accumulator by alpha, then bf16(P) packed as the
// register A operand of P V.
template <int D, bool kStatic>
__device__ __forceinline__ void rescale_pack(float (&acc)[D / 2],
                                             uint32_t (&pa)[8][4],
                                             const float (&sc)[64],
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

// S = Q K^T over one key tile: 64 rows x 128 keys, depth D, both operands
// K-major in shared memory (column blocks kQBlock / kKVBlock bytes apart).
template <int D, int kQBlock, int kKVBlock>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mma_ss<128, 0, 0>(
        sc, desc_sw128(q_addr + (kk >> 2) * kQBlock + (kk & 3) * 32, 16, 1024),
        desc_sw128(k_addr + (kk >> 2) * kKVBlock + (kk & 3) * 32, 16, 1024),
        kk > 0);
  }
}

// O += bf16(P) V over one key tile, V MN-major in shared memory.
template <int D, int kKVBlock>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_rs<D, 1>(acc, pa[kk], desc_sw128(v_addr + kk * 2048, kKVBlock, 1024),
                 1);
}

template <int D, bool kStatic, int kCWG>
__global__ void __launch_bounds__((kCWG + 1) * kWG, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o,
                     const float* __restrict__ bound_ptr, int bh, int sq,
                     int skv, float q_scale) {
  using L = Layout<D, kCWG>;
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
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = bars + 6;
  uint64_t* k_empty = bars + 8;
  uint64_t* v_empty = bars + 10;
  uint64_t* q_ready = bars + 12;  // K3's rescaled Q

  const int n_q = (sq + L::kQRows - 1) / L::kQRows;
  const int n_kv = (skv + kN - 1) / kN;
  const int n_tiles = bh * n_q;
  const int wg = threadIdx.x / kWG;
  const bool rescale_q = !kStatic && q_scale != 1.0f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kCWG * kWG);
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kCWG * kWG);
      mbar_init(v_empty + s, kCWG * kWG);
      mbar_init(q_ready + s, kWG - 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (rescale_q && threadIdx.x >= 32) {
      // warps 1-3 rescale each landed Q tile in place for K3, off the
      // consumers' path (16 bytes a thread at a time, shared-window
      // addresses: the warpgroup has 24 or 32 registers)
      const __nv_bfloat162 s2 = __float2bfloat162_rn(q_scale);
      const uint32_t q0 = smem_u32(smem + L::kQ);
      const uint32_t full0 = smem_u32(q_full), ready0 = smem_u32(q_ready);
      const int mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
      for (int local = 0; local < mine; ++local) {
        const uint32_t b = local & 1;
        mbar_wait_u32(full0 + 8 * b, (local >> 1) & 1);
        for (uint32_t a = q0 + b * L::kQTile + 16 * (threadIdx.x - 32);
             a < q0 + (b + 1) * L::kQTile; a += 16 * (kWG - 32))
          scale_16b(a, s2);
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
          const int s = it & 1;
          const uint32_t ph = ((it >> 1) - 1) & 1;
          if (it >= 2) mbar_wait(k_empty + s, ph);
          mbar_expect_tx(k_full + s, L::kKVTile);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load_3d(smem + L::kK + s * L::kKVTile + cb * L::kKVBlock,
                        &tm_k, k_full + s, 64 * cb, n * kN, b);
          if (it >= 2) mbar_wait(v_empty + s, ph);
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
    const uint32_t k_addr = smem_u32(smem + L::kK);
    const uint32_t v_addr = smem_u32(smem + L::kV);
    const float bound = kStatic ? *bound_ptr : 0.0f;  // read once a block
    // the ring of turns starts with consumer 0
    if (w == kCWG - 1) named_bar_arrive(kSchedBar, 2 * kWG);

    int local = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int b = tile / n_q;
      const int m0 = (tile % n_q) * L::kQRows;
      const int buf = local & 1;
      const uint32_t q_addr =
          smem_u32(smem + L::kQ + buf * L::kQTile + 64 * w * kRowBytes);
      mbar_wait((rescale_q ? q_ready : q_full) + buf, (local >> 1) & 1);

      float m_lo = kNegInf, m_hi = kNegInf;  // running max (online variant)
      float l_lo = 0.0f, l_hi = 0.0f;        // per-thread partial row sums
      float al_lo = 1.0f, al_hi = 1.0f;      // K3's rescale of acc
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float sc[64];
      uint32_t pa[8][4];
      // key tile j of this q tile sits in ring stage (it + j) % 2
      auto k_tile = [&](int j) {
        mbar_wait(k_full + ((it + j) & 1), ((it + j) >> 1) & 1);
        return k_addr + ((it + j) & 1) * L::kKVTile;
      };
      auto v_tile = [&](int j) {
        mbar_wait(v_full + ((it + j) & 1), ((it + j) >> 1) & 1);
        return v_addr + ((it + j) & 1) * L::kKVTile;
      };
      // a stage of the K (V) ring is free once the products reading it
      // have completed
      auto k_done = [&](int j) { mbar_arrive(k_empty + ((it + j) & 1)); };
      auto v_done = [&](int j) { mbar_arrive(v_empty + ((it + j) & 1)); };
      // A batch of products: every register it reads or writes is defined
      // before the fence and read only after the wait (else ptxas
      // serialises the wgmmas); the consumers take turns.
      auto begin = [&] {
        named_bar_sync(kSchedBar + w, 2 * kWG);
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
      };
      auto end = [&] {
        wgmma_commit();
        named_bar_arrive(kSchedBar + (w + 1) % kCWG, 2 * kWG);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
      };
      auto softmax = [&](int n) {
        softmax_tile<kStatic>(sc, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi,
                              bound, n * kN, skv, t);
      };

      // S_0 and its softmax; then, for each later key tile n, one batch of
      // S_n = Q K_n^T and O += bf16(P_{n-1}) V_{n-1} and the softmax of
      // tile n; then the last tile's P V. The softmax of tile n runs while
      // P_{n-1} V_{n-1} is still in the tensor cores (the P V products are
      // their own commit group).
      uint32_t kt = k_tile(0);
      begin();
      issue_s<D, L::kQBlock, L::kKVBlock>(sc, q_addr, kt);
      end();
      k_done(0);
      if (n_kv == 1) mbar_arrive(q_empty + buf);  // Q is read
      softmax(0);
      rescale_pack<D, kStatic>(acc, pa, sc, al_lo, al_hi);
      for (int n = 1; n < n_kv; ++n) {
        const uint32_t vt = v_tile(n - 1);
        kt = k_tile(n);
        begin();
        issue_s<D, L::kQBlock, L::kKVBlock>(sc, q_addr, kt);
        wgmma_commit();
        issue_pv<D, L::kKVBlock>(acc, pa, vt);
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
        v_done(n - 1);
        rescale_pack<D, kStatic>(acc, pa, sc, al_lo, al_hi);
      }
      const uint32_t vt = v_tile(n_kv - 1);
      begin();
      issue_pv<D, L::kKVBlock>(acc, pa, vt);
      end();
      v_done(n_kv - 1);
      it += n_kv;

      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
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
int launch(const void* q, const void* k, const void* v, void* o,
           const float* bound, int bh, int sq, int skv, float q_scale,
           cudaStream_t stream) {
  constexpr int kCWG = consumer_wgs<D>();
  using L = Layout<D, kCWG>;
  const auto kernel = flash_fwd_kernel<D, kStatic, kCWG>;
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
      q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [bh, sq, D], k/v [bh, skv, D], o [bh, sq, D]: contiguous bf16.
// static_bound != 0: K1, exp2(max(s - *bound, -120)) over an already
// scaled q; else K3, online softmax over q scaled in-kernel by q_scale.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported head_dim; a negative value if a TMA map cannot be
// encoded).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const float* bound, int bh, int sq,
                              int skv, int head_dim, int static_bound,
                              float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) {
    return static_bound
               ? launch<128, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s)
               : launch<128, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
  }
  if (head_dim == 64) {
    return static_bound
               ? launch<64, true>(q, k, v, o, bound, bh, sq, skv, q_scale, s)
               : launch<64, false>(q, k, v, o, bound, bh, sq, skv, q_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape at a head_dim (64 or 128): what = 0 gives the dynamic
// shared memory (bytes), 1 the consumer warpgroups, 2 the q rows a tile;
// -1 for anything else.
extern "C" int flash_fwd_config(int head_dim, int what) {
  if (head_dim != 64 && head_dim != 128) return -1;
  const int cwg = head_dim == 64 ? consumer_wgs<64>() : consumer_wgs<128>();
  const int smem = head_dim == 64 ? Layout<64, consumer_wgs<64>()>::kBytes
                                  : Layout<128, consumer_wgs<128>()>::kBytes;
  switch (what) {
    case 0: return smem;
    case 1: return cwg;
    case 2: return 64 * cwg;
    default: return -1;
  }
}
