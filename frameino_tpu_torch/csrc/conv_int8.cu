// w8a8 convolution for Hopper (sm_90a), K14: an fp32 activation quantized
// per tensor to int8, an int8 x int8 implicit GEMM with int32 sums on the
// tensor cores (wgmma), and the fp32 epilogue, written in the VAE's
// channels-first layout.
//
// Replaces frameino_tpu/ops/conv.py::_conv_int8 (XLA, not Pallas: PyTorch
// has no int8 convolution on CUDA), reached from causal_conv3d, conv3d and
// conv2d when a Wan VAE conv holds int8 weights (quantize_wan_vae_int8):
//
//   s_x = max(amax(|x|) * fp32(1/127), 1e-12)      over the whole input
//   xq  = clip(round_half_even(x / s_x), -127, 127)
//   acc = conv(xq, wq)                             int32
//   y   = fma(float(acc), s_x * scale[n], bias[n])
//
// These are the numerics of JAX's jitted VAE programs (its streaming and
// tiled / hybrid walks, the serving default): XLA MULTIPLIES the absmax by
// the fp32-rounded 1/127 (K7's rule), x / s_x is an IEEE division (nvcc's
// default -prec-div=true: never build this file with --use_fast_math), and
// the epilogue's product and bias are one fused multiply-add, rounded
// once (__fmaf_rn; XLA contracts them). s_x * scale[n] is rounded on its
// own first (__fmul_rn). Every int32 sum is exact in any order (|sum| <=
// 127 * 127 * 27,648 < 2^31 at the VAE's widest K), so the partial sums of
// a split K add up to the same bits.
//
// Work. Three launches, on the caller's stream:
//   1. conv_int8_absmax: |x| reduced to one fp32 (its bits through
//      atomicMax: the values are never negative), a read of x;
//   2. conv_int8_quantize: x [B, C, P] (P = T*H*W) read once, the codes
//      written channels-last, xq [B, P, Cp] with Cp = C rounded up to 32
//      and the pad channels zero: a quarter-size write. A block transposes
//      a 64-position x 32-channel tile through shared memory;
//   3. conv_int8_igemm: M = B*To*Ho*Wo output positions, N = Cout, K =
//      kt*kh*kw*Cp in (tap, channel) order, the weights laid out [Cout, kt,
//      kh, kw, Cp]: one [Cout, K] row a channel, contiguous in K.
//
// What bounds the GEMM on this card, and what the design does about it.
// The VAE's convs hold 0.05-35 TOP each (the decoder's 35 convs 361 TOP),
// so the int8 tensor-core rate bounds them: 1,979 TOP/s dense, reached only
// by wgmma (the design this replaces, warp-level m16n8k32 products,
// reached 17% of it at the widest conv: 32-byte K steps, each behind a
// barrier). A tile of 128 positions x BN channels is fed 128 bytes of K a
// stage, so the operands a stage moves from L2 into shared memory (16 KB
// of A, BN * 128 bytes of B) buy 128 * BN * 128 products:
//   - B (the weights) by TMA, one box of 128 bytes x BN rows a stage with
//     the 128-byte swizzle that the wgmma descriptors read, rows past Cout
//     and columns past K filled with zeros;
//   - A (the implicit im2col of xq) by 16-byte cp.async gathers of a
//     producer warpgroup: a row is one output position, its 128 bytes of a
//     stage are one or more taps' channel runs (Cp = 160 spans two taps in
//     a stage), each 16-byte chunk c of row r written at chunk c ^ (r % 8),
//     TMA's own swizzle. A tap that falls outside the input (the causal
//     front pad, the spatial pads, the far edge of a stride-2 window) is a
//     zero-fill copy: no padded copy of the input exists. Cp is any
//     multiple of 32, so a tiled TMA box (which needs Cp % 128 == 0 and a
//     rectangle of positions) would not serve the encoder's 160 / 320
//     channels; the gathers serve every conv. Each thread owns one chunk
//     column of 8 rows for the whole K loop and keeps, per row, its first
//     input position and a bit mask of the taps that lie inside the input
//     (taps <= 32); its chunk's tap and channel advance as counters, with
//     no division in the loop;
//   - a ring of stages in shared memory (4 at BN = 256, 6 at 160), full
//     and empty mbarriers: the producer's warps arrive on a stage's full
//     barrier once their copies into it have landed (cp.async.wait_group,
//     kept kStages - 2 stages behind the issue, then the generic -> async
//     proxy fence), with TMA's bytes; two consumer warpgroups of 64 rows
//     each issue wgmma m64nBNk32 s32.s8.s8 (four a stage, both operands
//     K-major) and free the stage one stage later. setmaxnreg gives the
//     producer 56 registers, each consumer 224 (its accumulator is BN / 2);
//   - tiles by conv shape: BN = 256 where Cout is a multiple of it (the
//     decoder's 2048 / 1024 / 512 / 256), else 160 (the encoder's 640 /
//     320 / 160), else the one that pads Cout least; the block's tiles run
//     with N fastest, so the N tiles of one set of rows gather it from L2
//     together;
//   - split K where the tiles do not fill the SMs (the hybrid decode's
//     small tiles: M = 96 .. 1,536 at N = 1024, K = 27,648): blockIdx.y is
//     a split, a contiguous range of K stages (at least kMinSplitStages:
//     on the card a split of fewer stages cost more in zeroing and atomics
//     than it saved), its int32 partial sums added into a zeroed workspace
//     by atomics; a counter a tile elects the split that arrives last,
//     which runs the epilogue once on the full sum (the plan is
//     ops/conv_int8.igemm_plan);
//   - the epilogue: the int32 tile goes through shared memory (the ring,
//     [BN][128 + 4] words, free of bank conflicts both ways), then each
//     warp writes whole channel rows of 128 consecutive positions with
//     16-byte stores; s_x * scale[n] and bias[n] are read once a column
//     into shared memory.
// One block per SM (384 threads, 199,760 / 223,600 bytes of shared
// memory). The absmax and quantize passes are bound by bytes (x read twice,
// a quarter of it written) and stay as they were. On an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 30) the GEMM alone runs at 58-76% of
// the int8 rate at the decoder's 3x3x3 and 1x3x3 convs and the whole call
// at 45-68%, the rest being those two passes over the fp32 input; a 1x1x1
// conv (K = 160 .. 1,024) is bound by its bytes and by each tile's fixed
// cost (one block an SM, its loads, products and stores in turn).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, to fp32
constexpr float kScaleFloor = 1e-12f;

constexpr int kQuantThreads = 256;
constexpr int kQuantTileP = 64;
constexpr int kQuantTileC = 32;

// the implicit GEMM
constexpr int kChannelGranule = 32;  // Cp % kChannelGranule == 0
constexpr int kBM = 128;             // rows (output positions) of a tile
constexpr int kStageK = 128;         // bytes of K a stage
constexpr int kChunk = 16;           // bytes of one cp.async
constexpr int kWG = 128;
constexpr int kThreads = 3 * kWG;    // a producer and two consumers
constexpr int kRowsPerThread = kBM * (kStageK / kChunk) / kWG;  // 8
constexpr int kStgStride = kBM + 4;  // words of a staged channel row
constexpr int kMinSplitStages = 16;  // fewer: its reduction costs more
constexpr int kMaxTaps = 32;         // the taps' bit mask is 32 bits
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;   // 56 + 2 * 224 = 3 * 168 a thread

template <int BN>
struct Tiles {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kA = kBM * kStageK;   // bytes of an A stage
  static constexpr int kB = BN * kStageK;    // bytes of a B stage
  static constexpr int kOffB = kStages * kA;
  static constexpr int kOffBars = kOffB + kStages * kB;
  static constexpr int kOffScale = kOffBars + 2 * kStages * 8;
  static constexpr int kOffBias = kOffScale + BN * 4;
  static constexpr int kOffFlag = kOffBias + BN * 4;
  static constexpr int kBytes = kOffFlag + 16 + 1024;  // + alignment slack
  static_assert(BN * kStgStride * 4 <= kOffBars, "staging fits the ring");
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "1024-byte stages");
};

__device__ __forceinline__ float activation_scale(const unsigned* amax_bits) {
  return fmaxf(__fmul_rn(__uint_as_float(*amax_bits), kInv127), kScaleFloor);
}

__global__ void absmax_kernel(const float* __restrict__ x, long long n,
                              unsigned* __restrict__ amax_bits) {
  __shared__ float warp_max[kQuantThreads / 32];
  float m = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    m = fmaxf(m, fabsf(x[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits, __float_as_uint(m));
  }
}

// x [B, C, P] fp32 -> xq [B, P, Cp] int8; grid (ceil(P/64), Cp/32, B)
__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ xq,
                                const unsigned* __restrict__ amax_bits,
                                int C, int Cp, long long P) {
  // 48-byte rows: 16-byte aligned for the vector stores out
  __shared__ __align__(16) int8_t tile[kQuantTileP][kQuantTileC + 16];
  const float s = activation_scale(amax_bits);
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kQuantTileC;
  const long long p0 = static_cast<long long>(blockIdx.x) * kQuantTileP;
  const int pl = threadIdx.x % kQuantTileP;
  const long long p = p0 + pl;
#pragma unroll
  for (int j = threadIdx.x / kQuantTileP; j < kQuantTileC;
       j += kQuantThreads / kQuantTileP) {
    const int c = c0 + j;
    int code = 0;
    if (c < C && p < P) {
      const float v = x[(static_cast<long long>(b) * C + c) * P + p];
      code = min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
    }
    tile[pl][j] = static_cast<int8_t>(code);
  }
  __syncthreads();
  if (threadIdx.x < 2 * kQuantTileP) {
    const int row = threadIdx.x / 2, half = threadIdx.x % 2;
    const long long pr = p0 + row;
    if (pr < P) {
      *reinterpret_cast<int4*>(xq + (static_cast<long long>(b) * P + pr) * Cp +
                               c0 + 16 * half) =
          *reinterpret_cast<const int4*>(&tile[row][16 * half]);
    }
  }
}

struct ConvShape {
  int Ti, Hi, Wi, Cp, Cout;
  int kt, kh, kw;
  int st, sh, sw;
  int pt, ph, pw;  // front / top / left padding; the far sides by bounds
  int To, Ho, Wo;
  int M;           // B * To * Ho * Wo (< 2^31)
  int P;           // To * Ho * Wo
  int nk;          // stages of K: ceil(taps * Cp / kStageK)
  int n_tiles;     // tiles along N; a block's tile is blockIdx.x
  int split;       // splits of K (gridDim.y)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The taps (dt, dh, dw), bit (dt * kh + dh) * kw + dw, at which a window
// whose first input position is (ti0, hi0, wi0) reads inside the input.
__device__ __forceinline__ uint32_t tap_mask(int ti0, int hi0, int wi0,
                                             const ConvShape& g) {
  uint32_t vh = 0, vw = 0, mask = 0;
  for (int d = 0; d < g.kh; ++d)
    vh |= static_cast<uint32_t>(static_cast<unsigned>(hi0 + d) <
                                static_cast<unsigned>(g.Hi)) << d;
  for (int d = 0; d < g.kw; ++d)
    vw |= static_cast<uint32_t>(static_cast<unsigned>(wi0 + d) <
                                static_cast<unsigned>(g.Wi)) << d;
  int tap = 0;
  for (int dt = 0; dt < g.kt; ++dt) {
    const bool t_ok =
        static_cast<unsigned>(ti0 + dt) < static_cast<unsigned>(g.Ti);
    for (int dh = 0; dh < g.kh; ++dh, tap += g.kw)
      if (t_ok && ((vh >> dh) & 1u)) mask |= vw << tap;
  }
  return mask;
}

// y from the int32 sum of channel n: one rounding of the product and bias
__device__ __forceinline__ float epilogue(int acc, float sn, float bn,
                                          bool has_bias) {
  const float a = __int2float_rn(acc);
  return has_bias ? __fmaf_rn(a, sn, bn) : __fmul_rn(a, sn);
}

// A consumer's int32 accumulator (64 rows x BN) added into a split's
// workspace tile [BN][kBM] (the epilogue's channel rows).
template <int BN>
__device__ __forceinline__ void red_partial_add(int* wt,
                                                const uint32_t (&acc)[BN / 2],
                                                int w, int warp, int lane) {
  const int m = 64 * w + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      atomicAdd(wt + (8 * j + 2 * (lane % 4) + (e & 1)) * kBM + m +
                    8 * (e >> 1),
                static_cast<int>(acc[4 * j + e]));
}

// The epilogue's stores: each of the 8 consumer warps writes whole channel
// rows (128 positions, 4 a lane, a 16-byte store where the positions are
// consecutive in one batch) of the tile's int32 sums at `src` ([BN][stride]
// words: shared memory, or a split's workspace in device memory).
template <int BN, bool kFromGlobal>
__device__ __forceinline__ void store_tile(const int* src, int stride,
                                           const float* sn_s,
                                           const float* bn_s, bool has_bias,
                                           float* __restrict__ out,
                                           int m0, int n0,
                                           const ConvShape& g, int cwarp,
                                           int lane) {
  const int m = m0 + 4 * lane;
  const bool vec = g.P % 4 == 0 && m + 3 < g.M;
  long long base[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int me = m + e;
    const int b = me / g.P;
    base[e] = me < g.M ? static_cast<long long>(b) * g.Cout * g.P +
                             (me - b * g.P)
                       : -1;
  }
  for (int nl = cwarp; nl < BN; nl += 8) {
    const int n = n0 + nl;
    if (n >= g.Cout) break;
    const int4* row = reinterpret_cast<const int4*>(src + nl * stride) + lane;
    const int4 a = kFromGlobal ? __ldcg(row) : *row;
    const float s = sn_s[nl], c = bn_s[nl];
    const float4 y = make_float4(epilogue(a.x, s, c, has_bias),
                                 epilogue(a.y, s, c, has_bias),
                                 epilogue(a.z, s, c, has_bias),
                                 epilogue(a.w, s, c, has_bias));
    const long long nP = static_cast<long long>(n) * g.P;
    if (vec) {
      *reinterpret_cast<float4*>(out + base[0] + nP) = y;
    } else {
      const float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base[e] >= 0) out[base[e] + nP] = v[e];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    igemm_kernel(const __grid_constant__ CUtensorMap tm_w,
                 const int8_t* __restrict__ xq,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const unsigned* __restrict__ amax_bits,
                 float* __restrict__ out, int* __restrict__ ws,
                 const __grid_constant__ ConvShape g) {
  using T = Tiles<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kOffBars);
  uint64_t* empty = full + S;
  float* sn_s = reinterpret_cast<float*>(smem + T::kOffScale);
  float* bn_s = reinterpret_cast<float*>(smem + T::kOffBias);
  int* last_s = reinterpret_cast<int*>(smem + T::kOffFlag);

  const int tile = blockIdx.x;
  const int m0 = (tile / g.n_tiles) * kBM;
  const int n0 = (tile % g.n_tiles) * BN;
  // this split's stages of K: [ks0, ks1)
  const int nk = g.nk;
  const int ks0 = static_cast<int>(static_cast<long long>(blockIdx.y) * nk /
                                   g.split);
  const int ks1 = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * nk / g.split);
  const int n_it = ks1 - ks0;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, kWG / 32 + 1);  // 4 producer warps + TMA's bytes
      mbar_init(empty + s, 2 * kWG / 32);  // the 8 consumer warps
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: A by cp.async gathers, B by TMA -----------------------
    setmaxnreg_dec<kProducerRegs>();
    const int c = threadIdx.x & 7;   // this thread's 16-byte chunk of a row
    const int r0 = threadIdx.x >> 3;  // its rows: r0 + 16 i, i < 8
    const int taps = g.kt * g.kh * g.kw;
    int rowpos[kRowsPerThread];       // input position of tap (0, 0, 0)
    uint32_t rowmask[kRowsPerThread];  // taps inside the input
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = m0 + r0 + 16 * i;
      rowpos[i] = 0;
      rowmask[i] = 0;
      if (m < g.M) {
        const int b = m / g.P;
        int r = m - b * g.P;
        const int to = r / (g.Ho * g.Wo);
        r -= to * g.Ho * g.Wo;
        const int ho = r / g.Wo;
        const int wo = r - ho * g.Wo;
        int ti0, hi0, wi0;
        ti0 = to * g.st - g.pt;
        hi0 = ho * g.sh - g.ph;
        wi0 = wo * g.sw - g.pw;
        rowpos[i] = b * g.Ti * g.Hi * g.Wi + (ti0 * g.Hi + hi0) * g.Wi + wi0;
        rowmask[i] = tap_mask(ti0, hi0, wi0, g);
      }
    }
    // the chunk's place in K: tap (dt, dh, dw) and channel ch
    const int k_first = ks0 * kStageK + kChunk * c;
    int tap = k_first / g.Cp;
    int ch = k_first - tap * g.Cp;
    int dt = tap / (g.kh * g.kw);
    int dh = (tap - dt * g.kh * g.kw) / g.kw;
    int dw = tap - (dt * g.kh + dh) * g.kw;
    int tappos = (dt * g.Hi + dh) * g.Wi + dw;
    // shared-memory address of the chunk in row r0, stage 0; row r0 + 16 i
    // is 2048 * i bytes on, with the same swizzle phase (r % 8 == r0 % 8)
    const uint32_t a_dst0 =
        smem_u32(smem) + r0 * kStageK + ((c ^ (r0 & 7)) << 4);
    // stages a warp's copies may stay in flight before it arrives: the
    // consumers free a stage one stage late, so the arrival for stage it - L
    // must come before the wait at it + 1 for the slot of stage it + 1 - S
    constexpr int L = S - 2;
    int s = 0;
    for (int it = 0; it < n_it; ++it) {
      if (it >= S) mbar_wait(empty + s, ((it / S) + 1) & 1);
      if (threadIdx.x == 0) {
        mbar_expect_tx(full + s, T::kB);
        tma_load_3d(smem + T::kOffB + s * T::kB, &tm_w, full + s,
                    (ks0 + it) * kStageK, n0, 0);
      }
      const bool in_k = tap < taps;
      const uint32_t dst = a_dst0 + s * T::kA;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const bool ok = in_k && ((rowmask[i] >> (tap & 31)) & 1u);
        const int8_t* src =
            ok ? xq + static_cast<long long>(rowpos[i] + tappos) * g.Cp + ch
               : xq;
        cp_async16(dst + 2048 * i, src, ok);
      }
      cp_async_commit();
      // the next stage's chunk: 128 bytes on in K
      ch += kStageK;
      if (ch >= g.Cp) {
        do {
          ch -= g.Cp;
          ++tap;
          if (++dw == g.kw) {
            dw = 0;
            if (++dh == g.kh) {
              dh = 0;
              ++dt;
            }
          }
        } while (ch >= g.Cp);
        tappos = (dt * g.Hi + dh) * g.Wi + dw;
      }
      if (it >= L) {
        // stage it - L has landed: make it visible to wgmma (the async
        // proxy) and arrive for this warp
        cp_async_wait<L>();
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + (it + S - L) % S);
      }
      s = s + 1 == S ? 0 : s + 1;
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      for (int it = n_it > L ? n_it - L : 0; it < n_it; ++it)
        mbar_arrive(full + it % S);
    }
  } else {
    // ---- consumers: 64 rows each -----------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;
    const int ctid = threadIdx.x - kWG;
    const int warp = (threadIdx.x / 32) % 4;
    const bool has_bias = bias != nullptr;
    {
      const float sx = activation_scale(amax_bits);
      for (int j = ctid; j < BN; j += 2 * kWG) {
        const int n = n0 + j;
        sn_s[j] = n < g.Cout ? __fmul_rn(sx, scale[n]) : 0.0f;
        bn_s[j] = n < g.Cout && has_bias ? bias[n] : 0.0f;
      }
    }
    const uint64_t a_desc =
        desc_sw128(smem_u32(smem + w * 64 * kStageK), 16, 1024);
    const uint64_t b_desc = desc_sw128(smem_u32(smem + T::kOffB), 16, 1024);
    uint32_t acc[BN / 2];
    int s = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_it; ++it) {
      mbar_wait(full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk)
        mma_ss_s8<BN>(acc, desc_add(a_desc, s * T::kA + 32 * kk),
                      desc_add(b_desc, s * T::kB + 32 * kk), (it | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      // the previous stage's products are done: free its slot
      if (it > 0 && lane == 0) mbar_arrive(empty + (s == 0 ? S - 1 : s - 1));
      if (++s == S) {
        s = 0;
        ph ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    if (g.split == 1) {
      // every stage consumed by both warpgroups: the ring is free
      named_bar_sync(1, 2 * kWG);
      int* stg = reinterpret_cast<int*>(smem);
      const int m = 64 * w + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stg[(8 * j + 2 * (lane % 4) + (e & 1)) * kStgStride + m +
              8 * (e >> 1)] = static_cast<int>(acc[4 * j + e]);
      named_bar_sync(1, 2 * kWG);
      store_tile<BN, false>(stg, kStgStride, sn_s, bn_s, has_bias, out, m0,
                            n0, g, ctid / 32, lane);
    } else {
      const int tiles = gridDim.x;
      int* wt = ws + static_cast<long long>(tile) * BN * kBM;
      red_partial_add<BN>(wt, acc, w, warp, lane);
      __threadfence();
      named_bar_sync(1, 2 * kWG);
      if (ctid == 0) {
        int* count = ws + static_cast<long long>(tiles) * BN * kBM + tile;
        *last_s = atomicAdd(count, 1) == g.split - 1;
      }
      named_bar_sync(1, 2 * kWG);
      if (*last_s) {
        // the last split to arrive: every partial sum is in the workspace
        __threadfence();
        store_tile<BN, true>(wt, kBM, sn_s, bn_s, has_bias, out, m0, n0, g,
                             ctid / 32, lane);
      }
    }
  }
}

// Once per instantiation (the process's current device): the opt-in to the
// dynamic shared memory.
template <int BN>
int prepare() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      igemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tiles<BN>::kBytes));
  return err;
}

template <int BN>
int launch_igemm(const int8_t* xq, const void* wq, const float* scale,
                 const float* bias, const unsigned* amax_bits, float* out,
                 int* ws, long long K, ConvShape g, cudaStream_t stream) {
  const int err = prepare<BN>();
  if (err) return err;
  CUtensorMap tm_w;
  // the weights as [1, Cout, K] int8 rows, a box of 128 bytes x BN rows
  const int enc = encode_rows_map(&tm_w, wq, 1, 1, g.Cout,
                                  static_cast<int>(K), BN, kStageK);
  if (enc) return enc;
  g.n_tiles = (g.Cout + BN - 1) / BN;
  const long long tiles =
      (static_cast<long long>(g.M) + kBM - 1) / kBM * g.n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), g.split);
  igemm_kernel<BN><<<grid, kThreads, Tiles<BN>::kBytes, stream>>>(
      tm_w, xq, scale, bias, amax_bits, out, ws, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// |x|'s max over n floats into *amax_bits (zeroed by the caller)
extern "C" int conv_int8_absmax(const void* x, int64_t n, void* amax_bits,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n / 4 + kQuantThreads - 1) / kQuantThreads;
  blocks = blocks < 1 ? 1 : (blocks > 2048 ? 2048 : blocks);
  absmax_kernel<<<static_cast<int>(blocks), kQuantThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<unsigned*>(amax_bits));
  return static_cast<int>(cudaGetLastError());
}

// x [B, C, P] fp32 -> xq [B, P, Cp] int8 (Cp % 32 == 0, pad channels 0)
extern "C" int conv_int8_quantize(const void* x, void* xq,
                                  const void* amax_bits, int B, int C, int Cp,
                                  int64_t P, void* stream) {
  if (B <= 0 || C <= 0 || P <= 0 || Cp % kQuantTileC || Cp < C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((P + kQuantTileP - 1) / kQuantTileP),
                  Cp / kQuantTileC, B);
  quantize_kernel<<<grid, kQuantThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xq),
      static_cast<const unsigned*>(amax_bits), C, Cp, P);
  return static_cast<int>(cudaGetLastError());
}

// xq [B, Ti, Hi, Wi, Cp] int8, wq [Cout, kt, kh, kw, Cp] int8 (16-byte
// aligned), scale and bias (or null) [Cout] fp32 -> out [B, Cout, To, Ho,
// Wo] fp32; pt / ph / pw pad the front / top / left, the far sides are read
// as zeros by bounds. block_n (256 or 160) and split (the K splits, at
// least kMinSplitStages stages each) are ops/conv_int8.igemm_plan's; with
// split > 1, workspace holds (tiles * block_n * 128 + tiles) zeroed int32s
// (the partial sums, then a counter a tile). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for arguments the kernel does not
// take, or a negative value if the weights' TMA map cannot be encoded.
extern "C" int conv_int8_igemm(const void* xq, const void* wq,
                               const void* scale, const void* bias,
                               const void* amax_bits, void* out,
                               void* workspace, int B, int Ti, int Hi, int Wi,
                               int Cp, int Cout, int kt, int kh, int kw,
                               int st, int sh, int sw, int pt, int ph, int pw,
                               int To, int Ho, int Wo, int block_n, int split,
                               void* stream) {
  const long long taps = static_cast<long long>(kt) * kh * kw;
  if (B <= 0 || Cp <= 0 || Cp % kChannelGranule || Cout <= 0 || To <= 0 ||
      Ho <= 0 || Wo <= 0 || kt <= 0 || kh <= 0 || kw <= 0 || st <= 0 ||
      sh <= 0 || sw <= 0 || taps > kMaxTaps ||
      static_cast<long long>(B) * Ti * Hi * Wi >= (1LL << 31) ||
      static_cast<long long>(B) * To * Ho * Wo >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(wq) % 16 ||
      (block_n != 256 && block_n != 160)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long K = taps * Cp;
  const int P = To * Ho * Wo;
  const int nk = static_cast<int>((K + kStageK - 1) / kStageK);
  if (split < 1 || (split > 1 && (workspace == nullptr ||
                                  split * kMinSplitStages > nk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvShape g{Ti, Hi, Wi, Cp, Cout, kt, kh, kw, st, sh, sw, pt, ph,
                    pw, To, Ho, Wo, B * P, P, nk, 0, split};
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* am = static_cast<const unsigned*>(amax_bits);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int*>(workspace);
  auto s = static_cast<cudaStream_t>(stream);
  return block_n == 256
             ? launch_igemm<256>(x8, wq, sc, bi, am, o, w, K, g, s)
             : launch_igemm<160>(x8, wq, sc, bi, am, o, w, K, g, s);
}

// Dynamic shared memory of igemm_kernel<block_n> (its ring, barriers and
// the epilogue's per-column scales), or -1 for a width it has no kernel
// for.
extern "C" int conv_int8_igemm_smem_bytes(int block_n) {
  return block_n == 256 ? Tiles<256>::kBytes
                        : block_n == 160 ? Tiles<160>::kBytes : -1;
}
