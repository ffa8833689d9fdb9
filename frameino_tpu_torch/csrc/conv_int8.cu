// w8a8 convolution for Hopper (sm_90a), K14: an fp32 activation quantized
// per tensor to int8, an int8 x int8 implicit GEMM with int32 sums on the
// tensor cores, and the fp32 epilogue fused, written in the VAE's
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
// own first (__fmul_rn).
//
// Work. Three launches, on the caller's stream:
//   1. conv_int8_absmax: |x| reduced to one fp32 (its bits through
//      atomicMax: the values are never negative), a read of x;
//   2. conv_int8_quantize: x [B, C, P] (P = T*H*W) read once, the codes
//      written channels-last, xq [B, P, Cp] with Cp = C rounded up to 32
//      and the pad channels zero: a quarter-size write. A block transposes
//      a 64-position x 32-channel tile through shared memory;
//   3. conv_int8_igemm: M = B*To*Ho*Wo output positions, N = Cout, K =
//      kt*kh*kw*Cp, in that (tap, channel) order, the weights laid out
//      [Cout, kt, kh, kw, Cp]. A block takes a 128 x 128 output tile; its
//      8 warps (4 along M, 2 along N) each 32 x 64, as 2 x 8 tiles of
//      mma.sync m16n8k32 s8 with int32 accumulators. K goes in steps of 32
//      bytes (one tap, 32 channels) through a 4-stage cp.async ring. The
//      A rows are gathered from xq: each thread owns one output position
//      for the whole loop, and a tap that falls outside the input (causal
//      front padding, spatial padding, the far edge of a stride-2 window)
//      is a zero-fill copy (src-size 0), so no padded copy of the input
//      ever exists. A row's two 16-byte halves swap places in shared
//      memory every 4 rows, which keeps the fragment loads free of bank
//      conflicts.
//
// Bound: int8 operations (2*M*N*K at 1,979 TOP/s dense) at the VAE's
// widths; the quantizer's bytes (x read twice, xq written) come on top.
// This is the first, plain design (mma.sync, not wgmma/TMA): right first,
// fast later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, to fp32
constexpr float kScaleFloor = 1e-12f;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;  // bytes of K per stage: one tap, 32 channels
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kQuantTileP = 64;
constexpr int kQuantTileC = 32;

__device__ __forceinline__ float activation_scale(const unsigned* amax_bits) {
  return fmaxf(__fmul_rn(__uint_as_float(*amax_bits), kInv127), kScaleFloor);
}

__global__ void absmax_kernel(const float* __restrict__ x, long long n,
                              unsigned* __restrict__ amax_bits) {
  __shared__ float warp_max[kThreads / 32];
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
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
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
       j += kThreads / kQuantTileP) {
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
  long long M;     // B * To * Ho * Wo
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of 16-byte half `half` of tile row `row` (32 bytes a row)
__device__ __forceinline__ int swz(int row, int half) {
  return row * kBK + 16 * (half ^ ((row >> 2) & 1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* tile, int row,
                                          int half, int word) {
  return *reinterpret_cast<const uint32_t*>(tile + swz(row, half) + 4 * word);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
    igemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const unsigned* __restrict__ amax_bits,
                 float* __restrict__ out, const ConvShape g) {
  __shared__ __align__(128) int8_t smem_a[kStages][kBM * kBK];
  __shared__ __align__(128) int8_t smem_b[kStages][kBN * kBK];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long P = static_cast<long long>(g.To) * g.Ho * g.Wo;
  const int cchunks = g.Cp / kBK;
  const int taps = g.kt * g.kh * g.kw;
  const int nk = taps * cchunks;
  const long long K = static_cast<long long>(taps) * g.Cp;

  // this thread's copy slot: row `lrow`, 16-byte half `lhalf`, of both tiles
  const int lrow = tid / 2, lhalf = tid % 2;
  const long long m = m0 + lrow;
  const bool m_ok = m < g.M;
  int ti0 = 0, hi0 = 0, wi0 = 0;
  const int8_t* xb = xq;
  if (m_ok) {
    const long long b = m / P;
    long long r = m - b * P;
    const int to = static_cast<int>(r / (g.Ho * g.Wo));
    r -= static_cast<long long>(to) * g.Ho * g.Wo;
    const int ho = static_cast<int>(r / g.Wo);
    const int wo = static_cast<int>(r - static_cast<long long>(ho) * g.Wo);
    ti0 = to * g.st - g.pt;
    hi0 = ho * g.sh - g.ph;
    wi0 = wo * g.sw - g.pw;
    xb = xq + b * static_cast<long long>(g.Ti) * g.Hi * g.Wi * g.Cp;
  }
  const int n_row = n0 + lrow;
  const bool n_ok = n_row < g.Cout;
  const int8_t* wrow = wq + (n_ok ? static_cast<long long>(n_row) * K : 0);

  auto load_stage = [&](int ks, int stage) {
    const int tap = ks / cchunks;
    const int cc = ks - tap * cchunks;
    const int dt = tap / (g.kh * g.kw);
    const int dhw = tap - dt * g.kh * g.kw;
    const int dh = dhw / g.kw;
    const int dw = dhw - dh * g.kw;
    const int ti = ti0 + dt;
    const int hi = hi0 + dh;
    const int wi = wi0 + dw;
    const bool a_ok = m_ok && ti >= 0 && ti < g.Ti && hi >= 0 &&
                      hi < g.Hi && wi >= 0 && wi < g.Wi;
    const int8_t* a_src =
        a_ok ? xb + ((static_cast<long long>(ti) * g.Hi + hi) * g.Wi + wi) *
                        g.Cp + cc * kBK + 16 * lhalf
             : xq;
    cp_async16(smem_a[stage] + swz(lrow, lhalf), a_src, a_ok);
    const int8_t* b_src =
        n_ok ? wrow + static_cast<long long>(ks) * kBK + 16 * lhalf : wq;
    cp_async16(smem_b[stage] + swz(lrow, lhalf), b_src, n_ok);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp % 4, warp_n = warp / 4;
  const int grp = lane / 4, tig = lane % 4;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage read at step ks - 1 is free now: refill it
    const int next = ks + kStages - 1;
    if (next < nk) load_stage(next, next % kStages);
    cp_async_commit();

    const int8_t* ta = smem_a[ks % kStages];
    const int8_t* tb = smem_b[ks % kStages];
    uint32_t a[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp_m * 32 + i * 16 + grp;
      a[i][0] = lds32(ta, row, 0, tig);
      a[i][1] = lds32(ta, row + 8, 0, tig);
      a[i][2] = lds32(ta, row, 1, tig);
      a[i][3] = lds32(ta, row + 8, 1, tig);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = warp_n * 64 + j * 8 + grp;
      bf[j][0] = lds32(tb, row, 0, tig);
      bf[j][1] = lds32(tb, row, 1, tig);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], bf[j][0],
               bf[j][1]);
  }
  cp_async_wait<0>();

  // epilogue: y = float(acc) * (s_x * scale[n]) + bias[n], channels-first
  const float sx = activation_scale(amax_bits);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long mr = m0 + warp_m * 32 + i * 16 + grp + 8 * h;
      if (mr >= g.M) continue;
      const long long b = mr / P;
      float* orow = out + b * g.Cout * P + (mr - b * P);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp_n * 64 + j * 8 + 2 * tig + e;
          if (n >= g.Cout) continue;
          const float sn = __fmul_rn(sx, scale[n]);
          const float a = __int2float_rn(acc[i][j][2 * h + e]);
          orow[static_cast<long long>(n) * P] =
              bias != nullptr ? __fmaf_rn(a, sn, bias[n]) : __fmul_rn(a, sn);
        }
      }
    }
  }
}

}  // namespace

// |x|'s max over n floats into *amax_bits (zeroed by the caller)
extern "C" int conv_int8_absmax(const void* x, int64_t n, void* amax_bits,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 2048 ? 2048 : blocks);
  absmax_kernel<<<static_cast<int>(blocks), kThreads, 0,
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
  quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xq),
      static_cast<const unsigned*>(amax_bits), C, Cp, P);
  return static_cast<int>(cudaGetLastError());
}

// xq [B, Ti, Hi, Wi, Cp] int8, wq [Cout, kt, kh, kw, Cp] int8, scale and
// bias (or null) [Cout] fp32 -> out [B, Cout, To, Ho, Wo] fp32; pt / ph /
// pw pad the front / top / left, the far sides are read as zeros by bounds
extern "C" int conv_int8_igemm(const void* xq, const void* wq,
                               const void* scale, const void* bias,
                               const void* amax_bits, void* out, int B,
                               int Ti, int Hi, int Wi, int Cp, int Cout,
                               int kt, int kh, int kw, int st, int sh, int sw,
                               int pt, int ph, int pw, int To, int Ho, int Wo,
                               void* stream) {
  if (B <= 0 || Cp <= 0 || Cp % kBK || Cout <= 0 || To <= 0 || Ho <= 0 ||
      Wo <= 0 || kt <= 0 || kh <= 0 || kw <= 0 || st <= 0 || sh <= 0 ||
      sw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvShape g{Ti, Hi, Wi, Cp, Cout, kt, kh, kw, st, sh, sw, pt, ph, pw,
                    To, Ho, Wo, static_cast<long long>(B) * To * Ho * Wo};
  const dim3 grid(static_cast<unsigned>((g.M + kBM - 1) / kBM),
                  (Cout + kBN - 1) / kBN);
  igemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const unsigned*>(amax_bits), static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
