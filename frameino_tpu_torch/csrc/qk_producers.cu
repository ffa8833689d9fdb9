// The q/k producers of the serving attention for Hopper (sm_90a): bf16
// [B, S, H*D] rows straight out of the to_q / to_k denses in, normed and
// rotated bf16 [B*H, S, D] (the flash kernels' layout) out.
//
// Replaces three Pallas TPU kernels of frameino_tpu/ops/attention.py:
//   K2 _qk_producer_fullrow (_qk_producer_fullrow_kernel): RMS-norm of each
//      token over all H*D columns, the [H*D] gain, interleaved RoPE;
//   K5 _qk_producer (_qk_producer_kernel): the same with a precomputed
//      per-token rstd (the tensor-parallel path all-reduces the sum of
//      squares) over a rank's H/tp heads;
//   K4 _qk_producer_ln (_qk_producer_ln_kernel): LayerNorm of each head's D
//      lanes with one [D] gamma/beta shared by all heads, then the same
//      RoPE (CogVideoX's joint tables, identity rows over the text).
//
// Numerics: those of the plain versions in ops/attention.py
// (qk_norm_rope_ref, qk_norm_rope_rstd_ref, qk_ln_rope_ref), step for step.
// The statistics are fp64: the squares of bf16 values, and K4's sums and
// deviations of a head's 64 or 128 values, are exact or nearly so there, so
// the sums hardly depend on their order and the fp32 rstd (and K4's mean)
// round as the plain version's do. The normed value is rounded to bf16 and
// back (the reference norms return x.dtype); every fp32 step rounds on its
// own (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction), as the plain
// version's separate tensor ops do, so K5 is bit-equal to it and the
// cancelling rotation cannot split a rounding.
//
// Design. Each producer moves 2 bytes in and 2 out per element and does no
// product: HBM bandwidth bounds it. A team of `team` threads takes one token
// row; thread t holds the row's 16-byte vectors v = j * team + t (j < VPT),
// so neighbouring threads read neighbouring 16 B and each thread holds four
// whole RoPE pairs: the pair swap is a register exchange. team is a
// multiple of the D/8 vectors of a head row, so a thread's vectors sit at
// the same offset dv in every head: its [H*D] gains (K2/K5, per vector),
// its gamma/beta (K4) and, per token, its four pairs' cos/sin (one 16-byte
// load each from the [S, D/2] tables, which stay in L2) are one set. The
// gains and gamma/beta are loaded once and stay in registers while the
// block walks its tokens: the grid is persistent, block b takes the token
// groups b, b + gridDim.x, ..., a group being one token per team. Each
// round issues the loads of the block's next group before the arithmetic
// of this one, so a thread keeps two tokens' vectors in flight. A
// thread's 8 outputs are
// contiguous in one head's D row of `out`, so stores are 16 B too. K2's
// sum of squares is reduced by a fixed xor-shuffle tree, then across the
// team's warps in shared memory in warp order; K4's two moments by the
// D/8 lanes of a head (xor steps within them). Ragged token counts and
// head counts that are not powers of two are masked by the mapping (a
// team past the last token or a vector past the row does no memory
// access); nothing is padded. The launch geometry (team, VPT, teams a
// block, grid) comes from ops/attention._producer_geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a block's threads, at most
constexpr int kMaxVpt = 4;        // 16-byte vectors a thread, at most

enum Kind { kNorm = 0, kNormRstd = 1, kLayerNorm = 2 };

struct Params {
  const uint4* raw;    // [n_tokens, H*D / 8] vectors of 8 bf16
  const float* rstd;   // K5: [n_tokens]
  const float* gain;   // K2/K5: [H*D]; K4: gamma [D]
  const float* beta;   // K4: [D]
  const float* cos;    // [seq, D/2]
  const float* sin;    // [seq, D/2]
  uint4* out;          // [B*H, seq, D]
  int n_tokens, seq, heads, head_dim, team, teams_per_block;
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four interleaved pairs (f[2i], f[2i+1]) rotated by (c[i], s[i]), each
// product rounded before the sum, packed to 8 bf16.
__device__ __forceinline__ uint4 rope8(const float (&f)[8], const float4& c4,
                                       const float4& s4) {
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float fe = f[2 * i], fo = f[2 * i + 1];
    const __nv_bfloat162 o = __floats2bfloat162_rn(
        __fsub_rn(__fmul_rn(fe, c[i]), __fmul_rn(fo, s[i])),
        __fadd_rn(__fmul_rn(fo, c[i]), __fmul_rn(fe, s[i])));
    w[i] = *reinterpret_cast<const uint32_t*>(&o);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The token's row vectors of this thread (zeros past the row or the last
// token) and its four pairs' cos/sin.
template <int VPT>
__device__ __forceinline__ void load_token(const Params& p, int tok, int t,
                                           int nv, int dv, uint4 (&x)[VPT],
                                           float4& c4, float4& s4) {
  const bool live = tok < p.n_tokens;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * p.team + t;
    x[j] = (live && v < nv) ? __ldcs(p.raw + (size_t)tok * nv + v)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
  c4 = s4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t row = (size_t)(tok % p.seq) * (p.head_dim / 2);
    c4 = __ldg(reinterpret_cast<const float4*>(p.cos + row) + dv);
    s4 = __ldg(reinterpret_cast<const float4*>(p.sin + row) + dv);
  }
}

// Team team_id's token in group grp; n_tokens (no token) past the last
// group.
__device__ __forceinline__ int group_token(const Params& p, int grp,
                                           int groups, int team_id) {
  return grp < groups ? grp * p.teams_per_block + team_id : p.n_tokens;
}

// The 16-byte slot of out [B*H, seq, D] of token tok's vector v.
__device__ __forceinline__ uint4* out_slot(const Params& p, int tok, int v,
                                           int dv) {
  const int hv = p.head_dim / 8;
  const size_t b = tok / p.seq, s = tok % p.seq, h = v / hv;
  return p.out + ((b * p.heads + h) * p.seq + s) * hv + dv;
}

// K2 (kRstd false: the statistic of the row itself) and K5 (kRstd true).
template <int VPT, bool kRstd>
__global__ void __launch_bounds__(kMaxThreads)
    qk_norm_rope_kernel(const Params p) {
  __shared__ double partial[2][kMaxThreads / 32];
  const int nv = p.heads * p.head_dim / 8;
  const int team_id = threadIdx.x / p.team;
  const int t = threadIdx.x - team_id * p.team;
  const int dv = t % (p.head_dim / 8);

  float g[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * p.team + t;
#pragma unroll
    for (int i = 0; i < 8; ++i) g[j][i] = 0.f;
    if (v < nv) load8(p.gain + 8 * v, g[j]);
  }

  const int groups = (p.n_tokens + p.teams_per_block - 1) / p.teams_per_block;
  int buf = 0;
  // each round issues the next group's loads before its own arithmetic
  uint4 next[VPT];
  float4 next_c, next_s;
  load_token<VPT>(p, group_token(p, blockIdx.x, groups, team_id), t, nv, dv,
                  next, next_c, next_s);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tok = grp * p.teams_per_block + team_id;
    uint4 x[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) x[j] = next[j];
    const float4 c4 = next_c, s4 = next_s;
    load_token<VPT>(p, group_token(p, grp + gridDim.x, groups, team_id), t,
                    nv, dv, next, next_c, next_s);

    float rstd;
    if constexpr (kRstd) {
      rstd = tok < p.n_tokens ? __ldg(p.rstd + tok) : 0.f;
    } else {
      // squares of bf16 values are exact in fp64; one fixed tree for the sum
      double ss = 0.0;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        float xf[8];
        unpack8(x[j], xf);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double d = xf[i];
          ss = fma(d, d, ss);
        }
      }
      const int width = p.team < 32 ? p.team : 32;
      for (int off = width / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (p.team > 32) {
        const int warps = p.team / 32, w0 = team_id * warps;
        if ((threadIdx.x & 31) == 0) partial[buf][threadIdx.x / 32] = ss;
        __syncthreads();
        // the team's warps in order; the other buffer is written next
        // round, after the barrier every thread passes after this read
        ss = partial[buf][w0];
        for (int w = 1; w < warps; ++w) ss += partial[buf][w0 + w];
        buf ^= 1;
      }
      rstd = __double2float_rn(1.0 / sqrt(ss / (double)(8 * nv) +
                                          (double)p.eps));
    }

    if (tok < p.n_tokens) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int v = j * p.team + t;
        if (v < nv) {
          float f[8];
          unpack8(x[j], f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            f[i] = round_bf16(__fmul_rn(__fmul_rn(f[i], rstd), g[j][i]));
          }
          *out_slot(p, tok, v, dv) = rope8(f, c4, s4);
        }
      }
    }
  }
}

// K4: per-head LayerNorm (fp64 mean, then the sum of squared deviations),
// reduced over the D/8 lanes that hold the head.
template <int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    qk_ln_rope_kernel(const Params p) {
  const int nv = p.heads * p.head_dim / 8;
  const int hv = p.head_dim / 8;
  const int team_id = threadIdx.x / p.team;
  const int t = threadIdx.x - team_id * p.team;
  const int dv = t % hv;
  const double inv_d = 1.0 / p.head_dim;  // a power of two: exact

  float gamma[8], beta[8];
  load8(p.gain + 8 * dv, gamma);
  load8(p.beta + 8 * dv, beta);

  const int groups = (p.n_tokens + p.teams_per_block - 1) / p.teams_per_block;
  // each round issues the next group's loads before its own arithmetic
  uint4 next[VPT];
  float4 next_c, next_s;
  load_token<VPT>(p, group_token(p, blockIdx.x, groups, team_id), t, nv, dv,
                  next, next_c, next_s);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tok = grp * p.teams_per_block + team_id;
    uint4 x[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) x[j] = next[j];
    const float4 c4 = next_c, s4 = next_s;
    load_token<VPT>(p, group_token(p, grp + gridDim.x, groups, team_id), t,
                    nv, dv, next, next_c, next_s);

    double mean[VPT], var[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      float xf[8];
      unpack8(x[j], xf);
      double sum = 0.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += (double)xf[i];
      mean[j] = sum;
    }
    for (int off = hv / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        mean[j] += __shfl_xor_sync(0xffffffffu, mean[j], off);
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      mean[j] *= inv_d;
      float xf[8];
      unpack8(x[j], xf);
      double sq = 0.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const double dev = (double)xf[i] - mean[j];
        sq = __dadd_rn(sq, __dmul_rn(dev, dev));
      }
      var[j] = sq;
    }
    for (int off = hv / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        var[j] += __shfl_xor_sync(0xffffffffu, var[j], off);
      }
    }

    if (tok < p.n_tokens) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int v = j * p.team + t;
        if (v < nv) {
          const float rstd = __double2float_rn(
              1.0 / sqrt(var[j] * inv_d + (double)p.eps));
          const float mu = __double2float_rn(mean[j]);
          float f[8];
          unpack8(x[j], f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            f[i] = round_bf16(__fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(f[i], mu), rstd), gamma[i]),
                beta[i]));
          }
          *out_slot(p, tok, v, dv) = rope8(f, c4, s4);
        }
      }
    }
  }
}

template <int VPT>
const void* kernel_of(int kind) {
  switch (kind) {
    case kNorm: return reinterpret_cast<const void*>(
        &qk_norm_rope_kernel<VPT, false>);
    case kNormRstd: return reinterpret_cast<const void*>(
        &qk_norm_rope_kernel<VPT, true>);
    case kLayerNorm: return reinterpret_cast<const void*>(
        &qk_ln_rope_kernel<VPT>);
  }
  return nullptr;
}

const void* kernel_of(int kind, int vpt) {
  switch (vpt) {
    case 1: return kernel_of<1>(kind);
    case 2: return kernel_of<2>(kind);
    case 3: return kernel_of<3>(kind);
    case 4: return kernel_of<4>(kind);
  }
  return nullptr;
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

int launch(int kind, Params p, int batch, int vpt, int grid, void* stream) {
  const int hv = p.head_dim / 8;
  const int nv = p.heads * hv;
  const void* fn = kernel_of(kind, vpt);
  // the geometry's invariants (ops/attention._producer_geometry)
  if (fn == nullptr || vpt > kMaxVpt || batch <= 0 || p.seq <= 0 ||
      p.heads <= 0 ||
      !pow2(p.head_dim) || p.head_dim < 8 || p.head_dim > 256 ||
      p.team <= 0 || p.team % hv != 0 || p.team * vpt < nv ||
      (p.team < 32 ? !pow2(p.team) : p.team % 32 != 0) ||
      p.teams_per_block <= 0 || p.team * p.teams_per_block > kMaxThreads ||
      grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_tokens = batch * p.seq;
  void* args[] = {&p};
  cudaLaunchKernel(fn, dim3(grid), dim3(p.team * p.teams_per_block), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 (rstd null) and K5 (rstd [B*S] fp32): raw [B, S, H*D] bf16, gain
// [H*D], cos/sin [S, D/2] fp32 -> out [B*H, S, D] bf16; every pointer
// 16-byte aligned but rstd's. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernel does not take).
extern "C" int qk_norm_rope_bf16(const void* raw, const void* rstd,
                                 const void* gain, const void* cos,
                                 const void* sin, void* out, int batch,
                                 int seq, int heads, int head_dim, float eps,
                                 int team, int vpt, int teams_per_block,
                                 int grid, void* stream) {
  const Params p{static_cast<const uint4*>(raw),
                 static_cast<const float*>(rstd),
                 static_cast<const float*>(gain), nullptr,
                 static_cast<const float*>(cos),
                 static_cast<const float*>(sin), static_cast<uint4*>(out),
                 0, seq, heads, head_dim, team, teams_per_block, eps};
  return launch(rstd == nullptr ? kNorm : kNormRstd, p, batch, vpt, grid,
                stream);
}

// K4: raw [B, S, H*D] bf16, gamma/beta [D], cos/sin [S, D/2] fp32 -> out
// [B*H, S, D] bf16, every pointer 16-byte aligned.
extern "C" int qk_ln_rope_bf16(const void* raw, const void* gamma,
                               const void* beta, const void* cos,
                               const void* sin, void* out, int batch, int seq,
                               int heads, int head_dim, float eps, int team,
                               int vpt, int teams_per_block, int grid,
                               void* stream) {
  const Params p{static_cast<const uint4*>(raw), nullptr,
                 static_cast<const float*>(gamma),
                 static_cast<const float*>(beta),
                 static_cast<const float*>(cos),
                 static_cast<const float*>(sin), static_cast<uint4*>(out),
                 0, seq, heads, head_dim, team, teams_per_block, eps};
  return launch(kLayerNorm, p, batch, vpt, grid, stream);
}

// Blocks of `threads` threads of the kernel (kind 0 K2, 1 K5, 2 K4; vpt
// vectors a thread) resident on one SM at once; 0 on an error.
extern "C" int qk_producer_blocks_per_sm(int kind, int vpt, int threads) {
  const void* fn = kernel_of(kind, vpt);
  int blocks = 0;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, threads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}
