"""K2 and K5 as one Triton kernel: qk RMS-norm across heads + interleaved
RoPE.

K2 replaces ``_qk_producer_fullrow`` / ``_qk_producer_fullrow_kernel`` of
``frameino_tpu/ops/attention.py``: it reduces each token's RMS statistic
over all heads itself. K5 replaces ``_qk_producer`` /
``_qk_producer_kernel`` (tile ``_norm_rope_tile``): the tensor-parallel
path hands it a precomputed per-token ``rstd`` (the fp32 sum of squares
all-reduced over the tp ranks), and it reads only the rank's H/tp heads.
The two share every line but the statistic (the ``HAS_RSTD`` switch), so
their arithmetic is the same. This module imports ``triton`` at the top,
so only ``ops.attention.qk_norm_rope`` and ``qk_norm_rope_rstd`` import
it, and only for CUDA tensors.

Design. One program per token reads the whole [H*D] row once as two
strided [H, D/2] vectors (even and odd lanes), so the RoPE pair swap is a
register exchange; it reduces the sum of squares (K2) or loads the
token's rstd (K5), applies norm * gain, rounds to the output dtype (the
reference RMSNorm returns x.dtype), rotates in fp32 and writes the
[B*H, S, D] attention layout directly. H need not be a power of two (the
tp shards of 24 heads hold 12 or 6): the head axis is padded to BLOCK_H
and masked. What bounds it on the H100 is memory: 2 bytes read and 2
written per element and no product, so each element is read exactly once
and everything else stays in registers.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def _qk_norm_rope_kernel(raw_ptr, rstd_ptr, w_ptr, cos_ptr, sin_ptr, out_ptr,
                         S, eps, H: tl.constexpr, D: tl.constexpr,
                         BLOCK_H: tl.constexpr, HAS_RSTD: tl.constexpr):
    row = tl.program_id(0)                     # b * S + s
    b = row // S
    s = row % S
    HALF: tl.constexpr = D // 2
    h = tl.arange(0, BLOCK_H)[:, None]
    i = tl.arange(0, HALF)[None, :]
    hmask = h < H
    even = h * D + 2 * i                       # [BLOCK_H, HALF]
    base = raw_ptr + row.to(tl.int64) * (H * D)
    xe = tl.load(base + even, mask=hmask, other=0.0).to(tl.float32)
    xo = tl.load(base + even + 1, mask=hmask, other=0.0).to(tl.float32)
    if HAS_RSTD:
        rstd = tl.load(rstd_ptr + row)
    else:
        # fp64 sum of squares: the squares of bf16 values are exact and
        # their fp64 sum is (nearly) order-free, so rstd matches the plain
        # version bit for bit and the bf16 rounding of the normed value
        # cannot flip
        x2e = xe.to(tl.float64)
        x2o = xo.to(tl.float64)
        ssq = tl.sum(tl.sum(x2e * x2e + x2o * x2o, axis=1), axis=0)
        rstd = (1.0 / tl.sqrt(ssq / (H * D) + eps.to(tl.float64))
                ).to(tl.float32)
    we = tl.load(w_ptr + even, mask=hmask, other=0.0)
    wo = tl.load(w_ptr + even + 1, mask=hmask, other=0.0)
    out_ty = out_ptr.dtype.element_ty
    fe = (xe * rstd * we).to(out_ty).to(tl.float32)
    fo = (xo * rstd * wo).to(out_ty).to(tl.float32)
    c = tl.load(cos_ptr + s * HALF + i)        # [1, HALF], gain folded in
    sn = tl.load(sin_ptr + s * HALF + i)
    oe = fe * c - fo * sn
    oo = fo * c + fe * sn
    out = out_ptr + ((b * H + h).to(tl.int64) * S + s) * D + 2 * i
    tl.store(out, oe.to(out_ty), mask=hmask)
    tl.store(out + 1, oo.to(out_ty), mask=hmask)


def launch(raw, weight, cos, sin, out, num_heads: int, eps: float,
           rstd=None):
    """raw [B, S, H*D] bf16 -> out [B*H, S, D] (preallocated, checked by
    the caller). ``rstd`` [B, S] fp32 selects K5; without it, K2."""
    B, S, HD = raw.shape
    block_h = 1 << (num_heads - 1).bit_length()
    _qk_norm_rope_kernel[(B * S,)](
        raw, raw if rstd is None else rstd, weight, cos, sin, out, S,
        float(eps), H=num_heads, D=HD // num_heads, BLOCK_H=block_h,
        HAS_RSTD=rstd is not None, num_warps=4,
        # no mul+add -> fma contraction: the rotation rounds each product
        # as the plain version does, so cancellation cannot split them
        enable_fp_fusion=False)
