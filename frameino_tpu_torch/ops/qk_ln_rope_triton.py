"""K4 as a Triton kernel: per-head qk LayerNorm + joint-sequence RoPE.

Replaces ``_qk_producer_ln`` / ``_qk_producer_ln_kernel`` of
``frameino_tpu/ops/attention.py`` (the CogVideoX self-attention producer).
This module imports ``triton`` at the top, so only
``ops.attention.qk_ln_rope`` imports it, and only for CUDA tensors.

Design. One program per (block of BLOCK_S tokens, batch * head): it reads
that head's [BLOCK_S, D] slice of the raw [B, S, H*D] rows as two strided
[BLOCK_S, D/2] tiles (even and odd lanes, so the RoPE pair swap is a
register exchange), takes each token's mean and variance over the head's D
lanes, applies (x - mu) * rstd * gamma + beta with the [D] gamma/beta
shared by all heads, rounds to the output dtype (the reference LayerNorm
returns x.dtype), rotates in fp32 with the joint [S, D/2] tables (cos 1 /
sin 0 over the text prefix, softmax gain folded into q's) and writes the
[B*H, S, D] attention layout directly. For a fixed head, the D lanes of a
token are one 128-byte line at D = 64 on both sides, so reads and writes
are whole lines. What bounds it on the H100 is memory: 2 bytes read and 2
written per element and no product. The ragged last token block is masked
in the kernel; nothing is padded.
"""

from __future__ import annotations

import triton
import triton.language as tl

BLOCK_S = 64


@triton.jit
def _qk_ln_rope_kernel(raw_ptr, w_ptr, b_ptr, cos_ptr, sin_ptr, out_ptr, S,
                       eps, H: tl.constexpr, D: tl.constexpr,
                       BLOCK: tl.constexpr):
    pid_s = tl.program_id(0)
    bh = tl.program_id(1)                      # b * H + h
    b = bh // H
    h = bh % H
    HALF: tl.constexpr = D // 2
    s = pid_s * BLOCK + tl.arange(0, BLOCK)[:, None]     # [BLOCK, 1]
    i = tl.arange(0, HALF)[None, :]                       # [1, HALF]
    smask = s < S
    even = (b * S + s).to(tl.int64) * (H * D) + h * D + 2 * i
    xe = tl.load(raw_ptr + even, mask=smask, other=0.0).to(tl.float32)
    xo = tl.load(raw_ptr + even + 1, mask=smask, other=0.0).to(tl.float32)
    # fp64 statistics: the mean of bf16 values and the squares of their
    # deviations are exact there, so the sums are order-free and mu/rstd
    # match the plain version bit for bit (the bf16 rounding of the normed
    # value then cannot flip, which the cancelling rotation would amplify)
    de = xe.to(tl.float64)
    do = xo.to(tl.float64)
    mean = (tl.sum(de, axis=1) + tl.sum(do, axis=1)) / D
    ce = de - mean[:, None]
    co = do - mean[:, None]
    var = (tl.sum(ce * ce, axis=1) + tl.sum(co * co, axis=1)) / D
    rstd = (1.0 / tl.sqrt(var + eps.to(tl.float64))).to(tl.float32)[:, None]
    mu = mean.to(tl.float32)[:, None]
    we = tl.load(w_ptr + 2 * i)
    wo = tl.load(w_ptr + 2 * i + 1)
    be = tl.load(b_ptr + 2 * i)
    bo = tl.load(b_ptr + 2 * i + 1)
    out_ty = out_ptr.dtype.element_ty
    ne = ((xe - mu) * rstd * we + be).to(out_ty).to(tl.float32)
    no = ((xo - mu) * rstd * wo + bo).to(out_ty).to(tl.float32)
    c = tl.load(cos_ptr + s * HALF + i, mask=smask, other=0.0)
    sn = tl.load(sin_ptr + s * HALF + i, mask=smask, other=0.0)
    oe = ne * c - no * sn
    oo = no * c + ne * sn
    out = out_ptr + (bh.to(tl.int64) * S + s) * D + 2 * i
    tl.store(out, oe.to(out_ty), mask=smask)
    tl.store(out + 1, oo.to(out_ty), mask=smask)


def launch(raw, weight, bias, cos, sin, out, num_heads: int, eps: float):
    """raw [B, S, H*D] bf16 -> out [B*H, S, D] (preallocated, checked by
    the caller); weight/bias [D], cos/sin [S, D/2] fp32."""
    B, S, HD = raw.shape
    grid = (triton.cdiv(S, BLOCK_S), B * num_heads)
    _qk_ln_rope_kernel[grid](
        raw, weight, bias, cos, sin, out, S, float(eps),
        H=num_heads, D=HD // num_heads, BLOCK=BLOCK_S, num_warps=4,
        # no mul+add -> fma contraction: each product and sum rounds as in
        # the plain version, so the rotation's cancellation cannot split
        enable_fp_fusion=False)
