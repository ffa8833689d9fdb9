"""Dense / activation primitives (counterpart of
``frameino_tpu/ops/linear.py``): the float ``dense`` and the int8 w8a8
``dense_int8``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from frameino_tpu_torch.ops.dyn_quant import dynamic_quantize_rows


def _mm_f32(a, b):
    """a @ b of two bf16 CUDA matrices, fp32 accumulate and fp32 result."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _DenseBF16(torch.autograd.Function):
    """bf16 CUDA ``dense`` under autograd. ``torch.mm(..., out_dtype=)``
    has no derivative, so the backward is written out with the same
    fp32-result products: dX = dY W and dW = dY^T X, each rounded once to
    its input's dtype; db sums dY in fp32. dY arrives in ``out_dtype``:
    bf16 feeds the products as it is; an fp32 dY (``out_dtype=float32``)
    is not rounded, so its products run in fp32 as JAX's transpose of a
    mixed-dtype dot does."""

    @staticmethod
    def forward(ctx, x2, w, bias, out_dtype):
        ctx.save_for_backward(x2, w)
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        y = _mm_f32(x2, w.t())
        if bias is not None:
            y = y + bias.float()
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        if gy.dtype == x2.dtype:
            gy = gy.contiguous()
            dx = _mm_f32(gy, w).to(x2.dtype)
            dw = _mm_f32(gy.t(), x2).to(w.dtype)
        else:
            gy = gy.float()
            dx = torch.mm(gy, w.float()).to(x2.dtype)
            dw = torch.mm(gy.t(), x2.float()).to(w.dtype)
        db = gy.float().sum(0).to(ctx.bias_dtype) if ctx.has_bias else None
        return dx, dw, db, None


def dense(x, weight, bias=None, out_dtype=None):
    """x @ weight.T + bias with fp32 accumulation.

    ``weight`` is torch's [out, in] and is cast to x's dtype (as the JAX
    ``dense`` casts its kernel); the product accumulates in fp32, the bias
    is added in fp32 and the result is cast to ``out_dtype`` (default
    x's dtype). Differentiable on every path.
    """
    out_dtype = out_dtype or x.dtype
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        y = F.linear(x, w)
    elif x.is_cuda:
        y = _DenseBF16.apply(x.reshape(-1, x.shape[-1]), w, bias, out_dtype)
        return y.reshape(*x.shape[:-1], -1)
    else:
        # bf16 products are exact in fp32, so this is fp32 accumulation
        y = F.linear(x.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def dense_int8(x, weight_q, scale, bias=None, out_dtype=None):
    """w8a8 dense: per-row dynamic activation scales (K7) times static
    per-output-channel weight scales, int32 accumulation.

    ``weight_q`` is int8 [out, in], ``scale`` fp32 [out]. In JAX's order:
    y = int32(xq @ weight_q.T); y.float() * (s_x * scale) + bias.float(),
    cast to ``out_dtype`` (default x's dtype). The integer product is
    ``torch._int_mm`` (JAX leaves it to XLA, outside any Pallas kernel);
    on CUDA it needs more than 16 rows and in/out widths that are
    multiples of 8: fewer rows are padded with zero rows and sliced off,
    other widths raise. The epilogue runs in place, the same IEEE
    operations with one [rows, out] fp32 temporary fewer.
    """
    out_dtype = out_dtype or x.dtype
    n_out, n_in = weight_q.shape
    if x.shape[-1] != n_in or scale.shape != (n_out,):
        raise ValueError(f"dense_int8: x {tuple(x.shape)}, weight_q "
                         f"{tuple(weight_q.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if any(t is not None and t.device != x.device
           for t in (weight_q, scale, bias)):
        raise ValueError(f"dense_int8: mixed devices (x on {x.device})")
    xq, s_x = dynamic_quantize_rows(x)
    xq2, s2 = xq.reshape(-1, n_in), s_x.reshape(-1, 1)
    rows = xq2.shape[0]
    if x.is_cuda:
        if n_in % 8 or n_out % 8:
            raise ValueError(f"dense_int8: torch._int_mm on CUDA needs in "
                             f"and out widths that are multiples of 8, got "
                             f"{n_in} and {n_out}")
        if rows <= 16:
            xq2 = torch.cat([xq2, xq2.new_zeros(17 - rows, n_in)])
    y = torch._int_mm(xq2, weight_q.t())[:rows]
    return dequantize_epilogue(y, s2, scale, bias, out_dtype).reshape(
        *x.shape[:-1], n_out)


def dequantize_epilogue(y, s_x, scale, bias, out_dtype):
    """int32 y [rows, out] -> y.float() * (s_x * scale) + bias.float() in
    ``out_dtype``: JAX's order, in place on the fp32 copy of y."""
    yf = y.float()
    yf.mul_(s_x * scale.float())
    if bias is not None:
        yf.add_(bias.float())
    return yf.to(out_dtype)


def gelu_tanh(x):
    """Tanh-approximated GELU (diffusers 'gelu-approximate')."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)
