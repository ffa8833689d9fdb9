"""Dense / activation primitives (counterpart of
``frameino_tpu/ops/linear.py``; the int8 ``dense_int8`` is not ported).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def gelu_tanh(x):
    """Tanh-approximated GELU (diffusers 'gelu-approximate')."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)
