"""Dense / activation primitives (counterpart of
``frameino_tpu/ops/linear.py``; the int8 ``dense_int8`` is not ported).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x, weight, bias=None, out_dtype=None):
    """x @ weight.T + bias with fp32 accumulation.

    ``weight`` is torch's [out, in] and is cast to x's dtype (as the JAX
    ``dense`` casts its kernel); the product accumulates in fp32, the bias
    is added in fp32 and the result is cast to ``out_dtype`` (default
    x's dtype).
    """
    out_dtype = out_dtype or x.dtype
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        y = F.linear(x, w)
    elif x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
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
