"""Convolution primitives for the Wan causal video VAE (counterpart of
``frameino_tpu/ops/conv.py``; the int8 ``_conv_int8`` is not ported).

The JAX package runs one full-sequence conv per layer (equal to the
reference's chunked feature-cache streaming, see
``frameino_tpu/models/wan_vae.py``) and leaves it to XLA; here the same
convs go to cuDNN. Layout is torch's channels-first: video [B, C, T, H, W],
conv weights [Cout, Cin, kt, kh, kw].

``conv_dtype(dtype)`` is the port's ``conv_accum_dtype`` scope (the
trainer's frozen-VAE encodes run under it): inside it a conv casts an
input wider than ``dtype`` to ``dtype``, rounds its product to the
input's dtype and adds the bias in that dtype, JAX's order
(``preferred_element_type``, then ``+ bias``); cuDNN's bf16 convs
accumulate in fp32. Outside it a conv runs in its input's dtype with the
bias fused.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOr3 = Union[int, Tuple[int, int, int]]

_CONV_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "frameino_torch_conv_dtype", default=None)


class conv_dtype:
    """Context manager: the VAE convs (and the Wan VAE's channel norms)
    of this thread run in ``dtype`` (None: as outside the scope)."""

    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype

    def __enter__(self):
        self._token = _CONV_DTYPE.set(self.dtype)
        return self

    def __exit__(self, *exc):
        _CONV_DTYPE.reset(self._token)
        return False


def narrow_conv_dtype(dtype: torch.dtype) -> conv_dtype:
    """``conv_dtype(dtype)`` when ``dtype`` is narrower than fp32, else the
    unscoped rule (an fp32 conv keeps its bias fused, as before)."""
    return conv_dtype(dtype if dtype.itemsize < 4 else None)


def low_precision_dtype() -> Optional[torch.dtype]:
    """The scope's dtype when it is narrower than fp32, else None."""
    dt = _CONV_DTYPE.get()
    return dt if dt is not None and dt.itemsize < 4 else None


def silu_(x):
    """SiLU in place; under a low-precision scope ``x * (1 / (1 +
    exp(-x)))`` with every step rounded to x's dtype, as ``jax.nn.silu``
    runs on bf16."""
    if low_precision_dtype() is not None and x.dtype != torch.float32:
        return x.mul_(torch.exp(-x).add_(1).reciprocal_())
    return F.silu(x, inplace=True)


def _triple(x: IntOr3) -> Tuple[int, int, int]:
    return (x, x, x) if isinstance(x, int) else tuple(x)


def scoped_conv(fn, x, weight, bias, **kw):
    """``fn`` (F.conv2d / F.conv3d) on x with the weight cast to x's dtype,
    under the ``conv_dtype`` rule above."""
    dt = _CONV_DTYPE.get()
    if dt is None:
        return fn(x, weight.to(x.dtype),
                  None if bias is None else bias.to(x.dtype), **kw)
    if dt.itemsize < x.dtype.itemsize:
        x = x.to(dt)
    y = fn(x, weight.to(x.dtype), None, **kw)
    if bias is None:
        return y
    return y + bias.to(y.dtype).reshape(-1, *(1,) * (y.ndim - 2))


def causal_conv3d(x, weight, bias=None, stride: IntOr3 = 1,
                  padding: IntOr3 = 0):
    """Causal 3D conv: ``2 * pad_t`` zeros at the front of time only
    (reference ``WanCausalConv3d``), symmetric spatial padding. Weights are
    cast to x's dtype."""
    pt, ph, pw = _triple(padding)
    if pt:
        x = F.pad(x, (0, 0, 0, 0, 2 * pt, 0))
    return scoped_conv(F.conv3d, x, weight, bias, stride=_triple(stride),
                       padding=(0, ph, pw))


def conv3d(x, weight, bias=None, stride: IntOr3 = 1):
    """Plain 3D conv with no padding ('VALID')."""
    return scoped_conv(F.conv3d, x, weight, bias, stride=_triple(stride))


def conv2d(x, weight, bias=None, stride: int = 1, padding="same"):
    """2D conv. x: [N, C, H, W]; padding 'same' (stride 1) or 'valid'."""
    return scoped_conv(F.conv2d, x, weight, bias, stride=stride,
                       padding=padding)


def nearest_exact_upsample2d(x, factor: int = 2):
    """torch 'nearest-exact' upsample by an integer factor == pixel
    duplication. x: [N, C, H, W]."""
    return F.interpolate(x, scale_factor=factor, mode="nearest-exact")


def zero_pad_hw_br(x):
    """nn.ZeroPad2d((0, 1, 0, 1)): one pixel on the right and bottom.
    x: [..., H, W]."""
    return F.pad(x, (0, 1, 0, 1))
