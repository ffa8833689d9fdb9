"""Convolution primitives for the Wan causal video VAE (counterpart of
``frameino_tpu/ops/conv.py``).

The JAX package runs one full-sequence conv per layer (equal to the
reference's chunked feature-cache streaming, see
``frameino_tpu/models/wan_vae.py``) and leaves it to XLA; here the same
convs go to cuDNN. Layout is torch's channels-first: video [B, C, T, H, W],
conv weights [Cout, Cin, kt, kh, kw] (int8 weights in K14's layout, see
below).

``conv_dtype(dtype)`` is the port's ``conv_accum_dtype`` scope (the
trainer's frozen-VAE encodes run under it): inside it a conv casts an
input wider than ``dtype`` to ``dtype``, rounds its product to the
input's dtype and adds the bias in that dtype, JAX's order
(``preferred_element_type``, then ``+ bias``); cuDNN's bf16 convs
accumulate in fp32. Outside it a conv runs in its input's dtype with the
bias fused.

A conv given a ``scale`` holds int8 weights in K14's layout, [Cout, kt,
kh, kw, Cp] (2D: [Cout, kh, kw, Cp]; ``models/quant.
quantize_wan_vae_int8``; ``conv_weights(layer)`` reads either kind of
layer) and runs the w8a8 path, JAX's ``_conv_int8``: ``ops/conv_int8.
conv_int8``, which launches K14 on CUDA tensors and runs its plain version
on CPU tensors. Its padding is given to the kernel, never copied in.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from frameino_tpu_torch.ops.conv_int8 import conv_int8

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


def conv_weights(layer) -> dict:
    """A conv layer's ``weight`` and ``bias`` as the functions below take
    them; an int8 layer's (``weight_q``) with its ``scale`` too."""
    weight_q = getattr(layer, "weight_q", None)
    if weight_q is not None:
        return dict(weight=weight_q, bias=layer.bias, scale=layer.scale)
    return dict(weight=layer.weight, bias=layer.bias)


def _int8(x, weight, bias, scale, stride, padding):
    """The w8a8 conv of x [B, C, T, H, W], after JAX's cast of x to a
    narrower scope dtype."""
    dt = _CONV_DTYPE.get()
    if dt is not None and dt.itemsize < x.dtype.itemsize:
        x = x.to(dt)
    return conv_int8(x, weight, scale, bias, stride, padding)


def causal_conv3d(x, weight, bias=None, stride: IntOr3 = 1,
                  padding: IntOr3 = 0, scale=None, front=None):
    """Causal 3D conv: ``2 * pad_t`` zeros at the front of time only
    (reference ``WanCausalConv3d``), symmetric spatial padding; ``front``
    overrides the temporal front padding (a streaming chunk whose cache
    stands in for part of it). Weights are cast to x's dtype."""
    pt, ph, pw = _triple(padding)
    front = 2 * pt if front is None else front
    if scale is not None:
        return _int8(x, weight, bias, scale, _triple(stride),
                     ((front, 0), (ph, ph), (pw, pw)))
    if front:
        x = F.pad(x, (0, 0, 0, 0, front, 0))
    return scoped_conv(F.conv3d, x, weight, bias, stride=_triple(stride),
                       padding=(0, ph, pw))


def conv3d(x, weight, bias=None, stride: IntOr3 = 1, scale=None):
    """Plain 3D conv with no padding ('VALID')."""
    if scale is not None:
        return _int8(x, weight, bias, scale, _triple(stride), ((0, 0),) * 3)
    return scoped_conv(F.conv3d, x, weight, bias, stride=_triple(stride))


def conv2d(x, weight, bias=None, stride: int = 1, padding="same",
           scale=None):
    """2D conv. x: [N, C, H, W]; padding 'same' (stride 1), 'valid' or
    zeros ((top, bottom), (left, right)). The int8 path runs it as a 3D
    conv of one frame, so one activation scale spans all N images, as
    JAX's conv2d on [N, H, W, C]; it reads the padding as zeros, with no
    padded copy."""
    if scale is None:
        if not isinstance(padding, str):
            (t, b), (l, r) = padding
            x, padding = F.pad(x, (l, r, t, b)), "valid"
        return scoped_conv(F.conv2d, x, weight, bias, stride=stride,
                           padding=padding)
    if padding == "same":
        if stride != 1:
            raise ValueError("conv2d: 'same' padding takes stride 1")
        kh, kw = weight.shape[1:3]
        padding = (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))
    elif padding == "valid":
        padding = ((0, 0), (0, 0))
    return _int8(x[:, :, None], weight[:, None], bias, scale,
                 (1, stride, stride), ((0, 0), *padding))[:, :, 0]


def nearest_exact_upsample2d(x, factor: int = 2):
    """torch 'nearest-exact' upsample by an integer factor == pixel
    duplication. x: [N, C, H, W]."""
    return F.interpolate(x, scale_factor=factor, mode="nearest-exact")
