"""Convolution primitives for the Wan causal video VAE (counterpart of
``frameino_tpu/ops/conv.py``; the int8 ``_conv_int8`` is not ported).

The JAX package runs one full-sequence conv per layer (equal to the
reference's chunked feature-cache streaming, see
``frameino_tpu/models/wan_vae.py``) and leaves it to XLA; here the same
convs go to cuDNN. Layout is torch's channels-first: video [B, C, T, H, W],
conv weights [Cout, Cin, kt, kh, kw].
"""

from __future__ import annotations

from typing import Tuple, Union

import torch.nn.functional as F

IntOr3 = Union[int, Tuple[int, int, int]]


def _triple(x: IntOr3) -> Tuple[int, int, int]:
    return (x, x, x) if isinstance(x, int) else tuple(x)


def causal_conv3d(x, weight, bias=None, stride: IntOr3 = 1,
                  padding: IntOr3 = 0):
    """Causal 3D conv: ``2 * pad_t`` zeros at the front of time only
    (reference ``WanCausalConv3d``), symmetric spatial padding. Weights are
    cast to x's dtype."""
    pt, ph, pw = _triple(padding)
    if pt:
        x = F.pad(x, (0, 0, 0, 0, 2 * pt, 0))
    return F.conv3d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=_triple(stride), padding=(0, ph, pw))


def conv3d(x, weight, bias=None, stride: IntOr3 = 1):
    """Plain 3D conv with no padding ('VALID')."""
    return F.conv3d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=_triple(stride))


def conv2d(x, weight, bias=None, stride: int = 1, padding="same"):
    """2D conv. x: [N, C, H, W]; padding 'same' (stride 1) or 'valid'."""
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding)


def nearest_exact_upsample2d(x, factor: int = 2):
    """torch 'nearest-exact' upsample by an integer factor == pixel
    duplication. x: [N, C, H, W]."""
    return F.interpolate(x, scale_factor=factor, mode="nearest-exact")


def zero_pad_hw_br(x):
    """nn.ZeroPad2d((0, 1, 0, 1)): one pixel on the right and bottom.
    x: [..., H, W]."""
    return F.pad(x, (0, 1, 0, 1))
