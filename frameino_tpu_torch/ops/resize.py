"""Separable antialiased resize, as ``jax.image.resize`` computes it.

``jax.image.resize(method="linear" | "bicubic")`` (antialias on by default)
builds, for each resized axis, an [n_in, n_out] fp32 weight matrix
(``jax._src.image.scale.compute_weight_mat``): output sample j sits at
(j + 0.5) * n_in / n_out - 0.5 of the input, the kernel is widened by
n_in / n_out when downsampling (a low-pass filter) and kept as it is when
upsampling, each column is normalised to sum 1, and columns whose sample
lies outside the input are zeroed. ``F.interpolate`` neither widens the
kernel nor (for bicubic) uses Keys' a = -0.5, so it gives other values.
"""

from __future__ import annotations

import numpy as np
import torch


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5."""
    f = np.float32
    near = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    far = ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0)
    return np.where(x >= f(2.0), f(0.0), np.where(x >= f(1.0), far, near))


_FILTERS = {"linear": _triangle, "cubic": _keys_cubic}


def scale_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_in, n_out] fp32 weights of one resized axis (``method``: "linear"
    or "cubic")."""
    f = np.float32
    inv = f(n_in / n_out)
    kscale = max(inv, f(1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = _FILTERS[method](x).astype(f)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def resize_antialiased(x, shape, method: str = "linear"):
    """Resize every axis of ``x`` whose size differs from ``shape``, one
    separable pass per axis, in x's dtype and on its device."""
    for d, n in enumerate(shape):
        if x.shape[d] == n:
            continue
        w = torch.from_numpy(scale_weights(x.shape[d], n, method)).to(
            x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
