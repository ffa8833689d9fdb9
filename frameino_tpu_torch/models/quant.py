"""Post-training int8 quantization of the DiT matmul weights for serving
(counterpart of ``frameino_tpu/models/quant.py``).

Scheme: symmetric per-output-channel int8 weight scales, dynamic per-row
activation scales (``ops/linear.dense_int8``, whose activation quantizer
is K7). ``quantize_dit_int8(model)`` swaps, in place, the layers JAX's
``_QUANT_PATTERNS`` select, under their diffusers names:

- Wan: ``blocks.{i}.attn{1,2}.to_{q,k,v}``, ``...to_out.0``,
  ``blocks.{i}.ffn.net.0.proj`` and ``blocks.{i}.ffn.net.2`` (10 a block;
  Wan2.1 I2V adds ``attn2.add_{k,v}_proj``, 12 a block);
- CogVideoX: ``transformer_blocks.{i}.attn1.to_{q,k,v}``, ``...to_out.0``,
  ``...ff.net.0.proj`` and ``...ff.net.2`` (6 a block).

Every other layer stays float: the patch embeddings, the condition and
time embedders, the AdaLN tables and ``norm*.linear`` layers,
``text_proj`` and ``proj_out``. The DiTs' ``_lin`` dispatches a
``QuantLinear`` to ``dense_int8``.

The weight quantizer is JAX's ``_quantize_kernel`` as the serving
pipelines run it (jitted on the device): upcast to fp32, absmax over the
input axis times the fp32-rounded 1/127, floor 1e-12, then
``clip(round(w / s), -127, 127)``.

``quantize_wan_vae_int8(vae)`` swaps, in place, the Wan VAE convs JAX's
``_VAE_CONV_NAMES`` select (``conv1``, ``conv2``, ``conv_shortcut``,
``time_conv`` and the resamplers' 2D conv, ``resample.1``, in encoder and
decoder) for ``QuantConv3d`` / ``QuantConv2d``: int8 weights with one fp32
scale per output channel, run by ``ops/conv`` on the w8a8 path (K14 on
the card). ``conv_in``, ``conv_out``, the attention's ``to_qkv`` / ``proj``
and ``quant_conv`` / ``post_quant_conv`` stay float. JAX quantizes the VAE
eagerly, so this scale DIVIDES the absmax by 127 (``_quantize_conv_kernel``
outside ``jit``), unlike the DiT's, and does so on either device: the
divisor is a tensor, since CUDA's true division by a host scalar
multiplies by its fp32 reciprocal.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from frameino_tpu_torch.ops import conv as cops
from frameino_tpu_torch.ops.conv_int8 import kernel_weight
from frameino_tpu_torch.ops.dyn_quant import INV_127, SCALE_FLOOR
from frameino_tpu_torch.ops.linear import dense, dense_int8

_QUANT_PATTERN = re.compile(
    r"(transformer_)?blocks\.\d+\."
    r"(attn[12]\.(to_[qkv]|to_out\.0)|attn2\.add_[kv]_proj"
    r"|ffn?\.net\.(0\.proj|2))")
_VAE_QUANT_PATTERN = re.compile(
    r"(encoder|decoder)\..*\.(conv1|conv2|conv_shortcut|time_conv"
    r"|resample\.1)")


def quantize_weight(w):
    """[out, in] float -> (int8 [out, in], fp32 scale [out])."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=1, keepdim=True)
                        * INV_127.to(wf.device), SCALE_FLOOR)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s.squeeze(1)


class QuantLinear(nn.Module):
    """An ``nn.Linear`` stand-in holding int8 ``weight_q [out, in]``, fp32
    ``scale [out]`` and the float ``bias`` (or None), all buffers."""

    def __init__(self, weight_q, scale, bias=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        weight_q, scale = quantize_weight(lin.weight.detach())
        return cls(weight_q, scale,
                   None if lin.bias is None else lin.bias.detach())

    def extra_repr(self) -> str:
        out_features, in_features = self.weight_q.shape
        return (f"in_features={in_features}, out_features={out_features}, "
                f"bias={self.bias is not None}")


def linear(x, layer, out_dtype=None):
    """x through a DiT layer: ``dense`` for an ``nn.Linear``, ``dense_int8``
    for a ``QuantLinear``."""
    if isinstance(layer, QuantLinear):
        return dense_int8(x, layer.weight_q, layer.scale, layer.bias,
                          out_dtype=out_dtype)
    return dense(x, layer.weight, layer.bias, out_dtype=out_dtype)


def quantized_layer_names(model: nn.Module, pattern=_QUANT_PATTERN):
    """Names of the ``nn.Linear`` layers whose whole name ``pattern``
    matches (by default those ``quantize_dit_int8`` swaps), in module
    order."""
    return [n for n, m in model.named_modules()
            if isinstance(m, nn.Linear) and pattern.fullmatch(n)]


@torch.no_grad()
def quantize_dit_int8(model: nn.Module, pattern=_QUANT_PATTERN
                      ) -> nn.Module:
    """Swap the DiT's block matmuls (or the layers another ``pattern``
    selects) for ``QuantLinear``, in place and one layer at a time; each
    float weight is freed as soon as its int8 copy exists (JAX's
    ``donate=True``), so the peak stays at the float model plus one
    layer's fp32 temporaries. Returns ``model``."""
    names = quantized_layer_names(model, pattern)
    if not names:
        raise ValueError("no layers matched the int8 quant patterns")
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, child, QuantLinear.from_linear(getattr(parent, child)))
    return model


def quantize_conv_weight(w):
    """[Cout, Cin, k...] float -> (int8 of the same shape, fp32 scale
    [Cout]): JAX's eager ``_quantize_conv_kernel``, the absmax over every
    axis but the output channel's divided by 127, correctly rounded on
    the CPU and on CUDA alike."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), SCALE_FLOOR)
    shape = (-1,) + (1,) * (wf.ndim - 1)
    q = torch.clamp(torch.round(wf / s.reshape(shape)), -127, 127)
    return q.to(torch.int8), s


class _QuantConv(nn.Module):
    """An int8 conv: ``weight_q`` in K14's layout ([Cout, kt, kh, kw, Cp]
    or, 2D, [Cout, kh, kw, Cp]: ``ops/conv_int8.kernel_weight``), fp32
    ``scale [Cout]`` and the float ``bias``, all buffers."""

    def __init__(self, weight_q, scale, bias=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_conv(cls, conv: nn.Module):
        weight_q, scale = quantize_conv_weight(conv.weight.detach())
        out = cls(kernel_weight(weight_q), scale,
                  None if conv.bias is None else conv.bias.detach())
        if hasattr(conv, "causal_padding"):
            out.causal_padding = conv.causal_padding
        return out

    def extra_repr(self) -> str:
        return (f"{self.weight_q.shape[-1]} (padded), "
                f"{self.weight_q.shape[0]}, "
                f"kernel_size={tuple(self.weight_q.shape[1:-1])}")


class QuantConv3d(_QuantConv):
    """The int8 stand-in of the VAE's ``CausalConv3d``."""

    causal_padding = (0, 0, 0)

    def forward(self, x):
        return cops.causal_conv3d(x, **cops.conv_weights(self),
                                  padding=self.causal_padding)


class QuantConv2d(_QuantConv):
    """The int8 stand-in of a resampler's ``nn.Conv2d`` (called through
    ``ops/conv.conv2d``)."""


def vae_quantized_layer_names(vae: nn.Module):
    """Names of the convs ``quantize_wan_vae_int8`` swaps (or has swapped),
    in module order."""
    return [n for n, m in vae.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Conv3d, _QuantConv))
            and _VAE_QUANT_PATTERN.fullmatch(n)]


@torch.no_grad()
def quantize_wan_vae_int8(vae: nn.Module) -> nn.Module:
    """Swap the Wan VAE's resblock and resampler convs for int8 ones, in
    place, one at a time (each float weight freed once its int8 copy
    exists). Returns ``vae``."""
    names = [n for n in vae_quantized_layer_names(vae)
             if not isinstance(vae.get_submodule(n), _QuantConv)]
    if not names:
        raise ValueError("no VAE conv kernels matched the int8 patterns")
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = vae.get_submodule(parent_name)
        conv = getattr(parent, child)
        cls = QuantConv3d if isinstance(conv, nn.Conv3d) else QuantConv2d
        quantized = cls.from_conv(conv)
        if isinstance(parent, nn.ModuleList):
            parent[int(child)] = quantized
        else:
            setattr(parent, child, quantized)
    return vae
