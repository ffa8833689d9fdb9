"""Post-training int8 quantization of the DiT matmul weights for serving
(counterpart of ``frameino_tpu/models/quant.py``).

Scheme: symmetric per-output-channel int8 weight scales, dynamic per-row
activation scales (``ops/linear.dense_int8``, whose activation quantizer
is K7). ``quantize_dit_int8(model)`` swaps, in place, the layers JAX's
``_QUANT_PATTERNS`` select, under their diffusers names:

- Wan: ``blocks.{i}.attn{1,2}.to_{q,k,v}``, ``...to_out.0``,
  ``blocks.{i}.ffn.net.0.proj`` and ``blocks.{i}.ffn.net.2`` (10 a block);
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
"""

from __future__ import annotations

import re

import torch
from torch import nn

from frameino_tpu_torch.ops.dyn_quant import INV_127, SCALE_FLOOR
from frameino_tpu_torch.ops.linear import dense, dense_int8

_QUANT_PATTERN = re.compile(
    r"(transformer_)?blocks\.\d+\."
    r"(attn[12]\.(to_[qkv]|to_out\.0)|ffn?\.net\.(0\.proj|2))")

VAE_NOT_PORTED = ("the int8 Wan VAE (quantize_vae, ops/conv.py::_conv_int8) "
                  "is not ported: ROADMAP.md queue 1, item 13")


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


def quantize_wan_vae_int8(vae):
    """The int8 w8a8 Wan VAE of the JAX package: not ported (raises)."""
    raise NotImplementedError(VAE_NOT_PORTED)
