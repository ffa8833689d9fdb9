"""Tensor-parallel sharding of the Wan DiT's parameters (counterpart of
``frameino_tpu/parallel/sharding.py``, its tp rules for the Wan DiT).

JAX writes its rules on the ``[in, out]`` dense kernels of the plain-dict
trees and lets GSPMD insert the collectives. Here they are written on
diffusers names and ``nn.Linear``'s ``[out, in]`` weights, and each rank
holds only its slice:

- column-parallel (``attn1/attn2.to_q/to_k/to_v``, ``ffn.net.0.proj``):
  the output dim (0) and the bias are cut over tp, so a rank computes its
  contiguous slice of the heads or of the FFN hidden width;
- row-parallel (``attn1/attn2.to_out.0``, ``ffn.net.2``): the input dim
  (1) is cut; the partial products are all-reduced over tp and the bias,
  replicated, is added once after the sum (``models/wan_dit.py``);
- the ``norm_q``/``norm_k`` gains ``[H*D]`` are cut to the rank's heads
  (JAX replicates them and GSPMD slices them where they are used);
- everything else is replicated.

The dp batch slice, taken in ``WanDiT.forward``, stands in for JAX's
``constrain(x, mesh, "tokens")``. fsdp, sp and pp are not ported
(``core/meshes.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from frameino_tpu_torch.core.meshes import Mesh

# (pattern over the full parameter name, the dim cut over tp)
_TP_RULES = (
    (re.compile(r"blocks\.\d+\.(attn[12]\.(to_[qkv]|norm_[qk])"
                r"|ffn\.net\.0\.proj)\.(weight|bias)"), 0),
    (re.compile(r"blocks\.\d+\.(attn[12]\.to_out\.0|ffn\.net\.2)\.weight"),
     1),
)


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` cut over tp, or None (replicated)."""
    for pat, dim in _TP_RULES:
        if pat.fullmatch(name):
            return dim
    return None


def shard_state_dict(sd: Dict[str, torch.Tensor],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full ``WanDiT`` state dict: the tp-cut
    parameters as contiguous copies of the rank's slice (so the full
    tensors can be freed), the rest as they are."""
    tp, r = mesh.tp, mesh.tp_rank
    out = {}
    for name, t in sd.items():
        dim = tp_dim(name)
        if dim is None or tp == 1:
            out[name] = t
            continue
        n = t.shape[dim]
        if n % tp:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                             f"not divide over tp={tp}")
        out[name] = t.narrow(dim, r * (n // tp), n // tp).clone()
    return out
