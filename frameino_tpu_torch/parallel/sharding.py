"""Tensor-parallel sharding of the DiTs' parameters (counterpart of
``frameino_tpu/parallel/sharding.py``, its tp rules for the Wan and
CogVideoX DiTs).

JAX writes its rules on the ``[in, out]`` dense kernels of the plain-dict
trees and lets GSPMD insert the collectives. Here they are written on
diffusers names and ``nn.Linear``'s ``[out, in]`` weights, and each rank
holds only its slice:

- column-parallel (Wan ``blocks.N.attn1/attn2.to_q/to_k/to_v`` and
  ``ffn.net.0.proj``; CogVideoX ``transformer_blocks.N.attn1.to_q/to_k/
  to_v`` and ``ff.net.0.proj``): the output dim (0) and the bias are cut
  over tp, so a rank computes its contiguous slice of the heads or of the
  FFN hidden width;
- row-parallel (Wan ``attn1/attn2.to_out.0``, ``ffn.net.2``; CogVideoX
  ``attn1.to_out.0``, ``ff.net.2``): the input dim (1) is cut; the partial
  products are all-reduced over tp and the bias, replicated, is added once
  after the sum (``row_parallel``);
- Wan's ``norm_q``/``norm_k`` gains ``[H*D]`` are cut to the rank's heads
  (JAX replicates them and GSPMD slices them where they are used);
  CogVideoX's per-head LayerNorm ``[D]``, shared by every head, is
  replicated;
- everything else is replicated.

The dp batch slice (``run_dp``) and the sp token slice
(``ops/attention.sequence_cut``), taken in the DiTs' forwards, stand in
for JAX's ``constrain(x, mesh, "tokens")``. fsdp and pp are not
ported (``core/meshes.py``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.models.quant import linear
from frameino_tpu_torch.ops.linear import dense

# (pattern over the full parameter name, the dim cut over tp)
_TP_RULES = (
    # Wan
    (re.compile(r"blocks\.\d+\.(attn[12]\.(to_[qkv]|norm_[qk])"
                r"|ffn\.net\.0\.proj)\.(weight|bias)"), 0),
    (re.compile(r"blocks\.\d+\.(attn[12]\.to_out\.0|ffn\.net\.2)\.weight"),
     1),
    # CogVideoX
    (re.compile(r"transformer_blocks\.\d+\.(attn1\.to_[qkv]"
                r"|ff\.net\.0\.proj)\.(weight|bias)"), 0),
    (re.compile(r"transformer_blocks\.\d+\.(attn1\.to_out\.0|ff\.net\.2)"
                r"\.weight"), 1),
)


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` cut over tp, or None (replicated)."""
    for pat, dim in _TP_RULES:
        if pat.fullmatch(name):
            return dim
    return None


def shard_state_dict(sd: Dict[str, torch.Tensor],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full ``WanDiT`` or ``CogVideoXDiT`` state
    dict: the tp-cut
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


def row_parallel(x, layer, group):
    """A row-parallel layer on one tp rank: ``layer`` holds the rank's
    input rows of the weight and the whole bias; the rank's fp32 partial
    product is summed over ``group`` and the bias added once, after the
    sum. ``group`` None (tp = 1): the layer as it is."""
    if group is None:
        return linear(x, layer)
    y = dense(x, layer.weight, out_dtype=torch.float32)
    dist.all_reduce(y, group=group)
    return (y + layer.bias.float()).to(x.dtype)


def run_dp(mesh: Mesh, batch: int, run: Callable[[slice], torch.Tensor]):
    """``run(sl)`` on this dp rank's contiguous slice ``sl`` of a batch of
    ``batch``, then every dp rank's output joined along dim 0, in dp rank
    order, by an all-gather over the dp group."""
    dp, r = mesh.dp, mesh.dp_rank
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over dp={dp}")
    out = run(slice(r * (batch // dp), (r + 1) * (batch // dp)))
    parts = [torch.empty_like(out) for _ in range(dp)]
    dist.all_gather(parts, out, group=mesh.dp_group)
    return torch.cat(parts)
