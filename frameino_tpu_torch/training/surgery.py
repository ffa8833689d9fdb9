"""Channel surgery: widen the patch embedding's input channels with zeros
(counterpart of ``frameino_tpu/training/surgery.py``).

Reference: Stage-1 finetuning replaces the pretrained patch embedding
with a zero-initialized wider one, copying the original weights into the
first input channels so the added condition channels start as no-ops
(``train_code/train_wan_motion.py:723-746``,
``train_code/train_cogvideox_motion.py:641-654``). The port's patch
embeddings are the diffusers convs, weight [D, C, *patch] (Wan's Conv3d,
CogVideoX's Conv2d), so the new channels are zero slices along dim 1.
"""

from __future__ import annotations

from typing import Dict

import torch


def expand_patch_embedding(weight: torch.Tensor,
                           new_in_channels: int) -> torch.Tensor:
    """[D, C_old, *patch] -> [D, C_new, *patch], the new channels zero."""
    d, c_old = weight.shape[:2]
    if new_in_channels < c_old:
        raise ValueError(f"cannot narrow {c_old} -> {new_in_channels} "
                         f"channels")
    pad = weight.new_zeros((d, new_in_channels - c_old, *weight.shape[2:]))
    return torch.cat([weight, pad], dim=1)


def wan_stage1_surgery(state_dict: Dict[str, torch.Tensor],
                       new_in: int = 96) -> Dict[str, torch.Tensor]:
    """A ``WanDiT`` state dict with the patch embedding widened to
    ``new_in`` input channels (48 -> 96 for the trajectory latents)."""
    out = dict(state_dict)
    out["patch_embedding.weight"] = expand_patch_embedding(
        state_dict["patch_embedding.weight"], new_in)
    return out


def cogvideox_stage1_surgery(state_dict: Dict[str, torch.Tensor],
                             new_in: int = 48) -> Dict[str, torch.Tensor]:
    """A ``CogVideoXDiT`` state dict with the patch embedding (the Conv2d
    ``patch_embed.proj``, weight [D, C, p, p]) widened to ``new_in`` input
    channels (32 -> 48 for the trajectory latents)."""
    out = dict(state_dict)
    out["patch_embed.proj.weight"] = expand_patch_embedding(
        state_dict["patch_embed.proj.weight"], new_in)
    return out
