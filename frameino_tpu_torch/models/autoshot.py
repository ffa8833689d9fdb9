"""AutoShot shot-boundary supernet at its released widths (counterpart of
``frameino_tpu/preprocess/autoshot.py``; reference
``preprocess/auxiliary/AutoShot.py`` ``TransNetV2Supernet``, driven by
``preprocess/scoring_scene_cut_autoshot.py:46-186``).

The searched architecture the released checkpoint instantiates
(``AutoShot.py:70-127``): six dilated-(2+1)D-conv layers, three of them
type A (one (1,3,3) conv shared by five dilated (3,1,1) branches), with
residual adds + (1,2,2) average pools after layers 1/3/5, then the
TransNetV2 frame-similarity (448->128) and color-histogram (->128)
banded features (``models/transnet.py``) and a 4864->1024 head with
one-hot / many-hot logits. The supernet's attention branch and ``fc1``
do not run at inference; ``load_autoshot`` drops their keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.models import transnet as TN

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AutoShotConfig:
    lookup_window: int = 101
    bn_eps: float = 1e-3
    hidden: int = 1024
    similarity_dim: int = 128
    sim_output_dim: int = 128
    # (in_ch, filters, multiplier, n_dilation, shared-spatial?)
    layers: tuple = ((3, 16, 1, 4, False),
                     (64, 16, 4, 5, True),
                     (64, 32, 4, 5, True),
                     (128, 32, 4, 5, True),
                     (128, 64, 3, 5, False),
                     (256, 64, 2, 5, False))


AUTOSHOT = AutoShotConfig()

LAYER_NAMES = ("Layer_0_3", "Layer_1_8", "Layer_2_8", "Layer_3_8",
               "Layer_4_13", "Layer_5_12")

# the supernet's branches that never run at inference (``AutoShot.py:645``)
DEAD_PREFIXES = ("Layer_6_0.", "fc1.")


def branch_filters(filters: int, n_dilation: int) -> List[int]:
    """filters*4 split across dilation branches; the last branch takes
    the remainder (``AutoShot.py:528-550``)."""
    per = (filters * 4) // n_dilation
    return [per] * (n_dilation - 1) + [filters * 4 - per * (n_dilation - 1)]


class _Branch(nn.Module):
    """``Conv3DConfigurable``: its own (1,3,3) conv (``layers.0``) unless
    the layer shares one, then the dilated (3,1,1) conv."""

    def __init__(self, cin: int, mid: int, filters: int, dilation: int,
                 shared: bool, **kw):
        super().__init__()
        convs = [] if shared else [
            nn.Conv3d(cin, mid, (1, 3, 3), padding=(0, 1, 1), bias=False,
                      **kw)]
        convs.append(nn.Conv3d(mid, filters, (3, 1, 1),
                               dilation=(dilation, 1, 1),
                               padding=(dilation, 0, 0), bias=False, **kw))
        self.layers = nn.ModuleList(convs)

    def forward(self, x):
        for conv in self.layers:
            x = conv(x)
        return x


class DilatedLayer(nn.Module):
    """``DilatedDCNNV2`` (shared=False) / ``DilatedDCNNV2ABC`` type A
    (shared=True): branches concatenated -> BatchNorm -> relu."""

    def __init__(self, spec, eps: float, **kw):
        super().__init__()
        cin, filters, mult, n_dil, shared = spec
        mid = mult * filters
        self.share = (nn.Conv3d(cin, mid, (1, 3, 3), padding=(0, 1, 1),
                                bias=False, **kw) if shared else None)
        self.conv_blocks = nn.ModuleList([
            _Branch(cin, mid, bf, 2 ** i, shared, **kw)
            for i, bf in enumerate(branch_filters(filters, n_dil))])
        self.batch_norm = nn.BatchNorm3d(filters * 4, eps=eps, **kw)

    def forward(self, x):
        src = self.share(x) if self.share is not None else x
        y = torch.cat([b(src) for b in self.conv_blocks], dim=1)
        return F.relu(self.batch_norm(y))


class AutoShot(nn.Module):
    def __init__(self, cfg: AutoShotConfig = AUTOSHOT, **kw):
        super().__init__()
        self.cfg = cfg
        for name, spec in zip(LAYER_NAMES, cfg.layers):
            setattr(self, name, DilatedLayer(spec, cfg.bn_eps, **kw))
        feats = [4 * spec[1] for spec in cfg.layers[1::2]]
        self.frame_sim_layer = TN.FrameSimilarity(
            sum(feats), cfg.lookup_window, cfg.similarity_dim,
            cfg.sim_output_dim, wrapped=True, **kw)
        self.color_hist_layer = TN.ColorHistograms(
            cfg.lookup_window, cfg.sim_output_dim, wrapped=True, **kw)
        self.fc1_0 = TN.WrappedLinear(
            feats[-1] * 3 * 6 + 2 * cfg.sim_output_dim, cfg.hidden, **kw)
        self.cls_layer1 = TN.WrappedLinear(cfg.hidden, 1, **kw)
        self.cls_layer2 = TN.WrappedLinear(cfg.hidden, 1, **kw)

    def forward(self, frames_uint8: torch.Tensor):
        """frames: uint8 [B, T, 27, 48, 3] -> (one_hot [B, T, 1],
        many_hot [B, T, 1]). Sigmoid for cut probabilities
        (``AutoShot.py:145-216``)."""
        x = frames_uint8.permute(0, 4, 1, 2, 3).float() / 255.0
        shortcut = None
        block_features = []
        for i, name in enumerate(LAYER_NAMES[:len(self.cfg.layers)]):
            x = getattr(self, name)(x)
            if i % 2 == 0:
                shortcut = x
            else:
                x = TN.avg_pool_122(shortcut + x)
                block_features.append(x)
        B, T = x.shape[0], x.shape[2]
        feat = x.permute(0, 2, 3, 4, 1).reshape(B, T, -1)   # (H, W, C)
        feat = torch.cat([self.frame_sim_layer(block_features), feat], -1)
        feat = torch.cat([self.color_hist_layer(frames_uint8), feat], -1)
        h = F.relu(self.fc1_0(feat))
        return self.cls_layer1(h), self.cls_layer2(h)


def init_autoshot(cfg: AutoShotConfig, generator: torch.Generator
                  ) -> AutoShot:
    """A seeded random AutoShot (``transnet.init_random``) in eval mode."""
    return TN.init_random(AutoShot(cfg, device="meta"), generator)


def autoshot_from_jax(params, cfg: AutoShotConfig = AUTOSHOT) -> StateDict:
    """JAX ``init_autoshot`` / ``autoshot_from_state_dict`` tree -> the
    ``AutoShot`` state dict (the released names)."""
    sd: StateDict = {}
    for li, spec in enumerate(cfg.layers):
        name, lp, shared = LAYER_NAMES[li], params[f"layer{li}"], spec[4]
        if shared:
            sd[f"{name}.share.weight"] = TN.conv_from_jax(
                lp["share"]["kernel"])
        for i in range(spec[3]):
            parts = ("temporal",) if shared else ("spatial", "temporal")
            for k, part in enumerate(parts):
                sd[f"{name}.conv_blocks.{i}.layers.{k}.weight"] = \
                    TN.conv_from_jax(lp[f"b{i}"][part]["kernel"])
        TN.put_batch_norm(sd, f"{name}.batch_norm", lp["bn"])
    for name, key in (("frame_sim_layer.projection", ("frame_sim",
                                                      "projection")),
                      ("frame_sim_layer.fc", ("frame_sim", "fc")),
                      ("color_hist_layer.fc", ("color_hist", "fc")),
                      ("fc1_0", ("fc1_0",)), ("cls_layer1", ("cls1",)),
                      ("cls_layer2", ("cls2",))):
        p = params
        for k in key:
            p = p[k]
        TN.put_linear(sd, f"{name}.linear", p)
    return sd


def read_torch_checkpoint(path: str) -> StateDict:
    """A released ``.pth``: a plain state dict or one under ``model`` /
    ``state_dict`` / ``net``, ``module.`` prefixes stripped
    (``scoring_scene_cut_autoshot.py:112-121``). Read with
    ``weights_only=True``: tensors only, no pickled code (JAX reads with
    ``weights_only=False``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "net"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k.removeprefix("module."): torch.as_tensor(v)
            for k, v in ckpt.items()}


def load_autoshot(checkpoint_path: str, cfg: AutoShotConfig = AUTOSHOT,
                  device: Optional[str] = "cuda") -> AutoShot:
    """The released AutoShot ``.pth`` as an eval-mode module on
    ``device``. The dead supernet branches' keys are dropped; any other key
    the module lacks, or any key of the module the file lacks, raises."""
    sd = read_torch_checkpoint(checkpoint_path)
    model = AutoShot(cfg)
    own = model.state_dict()
    extra = [k for k in sd if k not in own and not k.startswith(
        DEAD_PREFIXES)]
    missing = [k for k in own if k not in sd]
    if extra or missing:
        raise KeyError(f"{checkpoint_path} is not an AutoShot checkpoint: "
                       f"missing {missing[:5]}, unexpected {extra[:5]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model.to(device).eval()


def make_autoshot_scorer(model: AutoShot, window: int = 100, pad: int = 25):
    """frames uint8 [T, H, W, 3] (resized to 27x48 on the host) ->
    per-frame cut probabilities [T]: the reference's sliding-window
    inference, which keeps the middle 50 of each 100-frame window
    (``scoring_scene_cut_autoshot.py:46-96``), on the model's device."""
    model.eval()
    dev = TN.model_device(model)

    @torch.no_grad()
    def score(frames: np.ndarray) -> np.ndarray:
        frames = TN.resize_27x48(frames)
        T = frames.shape[0]
        padded = np.concatenate([frames[:1].repeat(pad, 0), frames,
                                 frames[-1:].repeat(pad + window, 0)])
        out = []
        for start in range(0, T, window - 2 * pad):
            win = torch.from_numpy(padded[start:start + window][None]).to(dev)
            probs = torch.sigmoid(model(win)[0][0, :, 0])
            out.append(probs.float().cpu().numpy()[pad:window - pad])
        return np.concatenate(out)[:T]

    return score
