"""TransNetV2 shot-boundary model (counterpart of
``frameino_tpu/preprocess/transnet.py``; reference
``preprocess/auxiliary/TransNetV2.py``, the public soCzech/TransNetV2
architecture the AutoShot supernet builds on).

- (2+1)D separable convs: (1,3,3) spatial then (3,1,1) temporal with
  dilation d in {1,2,4,8}, concatenated -> BatchNorm(eps 1e-3) -> relu
  (``DilatedDCNNV2``); two per stack with a pre-activation shortcut and
  (1,2,2) average pooling (``StackedDDCNNV2``); three stacks F=16/32/64.
- FrameSimilarity: L2-normalized projected per-frame features (all
  stacks, spatially averaged), cosine-similarity matrix, banded
  101-wide lookup, linear+relu.
- ColorHistograms: 512-bin RGB histogram (3 bits/channel) per frame,
  L2-normalized, same banded-similarity head.
- Head: the flattened 3x6 spatial grid + the two 128-d similarity
  features -> fc1(1024) relu -> single-logit (+ many-hot) classifiers.

Input contract: uint8 [B, T, 27, 48, 3]. Module and parameter names are
the public checkpoint's, so a release loads with ``load_state_dict``;
``transnet_from_jax`` carries a JAX ``init_transnet`` tree across. The
pieces here (``banded_lookup``, ``color_histograms``, ``FrameSimilarity``,
``ColorHistograms``) are AutoShot's too (``models/autoshot.py``). Every
operation is a cuDNN convolution, a pooling, a product or a gather: JAX
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransNetV2Config:
    filters: int = 16            # F
    num_stacks: int = 3          # L
    blocks_per_stack: int = 2    # S
    hidden_dim: int = 1024       # D
    lookup_window: int = 101
    similarity_dim: int = 128
    sim_output_dim: int = 128
    use_many_hot: bool = True
    bn_eps: float = 1e-3


TRANSNETV2 = TransNetV2Config()

DILATIONS = (1, 2, 4, 8)


def banded_lookup(sim: torch.Tensor, window: int) -> torch.Tensor:
    """[B, T, T] similarity matrix -> [B, T, window] band centred on the
    diagonal, zero-padded at the edges (the reference's gather)."""
    B, T, _ = sim.shape
    half = (window - 1) // 2
    padded = F.pad(sim, (half, half))
    idx = (torch.arange(T, device=sim.device)[:, None]
           + torch.arange(window, device=sim.device)[None, :])
    return padded.gather(2, idx.expand(B, T, window))


def color_histograms(frames_uint8: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] uint8 -> [B, T, 512] L2-normalized RGB histograms
    (3 bits per channel, reference ``compute_color_histograms``). The
    counts and their squares' sum are integers under 2^24, so the fp32
    result is exact."""
    f = frames_uint8.to(torch.int64)
    bins = ((f[..., 0] >> 5) << 6) + ((f[..., 1] >> 5) << 3) \
        + (f[..., 2] >> 5)                                  # [B,T,H,W]
    B, T = bins.shape[:2]
    flat = bins.reshape(B * T, -1)
    hist = torch.zeros(B * T, 512, device=flat.device).scatter_add_(
        1, flat, torch.ones(flat.shape, device=flat.device))
    hist = hist.reshape(B, T, 512)
    return hist / hist.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class WrappedLinear(nn.Module):
    """AutoShot's ``Linear_``: an ``nn.Linear`` held as ``.linear`` (the
    released checkpoint's names)."""

    def __init__(self, i: int, o: int, **kw):
        super().__init__()
        self.linear = nn.Linear(i, o, **kw)

    def forward(self, x):
        return self.linear(x)


def _linear(wrapped: bool):
    return WrappedLinear if wrapped else nn.Linear


class FrameSimilarity(nn.Module):
    """Projected, L2-normalized per-frame features (each block's output
    averaged over space) -> cosine similarities -> banded lookup ->
    linear + relu."""

    def __init__(self, in_filters: int, window: int, similarity_dim: int,
                 output_dim: int, wrapped: bool = False, **kw):
        super().__init__()
        lin = _linear(wrapped)
        self.window = window
        self.projection = lin(in_filters, similarity_dim, **kw)
        self.fc = lin(window, output_dim, **kw)

    def forward(self, block_features):
        x = torch.cat([f.mean(dim=(3, 4)) for f in block_features], dim=1)
        x = self.projection(x.transpose(1, 2))              # [B, T, sim]
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        sim = torch.bmm(x, x.transpose(1, 2))
        return F.relu(self.fc(banded_lookup(sim, self.window)))


class ColorHistograms(nn.Module):
    """RGB histogram similarities -> banded lookup -> linear + relu."""

    def __init__(self, window: int, output_dim: int, wrapped: bool = False,
                 **kw):
        super().__init__()
        self.window = window
        self.fc = _linear(wrapped)(window, output_dim, **kw)

    def forward(self, frames_uint8):
        h = color_histograms(frames_uint8)
        sim = torch.bmm(h, h.transpose(1, 2))
        return F.relu(self.fc(banded_lookup(sim, self.window)))


def avg_pool_122(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool3d(x, (1, 2, 2))


class Conv3DConfigurable(nn.Module):
    """Separable conv: ``layers.0`` (1,3,3) spatial to 2F channels,
    ``layers.1`` (3,1,1) temporal with dilation d, both without bias
    (the released model has batch norm after them)."""

    def __init__(self, in_filters: int, filters: int, dilation: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Conv3d(in_filters, 2 * filters, (1, 3, 3), padding=(0, 1, 1),
                      bias=False, **kw),
            nn.Conv3d(2 * filters, filters, (3, 1, 1),
                      dilation=(dilation, 1, 1), padding=(dilation, 0, 0),
                      bias=False, **kw)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class DilatedDCNNV2(nn.Module):
    def __init__(self, in_filters: int, filters: int, eps: float,
                 activation: bool, **kw):
        super().__init__()
        for d in DILATIONS:
            setattr(self, f"Conv3D_{d}",
                    Conv3DConfigurable(in_filters, filters, d, **kw))
        self.bn = nn.BatchNorm3d(4 * filters, eps=eps, **kw)
        self.activation = activation

    def forward(self, x):
        y = torch.cat([getattr(self, f"Conv3D_{d}")(x) for d in DILATIONS],
                      dim=1)
        y = self.bn(y)
        return F.relu(y) if self.activation else y


class StackedDDCNNV2(nn.Module):
    def __init__(self, in_filters: int, filters: int, blocks: int,
                 eps: float, **kw):
        super().__init__()
        self.DDCNN = nn.ModuleList([
            DilatedDCNNV2(in_filters if j == 0 else 4 * filters, filters,
                          eps, activation=j != blocks - 1, **kw)
            for j in range(blocks)])

    def forward(self, x):
        shortcut = None
        for block in self.DDCNN:
            x = block(x)
            if shortcut is None:
                shortcut = x
        return avg_pool_122(F.relu(x) + shortcut)


def stack_channels(cfg: TransNetV2Config):
    """(in, F) of each stack."""
    chans, cin = [], 3
    for i in range(cfg.num_stacks):
        f = cfg.filters * 2 ** i
        chans.append((cin, f))
        cin = 4 * f
    return chans


class TransNetV2(nn.Module):
    def __init__(self, cfg: TransNetV2Config = TRANSNETV2, **kw):
        super().__init__()
        self.cfg = cfg
        chans = stack_channels(cfg)
        self.SDDCNN = nn.ModuleList([
            StackedDDCNNV2(cin, f, cfg.blocks_per_stack, cfg.bn_eps, **kw)
            for cin, f in chans])
        self.frame_sim_layer = FrameSimilarity(
            sum(4 * f for _, f in chans), cfg.lookup_window,
            cfg.similarity_dim, cfg.sim_output_dim, **kw)
        self.color_hist_layer = ColorHistograms(
            cfg.lookup_window, cfg.sim_output_dim, **kw)
        top = 4 * chans[-1][1]
        self.fc1 = nn.Linear(top * 3 * 6 + 2 * cfg.sim_output_dim,
                             cfg.hidden_dim, **kw)
        self.cls_layer1 = nn.Linear(cfg.hidden_dim, 1, **kw)
        self.cls_layer2 = (nn.Linear(cfg.hidden_dim, 1, **kw)
                           if cfg.use_many_hot else None)

    def forward(self, frames_uint8: torch.Tensor):
        """frames: uint8 [B, T, 27, 48, 3] -> (logits [B, T, 1],
        many_hot [B, T, 1] | None). Sigmoid for cut probabilities."""
        x = frames_uint8.permute(0, 4, 1, 2, 3).float() / 255.0
        block_features = []
        for stack in self.SDDCNN:
            x = stack(x)
            block_features.append(x)
        B, T = x.shape[0], x.shape[2]
        feat = x.permute(0, 2, 3, 4, 1).reshape(B, T, -1)   # (H, W, C)
        feat = torch.cat([self.frame_sim_layer(block_features), feat], -1)
        feat = torch.cat([self.color_hist_layer(frames_uint8), feat], -1)
        h = F.relu(self.fc1(feat))
        many = self.cls_layer2(h) if self.cls_layer2 is not None else None
        return self.cls_layer1(h), many


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights on ``generator``'s device, He-scaled so that the
    activations keep their size through depth: convolutions N(0, 2 /
    fan_in), linears N(0, 1 / fan_in), biases N(0, 0.01); batch norms
    near the identity (weight 1 + N(0, 0.1), bias and running mean N(0,
    0.05), running variance 1 + U(0, 0.1))."""
    model.to_empty(device=generator.device)
    dev = generator.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            gain = 1.0 if isinstance(m, nn.Linear) else 2.0
            m.weight.copy_(randn(m.weight.shape) * (gain / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.copy_(0.01 * randn(m.bias.shape))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.copy_(1.0 + 0.1 * randn(m.weight.shape))
            m.bias.copy_(0.05 * randn(m.bias.shape))
            m.running_mean.copy_(0.05 * randn(m.running_mean.shape))
            m.running_var.copy_(1.0 + 0.1 * torch.rand(
                m.running_var.shape, generator=generator, device=dev))
            m.num_batches_tracked.zero_()
    return model.eval()


def init_transnet(cfg: TransNetV2Config, generator: torch.Generator
                  ) -> TransNetV2:
    """A seeded random TransNetV2 (``init_random``) in eval mode."""
    return init_random(TransNetV2(cfg, device="meta"), generator)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def conv_from_jax(kernel) -> torch.Tensor:
    """JAX THWIO (or HWIO) kernel -> torch OI(D)HW."""
    k = np.asarray(kernel)
    return _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))


def put_linear(sd: StateDict, name: str, p):
    """JAX dense {kernel [in, out], bias} -> ``name.weight``/``.bias``."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def put_batch_norm(sd: StateDict, name: str, p):
    """JAX {weight, bias, mean, var} -> a torch BatchNorm's entries."""
    sd[f"{name}.weight"] = _t(p["weight"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def transnet_from_jax(params, cfg: TransNetV2Config = TRANSNETV2
                      ) -> StateDict:
    """JAX ``init_transnet`` / ``transnet_from_state_dict`` tree (numpy or
    JAX arrays) -> the ``TransNetV2`` state dict (the public names that
    JAX's ``transnet_from_state_dict`` reads)."""
    sd: StateDict = {}
    for i, sp in enumerate(params["stacks"]):
        for j, blk in enumerate(sp["blocks"]):
            b = f"SDDCNN.{i}.DDCNN.{j}."
            for d in DILATIONS:
                for k, part in enumerate(("spatial", "temporal")):
                    sd[b + f"Conv3D_{d}.layers.{k}.weight"] = conv_from_jax(
                        blk[f"d{d}"][part]["kernel"])
            put_batch_norm(sd, b + "bn", blk["bn"])
    put_linear(sd, "frame_sim_layer.projection",
               params["frame_sim"]["projection"])
    put_linear(sd, "frame_sim_layer.fc", params["frame_sim"]["fc"])
    put_linear(sd, "color_hist_layer.fc", params["color_hist"]["fc"])
    put_linear(sd, "fc1", params["fc1"])
    put_linear(sd, "cls_layer1", params["cls1"])
    if "cls2" in params:
        put_linear(sd, "cls_layer2", params["cls2"])
    return sd


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def resize_27x48(frames: np.ndarray) -> np.ndarray:
    """[F, H, W, 3] uint8 -> [F, 27, 48, 3] (cv2's bilinear resize, the
    reference's scoring script's)."""
    import cv2
    return np.stack([cv2.resize(f, (48, 27)) for f in frames])


def make_transnet_scorer(model: TransNetV2, window: int = 100,
                         overlap: int = 30):
    """Callable for ``scene_cut.score_scene_cuts``: [F, H, W, 3] uint8 (any
    resolution; resized to 27x48 on the host) -> [F] cut probabilities,
    scored in overlapping temporal windows on the model's device and
    averaged where they overlap, as JAX's ``make_transnet_scorer``."""
    model.eval()
    dev = model_device(model)

    @torch.no_grad()
    def score(frames: np.ndarray) -> np.ndarray:
        small = resize_27x48(frames)
        n = len(small)
        probs = np.zeros((n,), np.float32)
        counts = np.zeros((n,), np.float32)
        step = max(1, window - overlap)
        for s in range(0, n, step):
            chunk = torch.from_numpy(small[s:s + window][None]).to(dev)
            logits = model(chunk)[0][0, :, 0].float().cpu().numpy()
            p = 1.0 / (1.0 + np.exp(-logits))
            probs[s:s + len(p)] += p
            counts[s:s + len(p)] += 1.0
            if s + window >= n:
                break
        return probs / np.maximum(counts, 1.0)

    return score
