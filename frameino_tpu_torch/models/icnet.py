"""IC9600 ICNet image-complexity model (counterpart of
``frameino_tpu/preprocess/icnet.py``; reference
``preprocess/auxiliary/ICNet.py``, weights: huggingface
``incantor/image_complexity_ic9600`` ``ck.pth``).

Two ResNet-18 branches: a *detail* branch on the 512px image cut after
layer2 and a *context* branch on a 256px downsample cut after layer4, each
block followed by a SLAM spatial-attention gate (a per-channel sigmoid
weight from the features resized to a fixed grid and flattened,
``ICNet.py:8-31``); both branches upsampled to size1/8 (align-corners
bilinear), concatenated, and fed to a 1x1-sigmoid complexity *map* head
and a pooled linear-sigmoid *score* head (``ICNet.py:79-150``). Module and
parameter names are ``ck.pth``'s, so the release loads with
``load_state_dict``; batch norm runs in eval mode (JAX folds it into a
scale and bias: the outputs are compared, not that form).

The stride-2 3x3 convolutions pad one pixel on each side, as torchvision's
ResNet-18 that ``ck.pth`` was trained with. JAX's ``_conv`` pads them
"SAME" (no pixel before, one after), which shifts their sampling grid by
one pixel (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frameino_tpu_torch.models import transnet as TN

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ICNetConfig:
    size1: int = 512     # detail-branch input (reference default)
    size2: int = 256     # context-branch input


ICNET = ICNetConfig()


def resize_align_corners(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, (size, size), mode="bilinear",
                         align_corners=True)


class BasicBlock(nn.Module):
    """torchvision's ResNet-18 block (conv1/bn1/relu/conv2/bn2 + skip)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, **kw):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(cout, **kw)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False, **kw),
                nn.BatchNorm2d(cout, **kw))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + idn)


def _layer(cin: int, cout: int, stride: int, **kw) -> nn.Sequential:
    return nn.Sequential(BasicBlock(cin, cout, stride, **kw),
                         BasicBlock(cout, cout, 1, **kw))


def _resnet_prefix(**kw) -> nn.Sequential:
    """torchvision resnet18 ``children()[:5]``: conv1, bn1, relu,
    maxpool, layer1 (indices 0-4, as in ``ck.pth``)."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 7, 2, 3, bias=False, **kw), nn.BatchNorm2d(64, **kw),
        nn.ReLU(), nn.MaxPool2d(3, 2, 1), _layer(64, 64, 1, **kw))


class Slam(nn.Module):
    def __init__(self, spatial_dim: int, **kw):
        super().__init__()
        self.spatial_dim = spatial_dim
        self.linear = nn.Sequential(
            nn.Linear(spatial_dim ** 2, 512, **kw), nn.ReLU(),
            nn.Linear(512, 1, **kw), nn.Sigmoid())

    def forward(self, x):
        n, c = x.shape[:2]
        f = resize_align_corners(x, self.spatial_dim).reshape(n, c, -1)
        return self.linear(f)[..., None] * x                # [n, c, 1, 1]


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2, **kw)
        self.bn = nn.BatchNorm2d(cout, **kw)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UpConvBnRelu(ConvBnRelu):
    def __init__(self, up_size: int, cin: int, cout: int, **kw):
        super().__init__(cin, cout, 1, **kw)
        self.up_size = up_size

    def forward(self, x):
        return super().forward(resize_align_corners(x, self.up_size))


class ToMap(nn.Module):
    def __init__(self, cin: int, **kw):
        super().__init__()
        self.to_map = nn.Sequential(nn.Conv2d(cin, 1, 1, **kw), nn.Sigmoid())

    def forward(self, x):
        return self.to_map(x)


class ICNet(nn.Module):
    def __init__(self, cfg: ICNetConfig = ICNET, **kw):
        super().__init__()
        self.cfg = cfg
        self.b1_1, self.b1_1_slam = _resnet_prefix(**kw), Slam(32, **kw)
        self.b1_2, self.b1_2_slam = _layer(64, 128, 2, **kw), Slam(32, **kw)
        self.b2_1, self.b2_1_slam = _resnet_prefix(**kw), Slam(32, **kw)
        self.b2_2, self.b2_2_slam = _layer(64, 128, 2, **kw), Slam(32, **kw)
        self.b2_3, self.b2_3_slam = _layer(128, 256, 2, **kw), Slam(16, **kw)
        self.b2_4, self.b2_4_slam = _layer(256, 512, 2, **kw), Slam(8, **kw)
        up = cfg.size1 // 8
        self.up1 = UpConvBnRelu(up, 128, 256, **kw)
        self.up2 = UpConvBnRelu(up, 512, 256, **kw)
        self.to_map_f = ConvBnRelu(512, 512, 3, **kw)
        self.to_map_f_slam = Slam(32, **kw)
        self.to_map = ToMap(512, **kw)
        self.to_score_f = ConvBnRelu(512, 512, 3, **kw)
        self.to_score_f_slam = Slam(32, **kw)
        self.head = nn.Sequential(nn.Linear(512, 512, **kw), nn.ReLU(),
                                  nn.Linear(512, 1, **kw), nn.Sigmoid())

    def forward(self, x: torch.Tensor):
        """x: [N, 3, size1, size1] normalized (ImageNet stats) -> (score
        [N], complexity map [N, 1, size1/8, size1/8])
        (``ICNet.py:131-150``)."""
        if x.shape[-2:] != (self.cfg.size1, self.cfg.size1):
            raise ValueError(f"ICNet takes [N, 3, {self.cfg.size1}, "
                             f"{self.cfg.size1}], got {tuple(x.shape)}")
        x2 = resize_align_corners(x, self.cfg.size2)
        d = self.b1_1_slam(self.b1_1(x))
        d = self.b1_2_slam(self.b1_2(d))
        c = self.b2_1_slam(self.b2_1(x2))
        c = self.b2_2_slam(self.b2_2(c))
        c = self.b2_3_slam(self.b2_3(c))
        c = self.b2_4_slam(self.b2_4(c))
        x_cat = torch.cat([self.up1(d), self.up2(c)], dim=1)
        cly_map = self.to_map(self.to_map_f_slam(self.to_map_f(x_cat)))
        s = self.to_score_f_slam(self.to_score_f(x_cat)).mean(dim=(2, 3))
        return self.head(s)[:, 0], cly_map


def init_icnet(cfg: ICNetConfig, generator: torch.Generator) -> ICNet:
    """A seeded random ICNet (``transnet.init_random``) in eval mode."""
    return TN.init_random(ICNet(cfg, device="meta"), generator)


def _put_conv(sd: StateDict, name: str, p):
    sd[f"{name}.weight"] = TN.conv_from_jax(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = TN._t(p["b"])


def _put_bn(sd: StateDict, name: str, p):
    TN.put_batch_norm(sd, name, {"weight": p["scale"], "bias": p["bias"],
                                 "mean": p["mean"], "var": p["var"]})


def _put_lin(sd: StateDict, name: str, p):
    TN.put_linear(sd, name, {"kernel": p["w"], "bias": p["b"]})


def icnet_from_jax(params) -> StateDict:
    """JAX ``init_icnet`` / ``icnet_from_state_dict`` tree -> the ``ICNet``
    state dict (``ck.pth``'s names)."""
    sd: StateDict = {}

    def block(name, p):
        for k in ("conv1", "conv2"):
            _put_conv(sd, f"{name}.{k}", p[k])
        for k in ("bn1", "bn2"):
            _put_bn(sd, f"{name}.{k}", p[k])
        if "down_conv" in p:
            _put_conv(sd, f"{name}.downsample.0", p["down_conv"])
            _put_bn(sd, f"{name}.downsample.1", p["down_bn"])

    def layer(name, p):
        block(f"{name}.0", p["0"])
        block(f"{name}.1", p["1"])

    for name, p in params.items():
        if name.endswith("_slam"):
            _put_lin(sd, f"{name}.linear.0", p["l0"])
            _put_lin(sd, f"{name}.linear.2", p["l1"])
        elif name in ("b1_1", "b2_1"):
            _put_conv(sd, f"{name}.0", p["conv1"])
            _put_bn(sd, f"{name}.1", p["bn1"])
            layer(f"{name}.4", p["layer1"])
        elif name in ("b1_2", "b2_2", "b2_3", "b2_4"):
            layer(name, p)
        elif name in ("up1", "up2", "to_map_f", "to_score_f"):
            _put_conv(sd, f"{name}.conv", p["conv"])
            _put_bn(sd, f"{name}.bn", p["bn"])
        elif name == "to_map":
            _put_conv(sd, "to_map.to_map.0", p)
        elif name in ("head0", "head1"):
            _put_lin(sd, f"head.{2 * int(name[-1])}", p)
        else:
            raise KeyError(f"unknown ICNet entry {name!r}")
    return sd


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_complexity_scorer(model: ICNet):
    """image uint8 RGB [H, W, 3] -> complexity score in [0, 1] (the
    reference's IC_inference_transform: resize to size1 + ImageNet
    normalization on the host, ``scoring_img.py:109-113``), for
    ``image_scoring.complexity_score(model=)`` /
    ``score_images(full=True, complexity_model=)``."""
    import cv2
    model.eval()
    dev, size = TN.model_device(model), model.cfg.size1

    @torch.no_grad()
    def score(image: np.ndarray) -> float:
        img = cv2.resize(image, (size, size), interpolation=cv2.INTER_LINEAR)
        img = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        x = torch.from_numpy(img).permute(2, 0, 1)[None].to(dev)
        return float(model(x)[0][0])

    return score
