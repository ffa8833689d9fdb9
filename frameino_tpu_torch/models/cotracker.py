"""CoTracker3-offline point tracker (counterpart of
``frameino_tpu/models/cotracker.py``).

The reference drives CoTracker3 through ``torch.hub`` for the INO_Traj
metric (``evaluation/evaluate_INO_Traj.py:79,176``). Module and parameter
names are the released checkpoint's (``cotracker_base.py``
CoTrackerThreeOffline; ``scaled_offline.pth['model']``), so its state
dict loads with ``load_state_dict``. The graph is the JAX module's:

  BasicEncoder CNN (stride 4, 128-d, instance norm, 4 residual stages
  fused at 1/4 resolution) -> channel-L2-normalized feature maps -> a
  4-level average-pool pyramid -> per-query 7x7 support features at the
  query frame -> 6 refinement iterations: 7x7-patch correlation volumes
  (49x49) through the shared corr MLP per level, [vis, conf, corr
  embeddings, sinusoidal relative-motion encoding] tokens (1110-d) plus
  the interpolated time embedding -> EfficientUpdateFormer (3 time blocks
  interleaved with 3 space bottlenecks through 64 virtual tracks) ->
  additive (coords, vis, conf) deltas; sigmoid on read-out.

Sampling is ``F.grid_sample(align_corners=True, padding_mode="border")``
(JAX gathers the same taps, ``cotracker.py:155``); the refinement is a
Python loop for JAX's ``lax.scan``. Both the corr MLP and the transformer
MLPs use tanh-approximate GELU, as the JAX graph does. Attention is
``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CoTrackerConfig:
    window_len: int = 60            # offline model; time_emb table length
    stride: int = 4
    corr_radius: int = 3
    corr_levels: int = 4
    latent_dim: int = 128
    hidden_size: int = 384
    num_heads: int = 8
    time_depth: int = 3
    space_depth: int = 3
    num_virtual_tracks: int = 64
    model_resolution: Tuple[int, int] = (384, 512)
    corr_mlp_hidden: int = 384
    corr_mlp_out: int = 256
    mlp_ratio: float = 4.0
    iters: int = 6                  # predictor default (hub wrapper)

    @property
    def input_dim(self) -> int:
        # vis + conf + corr_levels * corr_mlp_out + posenc(4 rel coords,
        # 10 degrees): 4 + 4*2*10 = 84
        return 2 + self.corr_levels * self.corr_mlp_out + 84


COTRACKER3_OFFLINE = CoTrackerConfig()


def tiny_cotracker_config() -> CoTrackerConfig:
    return CoTrackerConfig(window_len=8, latent_dim=16, hidden_size=32,
                           num_heads=2, time_depth=2, space_depth=2,
                           num_virtual_tracks=4, corr_levels=2,
                           corr_mlp_hidden=16, corr_mlp_out=8,
                           model_resolution=(16, 24), iters=2)


# ---------------------------------------------------------------------------
# BasicEncoder
# ---------------------------------------------------------------------------

def _conv(conv: nn.Conv2d, x, stride: int = 1):
    k = conv.weight.shape[-1]
    return F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=k // 2)


def _inorm(x):
    """InstanceNorm2d, affine=False, biased variance, eps 1e-5."""
    return F.instance_norm(x, eps=1e-5)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, **kw):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, **kw))

    def forward(self, x):
        y = F.relu(_inorm(_conv(self.conv1, x, self.stride)))
        y = F.relu(_inorm(_conv(self.conv2, y)))
        if self.stride != 1:
            x = _inorm(_conv(self.downsample[0], x, self.stride))
        return F.relu(x + y)


def _res_layer(cin: int, cout: int, stride: int, **kw):
    return nn.Sequential(_ResBlock(cin, cout, stride, **kw),
                         _ResBlock(cout, cout, 1, **kw))


class BasicEncoder(nn.Module):
    def __init__(self, cfg: CoTrackerConfig, **kw):
        super().__init__()
        D = cfg.latent_dim
        self.stride = cfg.stride
        self.conv1 = nn.Conv2d(3, D // 2, 7, **kw)
        self.layer1 = _res_layer(D // 2, D // 2, 1, **kw)
        self.layer2 = _res_layer(D // 2, D * 3 // 4, 2, **kw)
        self.layer3 = _res_layer(D * 3 // 4, D, 2, **kw)
        self.layer4 = _res_layer(D, D, 2, **kw)
        self.conv2 = nn.Conv2d(D * 3 + D // 4, D * 2, 3, **kw)
        self.conv3 = nn.Conv2d(D * 2, D, 1, **kw)

    def forward(self, x):
        """[B, 3, H, W] -> [B, latent, H / stride, W / stride]."""
        tgt = (x.shape[2] // self.stride, x.shape[3] // self.stride)
        x = F.relu(_inorm(_conv(self.conv1, x, 2)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        cat = torch.cat([F.interpolate(t, tgt, mode="bilinear",
                                       align_corners=True)
                         for t in (a, b, c, d)], dim=1)
        y = F.relu(_inorm(_conv(self.conv2, cat)))
        return _conv(self.conv3, y)


# ---------------------------------------------------------------------------
# EfficientUpdateFormer
# ---------------------------------------------------------------------------

def _ln(x, norm: Optional[nn.LayerNorm] = None, eps: float = 1e-6):
    if norm is None:
        return F.layer_norm(x, x.shape[-1:], eps=eps)
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, eps)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None,
                 **kw):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, out or dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class _Attention(nn.Module):
    """q from x, fused kv from the context, softmax attention."""

    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, **kw)
        self.to_kv = nn.Linear(dim, 2 * dim, **kw)
        self.to_out = nn.Linear(dim, dim, **kw)

    def forward(self, x, context):
        B, N1, _ = x.shape
        h = self.heads
        q = self.to_q(x).reshape(B, N1, h, -1).transpose(1, 2)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(B, k.shape[1], h, -1).transpose(1, 2)
        v = v.reshape(B, v.shape[1], h, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(o.transpose(1, 2).reshape(B, N1, -1))


class _AttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, **kw):
        super().__init__()
        self.attn = _Attention(dim, heads, **kw)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x):
        h = _ln(x)
        x = x + self.attn(h, h)
        return x + self.mlp(_ln(x))


class _CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, **kw):
        super().__init__()
        self.cross_attn = _Attention(dim, heads, **kw)
        self.norm_context = nn.LayerNorm(dim, **kw)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, context):
        x = x + self.cross_attn(_ln(x), _ln(context, self.norm_context,
                                            1e-5))
        return x + self.mlp(_ln(x))


class UpdateFormer(nn.Module):
    def __init__(self, cfg: CoTrackerConfig, **kw):
        super().__init__()
        self.cfg = cfg
        d, h, r = cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio
        self.input_transform = nn.Linear(cfg.input_dim, d, **kw)
        self.flow_head = nn.Linear(d, 2, **kw)
        self.vis_conf_head = nn.Linear(d, 2, **kw)
        self.virual_tracks = nn.Parameter(
            torch.empty(1, cfg.num_virtual_tracks, 1, d, **kw))
        self.time_blocks = nn.ModuleList(
            _AttnBlock(d, h, r, **kw) for _ in range(cfg.time_depth))
        self.space_virtual_blocks = nn.ModuleList(
            _AttnBlock(d, h, r, **kw) for _ in range(cfg.space_depth))
        self.space_point2virtual_blocks = nn.ModuleList(
            _CrossAttnBlock(d, h, r, **kw) for _ in range(cfg.space_depth))
        self.space_virtual2point_blocks = nn.ModuleList(
            _CrossAttnBlock(d, h, r, **kw) for _ in range(cfg.space_depth))

    def forward(self, x):
        """x [B, N, T, input_dim] -> delta [B, N, T, 4]."""
        cfg = self.cfg
        B, N, T, _ = x.shape
        D = cfg.hidden_size
        tokens = self.input_transform(x)
        virtual = self.virual_tracks.expand(B, -1, T, -1)
        tokens = torch.cat([tokens, virtual], dim=1)
        Nv = N + cfg.num_virtual_tracks
        every = cfg.time_depth // cfg.space_depth
        j = 0
        for i in range(cfg.time_depth):
            tokens = self.time_blocks[i](tokens.reshape(B * Nv, T, D)
                                         ).reshape(B, Nv, T, D)
            if i % every == 0 and j < cfg.space_depth:
                st = tokens.transpose(1, 2).reshape(B * T, Nv, D)
                pts, virt = st[:, :N], st[:, N:]
                virt = self.space_virtual2point_blocks[j](virt, pts)
                virt = self.space_virtual_blocks[j](virt)
                pts = self.space_point2virtual_blocks[j](pts, virt)
                st = torch.cat([pts, virt], dim=1)
                tokens = st.reshape(B, T, Nv, D).transpose(1, 2)
                j += 1
        tokens = tokens[:, :N]
        return torch.cat([self.flow_head(tokens),
                          self.vis_conf_head(tokens)], dim=-1)


# ---------------------------------------------------------------------------
# Positional encodings (cotracker_base.py:19-66)
# ---------------------------------------------------------------------------

def sincos_time_embed(embed_dim: int, window_len: int) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    pos = np.linspace(0, window_len - 1, window_len)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)],
                          axis=1)[None].astype(np.float32)


def posenc(x, min_deg: int, max_deg: int):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four], dim=-1)


def _support_grid(r: int, device) -> torch.Tensor:
    """[2r+1, 2r+1, (x, y)]: the FIRST patch axis is the x offset (the
    reference's get_support_points; the 49x49 corr ordering feeds trained
    corr_mlp weights)."""
    d = torch.linspace(-r, r, 2 * r + 1, device=device)
    gx, gy = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def bilinear_sample(fmaps, xy):
    """``grid_sample(align_corners=True, padding_mode="border")`` at pixel
    coordinates. fmaps [M, C, H, W]; xy [M, ..., 2] (x, y) -> [M, ..., C]."""
    M, C, H, W = fmaps.shape
    shape = xy.shape[1:-1]
    scale = torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)],
                         dtype=xy.dtype, device=xy.device)
    g = (xy * scale - 1.0).reshape(M, 1, -1, 2)
    out = F.grid_sample(fmaps, g, mode="bilinear", padding_mode="border",
                        align_corners=True)                 # [M, C, 1, P]
    return out[:, :, 0].transpose(1, 2).reshape(M, *shape, C)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class CoTracker(nn.Module):
    """CoTrackerThreeOffline inference with the checkpoint's names."""

    def __init__(self, cfg: CoTrackerConfig = COTRACKER3_OFFLINE,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        r = 2 * cfg.corr_radius + 1
        self.fnet = BasicEncoder(cfg, **kw)
        self.corr_mlp = _Mlp(r ** 4, cfg.corr_mlp_hidden, cfg.corr_mlp_out,
                             **kw)
        self.updateformer = UpdateFormer(cfg, **kw)
        self.register_buffer("time_emb", torch.empty(
            1, cfg.window_len, cfg.input_dim, **kw))

    @torch.no_grad()
    def forward(self, video, queries, iters: Optional[int] = None):
        """video [B, T, 3, H, W] in 0..255; queries [B, N, 3] (t, x, y) in
        pixels -> (coords [B, T, N, 2] pixels, vis [B, T, N], conf
        [B, T, N]) probabilities, the last iteration's
        (cotracker_base.py:405)."""
        cfg = self.cfg
        B, T, _, H, W = video.shape
        N = queries.shape[1]
        iters = iters or cfg.iters
        r = 2 * cfg.corr_radius + 1
        C = cfg.latent_dim
        video = 2 * (video / 255.0) - 1.0
        qframe = queries[..., 0].long()                     # [B, N]
        qcoord = queries[..., 1:3] / cfg.stride             # [B, N, 2]

        fmaps = self.fnet(video.reshape(B * T, 3, H, W))
        fmaps = fmaps * torch.rsqrt(
            fmaps.square().sum(1, keepdim=True).clamp_min(1e-12))
        pyramid = [fmaps]                                    # [B*T, C, h, w]
        for _ in range(cfg.corr_levels - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, 2))

        grid = _support_grid(cfg.corr_radius, video.device)  # [r, r, 2]
        bidx = torch.arange(B, device=video.device)[:, None]

        # the 7x7 support features at each query's frame: sampled on every
        # frame, then the query's own taken (t is an integer)
        support = []
        for i, fm in enumerate(pyramid):
            pts = qcoord[:, None, :, None, None] / (2 ** i) + grid
            pts = pts.expand(B, T, N, r, r, 2).reshape(B * T, N, r, r, 2)
            feat = bilinear_sample(fm, pts).reshape(B, T, N, r, r, C)
            support.append(feat[bidx, qframe,
                                torch.arange(N, device=video.device)[None]])

        coords = qcoord[:, None].expand(B, T, N, 2).float().clone()
        vis = torch.zeros((B, T, N), device=video.device)
        conf = torch.zeros((B, T, N), device=video.device)
        scale = torch.tensor([cfg.model_resolution[1],
                              cfg.model_resolution[0]],
                             dtype=torch.float32,
                             device=video.device) / cfg.stride
        time_emb = self.time_emb
        if T != time_emb.shape[1]:
            time_emb = F.interpolate(time_emb.transpose(1, 2), size=T,
                                     mode="linear", align_corners=False
                                     ).transpose(1, 2)

        for _ in range(iters):
            corr_embs = []
            for i, fm in enumerate(pyramid):
                pts = coords[:, :, :, None, None] / (2 ** i) + grid
                feat = bilinear_sample(fm, pts.reshape(B * T, N, r, r, 2)
                                       ).reshape(B, T, N, r, r, C)
                corr = torch.einsum("btnhwc,bnijc->btnhwij", feat,
                                    support[i])
                corr_embs.append(self.corr_mlp(
                    corr.reshape(B, T, N, r ** 4)))
            corr_embs = torch.cat(corr_embs, dim=-1)

            fwd = F.pad(coords[:, :-1] - coords[:, 1:],
                        (0, 0, 0, 0, 0, 1)) / scale
            bwd = F.pad(coords[:, 1:] - coords[:, :-1],
                        (0, 0, 0, 0, 1, 0)) / scale
            rel = posenc(torch.cat([fwd, bwd], dim=-1), 0, 10)
            x = torch.cat([vis[..., None], conf[..., None], corr_embs, rel],
                          dim=-1).transpose(1, 2)           # [B, N, T, D]
            delta = self.updateformer(x + time_emb[:, None])
            coords = coords + delta[..., :2].transpose(1, 2)
            vis = vis + delta[..., 2].transpose(1, 2)
            conf = conf + delta[..., 3].transpose(1, 2)
        return coords * cfg.stride, torch.sigmoid(vis), torch.sigmoid(conf)


@torch.no_grad()
def cotracker_predict(model: CoTracker, video, queries,
                      backward_tracking: bool = False,
                      vis_threshold: float = 0.6):
    """The hub wrapper's contract: resize to ``model_resolution``
    (bilinear, align_corners=True), scale the queries, track, rescale;
    with ``backward_tracking`` also track the time-reversed video and take
    its tracks for the frames before each query frame. Returns (tracks
    [B, T, N, 2] in input pixels, visibility [B, T, N] bool = vis * conf >
    threshold)."""
    cfg = model.cfg
    B, T, C, H, W = video.shape
    mh, mw = cfg.model_resolution
    v = video.reshape(B * T, C, H, W)
    if (H, W) != (mh, mw):
        v = F.interpolate(v, (mh, mw), mode="bilinear", align_corners=True)
    v = v.reshape(B, T, C, mh, mw)
    sx = (mw - 1) / max(W - 1, 1)
    sy = (mh - 1) / max(H - 1, 1)
    q = torch.cat([queries[..., :1], queries[..., 1:2] * sx,
                   queries[..., 2:3] * sy], dim=-1)
    coords, vis, conf = model(v, q)
    if backward_tracking:
        inv_q = torch.cat([(T - 1) - q[..., :1], q[..., 1:]], dim=-1)
        bc, bv, bf = model(v.flip(1), inv_q)
        bc, bv, bf = bc.flip(1), bv.flip(1), bf.flip(1)
        before = (torch.arange(T, device=v.device)[None, :, None]
                  < q[..., 0].long()[:, None, :])
        coords = torch.where(before[..., None], bc, coords)
        vis = torch.where(before, bv, vis)
        conf = torch.where(before, bf, conf)
    coords = coords / torch.tensor([sx, sy], dtype=coords.dtype,
                                   device=coords.device)
    return coords, (vis * conf) > vis_threshold


@torch.no_grad()
def init_cotracker(cfg: CoTrackerConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32) -> CoTracker:
    """Seeded random CoTracker on ``generator``'s device, the JAX init's
    scales: uniform(+-1/sqrt(fan_in)) convs, N(0, 0.02) linears with zero
    biases, unit LayerNorms, N(0, 1) virtual tracks, the sincos time
    table."""
    m = CoTracker(cfg, device="meta", dtype=dtype)
    m.to_empty(device=generator.device)
    dev = generator.device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev)

    for mod in m.modules():
        if isinstance(mod, nn.Conv2d):
            bound = mod.weight[0].numel() ** -0.5
            mod.weight.copy_(rand(mod.weight.shape) * 2 * bound - bound)
            mod.bias.copy_(rand(mod.bias.shape) * 2 * bound - bound)
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(0.02 * randn(mod.weight.shape))
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    m.updateformer.virual_tracks.copy_(randn(
        m.updateformer.virual_tracks.shape))
    m.time_emb.copy_(torch.from_numpy(
        sincos_time_embed(cfg.input_dim, cfg.window_len)))
    return m.eval()


def load_cotracker_torch(checkpoint_path: str,
                         cfg: CoTrackerConfig = COTRACKER3_OFFLINE,
                         backward_tracking: bool = False,
                         device: str = "cuda"):
    """The released weights (``.pth``, its ``model`` dict, or
    ``.safetensors``) as the ``track(frames, queries)`` adapter. Keys the
    model does not hold are ignored, as the JAX loader ignores them; a
    missing one raises. A checkpoint without ``time_emb`` takes the sincos
    table."""
    from frameino_tpu_torch.models.weights import read_checkpoint
    sd = read_checkpoint(checkpoint_path)
    if "time_emb" not in sd:
        sd["time_emb"] = torch.from_numpy(
            sincos_time_embed(cfg.input_dim, cfg.window_len))
    m = CoTracker(cfg, device="meta")
    missing = m.load_state_dict(sd, strict=False, assign=True).missing_keys
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:8]}")
    return make_tracker_adapter(m.to(device).eval(),
                                backward_tracking=backward_tracking)


def make_tracker_adapter(model: CoTracker, backward_tracking: bool = False):
    """``track(frames [T, H, W, 3] uint8, queries [N, 2] xy on frame 0) ->
    [T, N, 2] int64`` on the model's device (coordinates truncated, as the
    reference's ``.long()``)."""
    dev = model.time_emb.device

    def track(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
        video = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        video = video.float().permute(0, 3, 1, 2)[None]
        q = torch.tensor([[0.0, float(x), float(y)] for (x, y) in queries],
                         dtype=torch.float32, device=dev)[None]
        coords, _ = cotracker_predict(model, video, q,
                                      backward_tracking=backward_tracking)
        return coords[0].cpu().numpy().astype(np.int64)

    return track
