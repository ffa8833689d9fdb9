"""w8a8 convolution, K14 (counterpart of
``frameino_tpu/ops/conv.py::_conv_int8``).

The int8 Wan VAE's convs (``models/quant.quantize_wan_vae_int8``) hold
int8 weights with one fp32 scale per output channel; the activation is
quantized per call with one scale over the whole input tensor:

    s_x = max(amax(|x|) * fp32(1/127), 1e-12)
    xq  = clip(round_half_even(x / s_x), -127, 127)
    y   = fma(float(conv(xq, wq) in int32), s_x * scale[n], bias[n])

in fp32, as JAX's jitted VAE programs compute it (the streaming chunks and
the tiled / hybrid tiles, JAX's serving default): XLA multiplies by the
fp32 reciprocal of 127 and contracts the epilogue's product and bias into
one fused multiply-add, rounded once. JAX's eager full-sequence decode
divides by 127 and rounds the product before the bias, so its scale is
one ulp off now and then and its outputs one ulp off often
(``tests/test_torch_vae_int8.py`` holds both).

``conv_int8(x, weight_q, scale, bias, stride, padding)`` takes x [B, C, T,
H, W], weight_q in the kernel's layout [Cout, kt, kh, kw, Cp] (int8, the
channels last and zero-padded to ``CHANNEL_GRANULE``: ``kernel_weight``
lays out torch's [Cout, C, kt, kh, kw] once, when a conv is quantized)
and ``padding`` ((front, back), (top, bottom), (left, right)). For a CUDA
tensor it launches K14 (``csrc/conv_int8.cu``: the absmax, the quantizer
into a channels-last int8 copy, the implicit GEMM on wgmma with the
epilogue fused, its tile width and K split from ``igemm_plan``; fp32
only) and raises on anything else; for a CPU tensor it runs
the plain version, ``conv_int8_ref``, whose int8 product is a float64
``F.conv3d`` (exact: every sum stays under 2**53). Launches are counted
in ``conv_int8.launches`` (``conv_int8_cuda`` launches it, or another
build of its C interface, uncounted).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from frameino_tpu_torch.ops.cuda_build import lib
from frameino_tpu_torch.ops.dyn_quant import INV_127, SCALE_FLOOR

Pads = Sequence[Tuple[int, int]]

# the channel granule of the kernel's int8 operands (kChannelGranule in
# the source)
CHANNEL_GRANULE = 32
# the implicit GEMM's tiling (kBM, kStageK, kMinSplitStages, kMaxTaps in the
# source): 128 output positions a tile, 128 bytes of K a stage, a tile of
# BLOCK_N_CHOICES output channels, at least MIN_SPLIT_STAGES stages a split
# of K, at most MAX_TAPS taps (their bit mask is 32 bits)
BLOCK_M, STAGE_K, MIN_SPLIT_STAGES, MAX_TAPS = 128, 128, 16, 32
BLOCK_N_CHOICES = (256, 160)


def activation_scale(x):
    """s_x of the whole tensor, an fp32 scalar on x's device."""
    return torch.clamp_min(x.float().abs().amax() * INV_127.to(x.device),
                           SCALE_FLOOR)


def quantize_activation_ref(x, s_x=None):
    """(xq as float codes, s_x): the plain activation quantizer."""
    xf = x.float()
    if s_x is None:
        s_x = activation_scale(xf)
    return torch.clamp(torch.round(xf / s_x), -127, 127), s_x


def padded_channels(c: int) -> int:
    """C rounded up to the kernel's channel granule."""
    return -(-c // CHANNEL_GRANULE) * CHANNEL_GRANULE


def kernel_weight(weight_q):
    """torch's [Cout, C, k...] int8 codes -> the kernel's [Cout, k..., Cp],
    the channels last and zero-padded to CHANNEL_GRANULE."""
    c = weight_q.shape[1]
    w = weight_q.permute(0, *range(2, weight_q.ndim), 1)
    return F.pad(w, (0, padded_channels(c) - c)).contiguous()


def torch_weight(weight_q, c: int):
    """The kernel's [Cout, k..., Cp] -> torch's [Cout, c, k...]."""
    return weight_q[..., :c].permute(0, weight_q.ndim - 1,
                                     *range(1, weight_q.ndim - 1))


def out_extents(shape, weight_shape, stride, padding):
    """(To, Ho, Wo) of a conv of x ``shape`` [B, C, T, H, W] by a weight
    of the kernel's layout [Cout, kt, kh, kw, Cp]."""
    return tuple((n + p0 + p1 - k) // s + 1 for n, k, s, (p0, p1)
                 in zip(shape[2:], weight_shape[1:4], stride, padding))


def _check_args(x, weight_q, scale, bias, stride, padding):
    if x.ndim != 5 or weight_q.ndim != 5:
        raise ValueError(f"conv_int8: x {tuple(x.shape)} and weight "
                         f"{tuple(weight_q.shape)} must be 5-D")
    if weight_q.dtype != torch.int8:
        raise TypeError(f"conv_int8: int8 weights, got {weight_q.dtype}")
    if weight_q.shape[4] != padded_channels(x.shape[1]):
        raise ValueError(f"conv_int8: {x.shape[1]} input channels, weight "
                         f"{tuple(weight_q.shape)} (the kernel's layout)")
    cout = weight_q.shape[0]
    if scale.shape != (cout,) or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"conv_int8: scale / bias must be [{cout}]")
    if len(stride) != 3 or len(padding) != 3:
        raise ValueError(f"conv_int8: stride {stride}, padding {padding}")
    if min(out_extents(x.shape, weight_q.shape, stride, padding)) < 1:
        raise ValueError(f"conv_int8: empty output for x {tuple(x.shape)}")


def fma_fp32(a, b, c):
    """fp32 ``a * b + c`` rounded once, exactly, from fp64 steps: the
    product is exact in fp64 (two 24-bit significands); the fp64 sum's own
    rounding error (TwoSum) decides the one case where rounding that sum
    to fp32 differs from rounding the exact value, a tie."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    v = s - p
    e = (p - (s - v)) + (cd - v)                 # s + e == p + c exactly
    f = s.float()
    d = s - f.double()
    nxt = torch.nextafter(f, torch.where(d > 0, torch.inf, -torch.inf)
                          .to(f.dtype))
    tie = (d != 0) & (d.abs() * 2 == (nxt.double() - f.double()).abs())
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), nxt, f)


def conv_int8_ref(x, weight_q, scale, bias=None, stride=(1, 1, 1),
                  padding: Pads = ((0, 0),) * 3, s_x=None):
    """Plain version of K14; ``s_x`` given: the activation scale of a
    larger tensor that ``x`` is a slice of."""
    _check_args(x, weight_q, scale, bias, stride, padding)
    xq, s_x = quantize_activation_ref(x, s_x)
    (t0, t1), (h0, h1), (w0, w1) = padding
    xq = F.pad(xq, (w0, w1, h0, h1, t0, t1))
    acc = F.conv3d(xq.double(), torch_weight(weight_q, x.shape[1]).double(),
                   stride=tuple(stride))
    shape = (-1, 1, 1, 1)
    accf = acc.to(torch.int32).float()
    sn = (s_x * scale.float()).reshape(shape)
    if bias is None:
        return (accf * sn).to(x.dtype)
    return fma_fp32(accf, sn, bias.float().reshape(shape)).to(x.dtype)


def conv_int8(x, weight_q, scale, bias=None, stride=(1, 1, 1),
              padding: Pads = ((0, 0),) * 3):
    """K14 (replaces ``frameino_tpu/ops/conv.py::_conv_int8``). CUDA: the
    kernel, fp32 only; CPU: ``conv_int8_ref``."""
    stride, padding = tuple(stride), tuple(tuple(p) for p in padding)
    if not x.is_cuda:
        return conv_int8_ref(x, weight_q, scale, bias, stride, padding)
    out = conv_int8_cuda(x, weight_q, scale, bias, stride, padding)
    conv_int8.launches += 1
    return out


def igemm_plan(m: int, n: int, k: int, sms: int) -> dict:
    """K14's implicit-GEMM launch for M = ``m`` output positions, N = ``n``
    output channels and K = ``k`` bytes of depth on ``sms`` SMs: the tile
    width ``block_n`` (256 where it divides N, the decoder's widths, else
    160, the encoder's, else the one that pads N least), the ``tiles``
    (128 positions x block_n), the K ``stages`` (128 bytes), the ``split``
    of K where the tiles leave SMs idle (as many splits as fill them, each
    at least MIN_SPLIT_STAGES stages) and the zeroed int32 ``workspace``
    the splits add into (partial sums, then a counter a tile)."""
    fits = [b for b in BLOCK_N_CHOICES if n % b == 0]
    block_n = fits[0] if fits else min(
        BLOCK_N_CHOICES, key=lambda b: (-(-n // b) * b, -b))
    tiles = -(-m // BLOCK_M) * -(-n // block_n)
    stages = -(-k // STAGE_K)
    split = 1
    if tiles < sms:
        split = max(1, min(sms // tiles, stages // MIN_SPLIT_STAGES))
    workspace = tiles * (block_n * BLOCK_M + 1) if split > 1 else 0
    return dict(block_n=block_n, tiles=tiles, stages=stages, split=split,
                workspace=workspace)


def sm_count(device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launched(fn: str, code: int):
    if code != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {code}")


def conv_int8_cuda(x, weight_q, scale, bias=None, stride=(1, 1, 1),
                   padding: Pads = ((0, 0),) * 3, *, library=None):
    """The three launches of ``csrc/conv_int8.cu`` (or of ``library``,
    another build of its C interface) on CUDA tensors, after the
    wrapper's checks; not counted. One zeroed int32 buffer holds the
    absmax and, where the plan splits K, the splits' workspace."""
    _check_args(x, weight_q, scale, bias, stride, padding)
    tensors = [("x", x), ("weight", weight_q), ("scale", scale)]
    if bias is not None:
        tensors.append(("bias", bias))
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"conv_int8: {name} on {t.device}")
        if name != "weight" and t.dtype != torch.float32:
            raise TypeError(f"conv_int8: the CUDA kernel takes float32 "
                            f"{name}, got {t.dtype}")
    B, C, T, H, W = x.shape
    cout = weight_q.shape[0]
    kt, kh, kw, cp = weight_q.shape[1:]
    if kt * kh * kw > MAX_TAPS:
        raise ValueError(f"conv_int8: the CUDA kernel takes at most "
                         f"{MAX_TAPS} taps, got {kt}x{kh}x{kw}")
    To, Ho, Wo = out_extents(x.shape, weight_q.shape, stride, padding)
    x, weight_q = (t.contiguous() for t in (x, weight_q))
    x, weight_q = (t.clone() if t.data_ptr() % 16 else t
                   for t in (x, weight_q))
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    plan = igemm_plan(B * To * Ho * Wo, cout, kt * kh * kw * cp,
                      sm_count(x.device))
    # the absmax at word 0, the workspace 16 bytes in
    buf = torch.zeros(4 + plan["workspace"], dtype=torch.int32,
                      device=x.device)
    xq = torch.empty((B, T, H, W, cp), dtype=torch.int8, device=x.device)
    out = torch.empty((B, cout, To, Ho, Wo), dtype=torch.float32,
                      device=x.device)
    L = library or lib("conv_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launched("conv_int8_absmax", L.conv_int8_absmax(
        x.data_ptr(), x.numel(), buf.data_ptr(), stream))
    _launched("conv_int8_quantize", L.conv_int8_quantize(
        x.data_ptr(), xq.data_ptr(), buf.data_ptr(), B, C, cp, T * H * W,
        stream))
    _launched("conv_int8_igemm", igemm(
        L, xq, weight_q, scale, bias, buf, out, stride, padding, plan,
        stream))
    return out


def igemm(L, xq, weight_q, scale, bias, buf, out, stride, padding, plan,
          stream) -> int:
    """``conv_int8_igemm`` of library ``L`` on the channels-last codes
    ``xq`` [B, T, H, W, Cp] into ``out`` [B, Cout, To, Ho, Wo] by
    ``plan`` (``igemm_plan``); ``buf`` holds the absmax bits at word 0 and,
    zeroed, the plan's workspace from word 4. Returns the C call's code."""
    B, T, H, W, cp = xq.shape
    cout, kt, kh, kw = weight_q.shape[:4]
    To, Ho, Wo = out.shape[2:]
    ws = buf[4:].data_ptr() if plan["split"] > 1 else None
    return L.conv_int8_igemm(
        xq.data_ptr(), weight_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), buf.data_ptr(),
        out.data_ptr(), ws, B, T, H, W, cp, cout, kt, kh, kw, *stride,
        padding[0][0], padding[1][0], padding[2][0], To, Ho, Wo,
        plan["block_n"], plan["split"], stream)


conv_int8.launches = 0
