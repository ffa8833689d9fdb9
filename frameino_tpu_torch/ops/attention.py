"""Attention ops: the plain PyTorch reference and the Hopper kernels.

Counterpart of ``frameino_tpu/ops/attention.py``. The serving paths need
three attention shapes:

- Wan self-attention over the video tokens, behind the qk RMS-norm taken
  across all heads and the interleaved RoPE:
  ``fused_qk_flash_attention`` = K2 (norm + RoPE producer) -> bound ->
  K1 (static-bound flash forward), at head_dim 128;
- Wan cross-attention to the 512 text tokens:
  ``flash_attention_inference`` = K3 (online-softmax flash forward);
- CogVideoX joint [text; video] self-attention, behind the per-head qk
  LayerNorm and the RoPE with identity rows over the text prefix:
  ``fused_ln_qk_flash_attention`` = K4 (LayerNorm + RoPE producer) ->
  bound -> K1, at head_dim 64.

The training path needs every attention differentiable:
``flash_attention_train`` = K6 (flash forward with the row log-sum-exp,
and a backward giving dQ, dK, dV), behind a ``torch.autograd.Function``.

K1 and K3 are one CUDA C++ kernel (``csrc/flash_fwd.cu``) templated on
the softmax variant and head_dim; K6 is a second CUDA C++ source
(``csrc/flash_attn_train.cu``). Both are warp-specialised wgmma kernels
fed by TMA, on the Hopper helpers of ``csrc/sm90_common.cuh``; K2 (with
K5) and K4 are the two kernels of ``csrc/qk_producers.cu``. Each
wrapper launches its kernel for CUDA tensors (bf16, contiguous) and
raises on anything else; for CPU tensors it runs the plain PyTorch
version beside it. Each wrapper counts its kernel launches in
``<wrapper>.launches``.

Under a process mesh (``core/meshes.py``) each rank runs the body of
JAX's shard_map on its own tensors: ``fused_qk_flash_attention_sharded``
and ``fused_ln_qk_flash_attention_sharded`` on a tp rank's heads, and the
sequence-parallel ``dispatch_attention``: ``sp_attention`` (K3 over the
keys and values gathered over sp) or ``ring_attention`` (JAX's fp32
online-softmax ring in plain ops, its shards passed round the sp group).

Layouts follow the JAX package: attention tensors are [B, H, S, D],
raw q/k are [B, S, H*D].
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from frameino_tpu_torch.ops import dyn_quant
from frameino_tpu_torch.ops.cuda_build import (  # noqa: F401 (re-exported)
    BUILD_DIR, BUILD_LOG, build_cuda_libs, check_cuda_bf16 as _check_cuda_bf16,
    lib as _lib)

LOG2E = 1.4426950408889634
_EXP_FLOOR = -120.0
_NEG_INF = -1e30      # the ring's running max before its first hop


def _default_scale(head_dim: int) -> float:
    return head_dim ** -0.5


# ---------------------------------------------------------------------------
# Plain reference
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, scale: Optional[float] = None):
    """softmax(q k^T * scale) v with fp32 softmax. q/k/v: [B, H, S, D].

    Counterpart of ``attention_xla``: fp32 logits, probabilities cast to
    v's dtype before the second product, fp32 accumulation.
    """
    scale = scale if scale is not None else _default_scale(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K1 / K3: CUDA flash forward (csrc/flash_fwd.cu; built by ops/cuda_build.py)
# ---------------------------------------------------------------------------

def _launch_flash(q, k, v, bound, q_scale: float):
    """q [BH, Sq, D], k/v [BH, Skv, D] bf16 CUDA; bound: 1-element fp32
    CUDA tensor (static variant) or None (online variant)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != k.shape:
        raise ValueError(f"flash: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash: head_dim {d} not in (64, 128)")
    if skv == 0 or sq == 0:
        raise ValueError("flash: empty sequence")
    _check_cuda_bf16("flash", q, k, v)
    if bound is not None:
        if (not bound.is_cuda or bound.dtype != torch.float32
                or bound.numel() != 1):
            raise ValueError("flash: bound must be a 1-element fp32 CUDA "
                             "tensor")
    lib = _lib("flash_fwd")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if bound is None else bound.data_ptr(), bh, sq, skv, d,
        int(bound is not None), float(q_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    return o


def flash_fwd_ref(q, k, v, q_scale: float):
    """Plain version of K3: q [BH, Sq, D] is scaled by ``q_scale`` in its
    own dtype (``q * jnp.asarray(c, q.dtype)`` on the TPU side), then
    exp2-domain softmax in fp32, probabilities cast to v's dtype."""
    qs = q * torch.tensor(q_scale, dtype=q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_fwd(q, k, v, q_scale: float):
    """K3 (replaces ``_flash_fwd`` / ``_flash_fwd_kernel``): online-softmax
    flash forward over [BH, S, D]; q is scaled by ``q_scale`` (rounded to
    q's dtype) inside the kernel. CUDA: kernel; CPU: ``flash_fwd_ref``."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, q_scale)
    dev_scale = float(torch.tensor(q_scale, dtype=torch.bfloat16))
    out = _launch_flash(q, k, v, None, dev_scale)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_fwd_static_ref(q, k, v, bound):
    """Plain version of K1: ``p = exp2(max(s - bound, -120))`` over
    pre-scaled q, probabilities cast to v's dtype, fp32 sums."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(s - bound.reshape(()).float(),
                               min=_EXP_FLOOR))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_fwd_static(q, k, v, bound):
    """K1 (replaces ``_flash_fwd_static`` / ``_flash_fwd_kernel_static``):
    static-bound flash forward over pre-scaled q [BH, S, D]. ``bound`` is a
    device scalar >= every logit; it is read by the kernel, never synced
    to the host. CUDA: kernel; CPU: ``flash_fwd_static_ref``."""
    if not q.is_cuda:
        return flash_fwd_static_ref(q, k, v, bound)
    out = _launch_flash(q, k, v, bound.reshape(1).contiguous(), 1.0)
    flash_fwd_static.launches += 1
    return out


flash_fwd_static.launches = 0


def flash_attention_inference(q, k, v, scale: Optional[float] = None):
    """Non-causal flash attention, forward only. q/k/v: [B, H, S, D], any
    strides (a head-split view of a batch of one reshapes to a view that
    is not contiguous; the kernel takes contiguous rows)."""
    B, H, Sq, D = q.shape
    scale = scale if scale is not None else _default_scale(D)
    out = flash_fwd(q.reshape(B * H, Sq, D).contiguous(),
                    k.reshape(B * H, -1, D).contiguous(),
                    v.reshape(B * H, -1, D).contiguous(), scale * LOG2E)
    return out.reshape(B, H, Sq, D)


# ---------------------------------------------------------------------------
# K6: CUDA flash attention forward + backward for training
# (csrc/flash_attn_train.cu)
# ---------------------------------------------------------------------------

def flash_attention_train_ref(q, k, v, scale: Optional[float] = None):
    """Plain version of K6: ``attention_ref`` under autograd. q [B, H, Sq,
    D], k/v [B, H, Skv, D]."""
    return attention_ref(q, k, v, scale)


def _check_train_shapes(name, q, k, v):
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[2] not in (64, 128):
        raise ValueError(f"{name}: head_dim {q.shape[2]} not in (64, 128)")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty sequence")


def flash_attn_train_fwd(q, k, v, scale: float):
    """K6 forward kernel on q [BH, Sq, D], k/v [BH, Skv, D] bf16 CUDA
    (a block per 128 q rows, 128-key tiles): returns (o [BH, Sq, D] bf16,
    lse [BH, Sq] fp32, natural log)."""
    _check_train_shapes("flash_attn_train_fwd", q, k, v)
    _check_cuda_bf16("flash_attn_train_fwd", q, k, v)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _lib("flash_attn_train").attn_train_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, sq, k.shape[1], d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_train_fwd_bf16 launch failed: CUDA error "
                           f"{err}")
    flash_attn_train_fwd.launches += 1
    return o, lse


flash_attn_train_fwd.launches = 0


def _k6_bwd_keys_per_block(bh: int, skv: int, num_sms: int,
                           head_dim: int = 128) -> int:
    """Keys a block of K6's backward main kernel: 128 (two consumer
    warpgroups) when ``bh * ceil(skv / 128)`` blocks fill the card's
    ``num_sms`` SMs, else 64 (one warpgroup, twice the blocks, two of them
    an SM). head_dim 64 always takes 64: its dQ product splits no further
    across two warpgroups."""
    if head_dim != 128 or bh * -(-skv // 128) < num_sms:
        return 64
    return 128


def flash_attn_train_bwd(q, k, v, o, lse, do, scale: float):
    """K6 backward kernels (pre: D_i and the staged statistics; main: the
    five products once per (key block, q tile); post: dQ to bf16) on the
    forward's inputs, its o and lse, and dO like o: returns (dq, dk, dv)
    bf16. The key blocks' dQ shares are summed in fp32 in scheduling order
    (TMA reduce-adds or atomics), so dQ's low bits may differ between
    runs; dK and dV are bit-reproducible."""
    _check_train_shapes("flash_attn_train_bwd", q, k, v)
    _check_cuda_bf16("flash_attn_train_bwd", q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attn_train_bwd: o and dO must be shaped "
                         "like q")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if (not lse.is_cuda or lse.dtype != torch.float32
            or lse.shape != (bh, sq) or not lse.is_contiguous()):
        raise ValueError("flash_attn_train_bwd: lse must be a contiguous "
                         "fp32 CUDA [BH, Sq] tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the fp32 dQ accumulator (zeroed by the pre-kernel) and the q tiles'
    # lse * log2(e) and D_i, padded to whole 64-row tiles
    dq_acc = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    stats = torch.empty((2, bh, -(-sq // 64) * 64), dtype=torch.float32,
                        device=q.device)
    keys = _k6_bwd_keys_per_block(
        bh, skv, torch.cuda.get_device_properties(
            q.device).multi_processor_count, d)
    err = _lib("flash_attn_train").attn_train_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), stats.data_ptr(), bh, sq, skv, d,
        keys, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_train_bwd_bf16 launch failed: CUDA error "
                           f"{err}")
    flash_attn_train_bwd.launches += 1
    return dq, dk, dv


flash_attn_train_bwd.launches = 0


class _FlashAttentionTrain(torch.autograd.Function):
    """K6 forward and backward behind autograd, on [B, H, S, D]."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, H, Sq, D = q.shape
        Skv = k.shape[2]
        o, lse = flash_attn_train_fwd(q.view(B * H, Sq, D),
                                      k.view(B * H, Skv, D),
                                      v.view(B * H, Skv, D), scale)
        o = o.view(B, H, Sq, D)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, H, Sq, D = q.shape
        Skv = k.shape[2]

        def rows(t, s):
            return t.reshape(B * H, s, D)

        dq, dk, dv = flash_attn_train_bwd(
            rows(q, Sq), rows(k, Skv), rows(v, Skv), rows(o, Sq), lse,
            rows(do.contiguous(), Sq), ctx.scale)
        return (dq.view(B, H, Sq, D), dk.view(B, H, Skv, D),
                dv.view(B, H, Skv, D), None)


def flash_attention_train(q, k, v, scale: Optional[float] = None):
    """K6 (replaces ``flash_attention_train``): differentiable non-causal
    attention on q [B, H, Sq, D], k/v [B, H, Skv, D], any lengths (masked
    in the kernel, no padding). CUDA: the forward and backward kernels,
    contiguous bf16 only; CPU: ``flash_attention_train_ref``."""
    scale = scale if scale is not None else _default_scale(q.shape[-1])
    if not q.is_cuda:
        return flash_attention_train_ref(q, k, v, scale)
    if q.ndim != 4 or k.ndim != 4 or q.shape[:2] != k.shape[:2]:
        raise ValueError(f"flash_attention_train: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    _check_cuda_bf16("flash_attention_train", q, k, v)
    return _FlashAttentionTrain.apply(q, k, v, float(scale))


# ---------------------------------------------------------------------------
# K2 / K5 / K4: qk-norm + RoPE producers (csrc/qk_producers.cu)
# ---------------------------------------------------------------------------
# The kernels and their design note are in the CUDA source; their launch
# geometry is chosen here, where the CPU tests check its index map.

_PRODUCER_THREADS = 256     # a block's threads, at most (kMaxThreads)
_PRODUCER_MAX_VPT = 4       # 16-byte vectors a thread, at most (kMaxVpt)
_PRODUCER_KINDS = {"qk_norm_rope": 0, "qk_norm_rope_rstd": 1,
                   "qk_ln_rope": 2}
_producer_resident: dict = {}   # (device, kind, vpt, threads) -> blocks


@functools.lru_cache(maxsize=None)
def _producer_geometry(num_heads: int, head_dim: int):
    """(team, vpt, teams_per_block) of the producers on rows of
    ``num_heads`` heads of ``head_dim``: a team of ``team`` threads takes a
    token, thread t holding the row's 16-byte vectors v = j * team + t
    (j < vpt); a block holds ``teams_per_block`` teams. team is a multiple
    of a head's head_dim / 8 vectors, so a thread's vectors sit at one
    offset in every head (its gains and tables stay in registers), and a
    power of two up to a warp or a whole number of warps (K2's reduction
    tree). Among those: the fewest idle vector slots, then the most
    vectors a thread."""
    if head_dim < 8 or head_dim > 256 or head_dim & (head_dim - 1):
        raise ValueError(f"qk producers: head_dim {head_dim} is not a power "
                         f"of two in [8, 256]")
    per_head = head_dim // 8
    nv = num_heads * per_head
    best = None
    for vpt in range(_PRODUCER_MAX_VPT, 0, -1):
        team = -(-nv // vpt)
        team = (max(1 << (team - 1).bit_length(), per_head) if team <= 32
                else -(-team // 32) * 32)
        if team > _PRODUCER_THREADS:
            continue
        used = -(-nv // team)
        key = (team * used - nv, -used)
        if best is None or key < best[0]:
            best = (key, team, used)
    if best is None:
        raise ValueError(f"qk producers: a row of {num_heads} heads of "
                         f"{head_dim} is wider than "
                         f"{_PRODUCER_THREADS * _PRODUCER_MAX_VPT * 8}")
    _, team, vpt = best
    return team, vpt, _PRODUCER_THREADS // team


def _producer_grid(n_tokens: int, teams_per_block: int,
                   resident_blocks: int) -> int:
    """The persistent grid: every block the card holds at once, but no
    more than there are token groups (one token a team)."""
    return max(1, min(-(-n_tokens // teams_per_block), resident_blocks))


def _check_producer(name, raw, num_heads: int, params, param_len: int,
                    cos, sin):
    """Raise unless the kernel takes these tensors: raw [B, S, H*D] bf16,
    the fp32 ``params`` (gains, or gamma and beta) [param_len] and cos/sin
    [S, D/2], each contiguous and 16-byte aligned (the kernel's vector
    accesses). Returns the output [B*H, S, D]."""
    B, S, HD = raw.shape
    H = num_heads
    D = HD // H
    if H * D != HD or D % 2 or (D & (D - 1)):
        raise ValueError(f"{name}: H*D={HD} with H={H} needs a "
                         f"power-of-two head_dim")
    if any(t.shape != (param_len,) for t in params) \
            or cos.shape != (S, D // 2) or sin.shape != cos.shape:
        raise ValueError(f"{name}: gains must be [{param_len}] and cos/sin "
                         f"[S, D/2]")
    _check_cuda_bf16(name, raw)
    for t in (*params, cos, sin):
        if not t.is_cuda or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: gains and cos/sin must be contiguous "
                             f"fp32 CUDA tensors")
    out = torch.empty((B * H, S, D), dtype=raw.dtype, device=raw.device)
    if any(t.data_ptr() % 16 for t in (out, *params, cos, sin)):
        raise ValueError(f"{name}: gains, cos/sin and the output must be "
                         f"16-byte aligned")
    return out


def _launch_producer(kind: str, raw, out, ptrs, num_heads: int, eps: float):
    """Launch the producer ``kind`` on raw -> out with the other pointers
    ``ptrs`` (rstd, gain or gamma, beta as the C function orders them)."""
    B, S, HD = raw.shape
    team, vpt, tpb = _producer_geometry(num_heads, HD // num_heads)
    lib = _lib("qk_producers")
    key = (raw.device, kind, vpt, team * tpb)
    if key not in _producer_resident:
        per_sm = lib.qk_producer_blocks_per_sm(_PRODUCER_KINDS[kind], vpt,
                                               team * tpb)
        if per_sm <= 0:
            raise RuntimeError(f"{kind}: no block of {team * tpb} threads "
                               f"fits an SM")
        _producer_resident[key] = per_sm * torch.cuda.get_device_properties(
            raw.device).multi_processor_count
    fn = lib.qk_ln_rope_bf16 if kind == "qk_ln_rope" else lib.qk_norm_rope_bf16
    err = fn(raw.data_ptr(), *ptrs, out.data_ptr(), B, S, num_heads,
             HD // num_heads, float(eps), team, vpt, tpb,
             _producer_grid(B * S, tpb, _producer_resident[key]),
             torch.cuda.current_stream(raw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} launch failed: CUDA error {err}")


def qk_norm_rope_rstd_ref(raw, rstd, weight, cos, sin, num_heads: int):
    """Plain version of K5. raw [B, S, H*D]; rstd [B, S] fp32, the per-token
    reciprocal RMS over ALL heads (the tp path all-reduces it); weight
    [H*D]; cos/sin [S, D/2] fp32 (any softmax gain already folded in).
    ``(raw * rstd) * gain`` in fp32, rounded to raw's dtype (RMSNorm returns
    x.dtype), then the rotation with each product rounded before the sum.
    Returns [B*H, S, D] in raw's dtype."""
    B, S, HD = raw.shape
    H = num_heads
    D = HD // H
    f = (raw.float() * rstd[..., None] * weight.float()).to(raw.dtype)
    f = f.float().reshape(B, S, H, D // 2, 2)
    fe, fo = f[..., 0], f[..., 1]
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    out = torch.stack([fe * c - fo * s, fo * c + fe * s], dim=-1)
    out = out.reshape(B, S, H, D).permute(0, 2, 1, 3)
    return out.reshape(B * H, S, D).to(raw.dtype).contiguous()


def qk_norm_rope_ref(raw, weight, cos, sin, num_heads: int, eps: float):
    """Plain version of K2: K5's with the statistic of the row itself.
    raw [B, S, H*D]; weight [H*D]; cos/sin [S, D/2] fp32. Returns
    [B*H, S, D] in raw's dtype."""
    HD = raw.shape[-1]
    # fp64 sum of squares and rsqrt, rounded once to fp32 (as the kernel);
    # eps is the fp32 value the TPU kernel adds
    ssq = raw.double().square().sum(-1)
    rstd = (1.0 / torch.sqrt(ssq / HD + float(np.float32(eps)))).float()
    return qk_norm_rope_rstd_ref(raw, rstd, weight, cos, sin, num_heads)


def qk_norm_rope(raw, weight, cos, sin, num_heads: int, eps: float):
    """K2 (replaces ``_qk_producer_fullrow``): RMS-norm across all heads,
    gain, round to raw's dtype, interleaved RoPE -> [B*H, S, D]. CUDA:
    ``csrc/qk_producers.cu``; CPU: ``qk_norm_rope_ref``."""
    if not raw.is_cuda:
        return qk_norm_rope_ref(raw, weight, cos, sin, num_heads, eps)
    out = _check_producer("qk_norm_rope", raw, num_heads, (weight,),
                          raw.shape[-1], cos, sin)
    _launch_producer("qk_norm_rope", raw, out,
                     (0, weight.data_ptr(), cos.data_ptr(), sin.data_ptr()),
                     num_heads, eps)
    qk_norm_rope.launches += 1
    return out


qk_norm_rope.launches = 0


def qk_norm_rope_rstd(raw, rstd, weight, cos, sin, num_heads: int):
    """K5 (replaces ``_qk_producer``): the norm with a precomputed per-token
    ``rstd`` [B, S] fp32, gain, round to raw's dtype, interleaved RoPE ->
    [B*H, S, D] over the H heads of raw (a tp rank's slice). CUDA: K2's
    kernel with the rstd (``csrc/qk_producers.cu``); CPU:
    ``qk_norm_rope_rstd_ref``."""
    if not raw.is_cuda:
        return qk_norm_rope_rstd_ref(raw, rstd, weight, cos, sin, num_heads)
    out = _check_producer("qk_norm_rope_rstd", raw, num_heads, (weight,),
                          raw.shape[-1], cos, sin)
    if (not rstd.is_cuda or rstd.dtype != torch.float32
            or rstd.shape != raw.shape[:2] or not rstd.is_contiguous()):
        raise ValueError("qk_norm_rope_rstd: rstd must be a contiguous fp32 "
                         "CUDA [B, S] tensor")
    _launch_producer("qk_norm_rope_rstd", raw, out,
                     (rstd.data_ptr(), weight.data_ptr(), cos.data_ptr(),
                      sin.data_ptr()), num_heads, 0.0)
    qk_norm_rope_rstd.launches += 1
    return out


qk_norm_rope_rstd.launches = 0


def qk_ln_rope_ref(raw, weight, bias, cos, sin, num_heads: int, eps: float):
    """Plain version of K4. raw [B, S, H*D]; weight/bias [D] (one LayerNorm
    shared by all heads); cos/sin [S, D/2] fp32 (identity rows over a text
    prefix and any softmax gain already in them). Returns [B*H, S, D] in
    raw's dtype.

    The kernel's arithmetic step for step: mean and variance of each head's
    D lanes in fp64, rstd rounded once to fp32, ((x - mu) * rstd) * gamma
    + beta in fp32, rounded to raw's dtype, then the rotation with each
    product rounded before the sum."""
    B, S, HD = raw.shape
    H = num_heads
    D = HD // H
    xf = raw.float().reshape(B, S, H, D)
    xd = xf.double()
    mean = xd.sum(-1, keepdim=True) / D
    var = (xd - mean).square().sum(-1, keepdim=True) / D
    # eps is the fp32 value the TPU kernel adds
    rstd = (1.0 / torch.sqrt(var + float(np.float32(eps)))).float()
    f = (xf - mean.float()) * rstd * weight.float() + bias.float()
    f = f.to(raw.dtype).float().reshape(B, S, H, D // 2, 2)
    fe, fo = f[..., 0], f[..., 1]
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    out = torch.stack([fe * c - fo * s, fo * c + fe * s], dim=-1)
    out = out.reshape(B, S, H, D).permute(0, 2, 1, 3)
    return out.reshape(B * H, S, D).to(raw.dtype).contiguous()


def qk_ln_rope(raw, weight, bias, cos, sin, num_heads: int, eps: float):
    """K4 (replaces ``_qk_producer_ln``): per-head LayerNorm with a shared
    [D] gamma/beta, round to raw's dtype, interleaved RoPE -> [B*H, S, D].
    CUDA: ``csrc/qk_producers.cu``; CPU: ``qk_ln_rope_ref``."""
    if not raw.is_cuda:
        return qk_ln_rope_ref(raw, weight, bias, cos, sin, num_heads, eps)
    out = _check_producer("qk_ln_rope", raw, num_heads, (weight, bias),
                          raw.shape[-1] // num_heads, cos, sin)
    _launch_producer("qk_ln_rope", raw, out,
                     (weight.data_ptr(), bias.data_ptr(), cos.data_ptr(),
                      sin.data_ptr()), num_heads, eps)
    qk_ln_rope.launches += 1
    return out


qk_ln_rope.launches = 0


# ---------------------------------------------------------------------------
# Fused self-attention paths: K2, K5 or K4 (q, k) -> bound -> K1
# ---------------------------------------------------------------------------

def _rowmax_norm(x):
    """max row L2 over [BH, S, D], fp32, on x's device."""
    return torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).amax()


def _fused_qk_flash(q_raw, k_raw, v, w_q, w_k, cos, sin, num_heads: int,
                    eps: float, scale: Optional[float], static_softmax: bool,
                    rstd=None):
    """Shared body of the fused paths (counterpart of
    ``_fused_qk_flash_impl``): with ``rstd`` [2, B, S] (q's, k's), K5
    applies the precomputed statistic; without it, K2 reduces it."""
    B, S, HD = q_raw.shape
    H = num_heads
    D = HD // H
    scale = scale if scale is not None else _default_scale(D)
    gain = scale * LOG2E
    cos = cos.float()
    sin = sin.float()
    tables_q = ((cos * gain).contiguous(), (sin * gain).contiguous())
    tables_k = (cos.contiguous(), sin.contiguous())
    w_q = w_q.float().contiguous()
    w_k = w_k.float().contiguous()
    if rstd is None:
        qh = qk_norm_rope(q_raw, w_q, *tables_q, H, eps)
        kh = qk_norm_rope(k_raw, w_k, *tables_k, H, eps)
    else:
        qh = qk_norm_rope_rstd(q_raw, rstd[0], w_q, *tables_q, H)
        kh = qk_norm_rope_rstd(k_raw, rstd[1], w_k, *tables_k, H)
    vh = v.reshape(B * H, S, D)
    if static_softmax:
        bound = _rowmax_norm(qh) * _rowmax_norm(kh)
        out = flash_fwd_static(qh, kh, vh, bound)
    else:
        out = flash_fwd(qh, kh, vh, 1.0)
    return out.reshape(B, H, S, D)


def fused_qk_flash_attention(q_raw, k_raw, v, w_q, w_k, cos, sin, *,
                             num_heads: int, eps: float,
                             scale: Optional[float] = None,
                             static_softmax: bool = True):
    """Self-attention with the qk-norm + interleaved-RoPE producers
    (counterpart of ``fused_qk_flash_attention``): K2 (q, k) -> bound ->
    K1.

    q_raw/k_raw: [B, S, H*D] straight out of the to_q/to_k denses. v:
    [B, H, S, D]. w_q/w_k: [H*D] RMSNorm gains. cos/sin: [S, D/2] fp32 rope
    pair tables. Returns [B, H, S, D]. The softmax scale * log2(e) is
    folded into q's rope tables, as on the TPU; with ``static_softmax``
    the bound max||q_i|| * max||k_j|| (Cauchy-Schwarz) stays on the device.
    """
    return _fused_qk_flash(q_raw, k_raw, v, w_q, w_k, cos, sin, num_heads,
                           eps, scale, static_softmax)


def fused_qk_flash_attention_sharded(q_raw, k_raw, v, w_q, w_k, cos, sin,
                                     mesh, *, num_heads: int, eps: float,
                                     scale: Optional[float] = None):
    """``fused_qk_flash_attention`` on one rank of a dp x tp mesh: the body
    of JAX's ``fused_qk_flash_attention_sharded`` shard_map, on the rank's
    own tensors.

    q_raw/k_raw: [B_l, S, H_l*D], the rank's batch slice and contiguous
    head slice straight out of its column-parallel to_q/to_k; v
    [B_l, H_l, S, D]; w_q/w_k [H_l*D], the rank's slice of the gains;
    ``num_heads`` counts ALL heads (H = H_l * tp). Returns
    [B_l, H_l, S, D].

    tp == 1: every head is local, and K2 reduces the statistic. tp > 1:
    the RMS statistic runs across every head, so each rank reduces the
    fp32 sum of squares of its H_l heads, one all-reduce over the tp group
    completes it (q's and k's together), ``rsqrt(ssq / (H*D) + eps)`` in
    fp32 gives rstd, and K5 applies it. The static bound is the rank's own
    (from its heads only, not all-reduced), as each JAX shard computes it;
    then K1.
    """
    tp = mesh.tp
    if num_heads % tp:
        raise ValueError(f"{num_heads} heads do not divide over tp={tp}")
    h_local = num_heads // tp
    if tp == 1:
        return fused_qk_flash_attention(q_raw, k_raw, v, w_q, w_k, cos, sin,
                                        num_heads=h_local, eps=eps,
                                        scale=scale)
    ssq = torch.stack([q_raw.float().square().sum(-1),
                       k_raw.float().square().sum(-1)])    # [2, B_l, S]
    dist.all_reduce(ssq, group=mesh.tp_group)
    rstd = torch.rsqrt(ssq / (tp * q_raw.shape[-1]) + eps)
    return _fused_qk_flash(q_raw, k_raw, v, w_q, w_k, cos, sin, h_local, eps,
                           scale, True, rstd=rstd)


def fused_ln_qk_flash_attention(q_raw, k_raw, v, w_q, b_q, w_k, b_k, cos,
                                sin, *, num_heads: int, eps: float,
                                scale: Optional[float] = None,
                                static_softmax: bool = True):
    """Joint [text; video] self-attention with the per-head LayerNorm +
    RoPE producers (counterpart of ``_fused_ln_qk_flash_impl``).

    q_raw/k_raw: [B, S, H*D] straight out of the to_q/to_k denses. v:
    [B, H, S, D]. w/b: [D] LayerNorm gamma/beta of norm_q / norm_k.
    cos/sin: joint [S, D/2] tables, cos 1 / sin 0 over the text prefix.
    Returns [B, H, S, D]. The softmax scale * log2(e) is folded into q's
    tables (so text q rows are scaled too); ``static_softmax`` takes the
    Cauchy-Schwarz bound and K1, otherwise K3 with q_scale 1.
    """
    B, S, HD = q_raw.shape
    H = num_heads
    D = HD // H
    scale = scale if scale is not None else _default_scale(D)
    gain = scale * LOG2E
    cos = cos.float()
    sin = sin.float()
    params = [t.float().contiguous() for t in (w_q, b_q, w_k, b_k)]
    qh = qk_ln_rope(q_raw, params[0], params[1], (cos * gain).contiguous(),
                    (sin * gain).contiguous(), H, eps)
    kh = qk_ln_rope(k_raw, params[2], params[3], cos.contiguous(),
                    sin.contiguous(), H, eps)
    vh = v.reshape(B * H, S, D)
    if static_softmax:
        bound = _rowmax_norm(qh) * _rowmax_norm(kh)
        out = flash_fwd_static(qh, kh, vh, bound)
    else:
        out = flash_fwd(qh, kh, vh, 1.0)
    return out.reshape(B, H, S, D)


# ---------------------------------------------------------------------------
# Under a process mesh (core/meshes.py): the fused CogVideoX path on a tp
# rank, and the sequence-parallel dispatch. Every function here runs on the
# rank's own tensors: the body of JAX's shard_map, not its global view.
# ---------------------------------------------------------------------------

def fused_sharded_supported(mesh, batch: int, num_heads: int) -> bool:
    """True iff the fused-producer paths run under ``mesh`` (JAX's
    ``fused_sharded_supported``): the sequence unsharded (the producers
    take the whole sequence's RoPE rows), the whole ``batch`` dividing dp,
    the heads dividing tp."""
    if mesh.sp > 1 or mesh.cfg.pp > 1:
        return False
    return (batch % (mesh.dp * mesh.cfg.fsdp) == 0
            and num_heads % mesh.tp == 0)


def fused_ln_qk_flash_attention_sharded(q_raw, k_raw, v, w_q, b_q, w_k,
                                        b_k, cos, sin, mesh, *,
                                        num_heads: int, eps: float,
                                        scale: Optional[float] = None):
    """``fused_ln_qk_flash_attention`` on one rank of a dp x tp mesh: the
    body of JAX's ``fused_ln_qk_flash_attention_sharded`` shard_map, on the
    rank's own tensors.

    q_raw/k_raw: [B_l, S, H_l*D], the rank's batch slice and contiguous
    head slice straight out of its column-parallel to_q/to_k; v
    [B_l, H_l, S, D]; w/b: the [D] LayerNorm gamma/beta, replicated;
    ``num_heads`` counts ALL heads (H = H_l * tp). Returns
    [B_l, H_l, S, D]. The per-head LayerNorm statistic is local to each
    head, so no collective runs: K4 on the rank's heads, the rank's own
    static bound (from its heads only, as each JAX shard computes it),
    then K1: ``fused_ln_qk_flash_attention`` with the rank's head count,
    which is what the CogVideoX DiT calls; this form pins it to JAX's
    sharded function."""
    if num_heads % mesh.tp:
        raise ValueError(f"{num_heads} heads do not divide over "
                         f"tp={mesh.tp}")
    return fused_ln_qk_flash_attention(q_raw, k_raw, v, w_q, b_q, w_k, b_k,
                                       cos, sin,
                                       num_heads=num_heads // mesh.tp,
                                       eps=eps, scale=scale)


# The sequence-parallel strategy (JAX's switch): "allgather" gathers the
# keys and values over the sp group once; "ring" passes their shards round
# it, one hop at a time, with an fp32 online softmax across the hops.
DEFAULT_SP_METHOD = "allgather"
SP_METHODS = ("allgather", "ring")

# the fp32 scores of one ring hop, per head chunk, are kept near this size
RING_SCORE_BYTES = 2 << 30


def sp_supported(mesh, q_shape) -> bool:
    """True iff ``mesh`` can cut this self-attention's sequence over sp
    (JAX's ``sp_supported``, on the GLOBAL shape ``q_shape`` [B, H, S, D]
    of the whole batch, heads and sequence): sp > 1, S divides sp, B
    divides dp, H divides tp. Where it fails, the DiTs run the whole
    sequence on every sp rank: the same result, no sp collective."""
    if mesh.sp <= 1:
        return False
    B, H, S, _ = q_shape
    return (S % mesh.sp == 0 and B % (mesh.dp * mesh.cfg.fsdp) == 0
            and H % mesh.tp == 0)


SP_TRAINING_NOT_PORTED = (
    "training under sp > 1 is not ported: K6 over keys gathered by a "
    "differentiable all-gather is ROADMAP.md queue 1, item 12.8")


def dispatch_attention(q, k, v, *, mesh=None, gather_kv: bool = True,
                       scale: Optional[float] = None,
                       sp_method: Optional[str] = None,
                       differentiable: bool = False):
    """Attention on one rank's [B_l, H_l, S_l, D] tensors (JAX's
    ``dispatch_attention``).

    ``differentiable``: the training route, K6 (``flash_attention_train``)
    on the rank's batch and head shard under any mesh with sp = 1 (JAX's
    ``sp_attention`` runs the local differentiable attention there);
    under sp > 1 it raises (``SP_TRAINING_NOT_PORTED``). Otherwise the
    forward only:

    ``mesh``: the mesh, where q holds the rank's shard of a sequence cut
    over sp (and k/v theirs, with ``gather_kv``); None where every rank
    holds the whole sequence (no mesh, an sp = 1 mesh, a sequence that sp
    does not divide). Then, and for an sp = 1 mesh, K3 runs on the local
    tensors. Otherwise ``sp_method`` (default ``DEFAULT_SP_METHOD``)
    decides: "ring" with ``gather_kv`` runs ``ring_attention``, anything
    else ``sp_attention`` (K3 over the gathered keys, or over the
    replicated ones without ``gather_kv``: cross-attention to the text)."""
    if differentiable:
        if mesh is not None and mesh.sp > 1:
            raise NotImplementedError(SP_TRAINING_NOT_PORTED)
        return flash_attention_train(q, k, v, scale)
    method = sp_method or DEFAULT_SP_METHOD
    if method not in SP_METHODS:
        raise ValueError(f"sp_method must be one of {SP_METHODS}, got "
                         f"{method!r}")
    if mesh is None or mesh.sp == 1:
        return flash_attention_inference(q, k, v, scale)
    if method == "ring" and gather_kv:
        return ring_attention(q, k, v, mesh, scale)
    return sp_attention(q, k, v, mesh, scale, gather_kv=gather_kv)


def sequence_cut(mesh, num_heads: int, n_tokens: int):
    """How a DiT cuts its ``n_tokens`` over sp (after the dp slice of the
    batch, which divides): under a mesh with sp > 1 whose cut
    ``sp_supported`` passes, (mesh, a function taking this sp rank's
    contiguous ``n_tokens / sp`` rows of a tensor along a dim, 0 by
    default); otherwise (None, the identity): every sp rank keeps the
    whole sequence."""
    if mesh is None or not sp_supported(mesh,
                                        (mesh.dp, num_heads, n_tokens, 1)):
        return None, lambda t, dim=0: t
    n = n_tokens // mesh.sp
    r0 = mesh.sp_rank * n
    return mesh, lambda t, dim=0: t.narrow(dim, r0, n)


def gather_sequence(t, mesh, dim: int):
    """Every sp rank's shard of ``t``, joined in sp order along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(mesh.sp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.sp_group)
    return torch.cat(parts, dim=dim)


def sp_attention(q, k, v, mesh, scale: Optional[float] = None, *,
                 gather_kv: bool = True):
    """All-gather-KV sequence-parallel attention on one rank (the body of
    JAX's ``sp_attention`` shard_map): q [B_l, H_l, S/sp, D] is the rank's
    sequence shard. With ``gather_kv`` the k/v shards of every sp rank are
    gathered over the sp group (one all-gather of both, in rank order),
    then K3 runs the rank's queries against the whole sequence; without it
    (cross-attention to replicated text) K3 runs on the k/v given."""
    if gather_kv and mesh.sp > 1:
        k, v = gather_sequence(torch.stack([k, v]), mesh, dim=3).unbind(0)
    return flash_attention_inference(q, k, v, scale)


def _ring_pass(t, mesh):
    """``t`` sent to the next sp rank, the previous one's received (i ->
    i + 1 round the ring; both posted at once, so no rank waits on another's
    order). gloo sends host tensors, so a CUDA tensor goes through host
    memory under gloo and stays on the card under NCCL."""
    sp, r = mesh.sp, mesh.sp_rank
    base = mesh.rank - r
    nxt = mesh.process(base + (r + 1) % sp)
    prv = mesh.process(base + (r - 1) % sp)
    staged = t.is_cuda and dist.get_backend(mesh.sp_group) == "gloo"
    send = t.cpu() if staged else t.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, mesh.sp_group),
        dist.P2POp(dist.irecv, recv, prv, mesh.sp_group)])
    for req in reqs:
        req.wait()
    return recv.to(t.device) if staged else recv


def ring_head_chunk(B: int, H: int, Sq: int, Skv: int) -> int:
    """Heads a chunk of the ring's score products: all of them, or as many
    as keep [B, chunk, Sq, Skv] fp32 scores near RING_SCORE_BYTES."""
    return max(1, min(H, RING_SCORE_BYTES // (B * Sq * Skv * 4)))


def ring_attention(q, k, v, mesh, scale: Optional[float] = None):
    """Ring sequence-parallel attention on one rank (the body of JAX's
    ``ring_attention`` shard_map): q, k, v [B_l, H_l, S/sp, D] are the
    rank's sequence shards. The k/v shards move round the sp ring, i ->
    i + 1, so hop j holds the shard of rank i - j (the rank's own first);
    each hop's scores are taken in fp32 and merged by an online softmax:
    running max m, ``exp(s - m_new)``, the sums and the P V accumulator
    rescaled by ``exp(m - m_new)``, both in fp32, then divided and cast to
    q's dtype. JAX computes this with einsums outside any Pallas kernel;
    here it is ``torch.matmul`` and plain ops, its fp32 products in full
    fp32 under the port's numerics (``serve.configure_cuda_numerics``
    turns TF32 off).

    The heads are taken in chunks (``ring_head_chunk``: as many as keep a
    hop's fp32 scores near RING_SCORE_BYTES; 35 GB for all 48 heads at
    CogVideoX's sp = 2); heads are independent, so the chunking changes no
    bit."""
    scale = scale if scale is not None else _default_scale(q.shape[-1])
    sp = mesh.sp
    B, H, Sq, D = q.shape
    qf = q.float() * scale
    m = torch.full((B, H, Sq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    chunk = ring_head_chunk(B, H, Sq, k.shape[2])
    for hop in range(sp):
        for h0 in range(0, H, chunk):
            h = slice(h0, min(H, h0 + chunk))
            s = torch.matmul(qf[:, h], kv[0, :, h].float().transpose(-1, -2))
            m_new = torch.maximum(m[:, h], s.amax(dim=-1, keepdim=True))
            p = torch.exp(s.sub_(m_new))
            del s
            alpha = torch.exp(m[:, h] - m_new)
            l[:, h] = alpha * l[:, h] + p.sum(dim=-1, keepdim=True)
            acc[:, h] = alpha * acc[:, h] + torch.matmul(
                p, kv[1, :, h].float())
            m[:, h] = m_new
            del p
        if hop + 1 < sp:
            kv = _ring_pass(kv, mesh)
    return (acc / l).to(q.dtype)


# the launch counts of every kernel of the port, K7 (the int8 path's
# row quantizer, ops/dyn_quant.py) among them
_COUNTED = (flash_fwd_static, qk_norm_rope, flash_fwd, qk_ln_rope,
            flash_attn_train_fwd, flash_attn_train_bwd,
            dyn_quant.dynamic_quantize_rows, qk_norm_rope_rstd)


def reset_launch_counts():
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}

