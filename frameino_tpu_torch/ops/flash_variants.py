"""The experiment flash forwards: five softmax variants and the
head-pair-packed kernel, with the plain PyTorch version of each.

Counterpart of the kernel and wrapper halves of
``scripts/bench_flash_variants.py`` and ``scripts/bench_attn_d64.py``, the
two scripts with which the JAX package decided what its flash kernel looks
like. Against the online-softmax forward K3 (``ops/attention.flash_fwd``,
variant ``v0``) they switch three things, and pack two heads a row:

- ``flash_v1`` (K9): the row sum l by a ones column of V, so on the tensor
  cores: ``l = sum_j bf16(p_ij)`` in fp32, rescaled with the accumulator;
- ``flash_v2`` (K10): ``p = exp2(s - bound)`` with a bound on every logit
  computed outside (``_bound``): no running max, no rescale, no floor
  under the exponent; l by a lane sum of fp32 p;
- ``flash_v12`` (K10, ``flash_v2(ones_col=True)``): both;
- ``flash_v3`` (K12): QK^T on per-row int8 codes, ``s = fp32(q_i8 . k_i8)
  * qs * ks`` (``_quant_rows`` outside, softmax scale * log2(e) folded
  into qs), online softmax, lane sum, bf16 P.V;
- ``flash_v123`` (K11, ``flash_v3(static_ones=True)``): the int8 logits
  with the bound taken from the codes and the ones column;
- ``packed_flash`` (K8): head_dim 64, two heads side by side in 128-wide
  rows ``[B*H/2, S, 128]``, two independent online softmaxes a row.

K8, K9-K10 and K11-K12 are persistent TMA + ``wgmma`` kernels of one
design (K1/K3's): ``csrc/flash_variants.cu`` with a bf16 S product and q
pre-scaled in the kernel (``bf16_flash`` launches it on a bound made
beforehand), ``csrc/flash_int8.cu`` on int8 codes (``int8_flash``
launches it on given codes) and ``csrc/flash_packed.cu`` on packed rows
(``packed_rows`` launches it on rows packed beforehand). Each wrapper
takes the JAX
function's arguments ([B, H, S, D] tensors), launches its kernel for CUDA
tensors (bf16, contiguous, head_dim 64 or 128) and raises on anything else;
for CPU tensors it runs the plain version beside it (``*_ref``). Each counts its
kernel launches in ``<wrapper>.launches``. ``block_q`` / ``block_k`` stay
in the signatures for the reader of both packages and are ignored: the
kernels have their own tiles and mask ragged edges, so nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from frameino_tpu_torch.ops.attention import LOG2E, flash_fwd_ref
from frameino_tpu_torch.ops.cuda_build import check_cuda_bf16, lib

_PACKED_HEAD_DIM = 64


# ---------------------------------------------------------------------------
# What the scripts compute outside the kernels: plain tensor ops
# ---------------------------------------------------------------------------

def _prescale(q, scale: float):
    """q * (scale * log2e) in q's dtype, as ``_prep`` does."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype)


def _row_norm(x):
    """fp32 L2 norm of each row, [..., S, 1] (no fp32 copy of a float x)."""
    x = x if x.is_floating_point() else x.float()
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True,
                                    dtype=torch.float32)


def _bound(q, k, scale: float):
    """max row L2 of q times max row L2 of k times scale * log2e: by
    Cauchy-Schwarz at least every logit of the pre-scaled q. [1, 1] fp32."""
    return (_row_norm(q).amax() * _row_norm(k).amax() * scale * LOG2E
            ).reshape(1, 1)


def _quant_rows(x):
    """[..., S, D] -> int8 codes and [..., S, 1] fp32 scales: symmetric per
    row, ``scale = max(amax, 1e-6) / 127`` by true division, codes rounded
    half to even and clipped to +-127. (Not K7: that one floors at 1e-12,
    multiplies by the reciprocal and does not clip.)"""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-6) / 127.0
    xi = torch.clamp(torch.round(xf / sc), -127, 127)
    return xi.to(torch.int8), sc


def quantize_qk(q, k, scale: float):
    """The int8 variants' inputs: (q codes, q scales with scale * log2e
    folded in, k codes, k scales)."""
    qi, qs = _quant_rows(q)
    ki, ks = _quant_rows(k)
    return qi, qs * (scale * LOG2E), ki, ks


def int8_bound(qi, qs, ki, ks):
    """The static bound of the int8 logits, from the codes: max row L2 of
    the dequantized q times that of k. 0-dim fp32."""
    return (_row_norm(qi) * qs).amax() * (_row_norm(ki) * ks).amax()


def pack(x):
    """[B, H, S, 64] -> [B*H/2, S, 128]: head pairs side by side."""
    B, H, S, D = x.shape
    x = x.reshape(B, H // 2, 2, S, D).permute(0, 1, 3, 2, 4)
    return x.reshape(B * H // 2, S, 2 * D)


def unpack(x, batch: int):
    """[B*H/2, S, 128] -> [B, H, S, 64]: the inverse of ``pack``."""
    pairs, S, D2 = x.shape
    x = x.reshape(batch, pairs // batch, S, 2, D2 // 2).permute(0, 1, 3, 2, 4)
    return x.reshape(batch, 2 * pairs // batch, S, D2 // 2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _softmax_pv(s, v, bound, ones_col: bool, out_dtype):
    """exp2-domain softmax of fp32 logits ``s`` times v. ``bound`` None:
    shifted by the row maximum (what the online kernels converge to), else
    ``exp2(s - bound)``. The probabilities are cast to v's dtype for the
    product; l sums those ROUNDED probabilities (``ones_col``: the row sum
    comes out of the same product) or the fp32 ones (lane sum)."""
    shift = s.amax(dim=-1, keepdim=True) if bound is None \
        else bound.reshape(()).float()
    p = torch.exp2(s - shift)
    pv = p.to(v.dtype).float()
    l = (pv if ones_col else p).sum(dim=-1, keepdim=True)
    return (torch.matmul(pv, v.float()) / l).to(out_dtype)


def _bf16_logits(q, k, scale):
    return torch.matmul(_prescale(q, scale).float(),
                        k.float().transpose(-1, -2))


def flash_v1_ref(q, k, v, *, scale: float):
    """Plain version of K9: online softmax, l = sum of bf16(p)."""
    return _softmax_pv(_bf16_logits(q, k, scale), v, None, True, q.dtype)


def flash_v2_ref(q, k, v, *, scale: float):
    """Plain version of K10 (lane sum): exp2(s - bound), l = sum of p."""
    return _softmax_pv(_bf16_logits(q, k, scale), v, _bound(q, k, scale),
                       False, q.dtype)


def flash_v12_ref(q, k, v, *, scale: float):
    """Plain version of K10 (ones column): exp2(s - bound), l = sum of
    bf16(p)."""
    return _softmax_pv(_bf16_logits(q, k, scale), v, _bound(q, k, scale),
                       True, q.dtype)


def int8_flash_ref(qi, qs, ki, ks, v, bound=None):
    """Plain version of K12 (``bound`` None: online softmax, lane sum) and
    K11 (``bound``: static, ones column) on given codes and scales: qi/ki
    [..., S, D] int8, qs/ks [..., S, 1] fp32. The int32 product is exact in
    fp32 (|s_i| <= 127 * 127 * 128 < 2**24); the scales multiply in the
    kernels' order, q's first."""
    s_i = torch.matmul(qi.float(), ki.float().transpose(-1, -2))
    s = s_i * qs * ks.transpose(-1, -2)
    return _softmax_pv(s, v, bound, bound is not None, v.dtype)


def flash_v3_ref(q, k, v, *, scale: float):
    """Plain version of K12."""
    return int8_flash_ref(*quantize_qk(q, k, scale), v)


def flash_v123_ref(q, k, v, *, scale: float):
    """Plain version of K11."""
    codes = quantize_qk(q, k, scale)
    return int8_flash_ref(*codes, v, int8_bound(*codes))


def packed_rows_ref(qp, kp, vp):
    """Plain version of K8's kernel on packed rows [pairs, S, 128]: each
    64-lane half is one head's online-softmax attention (K3's plain
    version at softmax scale 64 ** -0.5)."""
    D = _PACKED_HEAD_DIM
    c = D ** -0.5 * LOG2E
    return torch.cat([flash_fwd_ref(qp[..., h:h + D], kp[..., h:h + D],
                                    vp[..., h:h + D], c) for h in (0, D)],
                     dim=-1)


def packed_flash_ref(q, k, v):
    """Plain version of K8 on [B, H, S, 64] heads: ``pack``, the plain
    version on the packed rows, ``unpack``."""
    return unpack(packed_rows_ref(pack(q), pack(k), pack(v)), q.shape[0])


# ---------------------------------------------------------------------------
# K9-K10: csrc/flash_variants.cu; K11-K12: csrc/flash_int8.cu
# ---------------------------------------------------------------------------

def _check_qkv(name, q, k, v, head_dims=(64, 128)):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, H, S, D] "
                         f"shape, got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{head_dims}")
    if q.shape[2] == 0:
        raise ValueError(f"{name}: empty sequence")
    check_cuda_bf16(name, q, k, v)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# the C entry's body of each bf16 wrapper (csrc/flash_variants.cu)
BF16_BODIES = {"flash_v1": 1, "flash_v2": 2, "flash_v12": 12}


def variants_smem_layout(head_dim: int) -> dict:
    """The shared memory of a block of ``csrc/flash_variants.cu`` at a
    head_dim (64 or 128), as its ``Layout`` lays it out; the library's
    ``flash_variants_config`` reports the same numbers on a card. Byte
    offsets from the block's 1024-aligned base: two bf16 Q buffers of
    ``q_rows`` rows, then ``stages`` bf16 K tiles and V tiles of 128 keys,
    512 bytes of bf16 ones (the B operand of the ones column) and the
    mbarriers. A tile of D columns is D / 64 column blocks (``q_block`` /
    ``kv_block`` bytes each) of 128-byte rows, 128-byte swizzled."""
    if head_dim not in (64, 128):
        raise ValueError(f"head_dim {head_dim} not in (64, 128)")
    cwg, stages, keys = (3, 4, 128) if head_dim == 64 else (2, 2, 128)
    out = dict(consumer_wgs=cwg, q_rows=64 * cwg, stages=stages, keys=keys,
               swizzle=128, column_blocks=head_dim // 64, q=0,
               q_block=64 * cwg * 128, q_tile=64 * cwg * 2 * head_dim,
               kv_block=keys * 128, kv_tile=keys * 2 * head_dim)
    out["k"] = 2 * out["q_tile"]
    out["v"] = out["k"] + stages * out["kv_tile"]
    out["ones"] = out["v"] + stages * out["kv_tile"]
    out["bars"] = out["ones"] + 512
    out["smem_bytes"] = out["bars"] + (6 + 4 * stages) * 8 + 1024
    return out


def bf16_flash(q, k, v, bound, body: int, *, scale: float, library=None):
    """K9 (``body`` 1: online softmax, l by the ones column; ``bound``
    None) or K10 (2: ``p = exp2(s - bound)``, l by a lane sum; 12: the same
    with the ones column) on q, k, v [B, H, S, D] bf16 and, for K10, a
    bound made beforehand (one fp32, ``_bound``'s); q is pre-scaled by
    bf16(scale * log2e) in the kernel. CUDA: the kernel of
    ``csrc/flash_variants.cu`` (or of ``library``, another build of its C
    interface); CPU: the plain version on the same bound. Counts no
    launch: the wrappers ``flash_v1`` / ``flash_v2`` / ``flash_v12`` do."""
    if body not in BF16_BODIES.values():
        raise ValueError(f"bf16_flash: body {body} not in "
                         f"{sorted(BF16_BODIES.values())}")
    static = body != 1
    if static != (bound is not None):
        raise ValueError("bf16_flash: bodies 2 and 12 take a bound, body 1 "
                         "none")
    if not q.is_cuda:
        return _softmax_pv(_bf16_logits(q, k, scale), v, bound, body != 2,
                           q.dtype)
    _check_qkv("bf16_flash", q, k, v)
    if static and (not bound.is_cuda or bound.dtype != torch.float32
                   or bound.numel() != 1):
        raise ValueError("bf16_flash: bound must be one fp32 on the card")
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    q_scale = float(torch.tensor(scale * LOG2E, dtype=torch.bfloat16))
    err = (library or lib("flash_variants")).flash_variant_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        bound.data_ptr() if static else 0, B * H, S, S, D, body, q_scale,
        _stream(q))
    if err != 0:
        raise RuntimeError(f"bf16_flash: flash_variant_bf16 launch failed: "
                           f"CUDA error {err}")
    return o


def int8_smem_layout(head_dim: int) -> dict:
    """The shared memory of a block of ``csrc/flash_int8.cu`` at a head_dim
    (64 or 128), as its ``Layout`` lays it out; the library's
    ``flash_int8_config`` reports the same numbers on a card. Byte offsets
    from the block's 1024-aligned base: two int8 Q buffers of ``q_rows``
    rows, then ``stages`` int8 K tiles and bf16 V tiles of 128 keys,
    ``ks_slots`` slots of 128 fp32 key scales, 512 bytes of bf16 ones (the B
    operand of K11's ones column) and the mbarriers. An int8 row of D bytes
    is one swizzle atom of D bytes (``swizzle``)."""
    if head_dim not in (64, 128):
        raise ValueError(f"head_dim {head_dim} not in (64, 128)")
    cwg, stages, keys = (3, 4, 128) if head_dim == 64 else (2, 3, 128)
    out = dict(consumer_wgs=cwg, q_rows=64 * cwg, stages=stages, keys=keys,
               ks_slots=4,
               swizzle=head_dim, q=0, q_tile=64 * cwg * head_dim,
               k_tile=keys * head_dim, v_tile=keys * 2 * head_dim)
    out["k"] = 2 * out["q_tile"]
    out["v"] = out["k"] + stages * out["k_tile"]
    out["ks"] = out["v"] + stages * out["v_tile"]
    out["ones"] = out["ks"] + out["ks_slots"] * keys * 4
    out["bars"] = out["ones"] + 512
    out["smem_bytes"] = (out["bars"] + (4 + 4 * stages + 2 * out["ks_slots"])
                         * 8 + 1024)
    return out


def _check_codes(qi, qs, ki, ks, v, bound):
    if qi.ndim != 4 or ki.shape != qi.shape or v.shape != qi.shape:
        raise ValueError(f"int8_flash: codes and v must share one [B, H, S, "
                         f"D] shape, got {tuple(qi.shape)} {tuple(ki.shape)} "
                         f"{tuple(v.shape)}")
    if qi.shape[-1] not in (64, 128) or qi.shape[2] == 0:
        raise ValueError(f"int8_flash: shape {tuple(qi.shape)}: head_dim 64 "
                         f"or 128 and a non-empty sequence")
    check_cuda_bf16("int8_flash", v)
    for name, t, dtype, shape in (("qi", qi, torch.int8, qi.shape),
                                  ("ki", ki, torch.int8, qi.shape),
                                  ("qs", qs, torch.float32, qi.shape[:3] + (1,)),
                                  ("ks", ks, torch.float32, qi.shape[:3] + (1,))):
        if (not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"int8_flash: {name} must be a contiguous, "
                             f"16-byte aligned {dtype} CUDA tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if bound is not None and (not bound.is_cuda or bound.dtype != torch.float32
                              or bound.numel() != 1):
        raise ValueError("int8_flash: bound must be one fp32 on the card")


def int8_flash(qi, qs, ki, ks, v, bound=None, *, library=None):
    """K12 (``bound`` None: online softmax, lane sum) or K11 (``bound``:
    static, ones column) on given codes and scales, the arguments of
    ``int8_flash_ref``: qi/ki [B, H, S, D] int8, qs/ks [B, H, S, 1] fp32, v
    [B, H, S, D] bf16, bound one fp32. CUDA: the kernel of
    ``csrc/flash_int8.cu`` (or of ``library``, another build of its C
    interface); CPU: ``int8_flash_ref``. Counts no launch: the wrappers
    ``flash_v3`` / ``flash_v123`` do."""
    if not v.is_cuda:
        return int8_flash_ref(qi, qs, ki, ks, v, bound)
    _check_codes(qi, qs, ki, ks, v, bound)
    B, H, S, D = qi.shape
    o = torch.empty_like(v)
    err = (library or lib("flash_int8")).flash_variant_int8(
        qi.data_ptr(), qs.data_ptr(), ki.data_ptr(), ks.data_ptr(),
        v.data_ptr(), o.data_ptr(), 0 if bound is None else bound.data_ptr(),
        B * H, S, S, D, int(bound is not None), _stream(v))
    if err != 0:
        raise RuntimeError(f"int8_flash: flash_variant_int8 launch failed: "
                           f"CUDA error {err}")
    return o


def _launch_int8(name, q, k, v, scale: float, static_ones: bool):
    """The int8-logit bodies on [B, H, S, D]: codes, scales and (static)
    the bound are tensor ops here, the attention is the kernel."""
    _check_qkv(name, q, k, v)
    codes = quantize_qk(q, k, scale)
    bound = int8_bound(*codes).reshape(1) if static_ones else None
    return int8_flash(*codes, v, bound)


def flash_v1(q, k, v, *, scale: float, block_q: Optional[int] = None,
             block_k: Optional[int] = None):
    """K9 (replaces ``flash_v1`` / ``_kernel_v1``): online softmax with the
    row sum as a ones column of the P.V product. q/k/v [B, H, S, D]. CUDA:
    kernel; CPU: ``flash_v1_ref``."""
    if not q.is_cuda:
        return flash_v1_ref(q, k, v, scale=scale)
    out = bf16_flash(q, k, v, None, 1, scale=scale)
    flash_v1.launches += 1
    return out


flash_v1.launches = 0


def flash_v12(q, k, v, *, scale: float, block_q: Optional[int] = None,
              block_k: Optional[int] = None):
    """K10, ones-column body (replaces ``flash_v2(ones_col=True)`` /
    ``_kernel_v12``). CUDA: kernel; CPU: ``flash_v12_ref``."""
    if not q.is_cuda:
        return flash_v12_ref(q, k, v, scale=scale)
    out = bf16_flash(q, k, v, _bound(q, k, scale).reshape(1), 12,
                     scale=scale)
    flash_v12.launches += 1
    return out


flash_v12.launches = 0


def flash_v2(q, k, v, *, scale: float, block_q: Optional[int] = None,
             block_k: Optional[int] = None, ones_col: bool = False):
    """K10 (replaces ``flash_v2`` / ``_kernel_v2``): static-bound softmax,
    ``p = exp2(s - bound)`` without a floor, the bound a device scalar that
    is never synced to the host. ``ones_col``: ``flash_v12``. CUDA: kernel;
    CPU: ``flash_v2_ref``."""
    if ones_col:
        return flash_v12(q, k, v, scale=scale)
    if not q.is_cuda:
        return flash_v2_ref(q, k, v, scale=scale)
    out = bf16_flash(q, k, v, _bound(q, k, scale).reshape(1), 2,
                     scale=scale)
    flash_v2.launches += 1
    return out


flash_v2.launches = 0


def flash_v123(q, k, v, *, scale: float, block_q: Optional[int] = None,
               block_k: Optional[int] = None):
    """K11 (replaces ``flash_v3(static_ones=True)`` / ``_kernel_v123``):
    int8 QK^T with the static bound from the codes and the ones column.
    CUDA: kernel; CPU: ``flash_v123_ref``."""
    if not q.is_cuda:
        return flash_v123_ref(q, k, v, scale=scale)
    out = _launch_int8("flash_v123", q, k, v, scale, True)
    flash_v123.launches += 1
    return out


flash_v123.launches = 0


def flash_v3(q, k, v, *, scale: float, block_q: Optional[int] = None,
             block_k: Optional[int] = None, static_ones: bool = False):
    """K12 (replaces ``flash_v3`` / ``_kernel_v3``): int8 QK^T with per-row
    scales, online softmax, bf16 P.V. ``static_ones``: ``flash_v123``.
    CUDA: kernel; CPU: ``flash_v3_ref``."""
    if static_ones:
        return flash_v123(q, k, v, scale=scale)
    if not q.is_cuda:
        return flash_v3_ref(q, k, v, scale=scale)
    out = _launch_int8("flash_v3", q, k, v, scale, False)
    flash_v3.launches += 1
    return out


flash_v3.launches = 0


# ---------------------------------------------------------------------------
# K8: csrc/flash_packed.cu
# ---------------------------------------------------------------------------

def packed_smem_layout() -> dict:
    """The shared memory of a block of ``csrc/flash_packed.cu``, as its
    ``Layout`` lays it out; the library's ``flash_packed_config`` reports
    the same numbers on a card. Byte offsets from the block's 1024-aligned
    base: two bf16 Q buffers of ``q_rows`` packed rows, then ``stages`` K
    tiles and V tiles of 128 keys, and the mbarriers. A packed tile is two
    column blocks of 128-byte rows, 128-byte swizzled: head A's 64 lanes
    (``q_block`` / ``kv_block`` bytes), then head B's."""
    cwg, stages, keys = 2, 2, 128
    out = dict(consumer_wgs=cwg, q_rows=64 * cwg, stages=stages, keys=keys,
               swizzle=128, column_blocks=2, q=0, q_block=64 * cwg * 128,
               q_tile=64 * cwg * 2 * 128, kv_block=keys * 128,
               kv_tile=keys * 2 * 128)
    out["k"] = 2 * out["q_tile"]
    out["v"] = out["k"] + stages * out["kv_tile"]
    out["bars"] = out["v"] + stages * out["kv_tile"]
    out["smem_bytes"] = out["bars"] + (6 + 4 * stages) * 8 + 1024
    return out


def packed_rows(qp, kp, vp, *, library=None):
    """K8's kernel on packed rows made beforehand: qp/kp/vp [pairs, S, 128]
    bf16, each row [head A | head B]; q is pre-scaled by bf16(64 ** -0.5 *
    log2e) in the kernel. CUDA: the kernel of ``csrc/flash_packed.cu`` (or
    of ``library``, another build of its C interface); CPU:
    ``packed_rows_ref``. Counts no launch: ``packed_flash`` does."""
    if not qp.is_cuda:
        return packed_rows_ref(qp, kp, vp)
    if (qp.ndim != 3 or qp.shape[-1] != 2 * _PACKED_HEAD_DIM
            or kp.shape != qp.shape or vp.shape != qp.shape
            or qp.shape[1] == 0):
        raise ValueError(f"packed_rows: q, k, v must share one non-empty "
                         f"[pairs, S, {2 * _PACKED_HEAD_DIM}] shape, got "
                         f"{tuple(qp.shape)} {tuple(kp.shape)} "
                         f"{tuple(vp.shape)}")
    check_cuda_bf16("packed_rows", qp, kp, vp)
    o = torch.empty_like(qp)
    q_scale = float(torch.tensor(_PACKED_HEAD_DIM ** -0.5 * LOG2E,
                                 dtype=torch.bfloat16))
    err = (library or lib("flash_packed")).flash_packed_bf16(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
        qp.shape[0], qp.shape[1], kp.shape[1], q_scale, _stream(qp))
    if err != 0:
        raise RuntimeError(f"packed_rows: flash_packed_bf16 launch failed: "
                           f"CUDA error {err}")
    return o


def packed_flash(q, k, v, *, block_q: Optional[int] = None,
                 block_k: Optional[int] = None):
    """K8 (replaces ``packed_flash`` / ``_packed_kernel``): attention of
    [B, H, S, 64] heads, two a row: ``pack`` -> kernel on [B*H/2, S, 128]
    -> ``unpack``. The softmax scale is 64 ** -0.5. CUDA: kernel; CPU:
    ``packed_flash_ref``."""
    if not q.is_cuda:
        return packed_flash_ref(q, k, v)
    _check_qkv("packed_flash", q, k, v, head_dims=(_PACKED_HEAD_DIM,))
    if q.shape[1] % 2:
        raise ValueError(f"packed_flash: {q.shape[1]} heads do not pair")
    o = packed_rows(*(pack(t).contiguous() for t in (q, k, v)))
    packed_flash.launches += 1
    return unpack(o, q.shape[0]).contiguous()


packed_flash.launches = 0


_COUNTED = (flash_v1, flash_v2, flash_v12, flash_v3, flash_v123,
            packed_flash)


def reset_launch_counts():
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}
