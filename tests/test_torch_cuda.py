"""The port's Hopper kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA GPU and skips without one; run them
on a GPU machine with ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from frameino_tpu_torch.models import cogvideox_dit as cdit
from frameino_tpu_torch.models import quant
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.ops import dyn_quant
from frameino_tpu_torch.ops import flash_variants as FV
from frameino_tpu_torch.ops.linear import dense_int8
from frameino_tpu_torch.ops.rope import cogvideox_rope_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _bf16_ulp(x):
    ax = torch.clamp(x.abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _assert_flash_close(got, ref):
    # bf16 outputs of fp32 softmax sums in another order: 2e-2
    # elementwise, and the relative L2 limit chip_smoke.py holds them to
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert _rel_l2(got, ref) <= 5e-3


def _flash_inputs(dev, d, sq, skv, seed=0, bh=3):
    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(bh, n, d, device=dev, dtype=torch.bfloat16,
                             generator=g) for n in (sq, skv, skv))


# (1, 1) and (1, 77): a single ragged q row; (77, 1): one key; (300, 129):
# 3 q tiles and a 1-key tail; (384, 684 = 5 * 128 + 44): ragged key tiles
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(100, 77), (130, 512), (64, 64), (1, 1),
                                    (1, 77), (77, 1), (300, 129),
                                    (384, 684)])
def test_flash_kernels_match_plain(dev, d, sq, skv):
    q, k, v = _flash_inputs(dev, d, sq, skv)
    c = d ** -0.5 * A.LOG2E
    before = A.launch_counts()
    got = A.flash_fwd(q, k, v, c)
    ref = A.flash_fwd_ref(q, k, v, c)
    qs = (q.float() * c).to(torch.bfloat16)
    bound = A._rowmax_norm(qs) * A._rowmax_norm(k)
    got_s = A.flash_fwd_static(qs, k, v, bound)
    ref_s = A.flash_fwd_static_ref(qs, k, v, bound)
    torch.cuda.synchronize()
    _assert_flash_close(got, ref)
    _assert_flash_close(got_s, ref_s)
    after = A.launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert after["flash_fwd_static"] == before["flash_fwd_static"] + 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(300, 129), (130, 512)])
def test_flash_k3_with_a_unit_q_scale(dev, d, sq, skv):
    """K3 with q_scale == 1 (the fused paths' call; the kernel skips its
    rescale pass) equals its plain version, and equals K3 on the same q
    pre-scaled outside with the scale passed in."""
    q, k, v = _flash_inputs(dev, d, sq, skv, seed=5)
    got = A.flash_fwd(q, k, v, 1.0)
    _assert_flash_close(got, A.flash_fwd_ref(q, k, v, 1.0))
    c = d ** -0.5 * A.LOG2E
    pre = q * torch.tensor(c, dtype=torch.bfloat16)
    assert torch.equal(A.flash_fwd(pre, k, v, 1.0), A.flash_fwd(q, k, v, c))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(300, 129), (384, 684)])
def test_flash_static_floor_keeps_far_rows_finite(dev, d, sq, skv):
    """A bound far above every logit: exp2(max(s - bound, -120)) is 2^-120
    for every key, and K1 averages V (its plain version does the same)
    where an exp2 without the floor would give 0 / 0."""
    q, k, v = _flash_inputs(dev, d, sq, skv, seed=6)
    bound = torch.full((1,), 500.0, device=dev)
    got = A.flash_fwd_static(q, k, v, bound)
    assert bool(torch.isfinite(got).all())
    _assert_flash_close(got, A.flash_fwd_static_ref(q, k, v, bound))
    mean_v = v.float().mean(1, keepdim=True).expand_as(got)
    torch.testing.assert_close(got.float(), mean_v, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_repeat_and_slice_bit_equal(dev, d):
    """Nothing is summed with atomics: two launches give equal bits, and a
    launch on some heads gives the same bits as those heads of the full
    launch (the persistent grid hands them to other blocks)."""
    q, k, v = _flash_inputs(dev, d, 300, 684, seed=7, bh=6)
    c = d ** -0.5 * A.LOG2E
    bound = A._rowmax_norm(q) * A._rowmax_norm(k)
    for run in (lambda q, k, v: A.flash_fwd(q, k, v, c),
                lambda q, k, v: A.flash_fwd_static(q, k, v, bound)):
        full = run(q, k, v)
        assert torch.equal(full, run(q, k, v))
        part = run(*(t[2:5].contiguous() for t in (q, k, v)))
        assert torch.equal(part, full[2:5])


def test_attn_d64_script_names_the_compiled_tile(dev):
    """The experiment scripts label each kernel's row with the tile its
    source is built for: K3's q rows (64 a consumer warpgroup) x 128 keys,
    K8's packed rows x 128 keys."""
    from frameino_tpu_torch.scripts import bench_attn_d64
    from frameino_tpu_torch.scripts import bench_flash_variants
    lib = A._lib("flash_fwd")
    assert bench_attn_d64.K3_TILES == [(lib.flash_fwd_config(64, 2), 128)]
    assert bench_attn_d64.PACKED_TILE == (
        FV.lib("flash_packed").flash_packed_config(2), 128)
    for d in (64, 128):
        assert bench_flash_variants.tile("v0", d) == (
            lib.flash_fwd_config(d, 2), 128)
    assert lib.flash_fwd_config(64, 2) == 64 * lib.flash_fwd_config(64, 1)
    assert lib.flash_fwd_config(128, 1) == 2
    assert lib.flash_fwd_config(96, 0) == -1


def test_flash_attention_inference_takes_a_head_split_batch_of_one(dev):
    """q as the DiTs make it, a head-split view [1, H, S, D] of [1, S, H*D]
    (a batch of one per dp rank, or sequential CFG): its [H, S, D] reshape
    is a view that is not contiguous, and the wrapper hands K3 a copy."""
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(1, 100, 2 * 128, device=dev, dtype=torch.bfloat16,
                    generator=g)
    q = x.reshape(1, 100, 2, 128).permute(0, 2, 1, 3)
    k, v = (torch.randn(1, 2, 77, 128, device=dev, dtype=torch.bfloat16,
                        generator=g) for _ in range(2))
    got = A.flash_attention_inference(q, k, v)
    ref = A.flash_fwd_ref(q.reshape(2, 100, 128), k[0], v[0],
                          128 ** -0.5 * A.LOG2E)
    torch.testing.assert_close(got[0].float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


# ragged S (1, 7, 777), B = 1, and head counts whose team idles slots (3)
@pytest.mark.parametrize("batch,heads,s", [(2, 3, 100), (2, 24, 257),
                                           (2, 24, 1), (1, 24, 777),
                                           (1, 3, 777), (2, 1, 7)])
def test_qk_norm_rope_kernel_within_one_ulp(dev, batch, heads, s):
    g = torch.Generator(dev).manual_seed(1)
    raw = torch.randn(batch, s, heads * 128, device=dev,
                      dtype=torch.bfloat16, generator=g)
    w = 1 + 0.1 * torch.randn(heads * 128, device=dev, generator=g)
    ang = torch.randn(s, 64, device=dev, generator=g)
    cos, sin = ang.cos() * 0.5, ang.sin() * 0.5
    before = A.launch_counts()["qk_norm_rope"]
    got = A.qk_norm_rope(raw, w, cos, sin, heads, 1e-6).float()
    assert A.launch_counts()["qk_norm_rope"] == before + 1
    ref = A.qk_norm_rope_ref(raw, w, cos, sin, heads, 1e-6).float()
    # the same roundings to bf16; fp32 reassociation may flip one: 1 ulp
    assert torch.all((got - ref).abs()
                     <= torch.maximum(_bf16_ulp(got), _bf16_ulp(ref)))


@pytest.mark.parametrize("heads,s", [(12, 300), (6, 257), (1, 100),
                                     (5, 777), (12, 1)])
def test_qk_norm_rope_rstd_kernel_bit_equal(dev, heads, s):
    """K5 on a tp rank's heads (12, 6 and 5: not powers of two) against
    its plain version on the same rstd: the same fp32 products in the same
    order, no FMA contraction, so every bf16 output is equal. Handed K2's
    statistic (fp64 sum of squares, rounded once), the concatenated shards
    are K2 on the full rows, within one bf16 ulp (K2's fp64 sum runs in
    another order than the plain version's)."""
    g = torch.Generator(dev).manual_seed(2)
    hd = heads * 128
    raw = torch.randn(2, s, 2 * hd, device=dev, dtype=torch.bfloat16,
                      generator=g)
    w = 1 + 0.1 * torch.randn(2 * hd, device=dev, generator=g)
    ang = torch.rand(s, 64, device=dev, generator=g) * 6.3
    cos, sin = ang.cos() * 0.5, ang.sin() * 0.5
    tp_rstd = torch.rsqrt(raw.float().square().sum(-1) / (2 * hd) + 1e-6)
    k2_rstd = (1.0 / torch.sqrt(raw.double().square().sum(-1) / (2 * hd)
                                + float(np.float32(1e-6)))).float()
    for rstd in (tp_rstd, k2_rstd):
        shards = []
        for r in range(2):
            raw_r, w_r = (t[..., r * hd:(r + 1) * hd].contiguous()
                          for t in (raw, w))
            before = A.launch_counts()["qk_norm_rope_rstd"]
            got = A.qk_norm_rope_rstd(raw_r, rstd, w_r, cos, sin, heads)
            assert A.launch_counts()["qk_norm_rope_rstd"] == before + 1
            assert torch.equal(got, A.qk_norm_rope_rstd_ref(
                raw_r, rstd, w_r, cos, sin, heads))
            shards.append(got.reshape(2, heads, s, 128))
    got = torch.cat(shards, 1).reshape(-1, s, 128).float()
    full = A.qk_norm_rope(raw, w, cos, sin, 2 * heads, 1e-6).float()
    assert torch.all((got - full).abs()
                     <= torch.maximum(_bf16_ulp(got), _bf16_ulp(full)))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(2, 64, 128, device=dev)
    with pytest.raises(TypeError):
        A.flash_fwd(q, q, q, 0.1)                       # fp32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        A.flash_fwd(qb.transpose(1, 2).contiguous().transpose(1, 2), qb,
                    qb, 0.1)                             # not contiguous
    with pytest.raises(ValueError):
        A.flash_fwd(torch.randn(2, 64, 96, device=dev,
                                dtype=torch.bfloat16), qb, qb, 0.1)
    with pytest.raises(ValueError):
        A.qk_norm_rope(torch.randn(1, 8, 3 * 96, device=dev,
                                   dtype=torch.bfloat16),
                       torch.ones(3 * 96, device=dev),
                       torch.ones(8, 48, device=dev),
                       torch.zeros(8, 48, device=dev), 3, 1e-6)


def test_dit_on_cuda_runs_the_kernels(dev):
    """A 2-block DiT at head_dim 128 in bf16: the CUDA forward launches
    K1 and K3 once and K2 twice per block, and agrees with the CPU plain
    path on the same bf16 weights."""
    cfg = tdit.tiny_config(num_attention_heads=2, attention_head_dim=128,
                           ffn_dim=256, in_channels=8, out_channels=4)
    cpu = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16)
    gpu = tdit.WanDiT(cfg, device="meta", dtype=torch.bfloat16)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                        assign=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 8, 3, 8, 10).astype(np.float32))
    t = torch.tensor([900.0, 900.0])
    ctx = torch.from_numpy(rs.randn(2, 7, 16).astype(np.float32))
    mask = torch.ones(2, 3 * 4 * 5)
    mask[:, :20] = 0
    A.reset_launch_counts()
    got = gpu(x.to(dev), t.to(dev), ctx.to(dev),
              timestep_mask=mask.to(dev)).cpu()
    counts = A.launch_counts()
    ref = cpu(x, t, ctx, timestep_mask=mask)
    assert counts == {"flash_fwd_static": 2, "qk_norm_rope": 4,
                      "flash_fwd": 2, "qk_ln_rope": 0,
                      "flash_attn_train_fwd": 0, "flash_attn_train_bwd": 0,
                      "dynamic_quantize_rows": 0,
                      "qk_norm_rope_rstd": 0}
    assert torch.isfinite(got).all()
    # both bf16 through 2 blocks; the kernels round p to bf16 at another
    # shift than the plain softmax: 5e-2
    torch.testing.assert_close(got, ref, atol=5e-2, rtol=5e-2)


def _cog_tables(dev, L, grid, gain=1.0):
    """Joint [L + f*h*w, 32] tables: identity over the text prefix."""
    cos, sin = cogvideox_rope_table(64, *grid)
    cos = torch.cat([torch.ones(L, 32), torch.from_numpy(cos)])
    sin = torch.cat([torch.zeros(L, 32), torch.from_numpy(sin)])
    return ((cos * gain).to(dev).contiguous(),
            (sin * gain).to(dev).contiguous())


@pytest.mark.parametrize("heads,L,grid", [(3, 11, (3, 5, 6)),
                                          (48, 226, (2, 7, 9))])
@pytest.mark.parametrize("gain", [1.0, 64 ** -0.5 * A.LOG2E])
def test_qk_ln_rope_kernel_within_one_ulp(dev, heads, L, grid, gain):
    """A text prefix of identity rows and a ragged S (101 and 352 tokens,
    neither a multiple of the 64-token block)."""
    g = torch.Generator(dev).manual_seed(2)
    cos, sin = _cog_tables(dev, L, grid, gain)
    S = cos.shape[0]
    raw = 2 * torch.randn(2, S, heads * 64, device=dev, dtype=torch.bfloat16,
                          generator=g) + 0.5
    w = 1 + 0.1 * torch.randn(64, device=dev, generator=g)
    b = 0.1 * torch.randn(64, device=dev, generator=g)
    before = A.launch_counts()["qk_ln_rope"]
    got = A.qk_ln_rope(raw, w, b, cos, sin, heads, 1e-6).float()
    ref = A.qk_ln_rope_ref(raw, w, b, cos, sin, heads, 1e-6).float()
    torch.cuda.synchronize()
    assert A.launch_counts()["qk_ln_rope"] == before + 1
    assert got.shape == (2 * heads, S, 64)
    # the plain version does the kernel's arithmetic (fp64 statistics, no
    # fma): within one bf16 ulp
    assert torch.all((got - ref).abs()
                     <= torch.maximum(_bf16_ulp(got), _bf16_ulp(ref)))


def test_qk_ln_rope_rejects_what_the_kernel_does_not_take(dev):
    cos, sin = _cog_tables(dev, 4, (1, 2, 2))
    raw = torch.randn(1, 8, 2 * 64, device=dev)
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        A.qk_ln_rope(raw, w, b, cos, sin, 2, 1e-6)           # fp32
    rb = raw.to(torch.bfloat16)
    with pytest.raises(ValueError):
        A.qk_ln_rope(rb.new_empty(1, 128, 8).transpose(1, 2), w, b, cos,
                     sin, 2, 1e-6)                           # not contiguous
    with pytest.raises(ValueError):
        A.qk_ln_rope(rb, w, b, cos.t().contiguous().t(), sin, 2, 1e-6)
    with pytest.raises(ValueError):
        A.qk_ln_rope(rb, w.half(), b, cos, sin, 2, 1e-6)


@pytest.mark.parametrize("batch,heads,s", [(1, 48, 777), (2, 48, 1),
                                           (1, 3, 777), (2, 3, 7)])
def test_qk_ln_rope_kernel_at_ragged_shapes(dev, batch, heads, s):
    """K4 at head_dim 64 at ragged S (1, 7, 777), B = 1 and 48 heads,
    on random tables, within one bf16 ulp of its plain version."""
    g = torch.Generator(dev).manual_seed(3)
    raw = 2 * torch.randn(batch, s, heads * 64, device=dev,
                          dtype=torch.bfloat16, generator=g) - 0.25
    w = 1 + 0.1 * torch.randn(64, device=dev, generator=g)
    b = 0.1 * torch.randn(64, device=dev, generator=g)
    ang = torch.rand(s, 32, device=dev, generator=g) * 6.3
    cos, sin = ang.cos() * 0.3, ang.sin() * 0.3
    got = A.qk_ln_rope(raw, w, b, cos, sin, heads, 1e-6).float()
    ref = A.qk_ln_rope_ref(raw, w, b, cos, sin, heads, 1e-6).float()
    assert got.shape == (batch * heads, s, 64)
    assert torch.all((got - ref).abs()
                     <= torch.maximum(_bf16_ulp(got), _bf16_ulp(ref)))


def _misaligned(t):
    """A copy of t whose data starts one element past a 16-byte line."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


def test_producers_refuse_tensors_that_are_not_16_byte_aligned(dev):
    """The producers read raw, gains and tables in 16-byte vectors: a view
    at an odd offset is refused, not read across a line."""
    raw = torch.randn(2, 9, 2 * 128, device=dev, dtype=torch.bfloat16)
    w = torch.ones(2 * 128, device=dev)
    cos, sin = torch.ones(9, 64, device=dev), torch.zeros(9, 64, device=dev)
    rstd = torch.ones(2, 9, device=dev)
    A.qk_norm_rope(raw, w, cos, sin, 2, 1e-6)
    for args in ((_misaligned(raw), w, cos, sin), (raw, _misaligned(w), cos,
                                                   sin),
                 (raw, w, _misaligned(cos), sin)):
        with pytest.raises(ValueError, match="aligned"):
            A.qk_norm_rope(*args, 2, 1e-6)
    with pytest.raises(ValueError, match="aligned"):
        A.qk_norm_rope_rstd(_misaligned(raw), rstd, w, cos, sin, 2)
    raw64 = raw.reshape(2, 9, 4 * 64)
    g64, b64 = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    c32, s32 = torch.ones(9, 32, device=dev), torch.zeros(9, 32, device=dev)
    A.qk_ln_rope(raw64, g64, b64, c32, s32, 4, 1e-6)
    for args in ((_misaligned(raw64), g64, b64, c32, s32),
                 (raw64, g64, _misaligned(b64), c32, s32),
                 (raw64, g64, b64, c32, _misaligned(s32))):
        with pytest.raises(ValueError, match="aligned"):
            A.qk_ln_rope(*args, 4, 1e-6)


def test_cogvideox_dit_on_cuda_runs_the_kernels(dev):
    """A 2-block FrameINO DiT at head_dim 64 in bf16: the CUDA forward
    launches K4 twice and K1 once per block, none of K2/K3, and agrees with
    the CPU plain path on the same bf16 weights."""
    cfg = cdit.tiny_config(num_attention_heads=2, attention_head_dim=64,
                           use_frame_in=True)
    cpu = cdit.init_cogvideox_dit(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16)
    gpu = cdit.CogVideoXDiT(cfg, device="meta", dtype=torch.bfloat16)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                        assign=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 12, 8, 12).astype(np.float32))
    t = torch.tensor([900.0, 900.0])
    ctx = torch.from_numpy(rs.randn(2, 8, 16).astype(np.float32))
    rope = cdit.cogvideox_rope(cfg, 3, 8, 12,
                               duplicate_first_frame_for_id=True)
    A.reset_launch_counts()
    got = gpu(x.to(dev), ctx.to(dev), t.to(dev),
              tuple(r.to(dev) for r in rope)).cpu()
    counts = A.launch_counts()
    ref = cpu(x, ctx, t, rope)
    assert counts == {"flash_fwd_static": 2, "qk_norm_rope": 0,
                      "flash_fwd": 0, "qk_ln_rope": 4,
                      "flash_attn_train_fwd": 0, "flash_attn_train_bwd": 0,
                      "dynamic_quantize_rows": 0,
                      "qk_norm_rope_rstd": 0}
    assert torch.isfinite(got).all()
    # both bf16 through 2 blocks; the kernels round p to bf16 at another
    # shift than the plain softmax: 5e-2
    torch.testing.assert_close(got, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(100, 37), (130, 512), (64, 64),
                                    (1111, 1111)])
def test_flash_attention_train_matches_plain(dev, d, sq, skv):
    """K6 forward and dQ/dK/dV against the plain version's fp32 autograd
    on the same bf16 inputs, at ragged and whole-tile lengths."""
    g = torch.Generator(dev).manual_seed(3)
    q, do = (torch.randn(2, 3, sq, d, device=dev, dtype=torch.bfloat16,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(2, 3, skv, d, device=dev, dtype=torch.bfloat16,
                        generator=g) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = A.launch_counts()
    out = A.flash_attention_train(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    after = A.launch_counts()
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = A.flash_attention_train_ref(*ref_leaves)
    ref.backward(do.float())
    assert after["flash_attn_train_fwd"] == before["flash_attn_train_fwd"] + 1
    assert after["flash_attn_train_bwd"] == before["flash_attn_train_bwd"] + 1
    # bf16 o, P and dS against fp32: ~2.4e-3 measured; the limits of
    # chip_smoke.py (5e-3 forward, 1e-2 gradients)
    assert _rel_l2(out, ref) <= 5e-3
    for got, want in zip(leaves, ref_leaves):
        assert torch.isfinite(got.grad).all()
        assert _rel_l2(got.grad, want.grad) <= 1e-2


@pytest.mark.parametrize("shape", [
    (1, 3, 777, 777, 128),     # ragged at head_dim 128
    (2, 3, 300, 40, 128),      # Skv under one key tile
    (2, 3, 40, 777, 64),       # Sq under one q tile, head_dim 64
    (1, 24, 1000, 512, 128),   # the cross shape's keys: 64-key blocks
    (1, 48, 300, 777, 128)])   # 48 x 7 = 336 blocks: 128-key blocks
def test_flash_attention_train_kernels_at_ragged_and_cross_shapes(dev, shape):
    """K6's forward (o within 5e-3, lse within 1e-3) and backward (1e-2)
    against fp32 autograd, at the shapes that exercise the tails of the
    TMA tiles and both of the backward's block sizes."""
    b, h, sq, skv, d = shape
    g = torch.Generator(dev).manual_seed(11)
    q, do = (torch.randn(b * h, sq, d, device=dev, dtype=torch.bfloat16,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(b * h, skv, d, device=dev, dtype=torch.bfloat16,
                        generator=g) for _ in range(2))
    scale = d ** -0.5
    o, lse = A.flash_attn_train_fwd(q, k, v, scale)
    grads = A.flash_attn_train_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = A.flash_attention_train_ref(*(t[None] for t in leaves), scale)[0]
    ref_grads = torch.autograd.grad(ref, leaves, do.float())
    lse_ref = torch.logsumexp(leaves[0].detach()
                              @ leaves[1].detach().transpose(1, 2) * scale, -1)
    assert _rel_l2(o, ref) <= 5e-3
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for got, want in zip(grads, ref_grads):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("skv", [512, 777])
def test_flash_attention_train_backward_repeats(dev, skv):
    """Two backward launches on the same inputs: dK and dV bit-equal (each
    block owns its keys), dQ within 1e-3 relative L2 (its fp32 atomics sum
    in scheduling order)."""
    g = torch.Generator(dev).manual_seed(12)
    q, do = (torch.randn(24, 1000, 128, device=dev, dtype=torch.bfloat16,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(24, skv, 128, device=dev, dtype=torch.bfloat16,
                        generator=g) for _ in range(2))
    o, lse = A.flash_attn_train_fwd(q, k, v, 128 ** -0.5)
    first = A.flash_attn_train_bwd(q, k, v, o, lse, do, 128 ** -0.5)
    second = A.flash_attn_train_bwd(q, k, v, o, lse, do, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    assert _rel_l2(second[0], first[0]) <= 1e-3


def test_flash_attention_train_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 2, 64, 128, device=dev)
    with pytest.raises(TypeError):
        A.flash_attention_train(q, q, q)                    # fp32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        A.flash_attention_train(qb.transpose(2, 3).contiguous()
                                .transpose(2, 3), qb, qb)   # not contiguous
    with pytest.raises(ValueError):
        A.flash_attention_train(torch.randn(1, 2, 64, 96, device=dev,
                                            dtype=torch.bfloat16),
                                qb[..., :96].contiguous(),
                                qb[..., :96].contiguous())   # head_dim 96


@pytest.mark.parametrize("remat", [False, True])
def test_differentiable_dit_on_cuda_runs_k6(dev, remat):
    """A 2-block DiT at head_dim 128 in bf16 under autograd: every
    attention goes through K6 (2 forward launches per block, 2 more when
    remat recomputes it, 2 backward), none of K1-K4; the loss and
    gradients agree with the CPU plain path on the same bf16 weights."""
    cfg = tdit.tiny_config(num_attention_heads=2, attention_head_dim=128,
                           ffn_dim=256, in_channels=8, out_channels=4)
    cpu = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16)
    gpu = tdit.WanDiT(cfg, device="meta", dtype=torch.bfloat16)
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                        assign=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, 8, 3, 8, 10).astype(np.float32))
    t = torch.tensor([700.0])
    ctx = torch.from_numpy(rs.randn(1, 7, 16).astype(np.float32))

    def loss_and_grads(model, device):
        out = model(x.to(device), t.to(device), ctx.to(device),
                    differentiable=True, remat=remat and device != "cpu")
        loss = out.square().mean()
        params = [p for _, p in model.named_parameters()]
        return loss, torch.autograd.grad(loss, params)

    A.reset_launch_counts()
    loss, grads = loss_and_grads(gpu, dev)
    torch.cuda.synchronize()
    counts = A.launch_counts()
    assert counts == {"flash_fwd_static": 0, "qk_norm_rope": 0,
                      "flash_fwd": 0, "qk_ln_rope": 0,
                      "flash_attn_train_fwd": 8 if remat else 4,
                      "flash_attn_train_bwd": 4, "dynamic_quantize_rows": 0,
                      "qk_norm_rope_rstd": 0}
    ref_loss, ref_grads = loss_and_grads(cpu, "cpu")
    # both bf16; the kernels round P and dS to bf16 where the plain path
    # keeps fp32: 2e-2 on the loss, 5e-2 relative L2 over all gradients
    assert abs(loss.item() - ref_loss.item()) <= 2e-2 * abs(ref_loss.item())
    num = sum(float((g.float().cpu() - r.float()).norm() ** 2)
              for g, r in zip(grads, ref_grads))
    den = sum(float(r.float().norm() ** 2) for r in ref_grads)
    assert all(torch.isfinite(g).all() for g in grads)
    assert (num / den) ** 0.5 <= 5e-2


# ---------------------------------------------------------------------------
# K7 and the int8 dense
# ---------------------------------------------------------------------------

def _halfway_and_zero_rows(d, dev):
    """Row 0 has scale exactly 1.0 (127 * fp32(1/127) rounds to 1), so
    its halves must round to even; row 1 is zeros (scale 1e-12)."""
    row = torch.tensor([127, 2.5, 3.5, -2.5, -0.5, 0.5, 126.5, -126.5, 1.5,
                        -1.5, 64.5, -64.5]).repeat(d // 12 + 1)[:d]
    return torch.stack([row, torch.zeros(d)]).to(dev, torch.bfloat16)


@pytest.mark.parametrize("shape", [(17, 200), (5, 13), (2, 150, 3072),
                                   (40, 14336), "halfway+zero"])
def test_dyn_quant_kernel_is_bit_equal_to_plain(dev, shape):
    """K7 against its plain version: every code and scale bit-equal, at a
    ragged width (200), a width off the 16-byte vectors (13: the scalar
    loops), the path's widths, and the half-way and zero rows."""
    if shape == "halfway+zero":
        x = _halfway_and_zero_rows(256, dev)
    else:
        g = torch.Generator(dev).manual_seed(4)
        x = (torch.randn(shape, device=dev, generator=g)
             * torch.randn(*shape[:-1], 1, device=dev, generator=g).exp()
             ).to(torch.bfloat16)
    before = A.launch_counts()["dynamic_quantize_rows"]
    q, s = dyn_quant.dynamic_quantize_rows(x)
    torch.cuda.synchronize()
    assert A.launch_counts()["dynamic_quantize_rows"] == before + 1
    rq, rs = dyn_quant.dynamic_quantize_rows_ref(x)
    assert q.dtype == torch.int8 and s.shape == (*x.shape[:-1], 1)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if shape == "halfway+zero":
        assert q[0, :12].tolist() == [127, 2, 4, -2, 0, 0, 126, -126, 2, -2,
                                      64, -64]
        assert s[0].item() == 1.0 and not q[1].any()


@pytest.mark.parametrize("rows,n_in,n_out", [(120, 256, 128), (5, 64, 40)])
def test_dense_int8_on_cuda_matches_cpu(dev, rows, n_in, n_out):
    """The card's dense_int8 (K7, torch._int_mm, the epilogue) against the
    CPU's plain one on the same bf16 x and int8 weights: the integer
    product is exact and the epilogue the same IEEE operations, so within
    one bf16 ulp (equal expected). 5 rows take the padded _int_mm."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(rows, n_in, generator=g).to(torch.bfloat16)
    wq, scale = quant.quantize_weight(0.05 * torch.randn(n_out, n_in,
                                                         generator=g))
    bias = torch.randn(n_out, generator=g)
    ref = dense_int8(x, wq, scale, bias).float()
    got = dense_int8(x.to(dev), wq.to(dev), scale.to(dev),
                     bias.to(dev)).float().cpu()
    assert torch.all((got - ref).abs()
                     <= torch.maximum(_bf16_ulp(got), _bf16_ulp(ref)))


def test_int8_wrappers_reject_what_the_kernel_does_not_take(dev):
    x = torch.randn(32, 64, device=dev)
    with pytest.raises(TypeError):
        dyn_quant.dynamic_quantize_rows(x)                    # fp32
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        dyn_quant.dynamic_quantize_rows(xb.t())               # not contiguous
    wq, scale = quant.quantize_weight(torch.randn(16, 64))
    with pytest.raises(ValueError):
        dense_int8(xb, wq, scale)                             # CPU weights
    wq9, scale9 = quant.quantize_weight(torch.randn(9, 64, device=dev))
    with pytest.raises(ValueError):
        dense_int8(xb, wq9, scale9)                           # out 9


def test_int8_dit_on_cuda_runs_k7(dev):
    """A 2-block DiT at head_dim 128 quantized to int8: the CUDA forward
    quantizes the input of every int8 dense through K7 (10 a block, the
    text K/V projected in the forward) besides K1-K3, and agrees with the
    CPU plain path on the same int8 weights."""
    cfg = tdit.tiny_config(num_attention_heads=2, attention_head_dim=128,
                           ffn_dim=256, in_channels=8, out_channels=4)
    cpu = quant.quantize_dit_int8(tdit.init_wan_dit(
        cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    gpu = quant.quantize_dit_int8(tdit.WanDiT(cfg, device="meta",
                                              dtype=torch.bfloat16))
    gpu.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                        assign=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 8, 3, 8, 10).astype(np.float32))
    t = torch.tensor([900.0, 900.0])
    ctx = torch.from_numpy(rs.randn(2, 7, 16).astype(np.float32))
    A.reset_launch_counts()
    got = gpu(x.to(dev), t.to(dev), ctx.to(dev)).cpu()
    counts = A.launch_counts()
    ref = cpu(x, t, ctx)
    assert counts == {"flash_fwd_static": 2, "qk_norm_rope": 4,
                      "flash_fwd": 2, "qk_ln_rope": 0,
                      "flash_attn_train_fwd": 0, "flash_attn_train_bwd": 0,
                      "dynamic_quantize_rows": 20,
                      "qk_norm_rope_rstd": 0}
    assert torch.isfinite(got).all()
    # both bf16 through 2 blocks (5e-2 as the float test); a code that
    # flips where the kernels' bf16 activations differ moves one element
    # of a dense's input by one step of its row's scale
    torch.testing.assert_close(got, ref, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# K8-K12: the experiment flash forwards
# ---------------------------------------------------------------------------

VARIANTS = {"v1": (FV.flash_v1, FV.flash_v1_ref),
            "v2": (FV.flash_v2, FV.flash_v2_ref),
            "v12": (FV.flash_v12, FV.flash_v12_ref),
            "v3": (FV.flash_v3, FV.flash_v3_ref),
            "v123": (FV.flash_v123, FV.flash_v123_ref)}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 100, 777])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_flash_variants_match_plain(dev, name, d, s):
    """Each variant kernel against its plain version on the same inputs
    (the int8 ones on the same codes: ``_quant_rows`` is deterministic),
    at sequence lengths on and off the 64-row tile."""
    g = torch.Generator(dev).manual_seed(3)
    q, k, v = (torch.randn(2, 3, s, d, device=dev, dtype=torch.bfloat16,
                           generator=g) for _ in range(3))
    kernel, plain = VARIANTS[name]
    before = kernel.launches
    got = kernel(q, k, v, scale=d ** -0.5)
    ref = plain(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    # bf16 outputs of fp32 sums in another order; the online bodies round
    # p to bf16 against a running maximum: 2e-2 elementwise, 5e-3 in L2
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert _rel_l2(got, ref) <= 5e-3


# K9/K10 (csrc/flash_variants.cu) through their C entry on a bound made
# beforehand: one row of one head with one key, ragged sequences (129: a
# one-key tail; 300: off the q tile of 128 rows at head_dim 128, 192 at 64;
# 777), batch one with 48 heads, and 96 rows, so that each persistent
# block walks several q tiles on one ring
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,s", [(1, 1, 1), (1, 1, 129), (1, 1, 300),
                                   (1, 1, 777), (1, 48, 777), (2, 48, 300)])
@pytest.mark.parametrize("body", [1, 2, 12], ids=["k9_v1", "k10_v2",
                                                  "k10_v12"])
def test_bf16_flash_kernel_bodies(dev, body, d, b, h, s):
    """Each body against its plain version on the same inputs and bound,
    and two launches bit-identical."""
    g = torch.Generator(dev).manual_seed(6)
    q, k, v = (torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16,
                           generator=g) for _ in range(3))
    scale = d ** -0.5
    bound = None if body == 1 else FV._bound(q, k, scale).reshape(1)
    got = FV.bf16_flash(q, k, v, bound, body, scale=scale)
    again = FV.bf16_flash(q, k, v, bound, body, scale=scale)
    ref = FV.bf16_flash(q.cpu(), k.cpu(), v.cpu(),
                        None if bound is None else bound.cpu(), body,
                        scale=scale)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_flash_close(got.cpu(), ref)


def test_flash_variants_config_matches_the_layout(dev):
    """The library's launch shape and shared memory are the layout that
    ``tests/test_torch_flash_variants_sm90.py`` replays on the CPU."""
    lib = FV.lib("flash_variants")
    for d in (64, 128):
        lay = FV.variants_smem_layout(d)
        assert [lib.flash_variants_config(d, w) for w in range(4)] == [
            lay["smem_bytes"], lay["consumer_wgs"], lay["q_rows"],
            lay["stages"]]
    assert lib.flash_variants_config(96, 0) == -1
    assert lib.flash_variants_config(64, 4) == -1


def test_bf16_flash_refuses_what_the_kernel_does_not_take(dev):
    """A view one element off a 16-byte line (TMA needs aligned rows), a
    bound that is not one fp32 on the card, a static body without a bound
    and an unknown body are refused, through the C-entry launcher and the
    wrappers."""
    q = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16)
    bound = FV._bound(q, q, 0.125).reshape(1)
    buf = torch.empty(q.numel() + 1, device=dev, dtype=torch.bfloat16)
    off = buf[1:].view(q.shape)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16
    for body, bnd in ((1, None), (2, bound), (12, bound)):
        with pytest.raises(ValueError, match="aligned"):
            FV.bf16_flash(off, q, q, bnd, body, scale=0.125)
        with pytest.raises(ValueError, match="aligned"):
            FV.bf16_flash(q, q, off, bnd, body, scale=0.125)
    for fn in (FV.flash_v1, FV.flash_v2, FV.flash_v12):
        with pytest.raises(ValueError, match="aligned"):
            fn(q, off, q, scale=0.125)
    with pytest.raises(ValueError):
        FV.bf16_flash(q, q, q, bound.double(), 2, scale=0.125)
    with pytest.raises(ValueError):
        FV.bf16_flash(q, q, q, torch.ones(2, device=dev), 12, scale=0.125)
    with pytest.raises(ValueError):
        FV.bf16_flash(q, q, q, None, 2, scale=0.125)
    with pytest.raises(ValueError):
        FV.bf16_flash(q, q, q, None, 3, scale=0.125)


# K11/K12 (csrc/flash_int8.cu) on given codes: one row of one head, a
# sequence of 1 and one under a key tile (100), one off the q tile (300:
# q tiles of 128 rows at head_dim 128, 192 at 64), the ragged 777; and 96
# rows, so that each persistent block walks several q tiles on one ring
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,s", [(1, 1, 1), (1, 1, 100), (1, 1, 300),
                                   (1, 1, 777), (2, 48, 777), (2, 48, 300)])
@pytest.mark.parametrize("static", [False, True], ids=["k12", "k11"])
def test_int8_flash_kernel_on_codes(dev, static, d, b, h, s):
    """The kernel against ``int8_flash_ref`` on the same codes and
    scales, and two launches bit-identical."""
    g = torch.Generator(dev).manual_seed(5)
    q, k, v = (torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16,
                           generator=g) for _ in range(3))
    codes = FV.quantize_qk(q, k, d ** -0.5)
    bound = FV.int8_bound(*codes).reshape(1) if static else None
    got = FV.int8_flash(*codes, v, bound)
    again = FV.int8_flash(*codes, v, bound)
    ref = FV.int8_flash_ref(*codes, v, bound)
    torch.cuda.synchronize()
    assert got.shape == v.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_flash_close(got, ref)


def test_int8_flash_config_matches_the_layout(dev):
    """The library's launch shape and shared memory are the layout that
    ``tests/test_torch_flash_int8.py`` replays on the CPU."""
    lib = FV.lib("flash_int8")
    for d in (64, 128):
        lay = FV.int8_smem_layout(d)
        assert [lib.flash_int8_config(d, w) for w in range(5)] == [
            lay["smem_bytes"], lay["consumer_wgs"], lay["q_rows"],
            lay["stages"], lay["swizzle"]]
    assert lib.flash_int8_config(96, 0) == -1


def test_int8_flash_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16)
    qi, qs, ki, ks = FV.quantize_qk(q, q, 0.125)
    with pytest.raises(ValueError):
        FV.int8_flash(qi.float(), qs, ki, ks, q)          # codes not int8
    with pytest.raises(ValueError):
        FV.int8_flash(qi, qs.double(), ki, ks, q)         # fp64 scales
    with pytest.raises(ValueError):
        FV.int8_flash(qi, qs, ki, ks[:, :, :32], q)       # short scales
    with pytest.raises(ValueError):
        FV.int8_flash(qi, qs, ki, ks, q, torch.ones(2, device=dev))
    with pytest.raises(ValueError):
        FV.int8_flash(qi[..., :48], qs, ki[..., :48], ks, q[..., :48])


def test_flash_variant_switches_dispatch(dev):
    q = torch.randn(1, 2, 70, 64, device=dev, dtype=torch.bfloat16)
    FV.reset_launch_counts()
    a = FV.flash_v2(q, q, q, scale=0.125, block_q=1024, block_k=1024,
                    ones_col=True)
    b = FV.flash_v3(q, q, q, scale=0.125, static_ones=True)
    assert torch.equal(a, FV.flash_v12(q, q, q, scale=0.125))
    assert torch.equal(b, FV.flash_v123(q, q, q, scale=0.125))
    assert FV.launch_counts() == {"flash_v1": 0, "flash_v2": 0,
                                  "flash_v12": 2, "flash_v3": 0,
                                  "flash_v123": 2, "packed_flash": 0}


@pytest.mark.parametrize("heads,s", [(2, 64), (4, 300), (6, 777)])
def test_packed_flash_matches_plain(dev, heads, s):
    g = torch.Generator(dev).manual_seed(4)
    q, k, v = (torch.randn(2, heads, s, 64, device=dev,
                           dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    before = FV.packed_flash.launches
    got = FV.packed_flash(q, k, v)
    ref = FV.packed_flash_ref(q, k, v)
    k3 = A.flash_attention_inference(q, k, v)
    torch.cuda.synchronize()
    assert FV.packed_flash.launches == before + 1
    assert got.shape == q.shape
    # as the variants: 2e-2 elementwise, 5e-3 in L2; K3 computes the same
    # function head by head
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert _rel_l2(got, ref) <= 5e-3
    assert _rel_l2(got, k3) <= 5e-3


def test_flash_packed_config_matches_the_layout(dev):
    """The library's launch shape and shared memory are the layout that
    ``tests/test_torch_flash_packed.py`` replays on the CPU."""
    lib = FV.lib("flash_packed")
    lay = FV.packed_smem_layout()
    assert [lib.flash_packed_config(w) for w in range(4)] == [
        lay["smem_bytes"], lay["consumer_wgs"], lay["q_rows"], lay["stages"]]
    assert lib.flash_packed_config(4) == -1


# K8 (csrc/flash_packed.cu) through its C entry on rows packed
# beforehand: one row with one key, ragged sequences (129: a one-key tail;
# 300: off the q tile of 128 rows; 777), 2 and 4 heads a batch entry, and
# 48 pairs, so that each persistent block walks several q tiles on one ring
@pytest.mark.parametrize("b,h,s", [(1, 2, 1), (1, 2, 129), (1, 4, 300),
                                   (1, 2, 777), (2, 4, 777), (1, 96, 300)])
def test_packed_rows_kernel(dev, b, h, s):
    """The kernel against ``packed_rows_ref`` on the same packed rows, and
    two launches bit-identical."""
    g = torch.Generator(dev).manual_seed(8)
    rows = [FV.pack(torch.randn(b, h, s, 64, device=dev,
                                dtype=torch.bfloat16, generator=g))
            .contiguous() for _ in range(3)]
    got = FV.packed_rows(*rows)
    again = FV.packed_rows(*rows)
    ref = FV.packed_rows_ref(*(t.cpu() for t in rows))
    torch.cuda.synchronize()
    assert got.shape == rows[0].shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_flash_close(got.cpu(), ref)


@pytest.mark.parametrize("head", [0, 1], ids=["head_a", "head_b"])
def test_packed_rows_keep_the_heads_apart(dev, head):
    """A head's output lanes depend on its own lanes of q, k and v only:
    the other head's k and v replaced, they are bit-identical."""
    g = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(3, 300, 128, device=dev, dtype=torch.bfloat16,
                           generator=g) for _ in range(3))
    other = slice(64 * (1 - head), 64 * (2 - head))
    mine = slice(64 * head, 64 * (head + 1))
    k2, v2 = k.clone(), v.clone()
    k2[..., other] = torch.randn_like(k2[..., other]) * 4
    v2[..., other] = torch.randn_like(v2[..., other]) * 4
    a = FV.packed_rows(q, k, v)
    b = FV.packed_rows(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(a[..., mine], b[..., mine])
    assert not torch.equal(a[..., other], b[..., other])


def test_packed_rows_refuse_what_the_kernel_does_not_take(dev):
    """Rows that are not [pairs, S, 128], differ in shape, are not bf16 or
    lie one element off a 16-byte line are refused."""
    q = torch.randn(2, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FV.packed_rows(q[..., :64].contiguous(), q[..., :64].contiguous(),
                       q[..., :64].contiguous())
    with pytest.raises(ValueError):
        FV.packed_rows(q, q[:, :32].contiguous(), q)
    with pytest.raises(TypeError):
        FV.packed_rows(q.float(), q.float(), q.float())
    buf = torch.empty(q.numel() + 1, device=dev, dtype=torch.bfloat16)
    off = buf[1:].view(q.shape)
    off.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        FV.packed_rows(off, q, q)


def test_flash_variants_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 2, 64, 64, device=dev)
    qb = q.to(torch.bfloat16)
    for fn in (FV.flash_v1, FV.flash_v2, FV.flash_v12, FV.flash_v3,
               FV.flash_v123):
        with pytest.raises(TypeError):
            fn(q, q, q, scale=0.125)                      # fp32
        with pytest.raises(ValueError):
            fn(qb, qb[:, :, :32], qb, scale=0.125)        # k shorter than q
        with pytest.raises(ValueError):
            fn(qb[..., :48], qb[..., :48], qb[..., :48], scale=0.125)
    with pytest.raises(TypeError):
        FV.packed_flash(q, q, q)
    q128 = torch.randn(1, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FV.packed_flash(q128, q128, q128)                 # head_dim 128
    with pytest.raises(ValueError):
        FV.packed_flash(qb[:, :1], qb[:, :1], qb[:, :1])  # one head


# ---------------------------------------------------------------------------
# the Wan VAE's chunked and tiled paths, checkpoints and the text encoder
# ---------------------------------------------------------------------------

def _small_wan22_vae(dev):
    from frameino_tpu_torch.models import wan_vae
    cfg = wan_vae.WanVAEConfig(
        base_dim=16, decoder_base_dim=24, z_dim=8, dim_mult=(1, 2, 2),
        num_res_blocks=1, temperal_downsample=(True, True), is_residual=True,
        in_channels=12, out_channels=12, patch_size=2,
        latents_mean=(0.0,) * 8, latents_std=(1.0,) * 8)
    return wan_vae.init_wan_vae(cfg, torch.Generator(dev).manual_seed(0))


@pytest.fixture
def no_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def test_streaming_and_hybrid_vae_on_cuda(dev, no_tf32):
    """fp32 on the card (cuDNN, TF32 off): streaming equals the full forms,
    hybrid equals tiled (the CPU tests' limits, 1e-4 and 1e-5)."""
    from frameino_tpu_torch.models import wan_vae_streaming as S
    from frameino_tpu_torch.models import wan_vae_tiling as T
    vae = _small_wan22_vae(dev)
    g = torch.Generator(dev).manual_seed(1)
    z = torch.randn(1, 8, 5, 12, 20, generator=g, device=dev)
    full = vae.decode(z)
    torch.testing.assert_close(S.streaming_decode(vae, z), full, atol=1e-4,
                               rtol=1e-4)
    kw = dict(tile_min=128, tile_stride=96)
    tiled = T.tiled_decode(vae, z, **kw)
    torch.testing.assert_close(T.hybrid_decode(vae, z, **kw), tiled,
                               atol=1e-5, rtol=1e-5)
    video = torch.tanh(torch.randn(1, 3, 9, 96, 160, generator=g,
                                   device=dev))
    torch.testing.assert_close(
        S.streaming_encode_moments(vae, video, chunk_pixel_frames=4),
        vae.encode_moments(video), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        T.hybrid_encode(vae, video, chunk_pixel_frames=4, **kw),
        T.tiled_encode(vae, video, **kw), atol=1e-5, rtol=1e-5)


def test_safetensors_bf16_round_trip_onto_cuda(dev, tmp_path):
    """bf16 tensors written from the card, read back and moved onto it:
    bit-equal; a whole DiT through from_pretrained likewise."""
    from frameino_tpu_torch.models import pretrained
    from frameino_tpu_torch.models.safetensors_io import load_file, save_file
    g = torch.Generator(dev).manual_seed(2)
    want = {"a": torch.randn(33, 7, generator=g, device=dev
                             ).to(torch.bfloat16),
            "b": torch.randn(5, generator=g, device=dev).to(torch.bfloat16)}
    save_file(want, str(tmp_path / "x.safetensors"))
    got = load_file(str(tmp_path / "x.safetensors"))
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].to(dev), v), k
    cfg = tdit.tiny_config(num_attention_heads=2, attention_head_dim=128)
    dit = tdit.init_wan_dit(cfg, torch.Generator(dev).manual_seed(3),
                            dtype=torch.bfloat16)
    pretrained.save_pretrained(str(tmp_path / "t"), cfg, dit)
    _, back = pretrained.from_pretrained(str(tmp_path / "t"), device=dev,
                                         dtype=torch.bfloat16)
    for k, v in dit.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_umt5_bf16_on_cuda_follows_fp32_on_the_cpu(dev):
    from frameino_tpu_torch.models import t5_encoder as T5
    cfg = T5.tiny_config(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                         num_layers=3)
    cpu = T5.init_t5_encoder(cfg, torch.Generator().manual_seed(4))
    card = T5.T5Encoder(cfg, device="meta", dtype=torch.bfloat16)
    card.load_state_dict({k: v.to(dev, torch.bfloat16)
                          for k, v in cpu.state_dict().items()}, assign=True)
    ids = torch.randint(0, 64, (2, 40), generator=torch.Generator()
                        .manual_seed(5))
    mask = torch.ones_like(ids)
    mask[1, 25:] = 0
    want = T5.encode_and_mask(cpu, ids, mask, 48)
    got = T5.encode_and_mask(card, ids.to(dev), mask.to(dev), 48).float()
    assert torch.all(got[1, 25:] == 0)
    assert _rel_l2(got.cpu(), want) < 3e-2


# ---------------------------------------------------------------------------
# K14: the w8a8 convolution of the int8 Wan VAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape, w_shape, stride, pads", [
    # causal 3x3x3 over 40 channels (a ragged channel chunk), the 1x1x1
    # shortcut, the 2D upsample conv, the stride-2 2D and time convs; the
    # encoder's widths (Cp = 160 and 320 on the 160-wide tile, a 128-byte
    # stage spanning two taps; its stride-2 conv at 160); a hybrid-sized
    # call, M = 256, N = 1024, K = 27,648, whose K is split
    ((2, 40, 5, 7, 9), (20, 40, 3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1))),
    ((1, 160, 3, 10, 12), (160, 160, 3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1))),
    ((1, 320, 3, 6, 8), (320, 320, 3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1))),
    ((4, 160, 1, 20, 24), (160, 160, 1, 3, 3), (1, 2, 2),
     ((0, 0), (0, 1), (0, 1))),
    ((1, 1024, 1, 16, 16), (1024, 1024, 3, 3, 3), (1, 1, 1),
     ((2, 0), (1, 1), (1, 1))),
    ((1, 64, 3, 6, 5), (32, 64, 1, 1, 1), (1, 1, 1), ((0, 0),) * 3),
    ((3, 32, 1, 9, 11), (16, 32, 1, 3, 3), (1, 1, 1),
     ((0, 0), (1, 1), (1, 1))),
    ((3, 32, 1, 9, 11), (32, 32, 1, 3, 3), (1, 2, 2),
     ((0, 0), (0, 1), (0, 1))),
    ((1, 32, 7, 4, 3), (32, 32, 3, 1, 1), (2, 1, 1), ((0, 0),) * 3),
    ((1, 32, 5, 4, 3), (64, 32, 3, 1, 1), (1, 1, 1), ((2, 0), (0, 0), (0, 0))),
])
def test_conv_int8_kernel_bit_equal(dev, x_shape, w_shape, stride, pads):
    """K14 against its plain version on the same card: exact int32 sums,
    the same fp32 epilogue, so bit-equal; launches counted."""
    from frameino_tpu_torch.ops import conv_int8 as K
    g = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(x_shape, device=dev, generator=g)
    w = K.kernel_weight(torch.randint(-127, 128, w_shape, device=dev,
                                      generator=g, dtype=torch.int8))
    scale = torch.rand(w_shape[0], device=dev, generator=g) * 1e-3
    bias = torch.randn(w_shape[0], device=dev, generator=g)
    before = K.conv_int8.launches
    got = K.conv_int8(x, w, scale, bias, stride, pads)
    assert K.conv_int8.launches == before + 1
    want = K.conv_int8_ref(x, w, scale, bias, stride, pads)
    assert torch.equal(got, want)
    assert torch.equal(K.conv_int8(x, w, scale, None, stride, pads),
                       K.conv_int8_ref(x, w, scale, None, stride, pads))


def test_conv_int8_rejects_what_the_kernel_does_not_take(dev):
    from frameino_tpu_torch.ops import conv_int8 as K
    x = torch.randn(1, 32, 3, 4, 4, device=dev)
    w = torch.zeros(8, 3, 3, 3, 32, dtype=torch.int8, device=dev)
    s = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        K.conv_int8(x.bfloat16(), w, s, padding=((2, 0), (1, 1), (1, 1)))
    with pytest.raises(ValueError, match="scale on cpu"):
        K.conv_int8(x, w, s.cpu(), padding=((2, 0), (1, 1), (1, 1)))
    # 45 taps: the kernel's tap mask holds 32
    w5 = torch.zeros(8, 5, 3, 3, 32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="taps"):
        K.conv_int8(torch.randn(1, 32, 5, 4, 4, device=dev), w5, s)


def test_vae_weight_quantizer_divides_on_cuda(dev):
    """The int8 VAE's weight scale is JAX's eager one (the absmax divided
    by 127) on the card as on the CPU: CUDA's true division by a host
    scalar multiplies by the fp32 reciprocal, a divisor tensor does not.
    The weights are drawn so that the two rules part on some channels."""
    from frameino_tpu_torch.models import quant as Q
    from frameino_tpu_torch.models import wan_vae as V
    w = torch.randn(512, 16, 3, 3, 3,
                    generator=torch.Generator().manual_seed(21))
    amax = w.abs().amax(dim=(1, 2, 3, 4))
    assert not torch.equal(amax / 127.0, amax * torch.tensor(1.0 / 127.0))
    q_cpu, s_cpu = Q.quantize_conv_weight(w)
    q_dev, s_dev = Q.quantize_conv_weight(w.to(dev))
    assert torch.equal(s_dev.cpu(), s_cpu)
    assert torch.equal(q_dev.cpu(), q_cpu)
    cfg = V.WanVAEConfig(base_dim=8, decoder_base_dim=12, z_dim=4,
                         dim_mult=(1, 2, 2), num_res_blocks=1,
                         temperal_downsample=(True, True), is_residual=True,
                         in_channels=12, out_channels=12, patch_size=2,
                         latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
    cpu = V.init_wan_vae(cfg, torch.Generator().manual_seed(0))
    card = V.WanVAE(cfg, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    Q.quantize_wan_vae_int8(cpu)
    Q.quantize_wan_vae_int8(card)
    want = cpu.state_dict()
    for k, v in card.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
