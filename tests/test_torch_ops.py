"""Parity of the PyTorch port's ops with the JAX package (CPU).

The same numpy inputs go through both sides. Pallas kernels on the JAX
side run in interpret mode, as tests/test_ops_attention.py runs them; on
the torch side the CPU tensors take each kernel's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from frameino_tpu.ops import attention as jattn
from frameino_tpu.ops import conv as jconv
from frameino_tpu.ops import embeddings as jemb
from frameino_tpu.ops import linear as jlin
from frameino_tpu.ops import norms as jnorms
from frameino_tpu.ops import rope as jrope
from frameino_tpu.schedulers import flow_match_euler as jsched
from frameino_tpu_torch.core import shape_buckets as tsb
from frameino_tpu_torch.ops import attention as tattn
from frameino_tpu_torch.ops import conv as tconv
from frameino_tpu_torch.ops import embeddings as temb
from frameino_tpu_torch.ops import flash_variants as tfv
from frameino_tpu_torch.ops import linear as tlin
from frameino_tpu_torch.ops import norms as tnorms
from frameino_tpu_torch.ops import rope as trope
from frameino_tpu_torch.schedulers import flow_match_euler as tsched

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, name="fp32"):
    """numpy array -> (jax array, torch tensor) of the same values."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7)


# ---------------------------------------------------------------------------
# norms / dense / embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norms_match_jax(dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 48).astype(np.float32)
    w = (1 + 0.1 * rs.randn(48)).astype(np.float32)
    b = (0.1 * rs.randn(48)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    # fp32 statistics on both sides: only reduction order differs (1e-5);
    # rms_norm returns x's dtype, so bf16 allows one rounding step (1e-2)
    tol = 1e-5 if dtype == "fp32" else 1e-2
    np.testing.assert_allclose(
        _np(tnorms.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))),
        _np(jnorms.layer_norm(xj, jnp.asarray(w), jnp.asarray(b))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(tnorms.rms_norm(xt, torch.from_numpy(w))),
        _np(jnorms.rms_norm(xj, jnp.asarray(w))), atol=tol, rtol=tol)
    # WanRMS_norm over channels: torch dim 1 of [B, C, T] vs JAX axis 1
    xc = rs.randn(2, 6, 3, 4).astype(np.float32)
    g = rs.rand(6).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorms.l2_normalize_channel(torch.from_numpy(xc), 6 ** 0.5,
                                        torch.from_numpy(g)[:, None, None])),
        _np(jnorms.l2_normalize_channel(jnp.asarray(xc), 6 ** 0.5,
                                        jnp.asarray(g)[:, None, None])),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_and_activations_match_jax(dtype):
    rs = np.random.RandomState(1)
    x = rs.randn(3, 7, 32).astype(np.float32)
    kern = (rs.randn(32, 24) / 6).astype(np.float32)       # JAX [in, out]
    bias = rs.randn(24).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = tlin.dense(xt, torch.from_numpy(kern.T.copy()),
                     torch.from_numpy(bias))
    ref = jlin.dense(xj, {"kernel": jnp.asarray(kern),
                          "bias": jnp.asarray(bias)})
    assert got.dtype == DTYPES[dtype][1]
    # both accumulate in fp32 and add the bias in fp32: sums reorder
    # (fp32 1e-5); bf16 output may round one ulp apart (1e-2 relative)
    tol = 1e-5 if dtype == "fp32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tlin.gelu_tanh(xt)),
                               _np(jlin.gelu_tanh(xj)), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tlin.silu(xt)), _np(jlin.silu(xj)),
                               atol=tol, rtol=tol)


def test_embeddings_match_jax():
    rs = np.random.RandomState(2)
    t = np.array([0.0, 3.5, 999.0], np.float32)
    # sin/cos of the same fp32 angles: libm differences only (1e-5)
    np.testing.assert_allclose(
        _np(temb.sinusoidal_timestep_embedding(torch.from_numpy(t), 32)),
        _np(jemb.sinusoidal_timestep_embedding(jnp.asarray(t), 32)),
        atol=1e-5, rtol=1e-5)

    def linear(d_in, d_out):
        k = (rs.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
        b = rs.randn(d_out).astype(np.float32)
        lin = torch.nn.Linear(d_in, d_out)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(k.T.copy()))
            lin.bias.copy_(torch.from_numpy(b))
        return lin, {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}

    l1, p1 = linear(32, 16)
    l2, p2 = linear(16, 16)
    x = rs.randn(3, 32).astype(np.float32)
    # fp32 MLPs, reordered sums only (1e-5)
    np.testing.assert_allclose(
        _np(temb.timestep_embedding_mlp(torch.from_numpy(x), l1, l2)),
        _np(jemb.timestep_embedding_mlp(jnp.asarray(x),
                                        {"linear_1": p1, "linear_2": p2})),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(temb.pixart_text_projection(torch.from_numpy(x), l1, l2)),
        _np(jemb.pixart_text_projection(jnp.asarray(x),
                                        {"linear_1": p1, "linear_2": p2})),
        atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# rope / conv / scheduler / shape buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(3, 4, 5), (14, 15, 26)])
def test_rope_tables_equal_jax(grid):
    # the same float64 numpy recipe: bit-equal
    jc, js = jrope.wan_rope_table(128, *grid)
    tc, ts = trope.wan_rope_table(128, *grid)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_rope_matches_jax(dtype):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 10, 16).astype(np.float32)
    ang = rs.randn(10, 8).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = trope.apply_rope_interleaved(xt, torch.from_numpy(np.cos(ang)),
                                       torch.from_numpy(np.sin(ang)))
    ref = jrope.apply_rope_interleaved(xj, jnp.cos(ang), jnp.sin(ang))
    # fp32 rotation on both sides; bf16 output one rounding (1e-2)
    tol = 1e-6 if dtype == "fp32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


def test_convs_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(1, 5, 6, 7, 3).astype(np.float32)       # JAX NDHWC
    k3 = (rs.randn(3, 3, 3, 3, 4) / 9).astype(np.float32)  # DHWIO
    b = rs.randn(4).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy())
    wt = torch.from_numpy(k3.transpose(4, 3, 0, 1, 2).copy())
    to_cl = (0, 2, 3, 4, 1)
    # fp32 convolutions, reordered sums only (1e-5)
    for stride, pad in [(1, 1), ((2, 1, 1), (1, 0, 0))]:
        got = tconv.causal_conv3d(xt, wt, torch.from_numpy(b), stride, pad)
        ref = jconv.causal_conv3d(jnp.asarray(x), jnp.asarray(k3),
                                  jnp.asarray(b), stride, pad)
        np.testing.assert_allclose(got.numpy().transpose(to_cl),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)
    got = tconv.conv3d(xt, wt, torch.from_numpy(b), (2, 1, 1))
    ref = jconv.conv3d(jnp.asarray(x), jnp.asarray(k3), jnp.asarray(b),
                       (2, 1, 1), "VALID")
    np.testing.assert_allclose(got.numpy().transpose(to_cl), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)

    x2 = rs.randn(2, 6, 8, 3).astype(np.float32)            # NHWC
    k2 = (rs.randn(3, 3, 3, 5) / 5).astype(np.float32)      # HWIO
    b2 = rs.randn(5).astype(np.float32)
    x2t = torch.from_numpy(x2.transpose(0, 3, 1, 2).copy())
    w2t = torch.from_numpy(k2.transpose(3, 2, 0, 1).copy())
    # the downsampler's nn.ZeroPad2d((0, 1, 0, 1)) is conv2d's own padding
    for stride, tpad, jpad, pre in [(1, "same", "SAME", False),
                                    (2, ((0, 1), (0, 1)), "VALID", True)]:
        xi_j = jconv.zero_pad_hw_br(jnp.asarray(x2)) if pre \
            else jnp.asarray(x2)
        got = tconv.conv2d(x2t, w2t, torch.from_numpy(b2), stride, tpad)
        ref = jconv.conv2d(xi_j, jnp.asarray(k2), jnp.asarray(b2), stride,
                           jpad)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)
    # pixel duplication: exact
    np.testing.assert_array_equal(
        tconv.nearest_exact_upsample2d(x2t).numpy().transpose(0, 2, 3, 1),
        np.asarray(jconv.nearest_exact_upsample2d(jnp.asarray(x2))))


@pytest.mark.parametrize("steps", [2, 50])
def test_scheduler_matches_jax(steps):
    cfg_j, cfg_t = jsched.FlowMatchEulerConfig(), tsched.FlowMatchEulerConfig()
    js, jt = jsched.inference_sigmas(cfg_j, steps)
    ts, tt = tsched.inference_sigmas(cfg_t, steps)
    np.testing.assert_array_equal(ts, js)        # same numpy recipe
    np.testing.assert_array_equal(tt, jt)
    rs = np.random.RandomState(5)
    lat = rs.randn(2, 4, 3).astype(np.float32)
    v = rs.randn(2, 4, 3).astype(np.float32)
    got = tsched.euler_step(torch.from_numpy(lat), torch.from_numpy(v),
                            ts[0], ts[1])
    ref = jsched.euler_step(jnp.asarray(lat), jnp.asarray(v),
                            jnp.asarray(js[0]), jnp.asarray(js[1]))
    # same fp32 step size, one fp32 multiply-add: bit-equal
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_shape_buckets_match_jax():
    from frameino_tpu.core import shape_buckets as jsb
    for h, w in [(32, 64), (480, 832), (250, 451)]:
        assert tsb.bucket_hw(h, w) == jsb.bucket_hw(h, w)
    for f in (1, 9, 17, 49, 50):
        assert tsb.bucket_frames(f) == jsb.bucket_frames(f)
        assert tsb.bucket_frames(f, frame_grid=8) == \
            jsb.bucket_frames(f, frame_grid=8)


# ---------------------------------------------------------------------------
# attention: the reference, and the three kernels' plain versions
# ---------------------------------------------------------------------------

def test_attention_ref_matches_xla():
    rs = np.random.RandomState(6)
    q, k, v = (rs.randn(2, 3, n, 16).astype(np.float32)
               for n in (17, 29, 29))
    got = tattn.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    ref = jattn.attention_xla(*(jnp.asarray(a) for a in (q, k, v)))
    # fp32 softmax on both sides (1e-5)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("sq,skv", [(128, 128), (200, 77)])
def test_flash_attention_inference_matches_pallas(dtype, sq, skv):
    """K3's plain version == the Pallas online-softmax kernel."""
    rs = np.random.RandomState(7)
    q = rs.randn(1, 2, sq, 64).astype(np.float32)
    k = rs.randn(1, 2, skv, 64).astype(np.float32)
    v = rs.randn(1, 2, skv, 64).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = jattn.flash_attention_inference(qj, kj, vj, block_q=128,
                                              block_k=128)
    got = tattn.flash_attention_inference(qt, kt, vt)
    assert got.dtype == DTYPES[dtype][1]
    # fp32: online vs one-pass softmax, reordered sums (1e-4); bf16: p is
    # rounded to bf16 against different running maxima (2e-2)
    tol = 1e-4 if dtype == "fp32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_qk_norm_rope_matches_pallas_producer(dtype):
    """K2's plain version == _qk_producer_fullrow (interpret)."""
    B, S, H, D = 2, 256, 3, 32
    rs = np.random.RandomState(8)
    raw = rs.randn(B, S, H * D).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(H * D)).astype(np.float32)
    ang = rs.randn(S, D // 2).astype(np.float32)
    gain = D ** -0.5 * tattn.LOG2E
    cos, sin = np.cos(ang), np.sin(ang)
    rj, rt = _pair(raw, dtype)
    c2, s2 = jattn._rope_expand(jnp.asarray(cos), jnp.asarray(sin), gain)
    with pltpu.force_tpu_interpret_mode():
        ref = jattn._qk_producer_fullrow(
            rj, jnp.asarray(w).reshape(1, H, D), c2, s2, num_heads=H,
            eps=1e-6, block_s=128, interpret=True)
    got = tattn.qk_norm_rope(rt, torch.from_numpy(w),
                             torch.from_numpy(cos) * gain,
                             torch.from_numpy(sin) * gain, H, 1e-6)
    assert got.shape == (B * H, S, D) and got.dtype == DTYPES[dtype][1]
    g, r = _np(got), _np(ref)
    if dtype == "fp32":
        # fp32 throughout; the sum of squares reorders (1e-5)
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)
    else:
        # the norm result and the output round to bf16 at the same points;
        # fp32 reordering may flip one rounding: within one bf16 ulp
        assert np.all(np.abs(g - r) <= np.maximum(_bf16_ulp(g), _bf16_ulp(r)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("heads", [1, 3, 4])
def test_qk_norm_rope_rstd_matches_pallas_producer(dtype, heads):
    """K5's plain version == _qk_producer (interpret) on the same rstd, at
    300 tokens (ragged against its 256-row blocks: JAX pads to 512 with
    rstd 1 and the pad rows are dropped) and a tp rank's 1, 3 or 4 heads.
    The rstd is a tp path's: the fp32 sum of squares over twice the
    rank's heads (the other rank's half included) and rsqrt."""
    B, S, D, block_s = 2, 300, 32, 256
    rs = np.random.RandomState(13)
    raw = rs.randn(B, S, heads * D).astype(np.float32)
    other = rs.randn(B, S, heads * D).astype(np.float32)
    ssq = np.square(raw).sum(-1) + np.square(other).sum(-1)
    rstd = (1.0 / np.sqrt(ssq / (2 * heads * D) + np.float32(1e-6))
            ).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(heads * D)).astype(np.float32)
    ang = rs.uniform(0, 2 * np.pi, (S, D // 2)).astype(np.float32)
    gain = np.float32(D ** -0.5 * tattn.LOG2E)
    cos, sin = np.cos(ang) * gain, np.sin(ang) * gain
    rj, rt = _pair(raw, dtype)
    c2, s2 = jattn._rope_expand(jnp.asarray(cos), jnp.asarray(sin))
    pad = 2 * block_s - S
    with pltpu.force_tpu_interpret_mode():
        ref = jattn._qk_producer(
            jnp.pad(rj, ((0, 0), (0, pad), (0, 0))),
            jnp.pad(jnp.asarray(rstd)[:, None], ((0, 0), (0, 0), (0, pad)),
                    constant_values=1.0),
            jnp.asarray(w).reshape(heads, 1, D),
            jnp.pad(c2, ((0, pad), (0, 0))), jnp.pad(s2, ((0, pad), (0, 0))),
            num_heads=heads, block_s=block_s, interpret=True)
    got = tattn.qk_norm_rope_rstd(rt, torch.from_numpy(rstd),
                                  torch.from_numpy(w), torch.from_numpy(cos),
                                  torch.from_numpy(sin), heads)
    assert got.shape == (B * heads, S, D) and got.dtype == DTYPES[dtype][1]
    g, r = _np(got), _np(ref)[:, :S]
    if dtype == "fp32":
        # the same fp32 products in the same order: 1 fp32 ulp at most
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6)
    else:
        # the same roundings to bf16 on the same rstd; XLA's CPU code may
        # contract the rotation into an FMA: within one bf16 ulp
        assert np.all(np.abs(g - r) <= np.maximum(_bf16_ulp(g), _bf16_ulp(r)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("static_softmax", [True, False])
def test_fused_qk_flash_matches_pallas(dtype, static_softmax):
    """K2 -> bound -> K1 (and the K3 fallback) == _fused_qk_flash_impl."""
    B, S, H, D = 2, 200, 3, 32
    rs = np.random.RandomState(9)
    q_raw = rs.randn(B, S, H * D).astype(np.float32)
    k_raw = rs.randn(B, S, H * D).astype(np.float32)
    v = rs.randn(B, H, S, D).astype(np.float32)
    w_q = (1.0 + 0.1 * rs.randn(H * D)).astype(np.float32)
    w_k = (1.0 + 0.1 * rs.randn(H * D)).astype(np.float32)
    ang = rs.randn(S, D // 2).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype)
                                    for a in (q_raw, k_raw, v))
    with pltpu.force_tpu_interpret_mode():
        ref = jattn.fused_qk_flash_attention(
            qj, kj, vj, jnp.asarray(w_q), jnp.asarray(w_k), jnp.asarray(cos),
            jnp.asarray(sin), num_heads=H, eps=1e-6, block_q=128,
            block_k=128, interpret=True, static_softmax=static_softmax)
    got = tattn.fused_qk_flash_attention(
        qt, kt, vt, torch.from_numpy(w_q), torch.from_numpy(w_k),
        torch.from_numpy(cos), torch.from_numpy(sin), num_heads=H, eps=1e-6,
        static_softmax=static_softmax)
    assert got.shape == (B, H, S, D)
    # fp32: reordered sums (1e-4); bf16: p rounds to bf16 against another
    # shift (running max vs global max / bound), 2e-2
    tol = 1e-4 if dtype == "fp32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


def test_kernel_wrappers_count_no_launch_on_cpu():
    """On the CPU a wrapper runs its plain version and counts no launch."""
    tattn.reset_launch_counts()
    q = torch.randn(2, 8, 64, dtype=torch.bfloat16)
    tattn.flash_fwd(q, q, q, 0.1)
    tattn.flash_fwd_static(q, q, q, torch.tensor(50.0))
    tattn.qk_norm_rope(torch.randn(1, 8, 128), torch.ones(128),
                       torch.ones(8, 32), torch.zeros(8, 32), 2, 1e-6)
    tattn.qk_norm_rope_rstd(torch.randn(1, 8, 128), torch.ones(1, 8),
                            torch.ones(128), torch.ones(8, 32),
                            torch.zeros(8, 32), 2)
    tattn.qk_ln_rope(torch.randn(1, 8, 128), torch.ones(64), torch.zeros(64),
                     torch.ones(8, 32), torch.zeros(8, 32), 2, 1e-6)
    qg = torch.randn(1, 2, 8, 64, requires_grad=True)
    tattn.flash_attention_train(qg, qg, qg).sum().backward()
    tattn.dyn_quant.dynamic_quantize_rows(q)
    # the experiment kernels K8-K12 count in their own module
    tfv.reset_launch_counts()
    q4 = q[None]
    tfv.flash_v1(q4, q4, q4, scale=0.125)
    for ones_col in (False, True):
        tfv.flash_v2(q4, q4, q4, scale=0.125, ones_col=ones_col)
        tfv.flash_v3(q4, q4, q4, scale=0.125, static_ones=ones_col)
    tfv.packed_flash(q4, q4, q4)
    assert tfv.launch_counts() == {"flash_v1": 0, "flash_v2": 0,
                                   "flash_v12": 0, "flash_v3": 0,
                                   "flash_v123": 0, "packed_flash": 0}
    assert tattn.launch_counts() == {"flash_fwd_static": 0,
                                     "qk_norm_rope": 0, "flash_fwd": 0,
                                     "qk_ln_rope": 0,
                                     "flash_attn_train_fwd": 0,
                                     "flash_attn_train_bwd": 0,
                                     "dynamic_quantize_rows": 0,
                                     "qk_norm_rope_rstd": 0}
