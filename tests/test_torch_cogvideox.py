"""The PyTorch port's CogVideoX FrameINO slice on the CPU against the JAX
package: the K4 producer's plain version and the fused head_dim-64
attention, the RoPE and sincos tables, the DiT, the VAE (full, streaming,
tiled), the DDIM and DPM schedulers, the weight bridge, the whole tiny
pipeline and the server. Inputs are drawn with numpy from a seed and
handed to both sides; the JAX Pallas kernels run in interpret mode.
"""

import base64
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_dit as jdit
from frameino_tpu.models import cogvideox_vae as jvae
from frameino_tpu.models import cogvideox_vae_streaming as jvs
from frameino_tpu.models import weights as jweights
from frameino_tpu.ops import attention as jattn
from frameino_tpu.ops import embeddings as jemb
from frameino_tpu.ops import rope as jrope
from frameino_tpu.pipelines import cogvideox_i2v as jpipe
from frameino_tpu.schedulers import cogvideox_dpm as jdpm
from frameino_tpu.schedulers import ddim as jddim
from frameino_tpu_torch import serve
from frameino_tpu_torch.app.server import PipelineServer
from frameino_tpu_torch.models import cogvideox_dit as tdit
from frameino_tpu_torch.models import cogvideox_vae as tvae
from frameino_tpu_torch.models import cogvideox_vae_streaming as tvs
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.ops import embeddings as temb
from frameino_tpu_torch.ops import rope as trope
from frameino_tpu_torch.pipelines import cogvideox_i2v as tpipe
from frameino_tpu_torch.schedulers import cogvideox_dpm as tdpm
from frameino_tpu_torch.schedulers import ddim as tddim


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_sd(m):
    return {k: v.numpy() for k, v in m.state_dict().items()}


def _bf16_ulp(x):
    ax = torch.clamp(x.abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


# ---------------------------------------------------------------------------
# ops: K4's plain version, the fused attention, the tables
# ---------------------------------------------------------------------------

def _joint_tables(L, grid, head_dim):
    """The DiT's joint [L + f*h*w, D/2] tables: identity over the text."""
    cos, sin = trope.cogvideox_rope_table(head_dim, *grid)
    half = head_dim // 2
    return (np.concatenate([np.ones((L, half), np.float32), cos]),
            np.concatenate([np.zeros((L, half), np.float32), sin]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [3, 4])
@pytest.mark.parametrize("gain", [1.0, 64 ** -0.5 * A.LOG2E])
def test_qk_ln_rope_ref_matches_pallas_producer(dtype, heads, gain):
    """11 text rows + a 3x5x6 grid: S = 101, not a multiple of 128. With a
    gain (q's tables) the text rows must come out scaled."""
    rs = np.random.RandomState(0)
    D, L = 64, 11
    cos, sin = _joint_tables(L, (3, 5, 6), D)
    S = cos.shape[0]
    raw = (2 * rs.randn(1, S, heads * D) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rs.randn(D)).astype(np.float32)
    b = (0.1 * rs.randn(D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    c2, s2 = jattn._rope_expand(jnp.asarray(cos), jnp.asarray(sin),
                                gain=gain)
    ref = jattn._qk_producer_ln(jnp.asarray(raw, jdt), jnp.asarray(w),
                                jnp.asarray(b), c2, s2, num_heads=heads,
                                head_dim=D, eps=1e-6, block_s=S,
                                interpret=True)
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    got = A.qk_ln_rope_ref(_t(raw).to(getattr(torch, dtype)), _t(w), _t(b),
                           _t(cos * np.float32(gain)),
                           _t(sin * np.float32(gain)), heads, 1e-6).float()
    assert got.shape == (heads, S, D)
    if dtype == "float32":
        # statistics in fp32 (JAX) against fp64 (port): 1e-5
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        # the same bf16 roundings, but JAX takes the statistics in fp32:
        # where that flips the rounding of a normed value (|n| < 4 here),
        # the rotation carries one ulp of it, at most gain * 2^-6, into
        # the output. Everything else is within one output ulp.
        d = (got - ref).abs()
        within = d <= torch.maximum(_bf16_ulp(got), _bf16_ulp(ref))
        assert within.float().mean() > 0.999
        assert d.max() <= gain * 2 ** -6
    # over the text prefix: the LayerNorm times the gain, unrotated
    tdt = getattr(torch, dtype)
    x = _t(raw[0, :L]).to(tdt).float().reshape(L, heads, D)
    want = torch.nn.functional.layer_norm(x, (D,), _t(w), _t(b), eps=1e-6)
    want = (want.to(tdt).float() * np.float32(gain)).permute(1, 0, 2)
    # fp32: 1e-5; bf16: rounded twice on each side, 1e-2
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got[:, :L], want, atol=tol, rtol=tol)


@pytest.mark.parametrize("static_softmax", [True, False])
def test_fused_ln_qk_flash_attention_matches_jax(static_softmax):
    """Joint attention over 7 text + 4x5x5 video tokens (S = 107, padded
    to 128 on the JAX side), 2 heads of 64, fp32."""
    rs = np.random.RandomState(1)
    H, D, L = 2, 64, 7
    cos, sin = _joint_tables(L, (4, 5, 5), D)
    S = cos.shape[0]
    q, k = (rs.randn(2, S, H * D).astype(np.float32) for _ in range(2))
    v = rs.randn(2, H, S, D).astype(np.float32)
    wq, wk = ((1 + 0.1 * rs.randn(D)).astype(np.float32) for _ in range(2))
    bq, bk = ((0.1 * rs.randn(D)).astype(np.float32) for _ in range(2))
    args = (q, k, v, wq, bq, wk, bk, cos, sin)
    ref = jattn.fused_ln_qk_flash_attention(
        *(jnp.asarray(a) for a in args), num_heads=H, head_dim=D, eps=1e-6,
        interpret=True, static_softmax=static_softmax)
    got = A.fused_ln_qk_flash_attention(*(_t(a) for a in args),
                                        num_heads=H, eps=1e-6,
                                        static_softmax=static_softmax)
    assert got.shape == (2, H, S, D)
    # fp32 on both sides, sums in another order: 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    # both softmax variants compute the same attention
    plain = A.attention_ref(
        A.qk_ln_rope_ref(_t(q), _t(wq), _t(bq), _t(cos), _t(sin), H, 1e-6)
        .reshape(2, H, S, D),
        A.qk_ln_rope_ref(_t(k), _t(wk), _t(bk), _t(cos), _t(sin), H, 1e-6)
        .reshape(2, H, S, D), _t(v))
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("f,h,w,dup", [(13, 30, 45, True), (4, 6, 10, False),
                                       (3, 8, 5, True), (2, 34, 50, False)])
def test_cogvideox_rope_table_matches_jax(f, h, w, dup):
    """The base 30x45 grid, grids below it on either aspect, one above."""
    want = jrope.cogvideox_rope_table(64, f, h, w,
                                      duplicate_first_frame_for_id=dup)
    got = trope.cogvideox_rope_table(64, f, h, w,
                                     duplicate_first_frame_for_id=dup)
    assert got[0].shape == ((f + dup) * h * w, 32)
    # the same float64 numpy arithmetic: bit-equal
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
    assert (trope.get_resize_crop_region_for_grid((h, w), 45, 30)
            == jrope.get_resize_crop_region_for_grid((h, w), 45, 30))


@pytest.mark.parametrize("dim,h,w,t", [(3072, 30, 45, 13), (32, 4, 6, 3)])
def test_cogvideox_sincos_pos_embed_matches_jax(dim, h, w, t):
    got = temb.cogvideox_3d_sincos_pos_embed(dim, h, w, t)
    want = jemb.cogvideox_3d_sincos_pos_embed(dim, h, w, t)
    assert got.shape == (t, h * w, dim)
    # the same float64 numpy arithmetic: bit-equal
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 3, 4, 4, 8), (1, 5, 15, 23, 8),
                                   (1, 2, 6, 9, 8)])
def test_antialiased_resize_matches_jax_trilinear(shape):
    """Downsampling (the position table onto a smaller patch grid) and
    upsampling against ``jax.image.resize(..., "trilinear")``."""
    x = np.random.RandomState(2).randn(1, 3, 8, 12, 8).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "trilinear"))
    got = tdit.resize_antialiased(_t(x), shape).numpy()
    # fp32 weights, sums in another order: 1e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True],
                ids=["motion", "frame_in"])
def dit_pair(request):
    """The tiny DiT with the same weights on both sides: a JAX tree through
    the weight bridge. The position table is random, text slots included,
    so that every slice and resize of it is seen."""
    kw = dict(use_frame_in=request.param)
    jcfg, tcfg = jdit.tiny_config(**kw), tdit.tiny_config(**kw)
    params = jdit.init_cogvideox_dit(jax.random.key(1), jcfg)
    pos = params["patch_embed"]["pos_embedding"]
    params["patch_embed"]["pos_embedding"] = jnp.asarray(
        np.random.RandomState(3).randn(*pos.shape).astype(np.float32))
    m = tdit.CogVideoXDiT(tcfg, device="meta")
    m.load_state_dict(tweights.cogvideox_dit_from_jax(
        jax.tree.map(np.asarray, params), tcfg), assign=True, strict=True)
    return jcfg, params, m.eval()


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("grid", ["sample", "smaller", "mixed"])
def test_dit_matches_jax(dit_pair, impl, grid):
    """The sample grid (motion: 3 frames at 8x8; FrameINO: plus the ID
    frame), a patch grid below it (a downsampling resize of the table) and
    one wider on one axis. "fused" runs the K4 -> bound -> K1 path (plain
    versions here) against JAX's Pallas producers in interpret mode."""
    jcfg, params, m = dit_pair
    fi = jcfg.use_frame_in
    H, W = {"sample": (8, 8), "smaller": (4, 4), "mixed": (4, 12)}[grid]
    F = 3
    rs = np.random.RandomState(4)
    x = rs.randn(2, F + fi, jcfg.in_channels, H, W).astype(np.float32)
    text = rs.randn(2, 8, 16).astype(np.float32)
    t = np.array([999.0, 400.0], np.float32)
    cj, sj = jdit.cogvideox_rope(jcfg, F, H, W,
                                 duplicate_first_frame_for_id=fi)
    jargs = (jnp.asarray(x), jnp.asarray(text), jnp.asarray(t))
    if impl == "fused":
        jattn.FORCE_INTERPRET = True
    try:
        ref = jdit.cogvideox_forward(
            jcfg, params, *jargs, image_rotary_emb=(cj, sj),
            attn_impl="pallas" if impl == "fused" else "xla")
    finally:
        jattn.FORCE_INTERPRET = False
    rope = tdit.cogvideox_rope(m.cfg, F, H, W,
                               duplicate_first_frame_for_id=fi)
    got = m(_t(x), _t(text), _t(t), rope, attn_impl=impl)
    assert got.shape == (2, F + fi, jcfg.out_channels, H, W)
    # fp32 through 2 blocks, sums in another order: 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(patch_size_t=2, ofs_embed_dim=16,
         use_learned_positional_embeddings=False),
    dict(ofs_embed_dim=16),
    dict(use_rotary_positional_embeddings=False,
         use_learned_positional_embeddings=False)],
    ids=["patch_size_t", "ofs", "no_rope"])
def test_dit_unported_branches_raise(kw):
    """The three layouts that once raised (CogVideoX 1.5's patch_size_t,
    the ofs embedding, the 2B without RoPE) now build and match JAX's
    forward on the sample grid (fp32, 2 blocks: 1e-4; the fuller checks
    are tests/test_torch_cogvideox_configs.py)."""
    jcfg, tcfg = jdit.tiny_config(**kw), tdit.tiny_config(**kw)
    params = jdit.init_cogvideox_dit(jax.random.key(2), jcfg)
    m = tdit.CogVideoXDiT(tcfg, device="meta")
    m.load_state_dict(tweights.cogvideox_dit_from_jax(
        jax.tree.map(np.asarray, params), tcfg), assign=True, strict=True)
    pt = jcfg.patch_size_t or 1
    F = 2 * pt
    rs = np.random.RandomState(5)
    x = rs.randn(1, F, jcfg.in_channels, 8, 8).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    t = np.array([500.0], np.float32)
    ofs = np.array([2.0], np.float32) if jcfg.ofs_embed_dim else None
    rope = (jdit.cogvideox_rope(jcfg, F // pt, 8, 8)
            if jcfg.use_rotary_positional_embeddings else None)
    ref = jdit.cogvideox_forward(
        jcfg, params, jnp.asarray(x), jnp.asarray(text), jnp.asarray(t),
        image_rotary_emb=rope, ofs=None if ofs is None else jnp.asarray(ofs),
        attn_impl="xla")
    got = m(_t(x), _t(text), _t(t),
            None if rope is None else tuple(_t(np.array(r)) for r in rope),
            None if ofs is None else _t(ofs), attn_impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_dit_rejects_an_unknown_attn_impl_and_a_short_prompt(dit_pair):
    """Off the sample grid the resized position table starts at the text
    length, so only a full-length prompt fits (JAX fails on a reshape)."""
    _, _, m = dit_pair
    fi = m.cfg.use_frame_in
    with pytest.raises(ValueError, match="attn_impl"):
        m(torch.zeros(1, 3 + fi, 12, 8, 8), torch.zeros(1, 8, 16),
          torch.zeros(1), tdit.cogvideox_rope(m.cfg, 3, 8, 8, fi),
          attn_impl="pallas")
    with pytest.raises(ValueError, match="8 tokens"):
        m(torch.zeros(1, 3 + fi, 12, 4, 4), torch.zeros(1, 5, 16),
          torch.zeros(1), tdit.cogvideox_rope(m.cfg, 3, 4, 4, fi))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    """The tiny VAE: torch init, loaded into a JAX tree by the JAX
    package's diffusers loader."""
    cfg = tvae.tiny_vae_config()
    jcfg = jvae.tiny_vae_config()
    m = tvae.init_cogvideox_vae(cfg, torch.Generator().manual_seed(2))
    return jcfg, jweights.cogvideox_vae_from_state_dict(_np_sd(m), jcfg), m


@pytest.mark.parametrize("frames", [9, 17])
def test_vae_full_and_streaming_match_jax(vae_pair, frames):
    """17 frames: encode chunks of 9 and 8 frames, decode chunks of 3 and 2
    latent frames, so both the odd first chunk and the even rest run."""
    jcfg, params, m = vae_pair
    rs = np.random.RandomState(5)
    video = np.tanh(rs.randn(1, 3, frames, 16, 16)).astype(np.float32)
    ref = np.asarray(jvae.encode_moments(jcfg, params, jnp.asarray(video)))
    ref_s = np.asarray(jvs.streaming_encode_moments(jcfg, params,
                                                    jnp.asarray(video)))
    got = m.encode_moments(_t(video)).numpy()
    got_s = tvs.streaming_encode_moments(m, _t(video)).numpy()
    assert got.shape == ref.shape == (1, 8, (frames - 1) // 4 + 1, 4, 4)
    # fp32 convs and norms, sums in another order: 1e-4
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s, ref_s, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s, got, atol=1e-4, rtol=1e-4)

    z = rs.randn(*ref[:, :4].shape).astype(np.float32)
    ref_d = np.asarray(jvae.decode(jcfg, params, jnp.asarray(z)))
    ref_sd = np.asarray(jvs.streaming_decode(jcfg, params, jnp.asarray(z)))
    got_d = m.decode(_t(z)).numpy()
    got_sd = tvs.streaming_decode(m, _t(z)).numpy()
    assert got_d.shape == (1, 3, frames, 16, 16)
    np.testing.assert_allclose(got_d, ref_d, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_sd, ref_sd, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_sd, got_d, atol=1e-4, rtol=1e-4)


def test_vae_tiled_matches_jax(vae_pair):
    """A 288x64 canvas: two 256-pixel tile rows (stride 192) blended in
    latent space to encode and in pixel space to decode."""
    jcfg, params, m = vae_pair
    rs = np.random.RandomState(6)
    video = np.tanh(rs.randn(1, 3, 5, 288, 64)).astype(np.float32)
    ref = np.asarray(jvs.tiled_streaming_encode_moments(
        jcfg, params, jnp.asarray(video)))
    got = tvs.tiled_streaming_encode_moments(m, _t(video)).numpy()
    assert got.shape == (1, 8, 2, 72, 16)
    # fp32, sums in another order: 1e-4
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    z = rs.randn(1, 4, 3, 72, 16).astype(np.float32)
    ref_d = np.asarray(jvs.tiled_streaming_decode(jcfg, params,
                                                  jnp.asarray(z)))
    got_d = tvs.tiled_streaming_decode(m, _t(z)).numpy()
    assert got_d.shape == (1, 3, 9, 288, 64)
    np.testing.assert_allclose(got_d, ref_d, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [2, 3, 50])
def test_ddim_tables_and_steps_match_jax(steps):
    cfg, jcfg = tddim.DDIMConfig(), jddim.DDIMConfig()
    ac = tddim.ddim_alphas_cumprod(cfg)
    np.testing.assert_array_equal(ac, jddim.ddim_alphas_cumprod(jcfg))
    ts = tddim.inference_timesteps(cfg, steps)
    np.testing.assert_array_equal(ts, jddim.inference_timesteps(jcfg, steps))
    ac32 = ac.astype(np.float32)
    rs = np.random.RandomState(7)
    x = rs.randn(1, 3, 4, 4, 4).astype(np.float32)
    xj = jnp.asarray(x)
    for t in ts[:4]:
        out = rs.randn(*x.shape).astype(np.float32)
        x = tddim.ddim_step(cfg, ac32, _t(x), _t(out), int(t), steps).numpy()
        xj = jddim.ddim_step(jcfg, jnp.asarray(ac32), xj, jnp.asarray(out),
                             jnp.asarray(t, jnp.int32), steps)
        # fp32 scalars on the host against traced fp32: 1e-5
        np.testing.assert_allclose(x, np.asarray(xj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("steps", [3, 5])
def test_dpm_steps_match_jax(steps):
    """The x0 carry and the t_back = -1 first-step sentinel, through the
    final (first-order) step."""
    cfg, jcfg = tddim.DDIMConfig(), jddim.DDIMConfig()
    ac32 = tddim.ddim_alphas_cumprod(cfg).astype(np.float32)
    ts = tddim.inference_timesteps(cfg, steps)
    ts_back = np.concatenate([[-1], ts[:-1]])
    rs = np.random.RandomState(8)
    x = rs.randn(1, 3, 4, 4, 4).astype(np.float32)
    x0 = np.zeros_like(x)
    xj, x0j = jnp.asarray(x), jnp.asarray(x0)
    x, x0 = _t(x), _t(x0)
    for t, tb in zip(ts, ts_back):
        out = rs.randn(*x.shape).astype(np.float32)
        x, x0 = tdpm.dpm_step_pair(cfg, ac32, x, _t(out), int(t), int(tb),
                                   x0, steps)
        xj, x0j = jdpm.dpm_step_pair(jcfg, jnp.asarray(ac32), xj,
                                     jnp.asarray(out),
                                     jnp.asarray(t, jnp.int32),
                                     jnp.asarray(tb, jnp.int32), x0j, steps)
        # fp32 scalars on the host against traced fp32: 1e-5
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(x0.numpy(), np.asarray(x0j), atol=1e-5,
                                   rtol=1e-5)
    assert torch.isfinite(x).all()


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame_in", [False, True])
def test_dit_bridge_loads_strict_and_matches_jax_names(frame_in):
    cfg = tdit.tiny_config(use_frame_in=frame_in)
    params = jdit.init_cogvideox_dit(jax.random.key(2),
                                     jdit.tiny_config(use_frame_in=frame_in))
    sd = tweights.cogvideox_dit_from_jax(jax.tree.map(np.asarray, params),
                                         cfg)
    m = tdit.CogVideoXDiT(cfg, device="meta")
    res = m.load_state_dict(sd, assign=True, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    # the JAX package's own export names and values
    want = jweights.cogvideox_dit_to_state_dict(params, jdit.tiny_config(
        use_frame_in=frame_in))
    assert set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


def test_vae_bridge_loads_strict_and_inverts_the_jax_loader(vae_pair):
    jcfg, params, m = vae_pair
    cfg = tvae.tiny_vae_config()
    sd = tweights.cogvideox_vae_from_jax(jax.tree.map(np.asarray, params),
                                         cfg)
    fresh = tvae.CogVideoXVAE(cfg, device="meta")
    res = fresh.load_state_dict(sd, assign=True, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    # the JAX loader read these same tensors from m: the round trip is exact
    for k, v in m.state_dict().items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0, msg=k)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

PH, PW, PF = 16, 16, 9


@pytest.fixture(scope="module")
def cog_pipes():
    """The tiny FrameINO DiT and VAE with the same weights on both sides.
    The encoder's logvar bias is driven to -100: after the -30 clip the
    posterior std is 3e-7, so the two sides' different noise is lost in
    fp32 rounding."""
    dcfg = tdit.tiny_config(use_frame_in=True)
    vcfg = tvae.tiny_vae_config()
    gen = torch.Generator().manual_seed(11)
    dit = tdit.init_cogvideox_dit(dcfg, gen)
    vae = tvae.init_cogvideox_vae(vcfg, gen)
    with torch.no_grad():
        vae.encoder.conv_out.conv.bias[vcfg.latent_channels:] = -100.0
    jdcfg = jdit.tiny_config(use_frame_in=True)
    jvcfg = jvae.tiny_vae_config()
    jp = jpipe.CogVideoXImageToVideoPipeline(
        jdcfg, jweights.cogvideox_dit_from_state_dict(_np_sd(dit), jdcfg),
        jvcfg, jweights.cogvideox_vae_from_state_dict(_np_sd(vae), jvcfg))
    return jp, dit, vae


def _cog_conditions(seed=9):
    rs = np.random.RandomState(seed)
    image = np.tanh(rs.randn(1, 3, PH, PW)).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, PF, PH, PW)).astype(np.float32)
    idf = np.tanh(rs.randn(1, 3, PH, PW)).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    latents = rs.randn(1, 3, 4, PH // 4, PW // 4).astype(np.float32)
    return image, traj, idf, text, latents


@pytest.mark.parametrize("output_type", ["latent", "np"])
@pytest.mark.parametrize("sched", ["ddim", "dpm"])
def test_pipeline_matches_jax(cog_pipes, sched, output_type):
    """Trajectory + ID frame, batch CFG with the dynamic schedule, 3
    steps; the latents, or the video through the tiled streaming decode."""
    jp, dit, vae = cog_pipes
    jp.pipe_cfg = jpipe.CogPipelineConfig(scheduler_type=sched)
    tp = tpipe.CogVideoXImageToVideoPipeline(
        dit, vae, tpipe.CogPipelineConfig(scheduler_type=sched))
    image, traj, idf, text, latents = _cog_conditions()
    common = dict(height=PH, width=PW, num_frames=PF, num_inference_steps=3,
                  guidance_scale=6.0, output_type=output_type)
    ref = np.asarray(jp(jnp.asarray(image), prompt_embeds=jnp.asarray(text),
                        traj_tensor=jnp.asarray(traj),
                        id_tensor=jnp.asarray(idf),
                        latents=jnp.asarray(latents), attn_impl="xla",
                        **common))
    got = tp(_t(image), prompt_embeds=_t(text), traj_tensor=_t(traj),
             id_tensor=_t(idf), latents=_t(latents), **common)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want_shape = (1, 3, 4, 4, 4) if output_type == "latent" \
        else (1, 3, PF, PH, PW)
    assert got.shape == ref.shape == want_shape
    assert np.isfinite(got).all()
    # fp32 on both sides: reordered sums through the VAE encodes, 3 DiT
    # steps at guidance up to 7 and the decode (1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_pipeline_decode_modes_agree(cog_pipes):
    """Every decode_mode ("full" and the Wan-only modes included) takes the
    tiled streaming walk, which agrees with the segmented full-sequence
    reference ``CogVideoXVAE.decode`` on the final latents."""
    _, dit, vae = cog_pipes
    tp = tpipe.CogVideoXImageToVideoPipeline(dit, vae)
    image, traj, _, text, latents = _cog_conditions(seed=10)

    def run(**kw):
        return tp(_t(image), prompt_embeds=_t(text), traj_tensor=_t(traj),
                  latents=_t(latents), height=PH, width=PW, num_frames=PF,
                  num_inference_steps=2, **kw)

    stream = run()
    np.testing.assert_array_equal(run(decode_mode="full"), stream)
    np.testing.assert_array_equal(run(decode_mode="hybrid"), stream)
    z = run(output_type="latent").permute(0, 2, 1, 3, 4) \
        / vae.cfg.scaling_factor
    full = vae.decode(z).clamp(-1.0, 1.0).numpy()
    # the same convs, the norms per segment vs per chunk: 1e-5
    np.testing.assert_allclose(full, stream, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cog_server():
    srv = PipelineServer(serve.build_pipeline(smoke=True, random_init=False,
                                              family="cogvideox"),
                         default_steps=2)
    httpd, port = srv.start_background()
    yield srv, port
    httpd.shutdown()
    httpd.server_close()


def _b64(arr, npy=False):
    buf = io.BytesIO()
    if npy:
        np.save(buf, arr)
    else:
        from PIL import Image
        Image.fromarray(arr, "RGB").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request(frames, with_id, **extra):
    img = np.random.default_rng(0).integers(0, 255, (40, 48, 3),
                                            dtype=np.uint8)
    req = {"image_b64": _b64(img),
           "prompt_embeds_b64": _b64(np.zeros((8, 16), np.float32), True),
           "trajectories": [[[5, 5], [40, 30]]],
           "height": 40, "width": 48, "num_frames": frames,
           "num_inference_steps": 1, **extra}
    if with_id:
        req["id_image_b64"] = _b64(img[:16, :16].copy())
    return req


@pytest.mark.parametrize("frames,with_id", [(7, True), (5, False)])
def test_cog_server_answers_with_the_requested_frames(cog_server, frames,
                                                      with_id):
    """The frame bucket comes from the CogVideoX VAE's
    temporal_compression_ratio (4): 7 frames are served at 9."""
    _, port = cog_server
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(_request(frames, with_id)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r) as resp:
        out = json.load(resp)
    assert (out["num_frames"], out["height"], out["width"]) == (frames, 40, 48)
    assert out["bucket"] == [(frames - 1 + 3) // 4 * 4 + 1, 64, 64]
    assert len(base64.b64decode(out["video_b64"])) > 100
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as resp:
        assert json.load(resp)["pipeline"] == "CogVideoXImageToVideoPipeline"


class _Recorder:
    """Stands in for a pipeline's ``__call__`` and records its kwargs."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, *a, **kw):
        self.calls.append(kw)
        return self.pipe(*a, **kw)


@pytest.mark.parametrize("extra,want", [({}, None),
                                        ({"decode_mode": "full"}, "full")])
def test_server_passes_decode_mode_only_when_asked(cog_server, extra, want):
    """Without decode_mode in the request the CogVideoX pipeline keeps its
    own default, the tiled streaming walk (a Wan request takes "hybrid",
    JAX's server default)."""
    srv, _ = cog_server
    rec = _Recorder(srv.pipeline)
    srv.pipeline = rec
    try:
        out = srv.handle_generate(_request(5, False, **extra))
    finally:
        srv.pipeline = rec.pipe
    assert out["num_frames"] == 5
    assert rec.calls[0].get("decode_mode") == want
    assert ("decode_mode" in rec.calls[0]) == bool(extra)


def test_serve_builds_the_cogvideox_smoke_pipeline():
    pipe = serve.build_pipeline(smoke=True, random_init=False,
                                family="cogvideox")
    assert isinstance(pipe, tpipe.CogVideoXImageToVideoPipeline)
    assert pipe.dit_cfg == tdit.tiny_config()
    assert pipe.vae_cfg == tvae.tiny_vae_config()
    assert pipe.device.type == "cpu"
    a = serve.parse_args(["--family", "cogvideox", "--smoke"])
    assert a.family == "cogvideox" and a.smoke
    # int8 CogVideoX is served now: the same tiny pipeline, quantized
    q = serve.build_pipeline(smoke=True, random_init=False,
                             family="cogvideox", quantize="int8")
    assert isinstance(q, tpipe.CogVideoXImageToVideoPipeline)
    assert q.dit_cfg == tdit.tiny_config() and q.device.type == "cpu"
    assert any(type(m).__name__ == "QuantLinear" for m in q.dit.modules())
