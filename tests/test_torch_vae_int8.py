"""The port's int8 w8a8 Wan VAE (``models/quant.quantize_wan_vae_int8``,
``ops/conv_int8``, K14's plain version) against the JAX package's
``quantize_wan_vae_int8`` and ``ops/conv._conv_int8`` (CPU, tiny configs:
JAX's ``_vae_tiny22`` of ``tests/test_quant.py`` and a plain Wan2.1-style
one).

The rules the tests pin:
- the weight scale DIVIDES the absmax by 127: JAX quantizes the VAE
  eagerly (``_quantize_conv_kernel`` outside ``jit``), so the port's
  ``weight_q`` / ``scale`` are bit-equal to JAX's;
- the activation path is JAX's under ``jit`` (its streaming chunks, its
  tiled and hybrid tiles, the serving default): the absmax MULTIPLIED by
  fp32(1/127), ``x / s_x`` a true division, and the epilogue's product
  and bias one fused multiply-add (XLA contracts them). JAX's eager
  full-sequence decode divides by 127 and rounds the product before the
  bias (``test_eager_jax_rounds_the_scale_and_epilogue_apart``), so the
  whole-VAE tests compare against JAX under ``jit``;
- every int8 conv kind of the VAE, per call, is bit-equal to JAX's.

The weights are a seeded torch VAE read into a JAX tree by the JAX
package's own diffusers loader; inputs are made with numpy.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import quant as jquant
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import wan_vae_streaming as jstream
from frameino_tpu.models import wan_vae_tiling as jtile
from frameino_tpu.models import weights as jweights
from frameino_tpu.ops import conv as jconv
from frameino_tpu_torch.models import quant as tquant
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models import wan_vae_streaming as S
from frameino_tpu_torch.models import wan_vae_tiling as T
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.ops import conv as tconv
from frameino_tpu_torch.ops import conv_int8 as K14

CFG_KW = {
    # tests/test_quant.py::_vae_tiny22
    "wan22": dict(base_dim=8, decoder_base_dim=12, z_dim=4, dim_mult=(1, 2, 2),
                  num_res_blocks=1, temperal_downsample=(True, True),
                  is_residual=True, in_channels=12, out_channels=12,
                  patch_size=2, latents_mean=(0.0,) * 4,
                  latents_std=(1.0,) * 4),
    # Wan2.1's plain blocks: 2D and 3D resamplers, no patchify
    "wan21": dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                  temperal_downsample=(False, True), is_residual=False,
                  scale_factor_temporal=2, scale_factor_spatial=4,
                  latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4),
}
Z_SHAPE = {"wan22": (1, 4, 4, 4, 4), "wan21": (1, 4, 4, 6, 6)}
VIDEO_SHAPE = {"wan22": (1, 3, 9, 32, 32), "wan21": (1, 3, 9, 24, 24)}

# The int8 VAE against JAX's int8 VAE. Each conv is bit-equal (below), but
# the float steps between them (the fp32 conv_in, channel norms, SiLU, the
# mid attention) round ~1e-7 apart, and a per-tensor int8 scale turns that
# into whole code steps wherever a value sits near a half or the absmax
# moves by an ulp; at 8-16 channels each step is a large share of a
# layer. Read here (CPU): mean abs relative 1.5e-7 to 1.40e-2 over the
# walks and configs (the plain encode of wan21 the largest), correlation
# >= 0.99988. The limit is JAX's own for int8 walks that differ by their
# scales (tests/test_quant.py:216-232); a conv's scale taken over the wrong
# tensor is caught bit-exactly by test_streaming_conv_scale_spans_cache.
VAE_MEAN_REL = 0.05
VAE_MIN_CORR = 0.999


def _vae(name, seed=0):
    return tvae.init_wan_vae(tvae.WanVAEConfig(**CFG_KW[name]),
                             torch.Generator().manual_seed(seed))


def _jax_params(model, name):
    return jweights.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        jvae.WanVAEConfig(**CFG_KW[name]))


_PAIRS = {}


def _pair(name):
    """(JAX config, JAX's int8 tree, the port's int8 VAE, JAX's float tree
    as numpy), made once."""
    if name not in _PAIRS:
        model = _vae(name)
        params = jax.tree.map(np.asarray, _jax_params(model, name))
        qparams = jquant.quantize_wan_vae_int8(params)
        tquant.quantize_wan_vae_int8(model)
        _PAIRS[name] = (jvae.WanVAEConfig(**CFG_KW[name]), qparams, model,
                        params)
    return _PAIRS[name]


@pytest.fixture(params=sorted(CFG_KW))
def pair(request):
    return (request.param, *_pair(request.param)[:3])


def _mean_rel(a, b):
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-8))


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert _mean_rel(got, ref) <= VAE_MEAN_REL, _mean_rel(got, ref)
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
    assert corr >= VAE_MIN_CORR, corr


# ---------------------------------------------------------------------------
# the weight quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CFG_KW))
def test_weights_are_bit_equal_to_jax(name):
    """weight_q / scale of every swapped conv equal JAX's on the bridged
    (numpy) weights, and the swapped set maps one to one onto JAX's
    ``kernel_q`` leaves."""
    _, qparams, model, _ = _pair(name)
    sd = model.state_dict()
    ref = tweights.wan_vae_from_jax(qparams, tvae.WanVAEConfig(**CFG_KW[name]))
    assert set(ref) == set(sd)
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype, k
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0, msg=k)
    swapped = {n for n, m in model.named_modules()
               if isinstance(m, (tquant.QuantConv3d, tquant.QuantConv2d))}
    assert swapped == {k[:-len(".weight_q")] for k in ref
                       if k.endswith(".weight_q")}
    assert swapped == set(tquant.vae_quantized_layer_names(model))
    kinds = {n.rsplit(".", 1)[-1] for n in swapped}
    assert kinds >= {"conv1", "conv2", "time_conv", "1"}
    for stays in ("encoder.conv_in", "encoder.conv_out", "decoder.conv_in",
                  "decoder.conv_out", "quant_conv", "post_quant_conv",
                  "decoder.mid_block.attentions.0.to_qkv",
                  "decoder.mid_block.attentions.0.proj"):
        assert isinstance(model.get_submodule(stays),
                          (torch.nn.Conv2d, torch.nn.Conv3d)), stays
    with pytest.raises(ValueError, match="no VAE conv"):
        tquant.quantize_wan_vae_int8(model)


def test_bridged_int8_tree_loads_into_a_quantized_vae():
    """JAX's int8 tree, through ``wan_vae_from_jax``, loads strictly into a
    port VAE quantized from other weights, and then decodes as the VAE
    quantized from the same ones."""
    _, qparams, model, _ = _pair("wan22")
    other = tquant.quantize_wan_vae_int8(_vae("wan22", seed=5))
    other.load_state_dict(tweights.wan_vae_from_jax(
        qparams, tvae.WanVAEConfig(**CFG_KW["wan22"])))
    z = torch.from_numpy(np.random.RandomState(1).randn(
        *Z_SHAPE["wan22"]).astype(np.float32))
    torch.testing.assert_close(other.decode(z), model.decode(z), atol=0,
                               rtol=0)


# ---------------------------------------------------------------------------
# the plain conv against JAX's _conv_int8, per conv kind
# ---------------------------------------------------------------------------

def _kernel(rs, k, cin, cout):
    w = rs.uniform(-1, 1, (*k, cin, cout)).astype(np.float32) / np.sqrt(
        np.prod(k) * cin)
    q, s = jquant._quantize_conv_kernel(w)
    b = rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32)
    return q, s, b


# kind: (JAX call on channels-last x, port call on channels-first x, the
# kernel's spatial shape, x's [B, C, T, H, W])
def _kinds():
    def cc(padding):
        return (lambda x, p: jconv.causal_conv3d(x, **p, padding=padding),
                lambda x, p: tconv.causal_conv3d(x, **p, padding=padding))

    def c2(stride, jpad, tpad, pre):
        def jax_fn(x, p):
            B, T_, H, W, C = x.shape
            x2 = x.reshape(B * T_, H, W, C)
            x2 = jconv.zero_pad_hw_br(x2) if pre else x2
            return jconv.conv2d(x2, **p, stride=stride, padding=jpad)

        def port_fn(x, p):
            B, C, T_, H, W = x.shape
            x2 = x.permute(0, 2, 1, 3, 4).reshape(B * T_, C, H, W)
            return tconv.conv2d(x2, **p, stride=stride, padding=tpad)
        return jax_fn, port_fn

    return {
        "causal_3x3x3": (*cc(1), (3, 3, 3), (1, 12, 5, 7, 6)),
        "shortcut_1x1x1": (*cc(0), (1, 1, 1), (1, 12, 5, 7, 6)),
        "time_conv_causal": (*cc((1, 0, 0)), (3, 1, 1), (2, 8, 5, 4, 3)),
        "time_conv_stride2": (
            lambda x, p: jconv.conv3d(x, **p, stride=(2, 1, 1),
                                      padding="VALID"),
            lambda x, p: tconv.conv3d(x, **p, stride=(2, 1, 1)),
            (3, 1, 1), (1, 8, 7, 4, 3)),
        "up_2d_same": (*c2(1, "SAME", "same", False), (3, 3), (1, 8, 3, 6, 5)),
        "down_2d_stride2": (*c2(2, "VALID", ((0, 1), (0, 1)), True), (3, 3),
                            (1, 8, 3, 7, 6)),
    }


KINDS = _kinds()


def _params(k, q, s, b, port):
    if not port:
        return dict(kernel_q=jnp.asarray(q), scale=jnp.asarray(s),
                    bias=jnp.asarray(b))
    axes = (4, 3, 0, 1, 2) if q.ndim == 5 else (3, 2, 0, 1)
    return dict(weight=K14.kernel_weight(torch.from_numpy(
        np.ascontiguousarray(q.transpose(axes)))), scale=torch.from_numpy(s),
        bias=torch.from_numpy(b))


def _to_channels_first(y):
    y = np.asarray(y)
    return y.transpose(0, 4, 1, 2, 3) if y.ndim == 5 else \
        y.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("x_kind", ["random", "zero", "round_half"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_conv_is_bit_equal_to_jax(kind, x_kind):
    """Each conv kind of the VAE through ``ops/conv`` (the plain version of
    K14 on CPU tensors) against JAX's jitted ``_conv_int8``: bit-equal,
    with an all-zero input (the 1e-12 floor) and one whose codes fall on
    halves (round half to even)."""
    jax_fn, port_fn, k, shape = KINDS[kind]
    rs = np.random.RandomState(sum(map(ord, kind)))
    q, s, b = _kernel(rs, k, shape[1], 10)
    x = rs.randn(*shape).astype(np.float32)
    if x_kind == "zero":
        x[:] = 0.0
    elif x_kind == "round_half":
        # amax 15.875 gives s_x = 0.125 exactly; odd multiples of 1/16
        # are then codes of k + 0.5
        x = (np.round(x * 8) / 8 + 1.0 / 16).astype(np.float32)
        x.flat[0] = 15.875
        sx = np.maximum(np.abs(x).max() * np.float32(1.0 / 127.0),
                        np.float32(1e-12))
        assert sx == np.float32(0.125)
        assert (np.abs(x / sx) % 1 == 0.5).sum() > 10
    xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    ref = _to_channels_first(jax.jit(jax_fn)(xj, _params(k, q, s, b, False)))
    got = port_fn(torch.from_numpy(x), _params(k, q, s, b, True))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if x_kind == "zero":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(
            b.reshape((-1,) + (1,) * (got.ndim - 2)), got.shape))


def test_eager_jax_rounds_the_scale_and_epilogue_apart():
    """JAX's eager ``_conv_int8`` (its full-sequence decode) divides the
    absmax by 127 and adds the bias to the rounded product; under ``jit``
    (every other walk) XLA multiplies by the fp32 reciprocal and fuses
    the epilogue. The scales are at most one ulp apart; where they agree,
    the outputs differ by the rounding of the unfused product alone, a few
    ulps of the largest output (and some do differ: the fused add)."""
    jax_fn, port_fn, k, shape = KINDS["causal_3x3x3"]
    rs = np.random.RandomState(9)
    q, s, b = _kernel(rs, k, shape[1], 10)
    n_off, n_ulp = 0, 0
    for i in range(12):
        x = (rs.randn(*shape) * rs.uniform(0.1, 10)).astype(np.float32)
        amax = np.abs(x).max()
        div = np.float32(amax / np.float32(127.0))
        mul = np.float32(amax * np.float32(1.0 / 127.0))
        assert abs(int(div.view(np.int32)) - int(mul.view(np.int32))) <= 1
        got = port_fn(torch.from_numpy(x), _params(k, q, s, b, True)).numpy()
        eager = _to_channels_first(jax_fn(
            jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
            _params(k, q, s, b, False)))
        if div == mul:
            ulp = np.spacing(np.abs(eager).max())
            assert np.abs(got - eager).max() <= 4 * ulp
            n_ulp += int((got != eager).sum())
        else:
            n_off += 1
            assert np.abs(got - eager).max() <= 1e-2 * np.abs(eager).max()
    assert n_off < 12 and n_ulp > 0


def test_conv_int8_checks_its_arguments():
    x = torch.zeros(1, 4, 3, 5, 5)
    w = K14.kernel_weight(torch.zeros(6, 4, 3, 3, 3, dtype=torch.int8))
    assert w.shape == (6, 3, 3, 3, K14.CHANNEL_GRANULE)
    s = torch.ones(6)
    with pytest.raises(TypeError, match="int8 weights"):
        K14.conv_int8(x, w.float(), s)
    with pytest.raises(ValueError, match="input channels"):
        K14.conv_int8(torch.zeros(1, 40, 3, 5, 5), w, s)
    with pytest.raises(ValueError, match="scale / bias"):
        K14.conv_int8(x, w, s[:5])
    with pytest.raises(ValueError, match="empty output"):
        K14.conv_int8(x[:, :, :1, :2], w, s)
    before = K14.conv_int8.launches
    assert K14.conv_int8(x, w, s, padding=((2, 0), (1, 1), (1, 1))).shape \
        == (1, 6, 3, 5, 5)
    assert K14.conv_int8.launches == before      # the CPU runs the plain one


# ---------------------------------------------------------------------------
# the whole int8 VAE against JAX's, in every walk
# ---------------------------------------------------------------------------

def _z(name):
    return np.random.RandomState(2).randn(*Z_SHAPE[name]).astype(np.float32)


def _video(name):
    return np.tanh(np.random.RandomState(3).randn(
        *VIDEO_SHAPE[name])).astype(np.float32)


def test_decode_full_and_streaming_match_jax(pair):
    """Both configs' full decode; the streaming walk on the Wan2.2 one (the
    serving VAE; JAX compiles a program a chunk kind)."""
    name, jcfg, qp, model = pair
    z = _z(name)
    ref = jax.jit(lambda t: jvae.decode(jcfg, qp, t))(jnp.asarray(z))
    _close(model.decode(torch.from_numpy(z)), ref)
    if name != "wan22":
        return
    ref_s = jstream.streaming_decode(jcfg, qp, jnp.asarray(z),
                                     chunk_latent_frames=2)
    got_s = S.streaming_decode(model, torch.from_numpy(z),
                               chunk_latent_frames=2)
    _close(got_s, ref_s)
    # each chunk quantizes with its own scale: the walks differ
    assert (got_s - model.decode(torch.from_numpy(z))).abs().max() > 1e-4


def test_encode_full_and_streaming_match_jax(pair):
    name, jcfg, qp, model = pair
    v = _video(name)
    ref = jax.jit(lambda t: jvae.encode_moments(jcfg, qp, t))(jnp.asarray(v))
    _close(model.encode_moments(torch.from_numpy(v)), ref)
    ref_s = jstream.streaming_encode_moments(jcfg, qp, jnp.asarray(v),
                                             chunk_pixel_frames=4)
    _close(S.streaming_encode_moments(model, torch.from_numpy(v),
                                      chunk_pixel_frames=4), ref_s)


@pytest.mark.parametrize("cache_frames", [None, 1, 2])
def test_streaming_conv_scale_spans_cache(cache_frames):
    """The streaming causal conv of an int8 layer quantizes [cache, x] with
    one scale and pads only what the cache leaves, bit-equal to JAX's
    jitted ``_cconv_fwd``; the cache holds the largest value, so a scale
    over the chunk alone would differ."""
    rs = np.random.RandomState(11)
    q, s, b = _kernel(rs, (3, 3, 3), 12, 10)
    p = _params(None, q, s, b, True)
    conv = tquant.QuantConv3d(p["weight"], p["scale"], p["bias"])
    x = rs.randn(1, 12, 3, 5, 4).astype(np.float32)
    cache = None
    if cache_frames:
        cache = (4 * rs.randn(1, 12, cache_frames, 5, 4)).astype(np.float32)
    got = S._cconv_fwd(torch.from_numpy(x), conv, None if cache is None
                       else torch.from_numpy(cache), 1)

    def cl(a):
        return None if a is None else jnp.asarray(a.transpose(0, 2, 3, 4, 1))
    ref = jax.jit(lambda x_, c_: jstream._cconv_fwd(
        x_, _params(None, q, s, b, False), c_, 1))(cl(x), cl(cache))
    np.testing.assert_array_equal(got.numpy(), _to_channels_first(ref))


# 2 x 2 tiles of one shape (JAX compiles each tile shape): latent tiles of 4
# at a stride of 3 over 7 x 7, pixel tiles of 16 at 12 over 28 x 28
TILE_KW = dict(tile_min=16, tile_stride=12)


def test_tiled_and_hybrid_decode_match_jax():
    """One activation scale a tile (and a chunk of a tile), as JAX."""
    jcfg, qp, model, _ = _pair("wan21")
    z = np.random.RandomState(3).randn(1, 4, 2, 7, 7).astype(np.float32)
    decode = jax.jit(lambda t: jvae.decode(jcfg, qp, t, clamp=False))
    ref = jtile.tiled_decode(jcfg, qp, jnp.asarray(z), decode_fn=decode,
                             **TILE_KW)
    _close(T.tiled_decode(model, torch.from_numpy(z), **TILE_KW), ref)
    ref_h = jtile.hybrid_decode(jcfg, qp, jnp.asarray(z),
                                chunk_latent_frames=2, **TILE_KW)
    _close(T.hybrid_decode(model, torch.from_numpy(z), chunk_latent_frames=2,
                           **TILE_KW), ref_h)


def test_tiled_and_hybrid_encode_match_jax():
    jcfg, qp, model, _ = _pair("wan21")
    v = np.tanh(np.random.RandomState(4).randn(1, 3, 5, 28, 28)).astype(
        np.float32)
    encode = jax.jit(lambda t: jvae.encode_moments(jcfg, qp, t))
    ref = jtile.tiled_encode(jcfg, qp, jnp.asarray(v), encode_fn=encode,
                             **TILE_KW)
    _close(T.tiled_encode(model, torch.from_numpy(v), **TILE_KW), ref)
    ref_h = jtile.hybrid_encode(jcfg, qp, jnp.asarray(v),
                                chunk_pixel_frames=4, **TILE_KW)
    _close(T.hybrid_encode(model, torch.from_numpy(v), chunk_pixel_frames=4,
                           **TILE_KW), ref_h)


def test_int8_decode_stays_near_fp32():
    """JAX's own quality measures of the int8 decode and encode
    (``tests/test_quant.py:181-199``) hold for the port."""
    model = _vae("wan22")
    z = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 3, 4, 4)
                         .astype(np.float32))
    v = torch.from_numpy(_video("wan22"))
    ref, refe = model.decode(z), model.encode(v)
    tquant.quantize_wan_vae_int8(model)
    got, gote = model.decode(z), model.encode(v)
    assert _mean_rel(got.numpy(), ref.numpy()) < 0.06
    assert np.corrcoef(got.numpy().ravel(), ref.numpy().ravel())[0, 1] > 0.99
    assert _mean_rel(gote.numpy(), refe.numpy()) < 0.03


# ---------------------------------------------------------------------------
# K14's index map, replayed
# ---------------------------------------------------------------------------

SRC = Path(tquant.__file__).resolve().parents[1] / "csrc" / "conv_int8.cu"


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def _replay_igemm(xq, wk, g):
    """The int32 sums of ``igemm_kernel`` as its threads compute them: each
    block's copy slots gather their rows tap by tap into the swizzled
    stages, each warp's lanes read their m16n8k32 fragments back through
    the same swizzle, and the fragments multiply as the PTX ISA lays them
    out. Returns [B, Cout, To, Ho, Wo] int64."""
    BM, BN, BK = _constant("kBM"), _constant("kBN"), _constant("kBK")
    threads = _constant("kThreads")
    B, Ti, Hi, Wi, Cp = xq.shape
    (Cout, kt, kh, kw, _), (st, sh, sw, pt, ph, pw, To, Ho, Wo) = \
        wk.shape, g
    M, P = B * To * Ho * Wo, To * Ho * Wo
    K = kt * kh * kw * Cp
    cchunks, nk = Cp // BK, kt * kh * kw * Cp // BK
    out = np.zeros((B, Cout, P), np.int64)
    tid = np.arange(threads)
    lrow, lhalf = tid // 2, tid % 2
    lane = np.arange(32)
    grp, tig = lane // 4, lane % 4

    def swz(row, half):
        return row * BK + 16 * (half ^ ((row >> 2) & 1))

    def lds32(tile, row, half, word):
        o = swz(row, half) + 4 * word
        return np.stack([tile[o + i] for i in range(4)], -1)  # 4 int8s

    for m0 in range(0, M, BM):
        m = m0 + lrow
        m_ok = m < M
        b, r = np.divmod(np.minimum(m, M - 1), P)
        to, r = np.divmod(r, Ho * Wo)
        ho, wo = np.divmod(r, Wo)
        ti0, hi0, wi0 = to * st - pt, ho * sh - ph, wo * sw - pw
        for n0 in range(0, Cout, BN):
            n_row = n0 + lrow
            n_ok = n_row < Cout
            acc = np.zeros((8, 2, 8, 32, 4), np.int64)  # warp, i, j, lane
            for ks in range(nk):
                tap, cc = divmod(ks, cchunks)
                dt, dhw = divmod(tap, kh * kw)
                dh, dw = divmod(dhw, kw)
                ti, hi, wi = ti0 + dt, hi0 + dh, wi0 + dw
                a_ok = (m_ok & (ti >= 0) & (ti < Ti) & (hi >= 0) & (hi < Hi)
                        & (wi >= 0) & (wi < Wi))
                ta = np.zeros(BM * BK, np.int64)
                tb = np.zeros(BN * BK, np.int64)
                for t in tid:
                    dst = swz(lrow[t], lhalf[t])
                    c0 = cc * BK + 16 * lhalf[t]
                    if a_ok[t]:
                        ta[dst:dst + 16] = xq[b[t], ti[t], hi[t], wi[t],
                                              c0:c0 + 16]
                    if n_ok[t]:
                        k0 = ks * BK + 16 * lhalf[t]
                        tb[dst:dst + 16] = wk.reshape(Cout, K)[n_row[t],
                                                               k0:k0 + 16]
                for warp in range(8):
                    wm, wn = warp % 4, warp // 4
                    for i in range(2):
                        row = wm * 32 + i * 16 + grp
                        a = [lds32(ta, r, half, tig)
                             for half, r in ((0, row), (0, row + 8),
                                             (1, row), (1, row + 8))]
                        # A[16 x 32]: a0 row g cols 4t.., a1 row g+8, a2 row
                        # g cols 16+4t.., a3 row g+8 cols 16+4t..
                        A = np.zeros((16, 32), np.int64)
                        for ln in range(32):
                            g_, t_ = grp[ln], tig[ln]
                            A[g_, 4 * t_:4 * t_ + 4] = a[0][ln]
                            A[g_ + 8, 4 * t_:4 * t_ + 4] = a[1][ln]
                            A[g_, 16 + 4 * t_:20 + 4 * t_] = a[2][ln]
                            A[g_ + 8, 16 + 4 * t_:20 + 4 * t_] = a[3][ln]
                        for j in range(8):
                            nrow = wn * 64 + j * 8 + grp
                            b0, b1 = lds32(tb, nrow, 0, tig), \
                                lds32(tb, nrow, 1, tig)
                            # B[32 x 8]: b0 k 4t.. col g, b1 k 16+4t..
                            Bm = np.zeros((32, 8), np.int64)
                            for ln in range(32):
                                g_, t_ = grp[ln], tig[ln]
                                Bm[4 * t_:4 * t_ + 4, g_] = b0[ln]
                                Bm[16 + 4 * t_:20 + 4 * t_, g_] = b1[ln]
                            C = A @ Bm
                            for ln in range(32):
                                g_, t_ = grp[ln], tig[ln]
                                acc[warp, i, j, ln] += [
                                    C[g_, 2 * t_], C[g_, 2 * t_ + 1],
                                    C[g_ + 8, 2 * t_], C[g_ + 8, 2 * t_ + 1]]
            # the epilogue's map: c0 c1 row g, c2 c3 row g + 8; cols 2t, 2t+1
            for warp in range(8):
                wm, wn = warp % 4, warp // 4
                for i in range(2):
                    for h in range(2):
                        for j in range(8):
                            for e in range(2):
                                for ln in range(32):
                                    mr = (m0 + wm * 32 + i * 16 + grp[ln]
                                          + 8 * h)
                                    n = n0 + wn * 64 + j * 8 + 2 * tig[ln] + e
                                    if mr < M and n < Cout:
                                        bb, p = divmod(mr, P)
                                        out[bb, n, p] = acc[warp, i, j, ln,
                                                            2 * h + e]
    return out.reshape(B, Cout, To, Ho, Wo)


@pytest.mark.parametrize("case", [
    # x [B, C, T, H, W], kernel, stride, ((front, back), (top, bottom),
    # (left, right)): causal 3x3x3 over a ragged 40 channels (two chunks
    # of 32, the second half padding); a stride-2 2D window with its far
    # zero pad read by bounds; a stride-2 time conv over two batches
    ((1, 40, 3, 5, 4), (3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1))),
    ((2, 8, 1, 7, 6), (1, 3, 3), (1, 2, 2), ((0, 0), (0, 1), (0, 1))),
    ((2, 16, 7, 3, 3), (3, 1, 1), (2, 1, 1), ((0, 0), (0, 0), (0, 0))),
])
def test_igemm_index_map_replays_the_plain_conv(case):
    """A numpy replay of K14's tiling, gathers, swizzle and fragment maps
    gives the plain version's int32 sums exactly (this pins the source's
    index arithmetic, not the compiled kernel: only the card runs that)."""
    shape, k, stride, pads = case
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    cout = 10
    w = torch.from_numpy(rs.randint(-127, 128, (cout, shape[1], *k))
                         .astype(np.int8))
    codes, _ = K14.quantize_activation_ref(x)
    cp = -(-shape[1] // K14.CHANNEL_GRANULE) * K14.CHANNEL_GRANULE
    xq = np.zeros((*shape[:1], *shape[2:], cp), np.int64)
    xq[..., :shape[1]] = codes.permute(0, 2, 3, 4, 1).numpy()
    wk = K14.kernel_weight(w)
    assert torch.equal(K14.torch_weight(wk, shape[1]), w)
    To, Ho, Wo = K14.out_extents(shape, wk.shape, stride, pads)
    wk = wk.numpy().astype(np.int64)
    got = _replay_igemm(xq, wk, (*stride, pads[0][0], pads[1][0],
                                 pads[2][0], To, Ho, Wo))
    xp = torch.nn.functional.pad(codes, (pads[2][0], pads[2][1], pads[1][0],
                                         pads[1][1], pads[0][0], pads[0][1]))
    want = torch.nn.functional.conv3d(xp.double(), w.double(),
                                      stride=stride).long().numpy()
    np.testing.assert_array_equal(got, want)
