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


def _tap_mask(ti0, hi0, wi0, dims, kernel):
    """``tap_mask`` of the source: bit (dt * kh + dh) * kw + dw set where
    the tap reads inside the input."""
    (Ti, Hi, Wi), (kt, kh, kw) = dims, kernel
    mask = np.zeros(np.shape(ti0), np.int64)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                ok = ((0 <= ti0 + dt) & (ti0 + dt < Ti) & (0 <= hi0 + dh)
                      & (hi0 + dh < Hi) & (0 <= wi0 + dw) & (wi0 + dw < Wi))
                mask |= ok.astype(np.int64) << ((dt * kh + dh) * kw + dw)
    return mask


def _sw128(row, chunk):
    """Byte offset of 16-byte chunk ``chunk`` of row ``row`` of a 128-byte
    swizzled tile that starts on a 1024-byte boundary (TMA's and wgmma's
    CU_TENSOR_MAP_SWIZZLE_128B)."""
    return row * 128 + ((chunk ^ (row % 8)) << 4)


def _replay_igemm(xq, wk, g, sms):
    """The int32 sums of ``igemm_kernel`` as its threads compute them, on
    ``sms`` SMs. The plan (``igemm_plan``: tile width, tiles with N
    fastest, K splits); per block and split, the producer's threads (chunk
    c = t % 8 of rows t / 8 + 16 i) keep each row's first input position
    and tap mask and advance their chunk's tap and channel by counters,
    gathering 16 bytes a row into the swizzled A stage (zeros outside the
    input or past K); B arrives as TMA's box of 128 bytes x block_n rows
    at (k0, n0), zero past Cout and K, swizzled; each consumer warpgroup
    reads its 64 rows and the B tile as the k32 descriptors address them
    and accumulates; the accumulator's registers (m64nN: row 16 warp +
    lane / 4 (+ 8), column 8 j + 2 (lane % 4) (+ 1) in acc[4 j + e]) go to
    the staged [block_n][128 + pad] tile (each warp's stores on 32
    distinct banks) or, split, are added into the workspace, whose last
    split runs the stores; the stores write channel rows, 4 positions a
    lane, 16-byte aligned where the vector path is taken. Returns [B,
    Cout, To, Ho, Wo] int64, every element written once."""
    src = SRC.read_text()
    BM, SK, CH, WG = (_constant(n) for n in ("kBM", "kStageK", "kChunk",
                                              "kWG"))
    assert (BM, SK) == (K14.BLOCK_M, K14.STAGE_K)
    assert _constant("kMinSplitStages") == K14.MIN_SPLIT_STAGES
    assert _constant("kChannelGranule") == K14.CHANNEL_GRANULE
    stride_w = BM + int(re.search(r"constexpr int kStgStride = kBM \+ (\d+);",
                                  src).group(1))
    rows_per = BM * (SK // CH) // WG
    B, Ti, Hi, Wi, Cp = xq.shape
    (Cout, kt, kh, kw, _), (st, sh, sw, pt, ph, pw, To, Ho, Wo) = \
        wk.shape, g
    P, taps = To * Ho * Wo, kt * kh * kw
    M, K = B * P, taps * Cp
    assert taps <= _constant("kMaxTaps")
    plan = K14.igemm_plan(M, Cout, K, sms)
    BN, split, nk = plan["block_n"], plan["split"], plan["stages"]
    assert re.search(rf"mma_ss_s8<{BN}>", (SRC.parent / "sm90_common.cuh")
                     .read_text())
    n_tiles = -(-Cout // BN)
    assert nk == -(-K // SK) and plan["tiles"] == -(-M // BM) * n_tiles
    w2, xflat = wk.reshape(Cout, K), xq.reshape(-1)
    out = np.zeros(B * Cout * P, np.int64)
    written = np.zeros(B * Cout * P, np.int64)
    ws = np.zeros(plan["workspace"], np.int64)
    t = np.arange(WG)
    c, r0 = t & 7, t >> 3
    rows = r0[:, None] + 16 * np.arange(rows_per)           # [WG, 8]
    lane = np.arange(32)
    # the A gather's destination: the kernel's a_dst0 + 2048 i
    dst = _sw128(rows, c[:, None])
    assert np.array_equal(dst, (r0 * SK + ((c ^ (r0 & 7)) << 4))[:, None]
                          + 2048 * np.arange(rows_per))
    # B's box through TMA's swizzle, and both operands as the descriptors
    # read them (chunk (32 kk + byte) / 16 of row r at _sw128)
    b_rows, b_cols = np.meshgrid(np.arange(BN), np.arange(SK), indexing="ij")
    b_phys = _sw128(b_rows, b_cols // 16) + b_cols % 16

    def operand(buf, base, nrows, kk):
        r, byte = np.meshgrid(np.arange(nrows), 32 * kk + np.arange(32),
                              indexing="ij")
        return buf[base + _sw128(r, byte // 16) + byte % 16]

    def stores(tile_src, stride, m0, n0):
        for cwarp in range(8):
            m = m0 + 4 * lane
            for ln in range(32):
                me = m[ln] + np.arange(4)
                b = me // P
                base = np.where(me < M, b * Cout * P + me - b * P, -1)
                v = P % 4 == 0 and me[3] < M
                for nl in range(cwarp, BN, 8):
                    n = n0 + nl
                    if n >= Cout:
                        break
                    a = tile_src[nl * stride + 4 * ln:nl * stride + 4 * ln + 4]
                    if v:
                        assert (base[0] + n * P) % 4 == 0
                        idx = base[0] + n * P + np.arange(4)
                    else:
                        idx = (base + n * P)[base >= 0]
                        a = a[base >= 0]
                    out[idx] = a
                    written[idx] += 1

    for tile in range(plan["tiles"]):
        m0, n0 = (tile // n_tiles) * BM, (tile % n_tiles) * BN
        arrived = 0
        for z in range(split):
            ks0, ks1 = z * nk // split, (z + 1) * nk // split
            assert split == 1 or ks1 - ks0 >= K14.MIN_SPLIT_STAGES
            m = m0 + rows
            ok_m = m < M
            mm = np.minimum(m, M - 1)
            b, r = np.divmod(mm, P)
            to, r = np.divmod(r, Ho * Wo)
            ho, wo = np.divmod(r, Wo)
            ti0, hi0, wi0 = to * st - pt, ho * sh - ph, wo * sw - pw
            rowpos = np.where(ok_m, b * Ti * Hi * Wi + (ti0 * Hi + hi0) * Wi
                              + wi0, 0)
            rowmask = np.where(ok_m, _tap_mask(ti0, hi0, wi0, (Ti, Hi, Wi),
                                               (kt, kh, kw)), 0)
            k_first = ks0 * SK + CH * c
            tap, ch = np.divmod(k_first, Cp)
            dt = tap // (kh * kw)
            dh = (tap - dt * kh * kw) // kw
            dw = tap - (dt * kh + dh) * kw
            acc = np.zeros((2, 64, BN), np.int64)
            for it in range(ks1 - ks0):
                assert np.array_equal(tap * Cp + ch,
                                      (ks0 + it) * SK + CH * c)
                A = np.zeros(BM * SK, np.int64)
                tappos = (dt * Hi + dh) * Wi + dw
                for i in range(rows_per):
                    ok = (tap < taps) & (((rowmask[:, i] >> (tap & 31)) & 1)
                                         == 1)
                    s0 = (rowpos[ok, i] + tappos[ok]) * Cp + ch[ok]
                    A[dst[ok, i][:, None] + np.arange(16)] = \
                        xflat[s0[:, None] + np.arange(16)]
                ch = ch + SK
                while (wrap := ch >= Cp).any():
                    ch = np.where(wrap, ch - Cp, ch)
                    tap = tap + wrap
                    dw = dw + wrap
                    carry = wrap & (dw == kw)
                    dw = np.where(carry, 0, dw)
                    dh = dh + carry
                    carry = carry & (dh == kh)
                    dh = np.where(carry, 0, dh)
                    dt = dt + carry
                k0 = (ks0 + it) * SK
                box = np.zeros((BN, SK), np.int64)
                part = w2[n0:n0 + BN, k0:k0 + SK]
                box[:part.shape[0], :part.shape[1]] = part
                Bt = np.zeros(BN * SK, np.int64)
                Bt[b_phys] = box
                for w in range(2):
                    for kk in range(SK // 32):
                        acc[w] += operand(A, w * 64 * SK, 64, kk) @ \
                            operand(Bt, 0, BN, kk).T
            # the accumulator registers, then the stage or the workspace
            stg = np.zeros(BN * stride_w, np.int64)
            for w in range(2):
                for warp in range(4):
                    mrow = 64 * w + 16 * warp + lane // 4
                    for j in range(BN // 8):
                        for e in range(4):
                            col = 8 * j + 2 * (lane % 4) + (e & 1)
                            row = mrow + 8 * (e >> 1)
                            val = acc[w][row - 64 * w, col]
                            if split == 1:
                                addr = col * stride_w + row
                                assert len(set(addr % 32)) == 32
                                stg[addr] = val
                            else:
                                ws[tile * BN * BM + col * BM + row] += val
            if split == 1:
                stores(stg, stride_w, m0, n0)
            else:
                ws[plan["tiles"] * BN * BM + tile] += 1
                arrived += 1
        if split > 1:
            assert ws[plan["tiles"] * BN * BM + tile] == arrived == split
            stores(ws[tile * BN * BM:(tile + 1) * BN * BM], BM, m0, n0)
    assert (written == 1).all()
    return out.reshape(B, Cout, To, Ho, Wo)


def _ring(block_n):
    """(stages, lag) of ``igemm_kernel<block_n>``'s ring, from the source:
    its depth and how many stages the producer's arrivals trail its
    copies."""
    src = SRC.read_text()
    deep, shallow = map(int, re.search(
        r"kStages = BN == 256 \? (\d+) : (\d+);", src).groups())
    stages = deep if block_n == 256 else shallow
    return stages, stages - int(re.search(r"constexpr int L = S - (\d+);",
                                          src).group(1))


def _replay_ring(n_it, stages, lag):
    """The mbarrier protocol of one block over ``n_it`` stages, stepped
    until nothing can move: the producer waits for a slot's empty barrier
    (the 8 consumer warps of the stage that held it), issues TMA's bytes
    (one arrival) and its copies, and its 4 warps arrive for the stage
    ``lag`` back once those copies landed (then for the last ``lag`` after
    the loop); each consumer warpgroup waits for a stage's full barrier (5
    arrivals), issues its products and, once the previous stage's are done
    (wait_group 1), frees that one. Returns (producer stages, drained,
    consumer stages)."""
    full, empty = [0] * n_it, [0] * n_it
    p_it, drained, c_it = 0, False, [0, 0]
    moved = True
    while moved:
        moved = False
        if p_it < n_it and (p_it < stages or empty[p_it - stages] == 8):
            full[p_it] += 1
            if p_it >= lag:
                full[p_it - lag] += 4
            p_it, moved = p_it + 1, True
        elif p_it == n_it and not drained:
            for j in range(max(0, n_it - lag), n_it):
                full[j] += 4
            drained = moved = True
        for w in range(2):
            it = c_it[w]
            if it < n_it and full[it] == 5:
                if it > 0:
                    empty[it - 1] += 4
                c_it[w], moved = it + 1, True
    return p_it, drained, c_it


@pytest.mark.parametrize("block_n", [256, 160])
@pytest.mark.parametrize("n_it", [1, 2, 4, 5, 13, 216])
def test_igemm_ring_never_stalls(block_n, n_it):
    """K14's full / empty barrier protocol runs every stage of a block (a
    small conv's 1-5 stages, a split's 13-16, a whole K's 216) without a
    stall, and a slot is refilled only after both consumers freed it: with
    the producer's arrivals one stage later (stages - 1 behind) it
    stalls."""
    stages, lag = _ring(block_n)
    assert 0 <= lag < stages
    assert _replay_ring(n_it, stages, lag) == (n_it, True, [n_it, n_it])
    if n_it > stages:
        assert _replay_ring(n_it, stages, stages - 1)[0] < n_it


@pytest.mark.parametrize("case", [
    # x [B, C, T, H, W], kernel, stride, ((front, back), (top, bottom),
    # (left, right)), Cout, SMs: causal 3x3x3 over a ragged 40 channels
    # (Cp = 64: a 128-byte stage spans two taps); a stride-2 2D window with
    # its far zero pad read by bounds; a stride-2 time conv over two
    # batches; the encoder's Cp = 160 / Cout = 160 (a stage spans two taps,
    # the 160-wide tile, two M tiles, the last ragged); a small M (96, the
    # hybrid decode's first tiles) whose K (54 stages) is split three ways
    # on 132 SMs, two 256-wide N tiles
    ((1, 40, 3, 5, 4), (3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
     10, 1),
    ((2, 8, 1, 7, 6), (1, 3, 3), (1, 2, 2), ((0, 0), (0, 1), (0, 1)),
     10, 1),
    ((2, 16, 7, 3, 3), (3, 1, 1), (2, 1, 1), ((0, 0), (0, 0), (0, 0)),
     10, 1),
    ((1, 160, 3, 7, 13), (3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
     160, 1),
    ((1, 256, 1, 6, 16), (3, 3, 3), (1, 1, 1), ((2, 0), (1, 1), (1, 1)),
     512, 132),
])
def test_igemm_index_map_replays_the_plain_conv(case):
    """A numpy replay of K14's plan, gathers, swizzle, TMA box, wgmma
    operand and accumulator maps, split-K partials and staged epilogue
    gives the plain version's int32 sums exactly (this pins the source's
    index arithmetic, not the compiled kernel: only the card runs that)."""
    shape, k, stride, pads, cout, sms = case
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
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
                                 pads[2][0], To, Ho, Wo), sms)
    xp = torch.nn.functional.pad(codes, (pads[2][0], pads[2][1], pads[1][0],
                                         pads[1][1], pads[0][0], pads[0][1]))
    want = torch.nn.functional.conv3d(xp.double(), w.double(),
                                      stride=stride).long().numpy()
    np.testing.assert_array_equal(got, want)
