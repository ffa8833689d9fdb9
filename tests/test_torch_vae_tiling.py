"""The port's streaming, tiled and hybrid Wan VAE (``models/
wan_vae_streaming.py``, ``models/wan_vae_tiling.py``) against its own
full-sequence forms and against the JAX package's ``wan_vae_tiling``; the
pipeline's trajectory encode and the server's decode default against
JAX's (CPU, tiny configs, fp32 on both sides).

The weights are a seeded torch VAE, read into a JAX tree by the JAX
package's own diffusers loader; inputs are made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import wan_vae_tiling as jtile
from frameino_tpu.models import weights as jweights
from frameino_tpu.pipelines import wan_i2v as jpipe
from frameino_tpu_torch import serve
from frameino_tpu_torch.app.server import PipelineServer
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models import wan_vae_streaming as S
from frameino_tpu_torch.models import wan_vae_tiling as T
from frameino_tpu_torch.pipelines import wan_i2v as tpipe

# the tiny configs of tests/test_vae_streaming.py: Wan2.1-like (plain
# blocks, 2x) and Wan2.2-like (residual blocks, patchified, 8x)
CFG_KW = {
    "wan21": dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                  temperal_downsample=(True,), is_residual=False,
                  scale_factor_temporal=2, scale_factor_spatial=2,
                  latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4),
    "wan22": dict(base_dim=8, decoder_base_dim=12, z_dim=4,
                  dim_mult=(1, 2, 2), num_res_blocks=1,
                  temperal_downsample=(True, True), is_residual=True,
                  in_channels=12, out_channels=12, patch_size=2,
                  latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4),
}
# latents of 5 frames for each config's decode
Z_SHAPE = {"wan21": (1, 4, 5, 4, 4), "wan22": (1, 4, 5, 2, 2)}

# streaming against the full forms: the same convs on the same frames, the
# causal padding taken from the cache (1e-4, JAX's own limit)
STREAM_TOL = 1e-4
# hybrid against tiled: the in-tile streaming alone (1e-5, JAX's limit)
HYBRID_TOL = 1e-5
# the port against JAX: fp32 convs, reordered sums (the port's VAE parity
# limit, tests/test_torch_models.py)
JAX_TOL = 1e-4


def _vae(name, seed=0):
    return tvae.init_wan_vae(tvae.WanVAEConfig(**CFG_KW[name]),
                             torch.Generator().manual_seed(seed))


def _jax_params(model, name):
    return jweights.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        jvae.WanVAEConfig(**CFG_KW[name]))


def _video(seed, shape):
    return np.tanh(np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.fixture(scope="module", params=sorted(CFG_KW))
def vae(request):
    return request.param, _vae(request.param)


# ---------------------------------------------------------------------------
# streaming == full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streaming_decode_matches_full(vae, chunk):
    name, model = vae
    z = torch.from_numpy(np.random.RandomState(1).randn(*Z_SHAPE[name])
                         .astype(np.float32))
    full = model.decode(z)
    got = S.streaming_decode(model, z, chunk_latent_frames=chunk)
    assert got.shape == full.shape
    torch.testing.assert_close(got, full, atol=STREAM_TOL, rtol=STREAM_TOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_streaming_encode_matches_full(vae, chunk):
    _, model = vae
    video = torch.from_numpy(_video(3, (1, 3, 9, 16, 16)))
    full = model.encode_moments(video)
    got = S.streaming_encode_moments(model, video, chunk_pixel_frames=chunk)
    assert got.shape == full.shape
    torch.testing.assert_close(got, full, atol=STREAM_TOL, rtol=STREAM_TOL)


def test_inline_encode_matches_full_and_carries_gradients(vae):
    """``encode_moments_inline`` leaves autograd on: the chunked encode
    equals the full one and its gradient reaches the input."""
    _, model = vae
    video = torch.from_numpy(_video(5, (1, 3, 9, 16, 16)))
    full = model.encode_moments(video)
    v = video.clone().requires_grad_(True)
    got = S.encode_moments_inline(model, v, chunk_pixel_frames=4)
    torch.testing.assert_close(got.detach(), full, atol=STREAM_TOL,
                               rtol=STREAM_TOL)
    got.square().sum().backward()
    assert v.grad is not None and v.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="multiple of 4"):
        S.encode_moments_inline(model, video, chunk_pixel_frames=6)


def _seeded_from_frames(rs, x, caches):
    """upsample3d's first chunk with its cache seeded from the chunk's own
    last frames instead of two zero frames (a planted fault)."""
    if caches.get() is None:
        caches.put(torch.cat([x[:, :, -1:]] * S.CACHE_T, dim=2))
        return rs._spatial(x)
    return _orig_up3d(rs, x, caches)


_orig_up3d = S._up3d_chunk


def test_streaming_decode_rejects_a_cache_seeded_from_frames(monkeypatch):
    """The zero frames of a fresh upsample3d cache matter: seeded from the
    first chunk's frames, the decode leaves the limit."""
    model = _vae("wan21")
    z = torch.from_numpy(np.random.RandomState(1).randn(*Z_SHAPE["wan21"])
                         .astype(np.float32))
    full = model.decode(z)
    monkeypatch.setattr(S, "_up3d_chunk", _seeded_from_frames)
    bad = S.streaming_decode(model, z, chunk_latent_frames=2)
    assert (bad - full).abs().max() > 10 * STREAM_TOL


# ---------------------------------------------------------------------------
# tiled and hybrid against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,tile,stride", [
    (32, 16, 12), (48, 16, 12), (16, 16, 12), (17, 16, 12), (704, 256, 192),
    (1280, 256, 192), (44, 16, 12), (80, 16, 12), (8, 16, 12)])
def test_positions_match_jax(total, tile, stride):
    assert T._positions(total, tile, stride) \
        == jtile._positions(total, tile, stride)


@pytest.fixture(scope="module")
def tiny_pair():
    model = _vae("wan21")
    return model, _jax_params(model, "wan21"), jvae.WanVAEConfig(
        **CFG_KW["wan21"])


TILE_KW = dict(tile_min=16, tile_stride=12)


def _latents():
    return np.random.RandomState(3).randn(1, 4, 5, 16, 24).astype(np.float32)


def test_tiled_decode_matches_jax(tiny_pair):
    """At tile_min=16, tile_stride=12 (latent tiles of 8 at a stride of 6,
    3 x 4 tiles); the seams are blended, so tiled is not the full
    decode."""
    model, params, jcfg = tiny_pair
    z = _latents()
    # JAX's per-tile decode jitted (4 tile shapes), as its hybrid's chunks
    # are: eager dispatch of every op of 12 tiles takes most of a minute
    # on a loaded host
    decode = jax.jit(lambda t: jvae.decode(jcfg, params, t, clamp=False))
    ref = np.asarray(jtile.tiled_decode(jcfg, params, jnp.asarray(z),
                                        decode_fn=decode, **TILE_KW))
    tiled = T.tiled_decode(model, torch.from_numpy(z), **TILE_KW)
    assert tiled.shape == ref.shape == (1, 3, 9, 32, 48)
    np.testing.assert_allclose(tiled.numpy(), ref, atol=JAX_TOL, rtol=JAX_TOL)
    full = model.decode(torch.from_numpy(z))
    assert (tiled - full).abs().max() > 1e-3


def test_hybrid_decode_matches_jax_and_tiled(tiny_pair):
    model, params, jcfg = tiny_pair
    z = _latents()
    hybrid = T.hybrid_decode(model, torch.from_numpy(z),
                             chunk_latent_frames=2, **TILE_KW)
    tiled = T.tiled_decode(model, torch.from_numpy(z), **TILE_KW)
    torch.testing.assert_close(hybrid, tiled, atol=HYBRID_TOL,
                               rtol=HYBRID_TOL)
    ref = np.asarray(jtile.hybrid_decode(jcfg, params, jnp.asarray(z),
                                         chunk_latent_frames=2, **TILE_KW))
    np.testing.assert_allclose(hybrid.numpy(), ref, atol=JAX_TOL,
                               rtol=JAX_TOL)


def test_tiled_encode_matches_jax(tiny_pair):
    model, params, jcfg = tiny_pair
    video = _video(4, (1, 3, 5, 32, 48))
    encode = jax.jit(lambda t: jvae.encode_moments(jcfg, params, t))
    ref = np.asarray(jtile.tiled_encode(jcfg, params, jnp.asarray(video),
                                        encode_fn=encode, **TILE_KW))
    tiled = T.tiled_encode(model, torch.from_numpy(video), **TILE_KW)
    assert tiled.shape == ref.shape == (1, 8, 3, 16, 24)
    np.testing.assert_allclose(tiled.numpy(), ref, atol=JAX_TOL, rtol=JAX_TOL)


def test_hybrid_encode_matches_jax_and_tiled(tiny_pair):
    model, params, jcfg = tiny_pair
    video = _video(4, (1, 3, 5, 32, 48))
    hybrid = T.hybrid_encode(model, torch.from_numpy(video),
                             chunk_pixel_frames=4, **TILE_KW)
    tiled = T.tiled_encode(model, torch.from_numpy(video), **TILE_KW)
    torch.testing.assert_close(hybrid, tiled, atol=HYBRID_TOL,
                               rtol=HYBRID_TOL)
    ref = np.asarray(jtile.hybrid_encode(jcfg, params, jnp.asarray(video),
                                         chunk_pixel_frames=4, **TILE_KW))
    np.testing.assert_allclose(hybrid.numpy(), ref, atol=JAX_TOL,
                               rtol=JAX_TOL)


def test_small_inputs_and_slices_bypass_tiling(tiny_pair):
    """Inputs within one tile take the plain forms; slicing splits the
    batch."""
    model, _, _ = tiny_pair
    video = torch.from_numpy(_video(6, (2, 3, 5, 16, 16)))
    full = model.encode_moments(video)
    torch.testing.assert_close(T.tiled_encode(model, video), full,
                               atol=0, rtol=0)
    torch.testing.assert_close(T.sliced_encode(model, video), full,
                               atol=1e-5, rtol=1e-5)
    z = full[:, :4]
    torch.testing.assert_close(T.sliced_decode(model, z), model.decode(z),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the pipeline's trajectory encode and the server's decode default
# ---------------------------------------------------------------------------

# the trajectory rule's smallest tiled clip: more than 9 frames, 256 px
# high, and 2 px past one tile wide (2 tiles); a VAE of base width 4
TRAJ_KW = dict(CFG_KW["wan21"], base_dim=4)


@pytest.fixture(scope="module")
def traj_case():
    """JAX's ``prepare_conditions`` on a trajectory that the rule tiles,
    and the torch VAE of the same weights."""
    model = tvae.init_wan_vae(tvae.WanVAEConfig(**TRAJ_KW),
                              torch.Generator().manual_seed(7))
    jcfg = jvae.WanVAEConfig(**TRAJ_KW)
    params = jweights.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    image = _video(8, (1, 3, 16, 16))
    traj = _video(9, (1, 3, 10, 256, 258))
    ref = jpipe.prepare_conditions(jcfg, params, jnp.asarray(image),
                                   jnp.asarray(traj), None)
    return model, image, traj, [np.asarray(r) for r in ref[:2]]


def test_prepare_conditions_tiles_the_trajectory_as_jax(traj_case):
    """A trajectory of more than 9 frames at >= 256 x 256 takes the hybrid
    encode (tiles of 256 px at a stride of 192, 16 frames a chunk) on both
    sides."""
    model, image, traj, ref = traj_case
    got = tpipe.prepare_conditions(model, torch.from_numpy(image),
                                   torch.from_numpy(traj), None)
    for r, g in zip(ref, got[:2]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=JAX_TOL, rtol=JAX_TOL)


def test_full_sequence_trajectory_encode_is_not_jax(traj_case):
    """The full-sequence encode, which the port took for every trajectory
    before, is off JAX's tiled latents at the seams (4.9e-3 relative L2
    here), far past the parity limit."""
    model, _, traj, ref = traj_case
    full = tvae.normalize_latents(model.cfg, model.encode(
        torch.from_numpy(traj))).numpy()
    rel = np.linalg.norm(full - ref[1]) / np.linalg.norm(ref[1])
    assert rel > 1e-3
    assert np.abs(full - ref[1]).max() > 100 * JAX_TOL


class _Recorder:
    """Stands in for a pipeline's ``__call__`` and records its kwargs."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, *a, **kw):
        self.calls.append(kw)
        return self.pipe(*a, **kw)


@pytest.mark.parametrize("extra,want", [({}, "hybrid"),
                                        ({"decode_mode": "full"}, "full"),
                                        ({"decode_mode": "streaming"},
                                         "streaming")])
def test_server_decodes_wan_hybrid_by_default(extra, want):
    """A Wan request without decode_mode decodes "hybrid", as JAX's server
    asks (frameino_tpu/app/server.py:161); a named mode is passed on."""
    import base64
    import io
    from PIL import Image
    pipe = _Recorder(serve.build_pipeline(smoke=True))
    srv = PipelineServer(pipe)
    buf, emb = io.BytesIO(), io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "PNG")
    np.save(emb, np.zeros((8, 16), np.float32))
    out = srv.handle_generate({
        "image_b64": base64.b64encode(buf.getvalue()).decode(),
        "prompt_embeds_b64": base64.b64encode(emb.getvalue()).decode(),
        "num_frames": 5, "num_inference_steps": 1,
        "trajectories": [[[2, 2], [10, 12]]], **extra})
    assert out["num_frames"] == 5
    assert pipe.calls[0]["decode_mode"] == want


@pytest.mark.parametrize("mode", tpipe.DECODE_MODES)
def test_pipeline_decode_modes(mode):
    """Every decode mode of the pipeline serves a clip; within one tile
    (64 x 64 px) each equals the full decode."""
    pipe = serve.build_pipeline(smoke=True)
    rs = np.random.RandomState(2)
    args = dict(prompt_embeds=torch.from_numpy(
                    rs.randn(1, 8, 16).astype(np.float32)),
                traj_tensor=torch.from_numpy(_video(3, (1, 3, 9, 64, 64))),
                height=64, width=64, num_frames=9, num_inference_steps=1)
    image = torch.from_numpy(_video(1, (1, 3, 64, 64)))
    got = pipe(image, decode_mode=mode, **args)
    want = pipe(image, decode_mode="full", **args)
    assert got.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(got, want, atol=STREAM_TOL, rtol=STREAM_TOL)
    assert set(pipe.timings) == {"text_encode_s", "vae_encode_s",
                                 "denoise_s", "decode_s"}
