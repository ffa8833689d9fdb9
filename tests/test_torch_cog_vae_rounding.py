"""The CogVideoX VAE in bf16 against JAX's rounding rule.

JAX runs the serving pipeline's condition encodes and its decode under
``conv_accum_dtype(vae dtype)``, and the Cog trainer's encodes under
``conv_accum_dtype(encode dtype)``: each conv rounds its product to bf16
and then adds the bias in bf16, the GroupNorm normalizes in fp32 and
rounds once, SiLU rounds each step. The port enters ``ops/conv.conv_dtype``
at the same places. A tiny VAE with bf16 weights on both sides; JAX's
functions jitted with ``xla_allow_excess_precision`` off, so that XLA
rounds where the program says.

The encoder's logvar bias is driven to -100: after the -30 clip the
posterior std is 3e-7, so the two sides' different noise is lost in the
rounding.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_vae as jvae
from frameino_tpu.models import cogvideox_vae_streaming as jvs
from frameino_tpu.models import weights as jweights
from frameino_tpu.ops.conv import conv_accum_dtype
from frameino_tpu.pipelines import cogvideox_i2v as jpipe
from frameino_tpu.training import cog_trainer as jcog
from frameino_tpu_torch.models import cogvideox_vae as tvae
from frameino_tpu_torch.models import cogvideox_vae_streaming as tvs
from frameino_tpu_torch.pipelines import cogvideox_i2v as tpipe
from frameino_tpu_torch.training import cog_trainer as tcog

H = W = 16
FRAMES = 9
NO_EXCESS = {"xla_allow_excess_precision": False}

# Relative L2 from JAX's latents and frames (the numbers are in
# CHANGES.md). The parent commit, one fused rounding a conv and no scope,
# reads 1.4e-2 .. 3.1e-2 on every output. With JAX's rule the single-frame
# encodes and the decode repeat JAX's roundings one for one (0 here); the
# 9-frame encodes read 9.1e-3 (condition) and 1.6e-2 (trainer): the
# GroupNorm's fp32 statistics over 9 frames are sums in another order than
# XLA's (a few ulp of the variance), a bf16 rounding of the normalized
# value flips here and there, and the flips carry into the layers after.
BF16_FRAME_REL_L2 = 1e-3
BF16_CLIP_REL_L2 = 2e-2
FP32_REL_L2 = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def vaes():
    """(JAX config, JAX params, port VAE) per dtype, with the same values:
    the fp32 init rounded to bf16 once."""
    cfg, jcfg = tvae.tiny_vae_config(), jvae.tiny_vae_config()
    m = tvae.init_cogvideox_vae(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        m.encoder.conv_out.conv.bias[cfg.latent_channels:] = -100.0
        for p in m.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    params = jweights.cogvideox_vae_from_state_dict(sd, jcfg)
    out = {}
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        out[tdt] = (jcfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), params),
                    copy.deepcopy(m).to(tdt))
    return out


def _inputs(seed=0):
    rs = np.random.RandomState(seed)

    def a(*shape):
        return np.tanh(rs.randn(*shape)).astype(np.float32)
    return a(1, 3, H, W), a(1, 3, FRAMES, H, W), a(1, 3, H, W)


def _conditions(vaes, tdt, jdt):
    jcfg, params, vae = vaes[tdt]
    image, traj, idf = _inputs()
    F = (FRAMES - 1) // 4 + 1
    fn = jax.jit(functools.partial(jpipe.prepare_conditions, jcfg),
                 static_argnums=(4,), compiler_options=NO_EXCESS)
    want = fn(params, jnp.asarray(image), jnp.asarray(traj),
              jnp.asarray(idf), F, jax.random.key(0))
    got = tpipe.prepare_conditions(vae, torch.from_numpy(image),
                                   torch.from_numpy(traj),
                                   torch.from_numpy(idf), F,
                                   torch.Generator().manual_seed(0))
    return ([g.float().numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


def _decode(vaes, tdt, jdt):
    """JAX's ``__call__`` decode lines against the port pipeline's. JAX's
    tiled streaming walk fetches each chunk to the host, so it does not
    jit; at 3 latent frames on a 16-pixel canvas it is one chunk of one
    tile, which is ``_decoder_chunk`` with an empty conv cache."""
    jcfg, params, vae = vaes[tdt]
    lat = np.random.RandomState(1).randn(1, 3, 4, H // 4, W // 4
                                         ).astype(np.float32)

    def jdecode(params, latents):
        z = (latents.transpose(0, 2, 1, 3, 4)
             / jcfg.scaling_factor).astype(jdt)
        with conv_accum_dtype(jdt):
            video = jvs._decoder_chunk(
                jcfg, params["decoder"], jvae._to_cl(z),
                [None] * jvs._MAX_CACHE, [0])
        video = jvae._to_cf(video)
        return jnp.clip(video.astype(jnp.float32), -1.0, 1.0)

    want = jax.jit(jdecode, compiler_options=NO_EXCESS)(params,
                                                         jnp.asarray(lat))
    got = tpipe.decode_latents(vae, torch.from_numpy(lat))
    return got.float().numpy(), np.asarray(want)


def _train_encode(vaes, tdt, jdt):
    jcfg, params, vae = vaes[tdt]
    image, traj, idf = _inputs(2)
    video = np.tanh(np.random.RandomState(4).randn(1, 3, FRAMES, H, W)
                    ).astype(np.float32)
    batch = {"video_tensor": video.transpose(0, 2, 1, 3, 4),
             "traj_tensor": traj.transpose(0, 2, 1, 3, 4),
             "first_frame_tensor": image, "ID_tensor": idf}
    jcfg_t = jcog.CogTrainerConfig(compute_dtype=jdt, augment_noise=False)

    def jenc(params, batch, key):
        with conv_accum_dtype(jdt):
            return jcog.encode_training_batch(jcfg_t, jcfg, params, batch,
                                              key)

    want = jax.jit(jenc, compiler_options=NO_EXCESS)(
        params, {k: jnp.asarray(v, jdt) for k, v in batch.items()},
        jax.random.key(0))
    tcfg = tcog.CogTrainerConfig(compute_dtype=tdt, augment_noise=False)
    got = tcog.encode_training_batch(
        tcfg, vae, {k: torch.from_numpy(v) for k, v in batch.items()},
        tcog.CogDraws(torch.Generator().manual_seed(0)))
    return ([g.float().numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


def test_bf16_conditions_follow_jax_rounding(vaes):
    got, want = _conditions(vaes, torch.bfloat16, jnp.bfloat16)
    for name, g, w in zip(("image", "traj", "id"), got, want):
        assert g.shape == w.shape, name
        limit = BF16_CLIP_REL_L2 if name == "traj" else BF16_FRAME_REL_L2
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w))


def test_bf16_decode_follows_jax_rounding(vaes):
    got, want = _decode(vaes, torch.bfloat16, jnp.bfloat16)
    assert got.shape == want.shape == (1, 3, FRAMES, H, W)
    assert _rel_l2(got, want) <= BF16_FRAME_REL_L2, _rel_l2(got, want)


def test_bf16_trainer_encode_follows_jax_rounding(vaes):
    got, want = _train_encode(vaes, torch.bfloat16, jnp.bfloat16)
    for name, g, w in zip(("video", "first_frame", "traj", "id"), got, want):
        assert g.shape == w.shape, name
        limit = (BF16_CLIP_REL_L2 if name in ("video", "traj")
                 else BF16_FRAME_REL_L2)
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w))


@pytest.mark.parametrize("what", ["conditions", "decode", "train_encode"])
def test_fp32_is_unchanged(vaes, what):
    """fp32 on both sides: the scope changes nothing (1e-5)."""
    fn = {"conditions": _conditions, "decode": _decode,
          "train_encode": _train_encode}[what]
    got, want = fn(vaes, torch.float32, jnp.float32)
    if what == "decode":
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= FP32_REL_L2


def test_fp32_takes_no_scope(vaes):
    """An fp32 VAE runs the unscoped rule (each conv's bias fused), so its
    conditions and decode are bit-equal to the bare walks."""
    _, _, vae = vaes[torch.float32]
    image, traj, _ = _inputs()
    sf = vae.cfg.scaling_factor
    got = tpipe.prepare_conditions(vae, torch.from_numpy(image),
                                   torch.from_numpy(traj), None, 3,
                                   torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    want_img = tvs.streaming_encode(vae, torch.from_numpy(image)[:, :, None],
                                    gen) * sf
    want_traj = tvs.streaming_encode(vae, torch.from_numpy(traj), gen) * sf
    assert torch.equal(got[0][:, :1], want_img.permute(0, 2, 1, 3, 4))
    assert torch.equal(got[1], want_traj.permute(0, 2, 1, 3, 4))
    lat = torch.randn(1, 3, 4, H // 4, W // 4, generator=gen)
    want = tvs.tiled_streaming_decode(
        vae, lat.permute(0, 2, 1, 3, 4) / sf).float().clamp(-1.0, 1.0)
    assert torch.equal(tpipe.decode_latents(vae, lat), want)
