"""The Wan trainer's frozen-VAE encode against JAX's rule: every clip of
more than one frame through the chunked encode, and the convolutions in
the encode dtype (``conv_accum_dtype`` in JAX, ``ops/conv.conv_dtype`` in
the port). The tiny VAE of tests/test_training.py, a 9-frame clip.

JAX's side is its ``encode_training_batch`` jitted with
``xla_allow_excess_precision`` off, so that XLA rounds every bf16
operation where the program rounds it (with the flag on, XLA may keep a
fused chain in fp32, and which chains it fuses is its own choice).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.ops.conv import conv_accum_dtype
from frameino_tpu.training import trainer as jtrainer
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import wan_vae_from_jax
from frameino_tpu_torch.training import trainer as ttrainer

VAE_KW = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              temperal_downsample=(True,), is_residual=False, patch_size=None,
              scale_factor_temporal=2, scale_factor_spatial=2,
              latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
NAMES = ("video", "first_frame", "traj", "id")

# bf16: the single-frame encodes (first frame, ID) repeat JAX's roundings
# one for one (relative L2 0 here); the 9-frame encodes differ where an
# fp32 sum of a 3-tap causal conv lands on the other side of a bf16
# rounding boundary, and the flip carries into later frames: 4.8e-3 and
# 1.0e-3 relative L2 here. The fp32 full-sequence encode of the parent
# commit reads 5.9e-3 / 5.5e-3 (single frames) and 9.7e-3 / 9.1e-3 (clips)
# from the same JAX latents, outside both limits (the test holds it so).
BF16_SINGLE_REL_L2 = 1e-3
BF16_CLIP_REL_L2 = 6e-3


def _batch(seed=0, B=1, F=9, H=32, W=32):
    rs = np.random.RandomState(seed)

    def a(*shape):
        return np.tanh(rs.randn(*shape)).astype(np.float32)
    return {"video_tensor": a(B, F, 3, H, W),
            "first_frame_tensor": a(B, 3, H, W),
            "traj_tensor": a(B, F, 3, H, W),
            "ID_tensor": a(B, 1, 3, H, W)}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jvae.WanVAEConfig(**VAE_KW), tvae.WanVAEConfig(**VAE_KW)
    params = jvae.init_wan_vae(jax.random.key(0), jcfg)
    vae = tvae.WanVAE(tcfg, device="meta")
    vae.load_state_dict(wan_vae_from_jax(jax.tree.map(np.asarray, params),
                                         tcfg), assign=True)
    return jcfg, params, vae


def _encode_both(models, jdtype, tdtype, chunk=8):
    """JAX's latents and the port's (``chunk`` None: the full-sequence
    encode)."""
    jcfg, params, vae = models
    batch = _batch()
    fn = jax.jit(functools.partial(jtrainer.encode_training_batch, jcfg,
                                   encode_chunk_frames=8),
                 compiler_options={"xla_allow_excess_precision": False})
    with conv_accum_dtype(jdtype):
        want = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttrainer.encode_training_batch(
        vae, {k: torch.from_numpy(v) for k, v in batch.items()},
        ttrainer.TrainerConfig(compute_dtype=tdtype,
                               vae_encode_chunk_frames=chunk))
    return ([g.numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_encode_follows_jax_conv_accum_dtype(models):
    got, want = _encode_both(models, jnp.bfloat16, torch.bfloat16)
    # the parent commit's encode: fp32, the full sequence at once
    parent, _ = _encode_both(models, jnp.bfloat16, torch.float32, None)
    for name, g, w, p in zip(NAMES, got, want, parent):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        limit = (BF16_CLIP_REL_L2 if name in ("video", "traj")
                 else BF16_SINGLE_REL_L2)
        assert _rel_l2(g, w) <= limit < _rel_l2(p, w), (
            name, _rel_l2(g, w), _rel_l2(p, w))


def test_fp32_encode_equals_jax_chunk_protocol(models):
    """fp32 on both sides: the port's 1 + 8-frame chunked encode against
    JAX's to 1e-5 (fp32 sums in another order)."""
    got, want = _encode_both(models, jnp.float32, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_encode_dtype_follows_compute_dtype_unless_given():
    cfg = ttrainer.TrainerConfig(compute_dtype=torch.bfloat16)
    assert cfg.encode_dtype == torch.bfloat16
    assert cfg.vae_encode_chunk_frames == 8
    cfg = ttrainer.TrainerConfig(compute_dtype=torch.bfloat16,
                                 vae_encode_accum_dtype=torch.float32)
    assert cfg.encode_dtype == torch.float32
