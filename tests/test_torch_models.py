"""Parity of the PyTorch port's Wan DiT and VAE with the JAX package, and
the weight bridge between them (CPU, tiny configs, fp32 on both sides).

Weights come from the JAX initializers and cross over through
``frameino_tpu_torch.models.weights``; inputs are made with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as jweights
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import wan_dit_from_jax, wan_vae_from_jax

DIT_KW = dict(in_channels=8, out_channels=4)

VAE_KW = {
    # the plain (Wan2.1-layout) tiny VAE of tests/test_wan_pipeline.py
    "plain": dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                  temperal_downsample=(True,), is_residual=False,
                  patch_size=None, scale_factor_temporal=2,
                  scale_factor_spatial=2, latents_mean=(0.0,) * 4,
                  latents_std=(1.0,) * 4),
    # the residual, patchified Wan2.2 layout of tests/test_wan_vae.py
    "wan22": dict(base_dim=8, decoder_base_dim=12, z_dim=4,
                  dim_mult=(1, 2, 2), num_res_blocks=1,
                  temperal_downsample=(True, True), is_residual=True,
                  in_channels=12, out_channels=12, patch_size=2,
                  latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4),
}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def dit_pair():
    jcfg = jdit.tiny_config(**DIT_KW)
    tcfg = tdit.tiny_config(**DIT_KW)
    params = jdit.init_wan_dit(jax.random.key(1), jcfg)
    model = tdit.WanDiT(tcfg, device="meta")
    model.load_state_dict(wan_dit_from_jax(_to_np(params), tcfg),
                          assign=True)
    return jcfg, params, model.eval()


def _dit_inputs(seed=0, B=2, F=3, H=4, W=6):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 8, F, H, W).astype(np.float32)
    t = np.array([999.0, 357.5][:B], np.float32)
    ctx = rs.randn(B, 7, 16).astype(np.float32)
    S = F * (H // 2) * (W // 2)
    mask = np.ones((B, S), np.float32)
    mask[:, :S // F] = 0.0                 # clean first-frame tokens
    return x, t, ctx, mask


# fp32 on both sides through 2 blocks: reordered sums only (1e-4)
DIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("timesteps", ["scalar", "two_level", "per_token"])
def test_dit_forward_matches_jax(dit_pair, timesteps):
    jcfg, params, model = dit_pair
    x, t, ctx, mask = _dit_inputs()
    kw_j, kw_t = {}, {}
    tj = tt = t
    if timesteps == "two_level":
        kw_j["timestep_mask"] = jnp.asarray(mask)
        kw_t["timestep_mask"] = torch.from_numpy(mask)
    elif timesteps == "per_token":
        tj = tt = mask * t[:, None]
    ref = jdit.wan_dit_forward(jcfg, params, jnp.asarray(x), jnp.asarray(tj),
                               jnp.asarray(ctx), attn_impl="xla", **kw_j)
    got = model(torch.from_numpy(x), torch.from_numpy(tt),
                torch.from_numpy(ctx), **kw_t)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 3, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIT_TOL)


def test_dit_text_kv_matches_jax(dit_pair):
    """Hoisted text K/V (two-level timesteps, the serving form)."""
    jcfg, params, model = dit_pair
    x, t, ctx, mask = _dit_inputs(seed=1)
    kv_j = jdit.precompute_text_kv(jcfg, params, jnp.asarray(ctx),
                                   dtype=jnp.float32)
    ref = jdit.wan_dit_forward(jcfg, params, jnp.asarray(x), jnp.asarray(t),
                               None, timestep_mask=jnp.asarray(mask),
                               attn_impl="xla", text_kv=kv_j)
    kv_t = model.precompute_text_kv(torch.from_numpy(ctx))
    assert len(kv_t) == jcfg.num_layers
    # the hoisted K of block 0 is the JAX one (same ops, fp32): 1e-5
    np.testing.assert_allclose(kv_t[0][0].numpy(), np.asarray(kv_j["k"][0]),
                               atol=1e-5, rtol=1e-5)
    got = model(torch.from_numpy(x), torch.from_numpy(t),
                timestep_mask=torch.from_numpy(mask), text_kv=kv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIT_TOL)
    # and hoisting changes nothing on the torch side: bit-equal
    direct = model(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   timestep_mask=torch.from_numpy(mask))
    torch.testing.assert_close(got, direct, atol=0, rtol=0)


def test_dit_bf16_weights_return_fp32(dit_pair):
    """The forward runs in the weights' dtype and hands fp32 back."""
    _, _, model = dit_pair
    m16 = tdit.WanDiT(model.cfg, device="meta", dtype=torch.bfloat16)
    m16.to_empty(device="cpu")
    m16.load_state_dict(model.state_dict())
    x, t, ctx, mask = _dit_inputs(seed=2)
    got = m16(torch.from_numpy(x), torch.from_numpy(t),
              torch.from_numpy(ctx), timestep_mask=torch.from_numpy(mask))
    ref = model(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx), timestep_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    # bf16 weights and activations vs fp32: 2 blocks of bf16 rounding
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.1, rtol=0.1)


def test_dit_bridge_equals_jax_exporter(dit_pair):
    """wan_dit_from_jax == weights.wan_dit_to_state_dict, name for name,
    and the names are exactly the module's."""
    jcfg, params, model = dit_pair
    ours = wan_dit_from_jax(_to_np(params), model.cfg)
    theirs = jweights.wan_dit_to_state_dict(params, jcfg)
    assert set(ours) == set(theirs) == set(model.state_dict())
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)


def test_dit_random_init_is_seeded():
    cfg = tdit.tiny_config(**DIT_KW)
    a = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(3))
    b = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=na)
    assert torch.all(a.blocks[0].attn1.norm_q.weight == 1)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(VAE_KW))
def vae_pair(request):
    """A seeded torch VAE and the same weights as a JAX tree, loaded by the
    JAX package's own diffusers loader (the JAX initializer runs eagerly
    and takes half a minute at this size; the loader is numpy)."""
    jcfg = jvae.WanVAEConfig(**VAE_KW[request.param])
    tcfg = tvae.WanVAEConfig(**VAE_KW[request.param])
    model = tvae.init_wan_vae(tcfg, torch.Generator().manual_seed(2))
    params = jweights.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    return jcfg, params, model


def test_vae_encode_decode_match_jax(vae_pair):
    jcfg, params, model = vae_pair
    rs = np.random.RandomState(4)
    video = np.tanh(rs.randn(1, 3, 9, 32, 32)).astype(np.float32)
    encode = jax.jit(lambda p, v: jvae.encode(jcfg, p, v))
    ref = encode(params, jnp.asarray(video))
    got = model.encode(torch.from_numpy(video))
    assert got.shape == ref.shape
    # fp32 convs through every level: reordered sums only (1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    z = rs.randn(*ref.shape).astype(np.float32)
    ref_v = jax.jit(lambda p, z: jvae.decode(jcfg, p, z))(params,
                                                           jnp.asarray(z))
    got_v = model.decode(torch.from_numpy(z))
    assert got_v.shape == ref_v.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-4,
                               rtol=1e-4)
    # single-frame clips (the condition and ID encodes)
    img = video[:, :, :1]
    np.testing.assert_allclose(
        model.encode(torch.from_numpy(img)).numpy(),
        np.asarray(encode(params, jnp.asarray(img))),
        atol=1e-4, rtol=1e-4)


def test_vae_bridge_round_trips(vae_pair):
    """wan_vae_from_jax -> weights.wan_vae_from_state_dict gives the JAX
    tree back; the tree has exactly ``init_wan_vae``'s structure and
    shapes, and the bridge names are exactly the module's."""
    jcfg, params, model = vae_pair
    init_shapes = jax.eval_shape(lambda k: jvae.init_wan_vae(k, jcfg),
                                 jax.random.key(0))
    assert jax.tree.structure(init_shapes) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(init_shapes)] == \
        [np.shape(a) for a in jax.tree.leaves(params)]
    sd = wan_vae_from_jax(_to_np(params), model.cfg)
    assert set(sd) == set(model.state_dict())
    back = jweights.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_latent_normalization_matches_jax():
    kw = dict(VAE_KW["plain"], latents_mean=(0.5, -1.0, 0.0, 2.0),
              latents_std=(2.0, 0.5, 1.0, 4.0))
    jcfg, tcfg = jvae.WanVAEConfig(**kw), tvae.WanVAEConfig(**kw)
    z = np.random.RandomState(5).randn(1, 4, 2, 3, 3).astype(np.float32)
    n = tvae.normalize_latents(tcfg, torch.from_numpy(z))
    np.testing.assert_allclose(
        n.numpy(), np.asarray(jvae.normalize_latents(jcfg, jnp.asarray(z))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tvae.denormalize_latents(tcfg, n).numpy(), z,
                               atol=1e-6, rtol=1e-6)


def test_wan22_configs_match_jax():
    assert dataclasses.asdict(tvae.WAN22_VAE_CONFIG) == \
        dataclasses.asdict(jvae.WAN22_VAE_CONFIG)
    j = dataclasses.asdict(jdit.WAN22_TI2V_5B_MOTION)
    for k, v in dataclasses.asdict(tdit.WAN22_TI2V_5B_MOTION).items():
        assert j[k] == v, k
