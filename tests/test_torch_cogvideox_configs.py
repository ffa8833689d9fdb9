"""The port's CogVideoX DiT at the three layouts beside the 5B (CPU, tiny
widths, fp32) against the JAX package's ``cogvideox_forward``:

- "1.5": CogVideoX 1.5's ``patch_size_t`` = 2 linear patchify and
  unpatchify, the ``ofs`` embedding, RoPE without learned positions (no
  position table at all);
- "ofs": the ``ofs`` embedding on the 5B layout (RoPE and the learned
  table);
- "2B": the sincos table without RoPE, ``norm_final`` over the video
  tokens, qk LayerNorm without rotation (on the card: K3 at head_dim 64).

The weights are JAX's ``init_cogvideox_dit`` tree (the 5B-layout table
randomized so every slot is seen) through ``weights.cogvideox_dit_from_
jax``; the bridge is held exact both ways, and the port's checkpoint
writer and reader carry each layout. Inputs are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_dit as jdit
from frameino_tpu.models import weights as jweights
from frameino_tpu.ops import attention as jattn
from frameino_tpu_torch.models import cogvideox_dit as tdit
from frameino_tpu_torch.models import pretrained
from frameino_tpu_torch.models import weights as tweights

# tiny_config's time_embed_dim is 16: the ofs embedding is added to it
CONFIGS = {
    "1.5": dict(patch_size_t=2, ofs_embed_dim=16,
                use_learned_positional_embeddings=False),
    "ofs": dict(ofs_embed_dim=16),
    "2B": dict(use_rotary_positional_embeddings=False,
               use_learned_positional_embeddings=False),
}
# latent frames of each forward (1.5: a multiple of patch_size_t)
FRAMES = {"1.5": 4, "ofs": 3, "2B": 3}
# fp32 through 2 blocks, sums in another order (the file's DiT limit,
# tests/test_torch_cogvideox.py::test_dit_matches_jax)
TOL = 1e-4


def _np_sd(m):
    return {k: v.numpy() for k, v in m.state_dict().items()}


def make_pair(name, seed=1):
    """(JAX config, JAX tree, the port's DiT with the same weights)."""
    jcfg = jdit.tiny_config(**CONFIGS[name])
    tcfg = tdit.tiny_config(**CONFIGS[name])
    params = jdit.init_cogvideox_dit(jax.random.key(seed), jcfg)
    pe = params["patch_embed"]
    if "pos_embedding" in pe:
        pe["pos_embedding"] = jnp.asarray(np.random.RandomState(3).randn(
            *pe["pos_embedding"].shape).astype(np.float32))
    m = tdit.CogVideoXDiT(tcfg, device="meta")
    m.load_state_dict(tweights.cogvideox_dit_from_jax(
        jax.tree.map(np.asarray, params), tcfg), assign=True, strict=True)
    return jcfg, params, m.eval()


def inputs(name, cfg, H=8, W=8, seed=4):
    """(x, text, t, ofs, the RoPE tables or None) as numpy / JAX arrays."""
    F = FRAMES[name]
    rs = np.random.RandomState(seed)
    x = rs.randn(2, F, cfg.in_channels, H, W).astype(np.float32)
    text = rs.randn(2, 8, 16).astype(np.float32)
    t = np.array([999.0, 400.0], np.float32)
    ofs = np.array([2.0, 2.0], np.float32) if cfg.ofs_embed_dim else None
    rope = None
    if cfg.use_rotary_positional_embeddings:
        rope = jdit.cogvideox_rope(cfg, F // (cfg.patch_size_t or 1), H, W)
    return x, text, t, ofs, rope


def jax_forward(name, jcfg, params, impl, H=8, W=8):
    x, text, t, ofs, rope = inputs(name, jcfg, H, W)
    if impl == "fused":
        jattn.FORCE_INTERPRET = True
    try:
        return np.asarray(jdit.cogvideox_forward(
            jcfg, params, jnp.asarray(x), jnp.asarray(text), jnp.asarray(t),
            image_rotary_emb=rope,
            ofs=None if ofs is None else jnp.asarray(ofs),
            attn_impl="pallas" if impl == "fused" else "xla"))
    finally:
        jattn.FORCE_INTERPRET = False


def port_forward(name, m, impl, H=8, W=8):
    x, text, t, ofs, rope = inputs(name, m.cfg, H, W)
    if rope is not None:
        rope = tuple(torch.from_numpy(np.array(r)) for r in rope)
    return m(torch.from_numpy(x), torch.from_numpy(text),
             torch.from_numpy(t), rope,
             None if ofs is None else torch.from_numpy(ofs),
             attn_impl=impl).numpy()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return (request.param, *make_pair(request.param))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_forward_matches_jax(pair, impl):
    """"fused" runs the kernels' plain versions (K4 -> K1 with RoPE, K3 for
    the 2B) against JAX's Pallas kernels in interpret mode."""
    name, jcfg, params, m = pair
    ref = jax_forward(name, jcfg, params, impl)
    got = port_forward(name, m, impl)
    assert got.shape == (2, FRAMES[name], jcfg.out_channels, 8, 8)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_off_grid_forward_matches_jax():
    """The 2B's sincos table resized to a patch grid off the sample grid."""
    jcfg, params, m = make_pair("2B")
    ref = jax_forward("2B", jcfg, params, "xla", H=4, W=12)
    np.testing.assert_allclose(port_forward("2B", m, "xla", H=4, W=12), ref,
                               atol=TOL, rtol=TOL)


def test_layouts_hold_their_pieces(pair):
    name, jcfg, params, m = pair
    sd = m.state_dict()
    assert ("patch_embed.pos_embedding" in sd) == ("pos_embedding" in
                                                   params["patch_embed"])
    assert ("ofs_embedding.linear_1.weight" in sd) == bool(jcfg.ofs_embed_dim)
    pt = jcfg.patch_size_t or 1
    assert isinstance(m.patch_embed.proj, torch.nn.Linear if pt > 1
                      else torch.nn.Conv2d)
    assert m.proj_out.out_features == jcfg.out_channels * 4 * pt
    assert set(m.trained_buffers()) == ({"patch_embed.pos_embedding"}
                                        if name != "1.5" else set())


def test_ofs_moves_the_output():
    """ofs adds its embedding to the time embedding; without ofs the model
    runs as JAX's does without one (the embedding skipped)."""
    jcfg, params, m = make_pair("1.5")
    x, text, t, ofs, rope = inputs("1.5", jcfg)
    rope_t = tuple(torch.from_numpy(np.array(r)) for r in rope)
    args = (torch.from_numpy(x), torch.from_numpy(text), torch.from_numpy(t),
            rope_t)
    with_ofs = m(*args, torch.from_numpy(ofs), attn_impl="xla")
    without = m(*args, attn_impl="xla")
    assert (with_ofs - without).abs().max() > 1e-3
    ref = jdit.cogvideox_forward(jcfg, params, jnp.asarray(x),
                                 jnp.asarray(text), jnp.asarray(t),
                                 image_rotary_emb=rope, attn_impl="xla")
    np.testing.assert_allclose(without.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="multiple of patch_size_t"):
        m(args[0][:, :3], *args[1:3], tuple(r[:48] for r in rope_t))


def test_bridge_round_trips_exactly(pair):
    """JAX tree -> the port (``cogvideox_dit_from_jax``) -> JAX's reader
    (``cogvideox_dit_from_state_dict``) gives the tree back, and JAX's
    writer (``cogvideox_dit_to_state_dict``) gives the port's state dict
    back, bit for bit."""
    name, jcfg, params, m = pair
    sd = _np_sd(m)
    back = jweights.cogvideox_dit_from_state_dict(sd, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))
    again = jweights.cogvideox_dit_to_state_dict(back, jcfg)
    assert set(again) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_checkpoint_writer_and_reader_carry_the_layout(pair, tmp_path):
    """``save_pretrained`` / ``from_pretrained``: the config's layout
    fields and every tensor (the ofs embedding, the Linear patchify, the
    table or its absence) come back."""
    name, jcfg, params, m = pair
    d = tmp_path / name
    pretrained.save_pretrained(str(d), m.cfg, m)
    cfg, m2 = pretrained.from_pretrained(str(d), device="cpu")
    assert cfg == m.cfg
    a, b = m.state_dict(), m2.state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=0, rtol=0, msg=k)
