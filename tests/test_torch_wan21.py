"""The port's Wan2.1 I2V branch on the CPU against the JAX package: the DiT's
image-KV branch (forward with CLIP states, with and without the FLF2V
position table, the hoisted text and image K/V), the weight bridges both
ways, the int8 layers it quantizes, the Wan2.1 condition algebra and
denoise, the whole pipeline with its CLIP image encoder, and checkpoint
directories with an ``image_encoder/``. fp32 on both sides, the same
seeded weights in both (JAX-initialised DiT and CLIP, port-initialised
VAE), tiny configs.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import clip_vision as jclip
from frameino_tpu.models import pretrained as JP
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as JW
from frameino_tpu.pipelines import wan_i2v as jpipe
from frameino_tpu_torch.models import clip_vision as tclip
from frameino_tpu_torch.models import pretrained as P
from frameino_tpu_torch.models import quant
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (clip_vision_from_jax,
                                               wan_dit_from_jax)
from frameino_tpu_torch.pipelines import wan_i2v as tpipe

# the DiT and K/V: fp32, reordered sums (1e-5)
DIT_TOL = 1e-5
# the condition latents: streaming (8-frame chunks) against JAX's
# full-sequence encode, fp32 (1e-5); the mask channels are exact
COND_TOL = 1e-5
# denoise and the pipelines: as tests/test_torch_pipeline.py holds the
# Wan2.2 pipeline (fp32 through encodes, steps and the decode)
DENOISE_TOL = 1e-4
PIPE_TOL = 1e-3

H = W = 16
CLIP_KW = dict(num_hidden_layers=2)
# tiny Wan2.1 I2V DiT: noisy z (4) + mask (tscale 2) + condition z (4) +
# trajectory z (4) = 14 input channels (tests/test_wan21_pipeline.py), the
# tiny CLIP's 16-wide states, image K/V from the 48-wide embedder output
DIT_KW = dict(in_channels=14, out_channels=4, image_dim=16,
              added_kv_proj_dim=48)


def _vae_kw(tscale):
    """The tiny Wan2.1-layout VAE at a temporal stride of 2 (JAX's test) or
    4 (the released VAE's)."""
    deep = tscale == 4
    return dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2) if deep else (1, 2),
                num_res_blocks=1,
                temperal_downsample=(True, True) if deep else (True,),
                is_residual=False, scale_factor_temporal=tscale,
                scale_factor_spatial=4 if deep else 2,
                latents_mean=tuple(np.linspace(-1, 1, 4).tolist()),
                latents_std=tuple(np.linspace(0.5, 2.5, 4).tolist()))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread beside the other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _dit_pair(seed=1, **kw):
    """A JAX-initialised tiny DiT (random image position table when it has
    one) and the port's module on the same weights."""
    jcfg = jdit.tiny_config(**kw)
    params = _np(jdit.init_wan_dit(jax.random.key(seed), jcfg))
    ie = params["condition_embedder"].get("image_embedder", {})
    if "pos_embed" in ie:
        ie["pos_embed"] = np.random.RandomState(seed).randn(
            *ie["pos_embed"].shape).astype(np.float32)
    tcfg = tdit.tiny_config(**kw)
    model = tdit.WanDiT(tcfg, device="meta")
    model.load_state_dict(wan_dit_from_jax(params, tcfg), assign=True)
    return jcfg, jax.tree.map(jnp.asarray, params), model.eval()


def _vae_pair(tscale, seed=0):
    """The port's seeded VAE and the same weights in JAX's tree (JAX's
    diffusers loader; its eager random init takes ~30 s on the CPU)."""
    tcfg = tvae.WanVAEConfig(**_vae_kw(tscale))
    vae = tvae.init_wan_vae(tcfg, torch.Generator().manual_seed(seed))
    jcfg = jvae.WanVAEConfig(**_vae_kw(tscale))
    params = JW.wan_vae_from_state_dict(
        {k: v.numpy() for k, v in vae.state_dict().items()}, jcfg)
    return jcfg, params, vae


def _clip_pair(seed=3):
    jcfg = jclip.tiny_config(**CLIP_KW)
    params = jclip.init_clip_vision(jax.random.key(seed), jcfg)
    tcfg = tclip.tiny_config(**CLIP_KW)
    model = tclip.CLIPVision(tcfg, device="meta")
    model.load_state_dict(clip_vision_from_jax(_np(params), tcfg),
                          assign=True)
    return jcfg, params, model.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_embed_seq_len", [None, 10],
                         ids=["i2v", "flf2v"])
def test_dit_forward_with_image_matches_jax(pos_embed_seq_len):
    """CLIP states through the image embedder (eps 1e-5; with the position
    table, each sample's two frames joined first) and every block's second
    softmax over the image keys; without states the branch is skipped."""
    jcfg, params, model = _dit_pair(pos_embed_seq_len=pos_embed_seq_len,
                                    **DIT_KW)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 14, 3, 4, 4).astype(np.float32)
    t = np.array([300.0, 700.0], np.float32)
    text = rs.randn(2, 5, 16).astype(np.float32)
    img = rs.randn(4 if pos_embed_seq_len else 2, 5, 16).astype(np.float32)
    for image in (img, None):
        want = jdit.wan_dit_forward(
            jcfg, params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
            None if image is None else jnp.asarray(image), attn_impl="xla")
        got = model(_t(x), _t(t), _t(text),
                    None if image is None else _t(image))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=DIT_TOL, rtol=DIT_TOL)


def test_precompute_text_kv_with_image_matches_jax():
    """k, v, k_img, v_img of every block, and the forward on them equal to
    the forward that projects them itself."""
    jcfg, params, model = _dit_pair(**DIT_KW)
    rs = np.random.RandomState(4)
    text = rs.randn(2, 6, 16).astype(np.float32)
    img = rs.randn(2, 5, 16).astype(np.float32)
    want = jdit.precompute_text_kv(jcfg, params, jnp.asarray(text),
                                   jnp.asarray(img), dtype=jnp.float32)
    got = model.precompute_text_kv(_t(text), _t(img))
    for i, kv in enumerate(got):
        assert len(kv) == 4
        for j, name in enumerate(("k", "v", "k_img", "v_img")):
            np.testing.assert_allclose(kv[j].numpy(),
                                       np.asarray(want[name][i]),
                                       atol=DIT_TOL, rtol=DIT_TOL)
    x = torch.from_numpy(rs.randn(2, 14, 3, 4, 4).astype(np.float32))
    t = torch.tensor([100.0, 900.0])
    torch.testing.assert_close(model(x, t, text_kv=got),
                               model(x, t, _t(text), _t(img)), atol=0,
                               rtol=0)
    # text only: two tensors a block, as the Wan2.2 path
    assert all(len(kv) == 2 for kv in model.precompute_text_kv(_t(text)))


def test_weight_bridges_both_ways_are_exact():
    """JAX tree -> the port (wan_dit_from_jax, clip_vision_from_jax) and
    the port's state dicts -> JAX's diffusers / transformers loaders, every
    leaf equal. JAX's exporter ``wan_dit_to_state_dict`` writes no image
    branch, so it is not on this path."""
    jcfg, params, model = _dit_pair(pos_embed_seq_len=10, **DIT_KW)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = JW.wan_dit_from_state_dict(sd, jcfg)
    for a, b in zip(jax.tree.leaves(_np(params)), jax.tree.leaves(_np(back))):
        np.testing.assert_array_equal(a, b)
    assert any(k.startswith("condition_embedder.image_embedder.") for k in sd)
    assert sum(k.endswith("attn2.add_k_proj.weight") for k in sd) == 2
    assert "blocks.0.attn2.add_k_proj.weight" not in \
        JW.wan_dit_to_state_dict(params, jcfg)
    ccfg, cparams, clip = _clip_pair()
    sd = {f"vision_model.{k}": v.numpy()
          for k, v in clip.state_dict().items()}
    back = jclip.clip_vision_from_state_dict(sd, ccfg)
    for a, b in zip(jax.tree.leaves(_np(cparams)),
                    jax.tree.leaves(_np(back))):
        np.testing.assert_array_equal(a, b)


def test_int8_quantizes_the_image_projections_as_jax():
    """``quantize_dit_int8`` swaps attn2.add_k_proj / add_v_proj too: 12
    layers a block, as many as JAX's ``_QUANT_PATTERNS`` select."""
    from frameino_tpu.models.quant import quantize_dit_int8 as jq
    jcfg, params, model = _dit_pair(**DIT_KW)
    names = quant.quantized_layer_names(model)
    assert len(names) == 12 * jcfg.num_layers
    assert "blocks.1.attn2.add_v_proj" in names
    qp = jq(jax.tree.map(lambda a: jnp.array(a, copy=True), params))
    n_jax = sum("kernel_q" in str(path) for path, _ in
                jax.tree_util.tree_leaves_with_path(qp["blocks"]))
    assert n_jax == 12


# ---------------------------------------------------------------------------
# Condition algebra and denoise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tscale", [2, 4])
@pytest.mark.parametrize("last", [False, True], ids=["first", "first_last"])
def test_prepare_conditions_wan21_matches_jax(tscale, last):
    """The mask channels (frame 0 repeated into the temporal stride, and
    the last frame with ``last_image``) exactly, the condition and
    trajectory latents of 17 frames (streamed in chunks here, whole in
    JAX) within COND_TOL."""
    jcfg, params, vae = _vae_pair(tscale)
    rs = np.random.RandomState(5)
    image = np.tanh(rs.randn(1, 3, H, W)).astype(np.float32)
    last_image = np.tanh(rs.randn(1, 3, H, W)).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, 17, H, W)).astype(np.float32)
    li = last_image if last else None
    want, want_traj = jpipe.prepare_conditions_wan21(
        jcfg, params, jnp.asarray(image), 17, jnp.asarray(traj),
        last_image=None if li is None else jnp.asarray(li))
    got, got_traj = tpipe.prepare_conditions_wan21(
        vae, _t(image), 17, _t(traj), None if li is None else _t(li))
    f = 16 // tscale + 1
    assert got.shape == want.shape == (1, tscale + 4, f, H // vae.cfg
                                       .scale_factor_spatial,
                                       W // vae.cfg.scale_factor_spatial)
    np.testing.assert_array_equal(got[:, :tscale].numpy(),
                                  np.asarray(want[:, :tscale]))
    mask = got[0, :, 0].numpy()
    assert mask[:tscale].min() == 1.0
    assert got[0, :tscale, -1].max().item() == (1.0 if last else 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COND_TOL,
                               rtol=COND_TOL)
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(want_traj),
                               atol=COND_TOL, rtol=COND_TOL)


def test_denoise_segment_wan21_matches_jax():
    """Batch-stacked CFG at guidance 4 with the image states on both
    halves, a trajectory, 3 Euler steps."""
    jcfg, params, model = _dit_pair(**DIT_KW)
    rs = np.random.RandomState(6)
    latents = rs.randn(1, 4, 5, 8, 8).astype(np.float32)
    cond = rs.randn(1, 6, 5, 8, 8).astype(np.float32)
    traj = rs.randn(1, 4, 5, 8, 8).astype(np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    img = rs.randn(1, 5, 16).astype(np.float32)
    sig = np.array([1.0, 0.8, 0.5, 0.0], np.float32)
    ts = (sig[:-1] * 1000).astype(np.float32)
    want = jpipe.denoise_segment_wan21(
        jcfg, params, jnp.asarray(latents), jnp.asarray(cond),
        jnp.asarray(traj), jnp.asarray(ctx), jnp.asarray(img),
        jnp.asarray(sig[:-1]), jnp.asarray(sig[1:]), jnp.asarray(ts), 4.0,
        attn_impl="xla")
    got = tpipe.denoise_segment_wan21(model, _t(latents), _t(cond), _t(traj),
                                      _t(ctx), _t(img), sig[:-1], sig[1:],
                                      ts, 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DENOISE_TOL, rtol=DENOISE_TOL)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    """The JAX and port Wan2.1 pipelines on the same weights, each with its
    CLIP image encoder."""
    jd_cfg, jd_params, dit = _dit_pair(**DIT_KW)
    jv_cfg, jv_params, vae = _vae_pair(2)
    jc_cfg, jc_params, clip = _clip_pair()
    jp = jpipe.WanImageToVideoPipeline(
        jd_cfg, jd_params, jv_cfg, jv_params,
        jpipe.WanPipelineConfig(expand_timesteps=False),
        image_encoder_fn=jclip.make_image_encoder_fn(jc_cfg, jc_params))
    tp = tpipe.WanImageToVideoPipeline(
        dit, vae, tpipe.WanPipelineConfig(expand_timesteps=False),
        image_encoder=tclip.make_image_encoder(clip.cfg, clip))
    return jp, tp


def _inputs(seed=7):
    rs = np.random.RandomState(seed)
    image = np.tanh(rs.randn(1, 3, H, W)).astype(np.float32)
    last = np.tanh(rs.randn(1, 3, H, W)).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, 9, H, W)).astype(np.float32)
    text = rs.randn(1, 7, 16).astype(np.float32)
    latents = rs.randn(1, 4, 5, H // 2, W // 2).astype(np.float32)
    return image, last, traj, text, latents


def _run_both(jp, tp, output_type="np", last=False, steps=2):
    image, last_image, traj, text, latents = _inputs()
    kw = dict(height=H, width=W, num_frames=9, num_inference_steps=steps,
              guidance_scale=3.0, output_type=output_type)
    li = last_image if last else None
    want = jp(jnp.asarray(image), prompt_embeds=jnp.asarray(text),
              traj_tensor=jnp.asarray(traj), latents=jnp.asarray(latents),
              last_image=None if li is None else jnp.asarray(li),
              attn_impl="xla", **kw)
    got = tp(_t(image), prompt_embeds=_t(text), traj_tensor=_t(traj),
             latents=_t(latents), last_image=None if li is None else _t(li),
             **kw)
    return np.asarray(want), (got.numpy() if isinstance(got, torch.Tensor)
                              else got)


def test_pipeline_matches_jax(pipes):
    """CLIP states of the image, mask + latent conditions, a trajectory,
    CFG, 2 steps, the decoded video."""
    want, got = _run_both(*pipes)
    assert got.shape == want.shape == (1, 3, 9, H, W)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PIPE_TOL, rtol=PIPE_TOL)
    assert set(pipes[1].timings) >= {"image_encode_s", "vae_encode_s",
                                      "denoise_s", "decode_s"}


def test_pipeline_first_last_latents_match_jax(pipes):
    """First + last frame conditioning: the latents."""
    want, got = _run_both(*pipes, output_type="latent", last=True)
    assert got.shape == (1, 4, 5, H // 2, W // 2)
    np.testing.assert_allclose(got, want, atol=DENOISE_TOL,
                               rtol=DENOISE_TOL)


def test_image_encoder_wiring(pipes):
    """The encoder runs once on the [-1, 1] image when no ``image_embeds``
    are given, never when they are (and the given states are used); the
    expand path's ID frames and two experts are refused."""
    _, tp = pipes
    calls = []
    enc = tp.image_encoder

    def spy(image):
        calls.append(tuple(image.shape))
        return enc(image)

    pipe = tpipe.WanImageToVideoPipeline(
        tp.dit, tp.vae, tpipe.WanPipelineConfig(expand_timesteps=False),
        image_encoder=spy)
    image, _, traj, text, latents = _inputs()
    kw = dict(prompt_embeds=_t(text), traj_tensor=_t(traj),
              latents=_t(latents), height=H, width=W, num_frames=9,
              num_inference_steps=1, guidance_scale=3.0,
              output_type="latent")
    a = pipe(_t(image), **kw)
    assert calls == [(1, 3, H, W)]
    b = pipe(_t(image), image_embeds=enc(_t(image)), **kw)
    assert calls == [(1, 3, H, W)]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    c = pipe(_t(image), image_embeds=torch.zeros(1, 5, 16), **kw)
    assert (c - a).abs().max() > 1e-4
    with pytest.raises(ValueError, match="ID frames"):
        pipe(_t(image), id_tensor=torch.zeros(1, 3, 1, H, W), **kw)
    with pytest.raises(NotImplementedError, match="two experts"):
        tpipe.WanImageToVideoPipeline(
            tp.dit, tp.vae, tpipe.WanPipelineConfig(expand_timesteps=False),
            dit_2=tp.dit)


def test_int8_pipeline_matches_jax(pipes):
    """quantize="int8" on both sides (the image projections among the
    quantized layers; K7's plain version on the CPU), 2 steps, the video,
    within the float pipelines' limit, and moved from the float video."""
    jp, tp = pipes
    jq = jpipe.WanImageToVideoPipeline(
        jp.dit_cfg, jax.tree.map(lambda a: jnp.array(a, copy=True),
                                 jp.dit_params),
        jp.vae_cfg, jp.vae_params,
        jpipe.WanPipelineConfig(expand_timesteps=False),
        image_encoder_fn=jp.image_encoder_fn, quantize="int8")
    tq = tpipe.WanImageToVideoPipeline(
        copy.deepcopy(tp.dit), tp.vae,
        tpipe.WanPipelineConfig(expand_timesteps=False),
        image_encoder=tp.image_encoder, quantize="int8")
    assert sum(isinstance(m, quant.QuantLinear)
               for m in tq.dit.modules()) == 24
    want, got = _run_both(jq, tq)
    np.testing.assert_allclose(got, want, atol=PIPE_TOL, rtol=PIPE_TOL)
    _, fp = _run_both(jp, tp)
    assert np.abs(fp - got).max() > 1e-3


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------

def test_pipeline_dir_with_image_encoder_loads(tmp_path):
    """transformer/ (Wan2.1 I2V, with the FLF2V position table), vae/ and
    image_encoder/ written by the port: ``load_pipeline_dir`` reads each
    bit-equal, and JAX's loaders read the same files to the same trees."""
    _, _, dit = _dit_pair(pos_embed_seq_len=10, **DIT_KW)
    _, _, vae = _vae_pair(2)
    _, _, clip = _clip_pair()
    root = str(tmp_path)
    for sub, m in (("transformer", dit), ("vae", vae),
                   ("image_encoder", clip)):
        P.save_pretrained(os.path.join(root, sub), m.cfg, m)
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "config.json"), "w") as f:
        f.write('{"_class_name": "FlowMatchEulerDiscreteScheduler"}')
    got = P.load_pipeline_dir(root, device="cpu")
    jax_got = JP.load_pipeline_dir(root)
    assert sorted(got) == sorted(jax_got) == ["image_encoder", "transformer",
                                              "vae"]
    for sub, m in (("transformer", dit), ("vae", vae),
                   ("image_encoder", clip)):
        cfg, loaded = got[sub]
        assert cfg == m.cfg
        for k, v in m.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (sub, k)
    assert dataclasses.asdict(jax_got["transformer"][0]) == \
        dataclasses.asdict(dit.cfg)
    sd = {k: v.numpy() for k, v in dit.state_dict().items()}
    want = JW.wan_dit_from_state_dict(sd, jax_got["transformer"][0])
    for a, b in zip(jax.tree.leaves(_np(want)),
                    jax.tree.leaves(_np(jax_got["transformer"][1]))):
        np.testing.assert_array_equal(a, b)
