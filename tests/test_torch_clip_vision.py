"""The port's CLIP vision tower (``frameino_tpu_torch/models/clip_vision.py``)
on the CPU: the forward and pooled output against the JAX package's and
against ``transformers.CLIPVisionModel``, the image preprocessing against
JAX's ``preprocess_image`` (``jax.image.resize`` bicubic, antialiased),
the encoder the Wan2.1 pipeline calls, and the checkpoint directory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frameino_tpu.models import clip_vision as J
from frameino_tpu.models import pretrained as JP
from frameino_tpu_torch.models import clip_vision as T
from frameino_tpu_torch.models import pretrained as P
from frameino_tpu_torch.models.weights import clip_vision_from_jax
from frameino_tpu_torch.ops.resize import scale_weights

# fp32 on both sides, sums in another order: the port against JAX
JAX_TOL = 1e-5
# against transformers: tests/test_clip_vision.py's limit for JAX
HF_TOL = 2e-5
# preprocess_image in [0, 1] pixel units (before CLIP's normalisation,
# which multiplies by 1 / std <= 3.8). JAX jits its resize, and XLA's code
# for the Keys polynomial puts its weights up to 4.5e-6 from their eager
# fp32 values; the port computes them as the eager function does. Against
# an fp64 product of the same weights the port reads under 1e-6.
PIXEL_TOL = 1e-5
F64_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread beside the other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(act="gelu", layers=3, seed=0):
    """JAX params of the tiny config and the port's module on them."""
    jcfg = J.tiny_config(num_hidden_layers=layers, hidden_act=act)
    params = J.init_clip_vision(jax.random.key(seed), jcfg)
    tcfg = T.tiny_config(num_hidden_layers=layers, hidden_act=act)
    model = T.CLIPVision(tcfg, device="meta")
    model.load_state_dict(clip_vision_from_jax(
        jax.tree.map(np.asarray, params), tcfg), assign=True)
    return jcfg, params, model.eval()


def _px(seed=1, batch=2, size=28):
    return np.random.RandomState(seed).randn(batch, 3, size, size).astype(
        np.float32)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_forward_and_pooled_output_match_jax(act):
    """Penultimate states, last layer and pooled output."""
    jcfg, params, model = _pair(act)
    px = _px()
    for pen in (True, False):
        want = np.asarray(J.clip_vision_forward(jcfg, params, px,
                                                penultimate=pen))
        got = model(torch.from_numpy(px), penultimate=pen).numpy()
        np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=JAX_TOL)
    last = J.clip_vision_forward(jcfg, params, px, penultimate=False)
    want = np.asarray(J.clip_pooled_output(jcfg, params, last))
    got = model.pooled_output(torch.from_numpy(np.asarray(last))).numpy()
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_forward_matches_transformers(act):
    """transformers' weights, loaded from a file with the ``vision_model.``
    prefix: both hidden states and the pooled output."""
    from transformers import CLIPVisionConfig as HFCfg, CLIPVisionModel
    hf_cfg = HFCfg(hidden_size=16, intermediate_size=32, num_hidden_layers=3,
                   num_attention_heads=2, image_size=28, patch_size=14,
                   hidden_act=act, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = CLIPVisionModel(hf_cfg).eval()
    model = T.CLIPVision(T.tiny_config(num_hidden_layers=3, hidden_act=act),
                         device="meta")
    model.load_state_dict(T.from_state_dict_names(hf.state_dict(), model),
                          assign=True)
    px = torch.from_numpy(_px())
    with torch.no_grad():
        ref = hf(pixel_values=px, output_hidden_states=True)
    torch.testing.assert_close(model(px), ref.hidden_states[-2],
                               atol=HF_TOL, rtol=HF_TOL)
    last = model(px, penultimate=False)
    torch.testing.assert_close(last, ref.last_hidden_state, atol=HF_TOL,
                               rtol=HF_TOL)
    torch.testing.assert_close(model.pooled_output(last), ref.pooler_output,
                               atol=HF_TOL, rtol=HF_TOL)


# downscales (the 480x832 canvas, a small one, a uint8 one) and upscales
# (a short side under 224), ViT-H/14's 224
@pytest.mark.parametrize("shape,u8", [((480, 832, 3), False),
                                      ((100, 160, 3), False),
                                      ((60, 90, 3), True),
                                      ((50, 30, 3), False)])
def test_preprocess_matches_jax(shape, u8):
    rs = np.random.RandomState(0)
    img = (rs.rand(*shape) * 255).astype(np.uint8) if u8 \
        else rs.rand(*shape).astype(np.float32)
    want = J.preprocess_image(img, J.CLIP_VIT_H_14)
    got = T.preprocess_image(img).numpy()
    assert got.shape == want.shape == (1, 3, 224, 224)
    std = np.asarray(T.CLIP_IMAGE_STD, np.float32).reshape(1, 3, 1, 1)
    np.testing.assert_allclose(got * std, want * std, atol=PIXEL_TOL,
                               rtol=0)
    # the port's separable passes against an fp64 product of its weights
    x = (img.astype(np.float64) / (255.0 if u8 else 1.0))
    h, w = shape[:2]
    scale = 224 / min(h, w)
    nh, nw = max(224, int(round(h * scale))), max(224, int(round(w * scale)))
    x = np.einsum("hwc,hH->cHw", x, scale_weights(h, nh, "cubic"))
    x = np.einsum("cHw,wW->cHW", x, scale_weights(w, nw, "cubic"))
    top, left = (nh - 224) // 2, (nw - 224) // 2
    x = x[:, top:top + 224, left:left + 224]
    mean = np.asarray(T.CLIP_IMAGE_MEAN).reshape(3, 1, 1)
    np.testing.assert_allclose(got[0] * std[0] + mean, x, atol=F64_TOL,
                               rtol=0)


def test_resize_differs_from_interpolate():
    """The antialiased Keys kernel is not ``F.interpolate``'s bicubic."""
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 96, 160)
                         .astype(np.float32))
    ours = T.preprocess_pixels(x, T.tiny_config(image_size=48))
    plain = torch.nn.functional.interpolate(x, size=(48, 80), mode="bicubic")
    std = torch.tensor(T.CLIP_IMAGE_STD).reshape(3, 1, 1)
    mean = torch.tensor(T.CLIP_IMAGE_MEAN).reshape(3, 1, 1)
    assert (ours * std + mean - plain[..., 16:64]).abs().max() > 1e-2


def test_encode_condition_image_matches_jax():
    """Pixels in [-1, 1] -> penultimate states of the preprocessed images,
    batch of two at 64 x 96 (a downscale to the tiny config's 28)."""
    jcfg, params, model = _pair("gelu", layers=2, seed=3)
    image = np.tanh(np.random.RandomState(4).randn(2, 3, 64, 96)).astype(
        np.float32)
    want = np.asarray(J.encode_condition_image(jcfg, params, image))
    got = T.make_image_encoder(model.cfg, model)(torch.from_numpy(image))
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("arch", ["CLIPVisionModel",
                                  "CLIPVisionModelWithProjection",
                                  "CLIPModel"])
def test_checkpoint_directory_loads_in_both_packages(tmp_path, arch):
    """A port-written directory: transformers' file layout (the prefix),
    read back bit-equal by the port and equal by JAX; the other CLIP
    classes' configs (``vision_config`` wrapper of CLIPModel) and extra
    tensors (projection, text tower) load too."""
    import json
    import os
    g = torch.Generator().manual_seed(5)
    cfg = T.tiny_config()
    model = T.init_clip_vision(cfg, g)
    d = str(tmp_path / "image_encoder")
    P.save_pretrained(d, cfg, model)
    cj = json.load(open(os.path.join(d, "config.json")))
    if arch != "CLIPVisionModel":
        from frameino_tpu_torch.models import safetensors_io as SIO
        path = os.path.join(d, "model.safetensors")
        # copies: the reader maps the file that is rewritten below
        sd = {k: v.clone() for k, v in SIO.load_file(path).items()}
        sd["visual_projection.weight"] = torch.zeros(4, cfg.hidden_size)
        if arch == "CLIPModel":
            sd["text_model.embeddings.token_embedding.weight"] = \
                torch.zeros(8, 4)
            cj = {"architectures": [arch], "vision_config": cj}
        SIO.save_file(sd, path)
        cj["architectures"] = [arch]
        json.dump(cj, open(os.path.join(d, "config.json"), "w"))
    got_cfg, got = P.from_pretrained(d, device="cpu")
    assert got_cfg == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    jcfg, params = JP.from_pretrained(d)
    px = _px(size=cfg.image_size)
    want = np.asarray(J.clip_vision_forward(jcfg, params, jnp.asarray(px)))
    np.testing.assert_allclose(got(torch.from_numpy(px)).numpy(), want,
                               atol=JAX_TOL, rtol=JAX_TOL)
