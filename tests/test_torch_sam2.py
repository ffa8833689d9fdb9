"""The port's SAM2.1 (``frameino_tpu_torch/models/sam2.py``,
``sam2_video.py``) against JAX's at the tiny config: the same seeded numpy
weights, loaded into JAX through ``sam2_from_state_dict`` and into the port
through ``load_state_dict``; fp32 on both sides.

The object-score head's last bias is set to +4 in the seeded weights, so
that the masks are the decoder's logits and not the constant NO_OBJ_SCORE
of an absent object."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import sam2 as jsam
from frameino_tpu.models import sam2_video as jvid
from frameino_tpu_torch.models import sam2 as tsam
from frameino_tpu_torch.models import sam2_video as tvid
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.models.safetensors_io import save_file

# fp32 sums in another order through the tiny Hiera, the decoder and the
# memory attention
REL_L2 = 1e-4
FRAMES = 9        # past num_maskmem = 3 and max_obj_ptrs = 4 of the tiny config


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded_state_dict(model: torch.nn.Module, seed: int):
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = (1.0 if "gaussian" in k else 0.1) * rs.randn(*v.shape)
        if "norm" in k and k.endswith("weight") or \
                k.endswith(("upscaling.1.weight", "encoder.1.weight",
                            "encoder.4.weight", "encoder.7.weight",
                            "encoder.10.weight", "downscaling.1.weight",
                            "downscaling.4.weight")):
            a += 1.0
        sd[k] = a.astype(np.float32)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"][:] = 4.0
    return sd


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = tsam.tiny_sam2_config(), jsam.tiny_sam2_config()
    sd = seeded_state_dict(tsam.Sam2(cfg, device="meta"), 0)
    m = tsam.Sam2(cfg, device="meta")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True, assign=True)
    return jcfg, jsam.sam2_from_state_dict(dict(sd), jcfg), m.eval(), sd


def test_image_encoder_matches_jax(pair):
    jcfg, params, m, _ = pair
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    want, wpos = jsam.image_encoder_forward(params, jnp.asarray(x), jcfg)
    got, gpos = m.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= REL_L2
    for g, w in zip(gpos, wpos):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(pair, multimask):
    """Prompt encoding, the dense PE and the mask decoder: the logits, IoU,
    tokens and object score (the dynamic stability fallback when one
    mask)."""
    jcfg, params, m, _ = pair
    rs = np.random.RandomState(2)
    g, C = 4, jcfg.d_model
    src = rs.randn(1, g, g, C).astype(np.float32)
    s0 = rs.randn(1, 4 * g, 4 * g, C // 8).astype(np.float32)
    s1 = rs.randn(1, 2 * g, 2 * g, C // 4).astype(np.float32)
    pts = np.array([[[5.0, 9.0], [40.0, 30.0]]], np.float32)
    lbl = np.array([[1, 0]], np.int32)
    jsparse = jsam.prompt_encoder_points(params, jnp.asarray(pts),
                                         jnp.asarray(lbl), jcfg)
    want = jsam.mask_decoder_forward(
        params, jnp.asarray(src), jsam.prompt_dense_pe(params, jcfg),
        jsparse, (jnp.asarray(s0), jnp.asarray(s1)), jcfg, multimask)
    pe = m.sam_prompt_encoder
    with torch.no_grad():
        sparse = pe.points(torch.from_numpy(pts), torch.from_numpy(lbl))
        got = m.sam_mask_decoder(torch.from_numpy(src), pe.dense_pe(g),
                                 sparse, (torch.from_numpy(s0),
                                          torch.from_numpy(s1)), multimask)
    assert _rel_l2(sparse.numpy(), jsparse) <= REL_L2
    for name, gg, w in zip(("masks", "iou", "tokens", "obj_score"), got,
                           want):
        assert gg.shape == w.shape, name
        assert _rel_l2(gg.numpy(), w) <= REL_L2, name


@pytest.fixture(scope="module")
def clip():
    return np.random.RandomState(3).randint(0, 255, (FRAMES, 24, 32, 3)
                                            ).astype(np.uint8)


def test_video_predictor_matches_jax(pair, clip):
    """Points on frame 0, then propagation over 9 frames: the memory bank
    grows through its early-frame rule (frames 1-2) to the full one
    (3 spatial memories, 4 pointers). Logits within REL_L2 per frame, the
    masks equal wherever |logit| > 1e-3."""
    jcfg, params, m, _ = pair
    pts, lbl = np.array([[16.0, 12.0], [8.0, 20.0]]), np.array([1, 1])
    jp = jvid.Sam2VideoPredictor(params, jcfg)
    js = jp.init_state(clip)
    w0 = jp.add_new_points(js, 0, pts, lbl)
    want = dict(jp.propagate_in_video(js))
    tp = tvid.Sam2VideoPredictor(m)
    ts = tp.init_state(clip)
    g0 = tp.add_new_points(ts, 0, pts, lbl).numpy()
    got = {t: v.numpy() for t, v in tp.propagate_in_video(ts)}
    assert _rel_l2(g0, w0) <= REL_L2
    assert sorted(got) == sorted(want) == list(range(FRAMES))
    for t in range(FRAMES):
        assert _rel_l2(got[t], want[t]) <= REL_L2, t
        sure = np.abs(want[t]) > 1e-3
        np.testing.assert_array_equal(got[t][sure] > 0, want[t][sure] > 0)
    # the propagated frames are not the constant of an absent object
    assert all(np.ptp(got[t]) > 0 for t in range(FRAMES))


def test_segmenter_adapters_agree(pair, clip):
    jcfg, params, m, _ = pair
    q = np.array([[10.0, 10.0], [20.0, 14.0]], np.float32)
    want = jvid.make_segmenter_adapter(params, jcfg)(clip[:4], q)
    got = tvid.make_segmenter_adapter(m)(clip[:4], q)
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 24, 32)
    # equal where the logits are clear of 0 (the predictor test holds them)
    assert (got != want).mean() < 1e-3


def test_bridge_round_trip():
    cfg, jcfg = tsam.tiny_sam2_config(), jsam.tiny_sam2_config()
    params = jax.tree.map(np.asarray, jsam.init_sam2(jax.random.key(5),
                                                     jcfg))
    sd = tweights.sam2_to_state_dict(params, cfg)
    tsam.Sam2(cfg, device="meta").load_state_dict(sd, strict=True,
                                                  assign=True)
    back = jsam.sam2_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                     jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 params, jax.tree.map(np.asarray, back))


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_checkpoint_loader(pair, clip, tmp_path, fmt):
    """``sam2.1_hiera_large.pt`` holds the state dict under ``model``, with
    the video API's unused ``mask_downsample`` conv beside it."""
    jcfg, params, m, sd = pair
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    tensors["mask_downsample.weight"] = torch.zeros(1, 1, 4, 4)
    tensors["mask_downsample.bias"] = torch.zeros(1)
    path = str(tmp_path / f"sam.{fmt}")
    if fmt == "pt":
        torch.save({"model": tensors}, path)
    else:
        save_file(tensors, path)
    segment = tvid.load_sam2_torch(path, tsam.tiny_sam2_config(),
                                   device="cpu")
    q = np.array([[12.0, 9.0]], np.float32)
    np.testing.assert_array_equal(segment(clip[:3], q),
                                  tvid.make_segmenter_adapter(m)(clip[:3], q))
