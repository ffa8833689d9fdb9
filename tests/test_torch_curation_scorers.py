"""The learned curation scorers of the PyTorch port against the JAX package
on the CPU: TransNetV2 and AutoShot (shot boundaries, ``models/transnet.py``
and ``models/autoshot.py``), the IC9600 ICNet (image complexity,
``models/icnet.py``), their scorers through the preprocess hooks, and the
optical-flow utilities.

Weights are drawn with numpy under the released names (He-scaled, so the
outputs move with the input) and reach JAX through JAX's own
``*_from_state_dict``, whose trees have the layout of JAX's ``init_*``;
the port's ``*_from_jax`` must give the same state dict back bit for bit. Inputs are numpy-seeded. fp32 on both sides:
logits, scores and maps are held to ``REL_L2`` = 1e-5 relative L2 (sums in
another order; the readings are 5e-7 to 3e-6), the histograms and the
banded lookup exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.preprocess import autoshot as JA
from frameino_tpu.preprocess import icnet as JI
from frameino_tpu.preprocess import image_scoring as jscoring
from frameino_tpu.preprocess import scene_cut as jscene
from frameino_tpu.preprocess import transnet as JT
from frameino_tpu.utils import optical_flow as jflow
from frameino_tpu_torch.models import autoshot as TA
from frameino_tpu_torch.models import icnet as TI
from frameino_tpu_torch.models import transnet as TT
from frameino_tpu_torch.preprocess import image_scoring as tscoring
from frameino_tpu_torch.preprocess import scene_cut as tscene
from frameino_tpu_torch.utils import optical_flow as tflow

REL_L2 = 1e-5

# three stacks (the head reads a 3x6 grid off 27x48), narrow
SMALL_TRANSNET = dict(filters=2, num_stacks=3, blocks_per_stack=2,
                      hidden_dim=16, lookup_window=11)
# six layers with residual pairs, narrow; type A (shared) at 1-3
SMALL_AUTOSHOT = ((3, 2, 1, 4, False), (8, 2, 2, 3, True),
                  (8, 4, 2, 3, True), (16, 4, 2, 3, True),
                  (16, 8, 1, 3, False), (32, 8, 1, 3, False))
SMALL_ICNET = dict(size1=64, size2=32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def draw_state_dict(model, seed):
    """numpy weights for every entry of ``model``'s state dict: matrices
    and kernels N(0, gain / fan_in) (gain 2 for convolutions), biases
    N(0, 0.01), batch norms near the identity."""
    rng = np.random.default_rng(seed)
    bn = {n + "." for n, m in model.named_modules()
          if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        in_bn = any(k.startswith(p) for p in bn)
        if k.endswith("num_batches_tracked"):
            a = np.array(0)
        elif k.endswith("running_var"):
            a = 1 + 0.1 * rng.random(shape)
        elif in_bn and k.endswith("weight"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif in_bn:                                   # bias, running_mean
            a = 0.05 * rng.standard_normal(shape)
        elif v.ndim == 1:
            a = 0.01 * rng.standard_normal(shape)
        else:
            gain = 1.0 if v.ndim == 2 else 2.0
            a = rng.standard_normal(shape) * np.sqrt(gain / np.prod(shape[1:]))
        sd[k] = a.astype(np.int64 if k.endswith("tracked") else np.float32)
    return sd


def load_numpy(model, sd):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.fixture(scope="module")
def transnet():
    jcfg = JT.TransNetV2Config(**SMALL_TRANSNET)
    model = TT.TransNetV2(TT.TransNetV2Config(**SMALL_TRANSNET))
    sd = draw_state_dict(model, 0)
    return jcfg, JT.transnet_from_state_dict(sd, jcfg), load_numpy(model, sd), sd


@pytest.fixture(scope="module")
def autoshot():
    jcfg = JA.AutoShotConfig(layers=SMALL_AUTOSHOT)
    model = TA.AutoShot(TA.AutoShotConfig(layers=SMALL_AUTOSHOT))
    sd = draw_state_dict(model, 1)
    return jcfg, JA.autoshot_from_state_dict(sd, jcfg), load_numpy(model, sd), sd


@pytest.fixture(scope="module")
def icnet():
    jcfg = JI.ICNetConfig(**SMALL_ICNET)
    model = TI.ICNet(TI.ICNetConfig(**SMALL_ICNET))
    sd = draw_state_dict(model, 2)
    return jcfg, JI.icnet_from_state_dict(sd, jcfg), load_numpy(model, sd), sd


@pytest.fixture
def icnet_torch_padding(monkeypatch):
    """JAX's ICNet with its stride-2 3x3 convolutions padded one pixel on
    each side, as torchvision's ResNet-18 (JAX pads them "SAME": none
    before, one after)."""
    conv = JI._conv

    def padded(p, x, stride=1, padding="SAME"):
        if stride == 2 and p["w"].shape[0] == 3 and padding == "SAME":
            padding = [(1, 1), (1, 1)]
        return conv(p, x, stride, padding)
    monkeypatch.setattr(JI, "_conv", padded)


def frames(seed, t, h=27, w=48):
    return np.random.default_rng(seed).integers(
        0, 256, (t, h, w, 3)).astype(np.uint8)


def test_histograms_and_banded_lookup_are_exact():
    clip = frames(3, 14)[None]
    np.testing.assert_array_equal(
        TT.color_histograms(torch.from_numpy(clip)).numpy(),
        np.asarray(JT.color_histograms(jnp.asarray(clip))))
    sim = np.random.default_rng(4).standard_normal((2, 13, 13)).astype(
        np.float32)
    for window in (5, 11, 101):
        np.testing.assert_array_equal(
            TT.banded_lookup(torch.from_numpy(sim), window).numpy(),
            np.asarray(JT._banded_lookup(jnp.asarray(sim), window)))


@pytest.mark.parametrize("name", ["transnet", "autoshot"])
def test_shot_models_match_jax(name, request):
    """Both logits over 16 frames at 27x48, and the weight bridge: the
    port's state dict through JAX's ``*_from_state_dict`` and back through
    ``*_from_jax`` is the same state dict."""
    jcfg, params, model, sd = request.getfixturevalue(name)
    jfwd = JT.transnet_forward if name == "transnet" else JA.autoshot_forward
    clip = frames(5, 16)[None]
    j_one, j_many = jax.jit(lambda f: jfwd(jcfg, params, f))(
        jnp.asarray(clip))
    with torch.no_grad():
        t_one, t_many = model(torch.from_numpy(clip))
    assert t_one.shape == t_many.shape == (1, 16, 1)
    assert rel_l2(t_one.numpy(), j_one) <= REL_L2
    assert rel_l2(t_many.numpy(), j_many) <= REL_L2
    # the logits move with the frames (the weights are not degenerate)
    assert np.asarray(j_one).std() > 0.05
    back = (TT.transnet_from_jax(params, model.cfg) if name == "transnet"
            else TA.autoshot_from_jax(params, model.cfg))
    assert_same_state(back, sd)


def test_icnet_matches_jax_with_torchvision_padding(icnet,
                                                    icnet_torch_padding):
    """Score and map of two 64x64 images against JAX's forward with its
    stride-2 convolutions padded as the released model's; the weight
    bridge both ways."""
    jcfg, params, model, sd = icnet
    x = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    j_score, j_map = jax.jit(lambda a: JI.icnet_forward(jcfg, params, a))(
        jnp.asarray(x))
    with torch.no_grad():
        t_score, t_map = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_score.shape == (2,) and t_map.shape == (2, 1, 8, 8)
    assert rel_l2(t_score.numpy(), j_score) <= REL_L2
    assert rel_l2(t_map.numpy()[:, 0], np.asarray(j_map)[..., 0]) <= REL_L2
    assert_same_state(TI.icnet_from_jax(params), sd)


def test_jax_icnet_pads_stride2_convolutions_same(icnet):
    """JAX's own ICNet (stride-2 3x3 convolutions padded "SAME": no pixel
    before, one after) departs from the released model's padding, which
    the port keeps: its map reads over 100x REL_L2 from the port's."""
    jcfg, params, model, _ = icnet
    x = np.random.default_rng(7).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    _, j_map = jax.jit(lambda a: JI.icnet_forward(jcfg, params, a))(
        jnp.asarray(x))
    with torch.no_grad():
        _, t_map = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_l2(t_map.numpy()[:, 0], np.asarray(j_map)[..., 0]) \
        > 100 * REL_L2


def test_transnet_scorer_windows_match_jax(transnet):
    """30 frames at 40x60 through ``score_scene_cuts``: resized to 27x48,
    windows of 8 with an overlap of 2 averaged."""
    jcfg, params, model, _ = transnet
    video = frames(8, 30, 40, 60)
    want = jscene.score_scene_cuts(
        video, model=JT.make_transnet_scorer(params, jcfg, window=8,
                                             overlap=2))
    got = tscene.score_scene_cuts(
        video, model=TT.make_transnet_scorer(model, window=8, overlap=2))
    assert got.shape == (30,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_autoshot_scorer_windows_match_jax(autoshot):
    """30 frames at 27x48 in windows of 12 that keep their middle 8 (pad
    2), through ``score_scene_cuts``."""
    jcfg, params, model, _ = autoshot
    video = frames(9, 30)
    want = jscene.score_scene_cuts(
        video, model=JA.make_autoshot_scorer(params, jcfg, window=12, pad=2))
    got = tscene.score_scene_cuts(
        video, model=TA.make_autoshot_scorer(model, window=12, pad=2))
    assert got.shape == (30,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_jax_autoshot_scorer_takes_only_27x48(autoshot):
    """JAX's AutoShot scorer runs the frames at their own size, so a clip
    of any other size (the curation step's) fails at the head; the port's
    resizes it to 27x48 first, as its TransNetV2 scorer and the reference's
    scoring script do, and equals JAX's scorer on the resized clip."""
    jcfg, params, model, _ = autoshot
    video = frames(10, 14, 40, 60)
    with pytest.raises(TypeError):
        JA.make_autoshot_scorer(params, jcfg, window=12, pad=2)(video)
    got = TA.make_autoshot_scorer(model, window=12, pad=2)(video)
    want = JA.make_autoshot_scorer(params, jcfg, window=12, pad=2)(
        TT.resize_27x48(video))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_complexity_scorer_through_score_images(icnet, icnet_torch_padding):
    """``score_images(full=True, complexity_model=)`` on a 48x80 frame:
    every score equal to JAX's, the complexity within 1e-6 of JAX's
    forward on the scorer's input (resized to size1, ImageNet-normalized).
    JAX's own scorer cannot run: it takes ``float`` of the score's [1]
    array, which jax refuses."""
    import cv2
    jcfg, params, model, _ = icnet
    frame = frames(11, 1, 48, 80)[0]
    with pytest.raises(TypeError, match="scalar"):
        JI.make_complexity_scorer(params, jcfg)(frame)
    x = cv2.resize(frame, (jcfg.size1, jcfg.size1),
                   interpolation=cv2.INTER_LINEAR)
    x = (x.astype(np.float32) / 255.0 - JI.IMAGENET_MEAN) / JI.IMAGENET_STD
    jax_score = float(jax.jit(lambda a: JI.icnet_forward(jcfg, params, a))(
        jnp.asarray(x[None]))[0][0])
    want = jscoring.score_images(frame, full=True,
                                 complexity_model=lambda image: jax_score)
    got = tscoring.score_images(frame, full=True,
                                complexity_model=TI.make_complexity_scorer(
                                    model))
    assert set(got) == set(want)
    for k in want:
        if k != "complexity":
            assert got[k] == want[k], k
    assert abs(got["complexity"] - want["complexity"]) <= 1e-6
    assert 0.0 < got["complexity"] < 1.0


def test_load_autoshot_reads_a_release(tmp_path, autoshot):
    """A ``.pth`` in the release's layout (under ``net``, ``module.``
    prefixes, the dead supernet branches beside) loads; a missing key
    raises."""
    _, _, model, sd = autoshot
    ckpt = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    ckpt["module.Layer_6_0.attn.weight"] = torch.zeros(3)
    ckpt["module.fc1.linear.weight"] = torch.zeros(2, 2)
    torch.save({"net": ckpt}, tmp_path / "autoshot.pth")
    loaded = TA.load_autoshot(str(tmp_path / "autoshot.pth"), model.cfg,
                              device="cpu")
    assert_same_state({k: v for k, v in loaded.state_dict().items()}, sd)
    del ckpt["module.cls_layer2.linear.bias"]
    torch.save(ckpt, tmp_path / "broken.pth")
    with pytest.raises(KeyError):
        TA.load_autoshot(str(tmp_path / "broken.pth"), model.cfg,
                         device="cpu")


@pytest.mark.parametrize("clip_flow", [None, 0.5])
@pytest.mark.parametrize("bgr", [False, True])
def test_flow_to_image_is_bit_equal(clip_flow, bgr):
    flow = np.random.default_rng(12).standard_normal((20, 30, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(tflow.make_colorwheel(),
                                  jflow.make_colorwheel())
    np.testing.assert_array_equal(
        tflow.flow_to_image(flow, clip_flow, bgr),
        jflow.flow_to_image(flow, clip_flow, bgr))


@pytest.mark.parametrize("sample_prob", [1.0, 0.3])
def test_filter_uv_is_bit_equal(sample_prob):
    flow = np.random.default_rng(13).standard_normal((20, 30, 2))
    np.testing.assert_array_equal(
        tflow.filter_uv(flow, 0.2, sample_prob, np.random.default_rng(14)),
        jflow.filter_uv(flow, 0.2, sample_prob, np.random.default_rng(14)))
