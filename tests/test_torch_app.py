"""The demo app of the PyTorch port (``app/core.py``, ``app/gradio_app.py``)
against the JAX package's on the CPU: canvas geometry, trajectory preview,
the colour legend, point-prompt segmentation, the session's state machine,
generation through the tiny Wan pipelines with the same weights and
latents, and the headless Gradio handlers; the training entry's metrics
mirror and ``--debug``; and the new modules' independence from jax.

Numpy images are compared bit for bit. The generated video in [-1, 1] is
held to 1e-3 (``tests/test_torch_pipeline.py::test_pipeline_matches_jax``'s
bound: fp32 on both sides, sums in another order), so its uint8 frames
(truncated from (v + 1) / 2 * 255, 0.13 of a code per 1e-3) may differ by
one code.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frameino_tpu.app.core as jcore
import frameino_tpu.app.gradio_app as jgradio
import frameino_tpu.data.video_io as jvideo_io
import frameino_tpu_torch.app.core as tcore
import frameino_tpu_torch.app.gradio_app as tgradio
import frameino_tpu_torch.data.video_io as tvideo_io
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as jweights
from frameino_tpu.pipelines import wan_i2v as jpipe
from frameino_tpu_torch import serve
from frameino_tpu_torch.data.traj import ALL_COLOR_CODES
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.pipelines import wan_i2v as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO_TOL = 1e-3
FRAMES = 9
SPEC = (32, 64, 16, 16, 8, 8)          # canvas 32x64, a 16x16 image at (8, 8)


def image(seed, h=16, w=16):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("dims", [(704, 1280), (700, 1270), (1, 33),
                                  (31, 64)])
def test_round_dims_matches_jax(dims):
    assert tcore.CanvasSpec.round_dims(*dims) == \
        jcore.CanvasSpec.round_dims(*dims)


@pytest.mark.parametrize("spec", [SPEC, (30, 64, 16, 16, 0, 0),
                                  (32, 64, 16, 16, 60, 0),
                                  (32, 64, 16, 16, -1, 0),
                                  (704, 1280, 480, 832, 224, 112)])
def test_validate_matches_jax(spec):
    def outcome(cls):
        try:
            cls(*spec).validate()
        except ValueError as e:
            return str(e)
        return None
    assert outcome(tcore.CanvasSpec) == outcome(jcore.CanvasSpec)


def test_canvases_crop_and_preview_match_jax():
    """Both canvases, the crop back to the placed image, the trajectory
    preview (two objects, one with two lines) and the legend."""
    img = image(0, 20, 12)
    spec_t, spec_j = tcore.CanvasSpec(*SPEC), jcore.CanvasSpec(*SPEC)
    got, want = tcore.build_canvas(img, spec_t), jcore.build_canvas(img,
                                                                   spec_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    video = np.stack([got[0]] * 3)
    np.testing.assert_array_equal(tcore.crop_padding(video, spec_t),
                                  jcore.crop_padding(video, spec_j))
    lines = [[(10, 10), (40, 30), (50, 12)], [(5, 25), (20, 20)],
             [(60, 5)]]
    for ids in (None, [0, 0, 1]):
        np.testing.assert_array_equal(
            tcore.visualize_trajectories(got[1], lines, object_ids=ids),
            jcore.visualize_trajectories(want[1], lines, object_ids=ids))
    for n in (0, 1, 3, len(ALL_COLOR_CODES) + 2):
        assert tcore.color_legend_html(n) == jcore.color_legend_html(n)


def sam_style(img, points):
    x, y = int(points[0][0]), int(points[0][1])
    ref = img[y, x].astype(np.float32)
    return np.abs(img.astype(np.float32) - ref).sum(-1) < 30


def image_only(img):
    return (img.sum(-1) > 100).astype(np.uint8)


def video_contract(frames, queries):
    """A video segmenter's contract (``sam2_video.make_segmenter_adapter``):
    frames [T, H, W, 3] -> masks [T, H, W]."""
    return np.ones((frames.shape[0],) + frames.shape[1:3], np.uint8)


@pytest.mark.parametrize("segmenter", [sam_style, image_only])
@pytest.mark.parametrize("point", [None, (4, 4)])
def test_segment_at_point_matches_jax(segmenter, point):
    img = np.zeros((32, 48, 3), np.uint8)
    img[8:24, 8:30] = 200
    got = tcore.segment_at_point(img, segmenter, point)
    np.testing.assert_array_equal(got, jcore.segment_at_point(img, segmenter,
                                                              point))
    assert got.shape == (32, 48) and got.dtype == np.uint8


def test_jax_segment_at_point_reads_an_image_as_a_clip():
    """JAX hands a video segmenter the image itself, which it reads as 48
    frames of [64, 3], and keeps the first: a (64, 3) mask, not (48, 64)."""
    img = np.zeros((48, 64, 3), np.uint8)
    assert jcore.segment_at_point(img, video_contract).shape == (64, 3)


def test_port_segment_at_point_keeps_jax_contract():
    """The port keeps JAX's contract, so it gives the same (64, 3); the
    video segmenter wrapped to take one image gives the (48, 64) mask."""
    img = np.zeros((48, 64, 3), np.uint8)
    assert tcore.segment_at_point(img, video_contract).shape == (64, 3)
    wrapped = lambda im, pts: video_contract(im[None], pts)  # noqa: E731
    mask = tcore.segment_at_point(img, wrapped)
    assert mask.shape == (48, 64) and mask.all()


def test_session_state_machine_matches_jax():
    """Points, new objects and lines, clearing, and the colour limit."""
    sessions = (tcore.InteractiveSession(None),
                jcore.InteractiveSession(None))
    for s in sessions:
        s.add_traj_point(1, 1)
        s.add_traj_point(2, 2)
        s.new_line()
        s.add_traj_point(5, 5)
        s.new_object()
        s.add_traj_point(9, 9)
        s.add_traj_point(3, 4, new_object=True)
    t, j = sessions
    assert t.polylines == j.polylines and t.line_obj == j.line_obj
    assert t.num_objects == j.num_objects == 3
    for s in sessions:
        s.clear_traj_points()
        assert s.num_objects == 0 and s.polylines == []
        s.new_line()                  # no object yet: starts one
        for _ in range(len(ALL_COLOR_CODES) - 1):
            s.new_object()
    errors = []
    for s in sessions:
        with pytest.raises(ValueError) as e:
            s.new_object()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class Recorder:
    """A pipeline that records its output and adds fixed keyword
    arguments (the latents; JAX's attention path) to every call."""

    def __init__(self, pipe, **extra):
        self.pipe, self.extra, self.outputs = pipe, extra, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, *a, **kw):
        out = self.pipe(*a, **kw, **self.extra)
        self.outputs.append(np.asarray(out))
        return out


@pytest.fixture(scope="module")
def pipes():
    """The smoke Wan configs with the same seeded weights on both sides,
    and one set of latents for the 32x64 canvas and 9 frames."""
    tdit_cfg, tvae_cfg = serve.smoke_configs()
    gen = torch.Generator().manual_seed(0)
    dit = tdit.init_wan_dit(tdit_cfg, gen)
    vae = tvae.init_wan_vae(tvae_cfg, gen)
    jdit_cfg = jdit.tiny_config(in_channels=8, out_channels=4)
    jvae_cfg = jvae.WanVAEConfig(**{
        f: getattr(tvae_cfg, f) for f in tvae_cfg.__dataclass_fields__})

    def np_sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    jp = jpipe.WanImageToVideoPipeline(
        jdit_cfg, jweights.wan_dit_from_state_dict(np_sd(dit), jdit_cfg),
        jvae_cfg, jweights.wan_vae_from_state_dict(np_sd(vae), jvae_cfg),
        jpipe.WanPipelineConfig())
    tp = tpipe.WanImageToVideoPipeline(dit, vae, tpipe.WanPipelineConfig())
    latents = np.random.default_rng(20).standard_normal(
        (1, 4, 5, 16, 32)).astype(np.float32)
    text = np.random.default_rng(21).standard_normal(
        (1, 7, tdit_cfg.text_dim)).astype(np.float32)
    return (Recorder(tp, latents=torch.from_numpy(latents)),
            Recorder(jp, latents=jnp.asarray(latents), attn_impl="xla"),
            text)


def assert_videos_close(tp, jp, got, want):
    np.testing.assert_allclose(tp.outputs[-1], jp.outputs[-1],
                               atol=VIDEO_TOL, rtol=VIDEO_TOL)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_session_run_matches_jax(pipes):
    """Canvas, two objects' trajectories and an ID image through
    ``InteractiveSession.run``: 9 frames cropped to the 16x16 image."""
    tp, jp, text = pipes
    out = []
    for core, pipe, arr in ((tcore, tp, torch.from_numpy),
                            (jcore, jp, jnp.asarray)):
        s = core.InteractiveSession(pipe, num_frames=FRAMES,
                                    num_inference_steps=2,
                                    guidance_scale=2.0)
        s.set_canvas(image(1), core.CanvasSpec(*SPEC))
        s.add_traj_point(40, 16)
        s.add_traj_point(55, 20)
        s.new_object()
        s.add_traj_point(10, 10)
        s.add_traj_point(20, 28)
        out.append(s.run(arr(text), id_image=image(2, 20, 12)))
    assert out[0].shape == (FRAMES, 16, 16, 3)
    assert_videos_close(tp, jp, *out)


def test_handlers_match_jax(pipes, monkeypatch, tmp_path):
    """The whole event sequence of ``make_handlers``: build (with the x32
    rounding), clicks with the preview and legend, a new object, a new
    line, segment (a point-prompt segmenter), run (a prompt through a text
    encoder, an mp4 written); the other handlers' outputs equal to JAX's,
    the frames written within one code, the port's mp4 readable."""
    tp, jp, text = pipes
    written = {}

    def recording(pkg, write):
        def write_video(path, frames, fps=12):
            written[pkg] = frames
            write(path, frames, fps)
        return write_video
    monkeypatch.setattr(tvideo_io, "write_video",
                        recording("torch", tvideo_io.write_video))
    monkeypatch.setattr(jvideo_io, "write_video",
                        recording("jax", jvideo_io.write_video))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    id_img = np.zeros((24, 20, 3), np.uint8)
    id_img[6:18, 4:16] = 180
    results = []
    for core, gradio_app, pipe, arr in (
            (tcore, tgradio, tp, torch.from_numpy),
            (jcore, jgradio, jp, jnp.asarray)):
        s = core.InteractiveSession(pipe, num_frames=FRAMES,
                                    num_inference_steps=2,
                                    guidance_scale=2.0, segmenter=sam_style)
        h = gradio_app.make_handlers(s, lambda prompts: arr(text))
        r = [h["build"](image(3), 30, 60, 8, 8), h["click"](40, 16),
             h["new_object"](), h["click"](10, 10), h["click"](20, 25),
             h["new_line"](), h["click"](30, 5), h["segment"](id_img),
             h["segment"](id_img, (10, 12))]
        r.append(h["clear"]())
        h["click"](40, 16)
        h["click"](52, 22)
        results.append((r, h["run"]("a red ball", id_img)))
    (got, t_path), (want, _) = results
    assert got[0][1:] == (32, 64, "canvas dims must be multiples of 32 — "
                                  "rounded 30x60 up to 32x64")

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]
    for g, w in zip(got, want):
        for a, b in zip(flat(g), flat(w)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert_videos_close(tp, jp, written["torch"], written["jax"])
    cap = cv2.VideoCapture(t_path)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == FRAMES and cap.get(cv2.CAP_PROP_FRAME_WIDTH) == 16
    cap.release()


def test_launch_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        tgradio.launch(None, None)


def test_metrics_logger_mirrors_to_tensorboard(tmp_path):
    """Each float metric reads back from ``tb/``'s event file at its
    step; the JSON lines stay as they were."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    from frameino_tpu_torch.core.metrics_logger import MetricsLogger
    log = MetricsLogger(str(tmp_path))
    log.log(1, {"loss": 0.5, "grad_norm": 2.0, "note": "warm"})
    log.log(2, {"loss": torch.tensor(0.25), "grad_norm": 1.5})
    log.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["grad_norm", "loss"]
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 0.5),
                                                                (2, 0.25)]
    assert [(e.step, e.value) for e in acc.Scalars("grad_norm")] == [
        (1, 2.0), (2, 1.5)]
    rows = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 2 and '"note": "warm"' in rows[0]


def test_wan_train_entry_accepts_debug():
    from frameino_tpu_torch import train
    assert train.parse_args(["--config_path", "c.yaml", "--debug"]).debug
    assert not train.parse_args(["--config_path", "c.yaml"]).debug


def test_new_modules_never_import_jax(tmp_path):
    """The demo, the scorers, the flow utilities and the metrics logger
    (with its tensorboard mirror) leave jax and the JAX package
    unimported in a fresh interpreter."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import frameino_tpu_torch.app as app
        from frameino_tpu_torch.app import gradio_app
        from frameino_tpu_torch.models import autoshot, icnet, transnet
        from frameino_tpu_torch.utils import optical_flow
        from frameino_tpu_torch.core.metrics_logger import MetricsLogger
        log = MetricsLogger(sys.argv[1])
        log.log(0, {"loss": 1.0})
        log.close()
        optical_flow.flow_to_image(np.ones((4, 4, 2)))
        app.build_canvas(np.zeros((8, 8, 3), np.uint8),
                         app.CanvasSpec(32, 32, 8, 8, 0, 0))
        g = torch.Generator().manual_seed(0)
        cfg = transnet.TransNetV2Config(filters=2, hidden_dim=8)
        clip = np.zeros((3, 20, 30, 3), np.uint8)
        transnet.make_transnet_scorer(transnet.init_transnet(cfg, g))(clip)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "frameino_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
