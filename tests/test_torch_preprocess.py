"""The port's curation chain against the JAX package's, on the CPU.

The numpy / cv2 steps (``frameino_tpu_torch/preprocess/``) are copies of
JAX's and must give identical outputs (exact equality, NaNs equal) on the
same inputs; both packages' ``process_video`` must give identical rows and
ID crops (bytes) on two fixture clips with the classical and template
backends, in process; the port's CLI keeps JAX's ``--allow_classical`` gate
and feeds the port's ``FrameINODataset``; the learned backends run through
the CLI at tiny configs (OneFormer, VGGT, CoTracker3, SAM2.1 and the
Qwen2.5-VL captioner from checkpoints written in the released layouts).
"""

import argparse
import json
import os
import types

import numpy as np
import pytest
import torch

from frameino_tpu.data import write_video as jax_write_video
from frameino_tpu.preprocess import basic_filter as j_basic
from frameino_tpu.preprocess import camera_pose as j_cam
from frameino_tpu.preprocess import captioning as j_cap
from frameino_tpu.preprocess import csv_io as j_csv
from frameino_tpu.preprocess import frameino_labeling as j_lab
from frameino_tpu.preprocess import image_scoring as j_img
from frameino_tpu.preprocess import motion_tracking as j_mot
from frameino_tpu.preprocess import panoptic as j_pan
from frameino_tpu.preprocess import scene_cut as j_cut
from frameino_tpu_torch.data.video_io import write_video
from frameino_tpu_torch.preprocess import basic_filter as t_basic
from frameino_tpu_torch.preprocess import camera_pose as t_cam
from frameino_tpu_torch.preprocess import captioning as t_cap
from frameino_tpu_torch.preprocess import csv_io as t_csv
from frameino_tpu_torch.preprocess import frameino_labeling as t_lab
from frameino_tpu_torch.preprocess import image_scoring as t_img
from frameino_tpu_torch.preprocess import motion_tracking as t_mot
from frameino_tpu_torch.preprocess import panoptic as t_pan
from frameino_tpu_torch.preprocess import scene_cut as t_cut
from frameino_tpu_torch.scripts import run_preprocess_pipeline as t_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(basic=j_basic, cam=j_cam, cap=j_cap, lab=j_lab,
                            img=j_img, mot=j_mot, pan=j_pan, cut=j_cut)
PORT = types.SimpleNamespace(basic=t_basic, cam=t_cam, cap=t_cap, lab=t_lab,
                             img=t_img, mot=t_mot, pan=t_pan, cut=t_cut)


def _same(a, b, path="out"):
    """Exact structural equality: arrays by value and dtype, floats bit for
    bit (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------

def _moving_square(F=20, H=64, W=96, seed=0, dx=0.8, dy=0.4):
    """A bright square moving over a static textured background (JAX's
    curation fixture)."""
    rs = np.random.RandomState(seed)
    bg = rs.randint(10, 60, (H, W, 3)).astype(np.uint8)
    frames = []
    for t in range(F):
        f = bg.copy()
        x, y = 6 + int(dx * t), 8 + int(dy * t)
        f[y:y + 16, x:x + 16] = (220, 180, 60)
        frames.append(f)
    return np.stack(frames)


def _textured(seed=0, h=96, w=128):
    import cv2
    rs = np.random.RandomState(seed)
    return cv2.GaussianBlur(rs.randint(0, 255, (h, w, 3)).astype(np.uint8),
                            (5, 5), 0)


def _panning(n=8, step=2.0, shake=False):
    """A textured frame shifted by ``step`` px a frame (alternating sign
    when ``shake``)."""
    import cv2
    base = _textured(3, 120, 160)
    out = []
    for t in range(n):
        dx = step * ((-1) ** t if shake else t)
        m = np.float32([[1, 0, dx], [0, 1, 0.5 * dx]])
        out.append(cv2.warpAffine(base, m, (160, 120),
                                  borderMode=cv2.BORDER_REFLECT))
    return np.stack(out)


def _camera_infos():
    rs = np.random.RandomState(5)
    infos = {}
    for i in range(7):
        T = 6
        rot = []
        for _ in range(T):
            q, _ = np.linalg.qr(rs.randn(3, 3))
            rot.append((q * np.sign(np.linalg.det(q))).tolist())
        infos[f"clip{i}"] = {
            "rotation": rot, "translation": rs.randn(T, 3).tolist(),
            "focal_x": (500 + 10 * rs.randn(T)).tolist(),
            "focal_y": (500 + 10 * rs.randn(T)).tolist()}
    return infos


def _text_frame():
    import cv2
    img = np.full((120, 200, 3), 255, np.uint8)
    cv2.putText(img, "HELLO WORLD", (8, 50), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (0, 0, 0), 2)
    return img


def _mask():
    m = np.zeros((48, 64), np.uint8)
    m[30:44, 40:58] = 1
    return m


def _sam2_case(P):
    frames = _moving_square(12, 64, 96)
    tracks = [[[14.0 + t * 0.8, 16.0 + t * 0.4], [16.0 + t, 18.0]]
              for t in range(12)]
    boxes = P.lab.find_region_boxes((frames[0, ..., 0] > 200)
                                    .astype(np.uint8))

    def segmenter(sub, points):
        return np.stack([(f[..., 0] > 200).astype(np.uint8) for f in sub])
    import random
    return P.lab.sam2_refine(frames, tracks, segmenter, boxes,
                             min_area_ratio=0.01, rng=random.Random(3))


CASES = {
    "filter_basic": lambda P: P.basic.filter_basic(
        [{"height": 720, "width": 1280, "num_frames": 100},
         {"height": 100, "width": 100, "num_frames": 100},
         {"height": 720, "width": 1280, "num_frames": 10},
         {"height": 480, "width": 1920, "num_frames": 100}]),
    "frame_difference_scores": lambda P: P.cut.frame_difference_scores(
        _moving_square(10)),
    "histogram_cut_scores": lambda P: P.cut.score_scene_cuts(np.concatenate(
        [_moving_square(8, seed=0), _moving_square(8, seed=4)])),
    "longest_clean_span": lambda P: P.cut.longest_clean_span(
        np.array([0, 0.1, 0.9, 0.2, 0.1, 0.7, 0, 0, 0, 0.1]), 0.5),
    "score_images_full": lambda P: P.img.score_images(
        _textured(1), full=True),
    "text_area_score": lambda P: (P.img.detect_text_regions(_text_frame()),
                                  P.img.text_area_score(_text_frame())),
    "aesthetic_complexity": lambda P: (
        P.img.aesthetic_score(_textured(2)),
        P.img.complexity_score(_textured(2)),
        P.img.colorfulness(_textured(2))),
    "prune_by_scores": lambda P: P.img.prune_by_scores(
        [("a", {"clarity": 30.0, "brightness": 0.5}),
         ("b", {"clarity": 3.0, "brightness": 0.5}),
         ("c", {"clarity": 30.0, "brightness": 0.5, "text_area": 0.2})]),
    "sample_points_from_mask": lambda P: P.pan.sample_points_from_mask(
        _mask(), 7, np.random.default_rng(3)),
    "connected_component_panoptic": lambda P:
        P.pan.connected_component_panoptic(_moving_square(1)[0]),
    "run_panoptic_step": lambda P: P.pan.run_panoptic_step(
        _moving_square(3), P.pan.connected_component_panoptic,
        num_points=5, min_area=16, rng=np.random.default_rng(0)),
    "motion_segmenter": lambda P: P.pan.motion_segmenter(
        _moving_square(20)),
    "motion_magnitude_filter": lambda P: (
        P.mot.motion_magnitude(np.cumsum(np.ones((6, 3, 2)), 0)),
        P.mot.motion_magnitude_filter(
            [np.zeros((5, 2, 2)), np.cumsum(np.full((5, 2, 2), 3.0), 0)])),
    "track_step": lambda P: P.mot.track_step(
        _moving_square(6), [[(20, 20), (40, 30)]],
        lambda f, q: np.stack([q + t for t in range(len(f))])),
    "pose_error_math": lambda P: P.cam.calculate_camera_motion(
        _camera_infos()["clip0"]),
    "camera_delete_list": lambda P: sorted(P.cam.make_camera_delete_list(
        _camera_infos())),
    "pose_prune": lambda P: (
        P.cam.pose_translation_stats(np.tile(np.eye(4), (5, 1, 1))),
        P.cam.prune_by_pose_error(np.tile(np.eye(4), (5, 1, 1)),
                                  max_jerk=1.0)),
    "estimate_relative_poses": lambda P: P.cam.estimate_relative_poses(
        _panning(5)),
    "classify_camera_motion": lambda P: (
        P.cam.classify_camera_motion(_panning(6)),
        P.cam.classify_camera_motion(_panning(6, shake=True))),
    "keep_by_camera_motion": lambda P: (
        P.cam.camera_motion_stats(_panning(6)),
        P.cam.keep_by_camera_motion(_panning(6)),
        P.cam.keep_by_camera_motion(_panning(6, step=25.0))),
    "region_boxes_and_crop": lambda P: (
        P.lab.find_region_boxes(_mask()),
        P.lab.crop_id_reference(_textured(4, 48, 64), _mask()),
        P.lab.label_step(_textured(4, 48, 64), _mask())),
    "sam2_refine": _sam2_case,
    "template_captioner": lambda P: [
        P.cap.template_captioner(_moving_square(6, seed=s))
        for s in range(3)],
    "caption_segments": lambda P: P.cap.caption_segments(
        _moving_square(40), [0, 5], vlm=lambda f, p: f"{len(f)}:{len(p)}"),
    "sample_caption_frames": lambda P: P.cap.sample_caption_frames(
        _moving_square(40), 3, 20, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_stage_matches_jax(case):
    """Each numpy / cv2 stage gives JAX's output exactly (tolerance 0)."""
    _same(CASES[case](JAX), CASES[case](PORT), case)


def test_caption_step_refuses_without_a_vlm():
    with pytest.raises(RuntimeError, match="allow_template"):
        t_cap.caption_step(_moving_square(4))
    assert t_cap.caption_step(_moving_square(4), allow_template=True) == \
        j_cap.caption_step(_moving_square(4), allow_template=True)
    assert t_cap.CAPTION_INSTRUCTION == j_cap.CAPTION_INSTRUCTION


def test_csv_writer_and_initial_csv_match_jax(tmp_path):
    """``write_csv`` and ``build_initial_csv`` write JAX's bytes; the port's
    reader (``data/csv_io``, re-exported) reads them back."""
    raw = tmp_path / "raw"
    raw.mkdir()
    write_video(str(raw / "a.mp4"), _moving_square(9))
    write_video(str(raw / "b.mp4"), _moving_square(7, 32, 48))
    assert t_csv.build_initial_csv(str(raw), str(tmp_path / "t" / "x.csv")) \
        == j_csv.build_initial_csv(str(raw), str(tmp_path / "j" / "x.csv"))
    rows = [["a", 1, json.dumps([[1, 2]])], ["b", 2, "x,y"]]
    t_csv.write_csv(str(tmp_path / "t" / "y.csv"), ["v", "n", "j"], rows)
    j_csv.write_csv(str(tmp_path / "j" / "y.csv"), ["v", "n", "j"], rows)
    for name in ("x.csv", "y.csv"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    from frameino_tpu_torch.data import csv_io
    assert t_csv.read_csv_folder is csv_io.read_csv_folder
    header, got = t_csv.read_csv_folder(str(tmp_path / "t"))
    assert header == ["v", "n", "j"] and got[-1] == ["b", "2", "x,y"]


# ---------------------------------------------------------------------------
# process_video and the CLI
# ---------------------------------------------------------------------------

def _args(**kw):
    base = dict(min_frames=30, min_size=32, max_aspect=2.5,
                cut_threshold=0.5, min_clarity=5.0, min_motion=2.0,
                num_points=10, keep_boxes=5, seed=0,
                caption_backend="template")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def raw_clips(tmp_path_factory):
    """Two 60x64x96 fixture clips written by the JAX package's writer
    (backgrounds whose clips the chain keeps: seeds 0 and 6)."""
    raw = tmp_path_factory.mktemp("raw")
    for i, seed in enumerate((0, 6)):
        jax_write_video(str(raw / f"clip{i}.mp4"),
                        _moving_square(60, seed=seed), fps=12)
    return raw


def _jax_process_video():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_run_preprocess_pipeline",
        os.path.join(REPO, "scripts", "run_preprocess_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.process_video


def test_process_video_matches_jax(raw_clips, tmp_path):
    """Both packages' ``process_video`` (classical steps, template
    captions) keep both clips with identical rows and byte-identical ID
    crops."""
    jax_pv = _jax_process_video()
    for name in ("clip0.mp4", "clip1.mp4"):
        steps = {}
        t_out, t_reason = t_run.process_video(
            name, str(raw_clips), str(tmp_path / "t"), _args(),
            step_seconds=steps)
        j_out, j_reason = jax_pv(name, str(raw_clips), str(tmp_path / "j"),
                                 _args())
        assert t_reason is None and j_reason is None, (t_reason, j_reason)
        _same(j_out[0], t_out[0], name)
        assert t_out[1] is None and j_out[1] is None
        assert {"decode", "scene_cut", "camera_pose", "panoptic",
                "caption", "tracking", "frameino_labeling"} <= set(steps)
    # a background whose histogram scores cut the clip below min_frames
    jax_write_video(str(tmp_path / "cut.mp4"), _moving_square(60, seed=1),
                    fps=12)
    assert t_run.process_video("cut.mp4", str(tmp_path), str(tmp_path / "t"),
                               _args()) == \
        jax_pv("cut.mp4", str(tmp_path), str(tmp_path / "j"), _args()) == \
        (None, "scene_cut")
    crops = sorted(os.listdir(tmp_path / "j"))
    assert crops and sorted(os.listdir(tmp_path / "t")) == crops
    for c in crops:
        assert (tmp_path / "t" / c).read_bytes() == \
            (tmp_path / "j" / c).read_bytes(), c


def test_cli_gate_refuses_and_the_csv_feeds_the_dataset(raw_clips, tmp_path,
                                                        capsys):
    """Without ``--allow_classical`` the port's CLI refuses (before any
    clip); with it, it keeps both clips, writes JAX's manifest and summary,
    and the port's ``FrameINODataset`` loads the CSV."""
    out = tmp_path / "FrameINO_data"
    base = ["--video_folder", str(raw_clips), "--output_folder", str(out),
            "--min_frames", "30", "--min_size", "32", "--caption_backend",
            "template", "--device", "cpu"]
    with pytest.raises(SystemExit, match="allow_classical"):
        t_run.main(base)
    assert not out.exists()
    summary = t_run.main(base + ["--allow_classical"])
    stdout = capsys.readouterr().out
    assert summary["kept"] == 2 and "keep clip0.mp4" in stdout
    assert "backend panoptic=classical:motion-residual" in stdout
    assert "WARNING: classical fallback" in stdout
    saved = json.loads((out / "curated.summary.json").read_text())
    assert saved["backends"]["tracking"] == "classical:pyramidal-lk"
    assert saved["backend_runs"] == {}

    from frameino_tpu_torch.data.frameino_dataset import (
        FrameINODataset, FrameINODatasetConfig)
    cfg = FrameINODatasetConfig(
        target_height=32, target_width=64, sample_accelerate_factor=1,
        train_frame_num_range=(13, 13), min_train_frame_num=9,
        dot_radius=45, drop_FrameIn_prob=0.0,
        point_keep_ratio_regular=1.0, point_keep_ratio_ID=1.0)
    ds = FrameINODataset(cfg, str(tmp_path.parent), os.path.join(
        tmp_path.name, "FrameINO_data", "dataset_csv_files"),
        os.path.relpath(raw_clips, tmp_path.parent), os.path.join(
            tmp_path.name, "FrameINO_data", "video_dataset",
            "train_ID_FrameIn"), seed=0)
    assert len(ds) == 2
    item = ds[0]
    assert item["video_tensor"].shape == (13, 3, 32, 64)
    assert np.abs(np.asarray(item["traj_tensor"])).max() > 0


@pytest.fixture
def one_torch_thread():
    """Tiny models: one intra-op thread. Beside five other pytest-xdist
    workers, OpenMP regions of many threads over tiny ops wait on each
    other (on a CPU host: 331 s so with the default thread count, 18 s
    with one thread and no other worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def labelled_clips(tmp_path_factory):
    """``chip_smoke.labelled_clip`` at 60x120x200 (Motion-JPEG), twice:
    clip1 is a copy of clip0, so VGGT gives both the same camera_info and
    the reference's ranked pruning, which deletes the top 40% of each
    ranking, deletes the copy (ties keep the order the clips came in)."""
    from chip_smoke import _write_avi, labelled_clip
    raw = tmp_path_factory.mktemp("labelled")
    frames = labelled_clip(2, 60, 120, 200)
    for i in range(2):
        _write_avi(str(raw / f"clip{i}.avi"), frames)
    return raw


def test_cli_runs_every_learned_backend(labelled_clips, tmp_path,
                                        monkeypatch, one_torch_thread):
    """Every learned step from checkpoints written in the released layouts
    (OneFormer ``.pth`` with its "model" dict, VGGT ``.pt``, CoTracker3,
    SAM2.1, a Qwen2.5-VL directory), at tiny configs on the CPU: the
    manifest names no classical step, each backend is called once a clip
    it reaches, and the summary holds its calls and seconds. SAM2.1's
    mask path reads brightness (``chip_smoke.sam2_reads_brightness``), so
    clip0 is labelled from SAM2.1's masks and kept: its ID crops are
    written and the port's ``FrameINODataset`` loads its row; the copy
    goes to the camera ranking."""
    import functools

    from chip_smoke import sam2_reads_brightness

    from frameino_tpu_torch.evaluation import perception
    from frameino_tpu_torch.models import cotracker, sam2, vggt
    from frameino_tpu_torch.models import qwen_vl as Q
    from frameino_tpu_torch.models.safetensors_io import save_file
    from frameino_tpu_torch.ops.attention import attention_ref
    from tests.test_torch_oneformer import tiny_of_config
    from tests.test_torch_qwen_vl import CFG as QCFG
    from tests.test_torch_qwen_vl import StubProcessor

    from frameino_tpu_torch.models.oneformer import init_oneformer
    of_cfg = tiny_of_config()
    of_sd = init_oneformer(of_cfg, torch.Generator().manual_seed(0))
    torch.save({"model": of_sd}, tmp_path / "oneformer.pth")
    vcfg = vggt.tiny_vggt_config()
    vsd = vggt.init_vggt(vcfg, torch.Generator().manual_seed(1))
    vsd["camera_head.pose_branch.fc2.bias"][7:] = 1.0
    torch.save(vsd, tmp_path / "vggt.pt")
    ccfg = cotracker.tiny_cotracker_config()
    torch.save({"model": cotracker.init_cotracker(
        ccfg, torch.Generator().manual_seed(2)).state_dict()},
        tmp_path / "cotracker.pth")
    scfg = sam2.tiny_sam2_config()
    torch.save({"model": sam2_reads_brightness(sam2.init_sam2(
        scfg, torch.Generator().manual_seed(3))).state_dict()},
        tmp_path / "sam2.pt")
    qdir = tmp_path / "qwen"
    qdir.mkdir()
    (qdir / "config.json").write_text(json.dumps(Q.qwen_vl_config_to_json(
        QCFG)))
    save_file(Q.init_qwen_vl(QCFG, torch.Generator().manual_seed(4),
                             dtype=torch.float32).state_dict(),
              str(qdir / "model.safetensors"))

    from frameino_tpu_torch.models import cotracker as C
    from frameino_tpu_torch.models import sam2_video as SV
    from frameino_tpu_torch.preprocess import panoptic_oneformer as PO
    # the tiny models at small input sizes: OneFormer's 800-pixel short
    # edge and VGGT's 518-pixel width are the released models' own
    monkeypatch.setattr(perception, "load_oneformer_checkpoint",
                        lambda path, device, **kw:
                        PO.load_oneformer_segmenter(
                            path, cfg=of_cfg, device=device, min_size=64,
                            max_size=96, **kw))
    monkeypatch.setattr(vggt, "preprocess_frames", functools.partial(
        vggt.preprocess_frames, target=28))
    monkeypatch.setattr(perception, "load_vggt_checkpoint",
                        lambda path, device: vggt.load_vggt_camera(
                            path, cfg=vcfg, device=device))
    monkeypatch.setattr(vggt, "_bf16_attention", attention_ref)
    monkeypatch.setattr(C, "load_cotracker_torch", functools.partial(
        C.load_cotracker_torch, cfg=ccfg))
    monkeypatch.setattr(SV, "load_sam2_torch", functools.partial(
        SV.load_sam2_torch, cfg=scfg))
    out = tmp_path / "out"
    summary = t_run.main(
        ["--video_folder", str(labelled_clips), "--output_folder",
         str(out), "--min_frames", "30", "--min_size", "32", "--device",
         "cpu", "--panoptic_checkpoint", str(tmp_path / "oneformer.pth"),
         "--camera_checkpoint", str(tmp_path / "vggt.pt"),
         "--cotracker_checkpoint", str(tmp_path / "cotracker.pth"),
         "--id_refine", "sam2", "--sam2_checkpoint",
         str(tmp_path / "sam2.pt"), "--caption_backend", "qwen_checkpoint",
         "--caption_model", str(qdir), "--min_motion", "0"],
        processor=StubProcessor())
    assert not any(b.startswith("classical:")
                   for b in summary["backends"].values())
    runs = summary["backend_runs"]
    assert sorted(runs) == ["camera", "caption", "id_refine", "panoptic",
                            "tracking"]
    for step in ("camera", "panoptic", "caption", "tracking"):
        assert runs[step]["calls"] == 2, (step, runs[step])
    assert runs["id_refine"]["calls"] >= 1
    assert all(r["peak_gib"] is None and r["seconds"] > 0
               for r in runs.values())
    assert set(summary["step_seconds"]) == {"clip0.avi", "clip1.avi"}
    assert summary["kept"] == 1 and summary["dropped"] == {
        "clip1.avi": "camera_pose"}, summary
    crops = sorted(os.listdir(out / "video_dataset" / "train_ID_FrameIn"))
    assert crops[0].startswith("clip0_") and len(crops) >= 2, crops
    from frameino_tpu_torch.data.frameino_dataset import (
        FrameINODataset, FrameINODatasetConfig)
    cfg = FrameINODatasetConfig(
        target_height=32, target_width=64, sample_accelerate_factor=1,
        train_frame_num_range=(13, 13), min_train_frame_num=9,
        dot_radius=45, drop_FrameIn_prob=0.0,
        point_keep_ratio_regular=1.0, point_keep_ratio_ID=1.0)
    ds = FrameINODataset(cfg, str(tmp_path.parent), os.path.join(
        tmp_path.name, "out", "dataset_csv_files"),
        os.path.relpath(labelled_clips, tmp_path.parent), os.path.join(
            tmp_path.name, "out", "video_dataset", "train_ID_FrameIn"),
        seed=0)
    assert len(ds) == 1
    assert ds[0]["video_tensor"].shape == (13, 3, 32, 64)
