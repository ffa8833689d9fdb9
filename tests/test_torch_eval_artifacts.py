"""The port's evaluation package (``frameino_tpu_torch/evaluation``)
against JAX's: the artifact layout in both directions, the naive backends
and metric cores, the frame-count check, and the real-backend loaders'
loud failure."""

import os
import pickle

import numpy as np
import pytest

from frameino_tpu.evaluation import metrics as jmetrics
from frameino_tpu.evaluation import perception as jperc
from frameino_tpu.evaluation.mass_evaluation import \
    mass_evaluation as jmass_eval
from frameino_tpu.evaluation.artifacts import \
    write_instance_artifacts as jwrite
from frameino_tpu.preprocess import lk_tracker as jlk
from frameino_tpu_torch.evaluation import metrics as tmetrics
from frameino_tpu_torch.evaluation import perception as tperc
from frameino_tpu_torch.evaluation.mass_evaluation import \
    mass_evaluation as tmass_eval
from frameino_tpu_torch.evaluation.artifacts import \
    write_instance_artifacts as twrite
from frameino_tpu_torch.preprocess import lk_tracker as tlk

H, W, F = 64, 96, 6
BOX = ((16, 16), (80, 48))
FRAME_IN = ("INO_TrajError", "INO_VSeg_MAE", "Relative_DINO", "INO_VLM")
FRAME_OUT = ("INO_TrajError", "INO_VSeg_MAE", "INO_VLM")


def _instances(seed=0):
    """Two instances of a moving textured square: gen == gt, and gen
    shifted."""
    rs = np.random.RandomState(seed)
    meta = {"full_pred_tracks": [[[(30, 30), (40, 36)]]] * F,
            "original_width": W, "original_height": H,
            "mask_region": BOX, "resized_mask_region_box": BOX}
    bg = rs.randint(0, 255, (H, W, 3)).astype(np.uint8)
    tex = rs.randint(0, 255, (16, 16, 3)).astype(np.uint8)
    gt = np.stack([bg] * F)
    for t in range(F):
        gt[t, 24:40, 24 + 3 * t:40 + 3 * t] = tex
    ref = rs.randint(0, 255, (20, 20, 3)).astype(np.uint8)
    return [(gt, gt.copy(), meta, ref), (gt, np.roll(gt, 5, axis=2), meta,
                                         ref)]


def _write(writer, root):
    for i, (gt, gen, meta, ref) in enumerate(_instances()):
        writer(str(root), i, gt, gen, meta, "the toy enters the scene", ref)
    return str(root)


def _score(mass_evaluation, backends, root, frame_in, tmp_path, tag):
    return mass_evaluation(
        root, FRAME_IN if frame_in else FRAME_OUT, backends,
        test_num_frames=F, is_frame_in=frame_in,
        store_json_path=str(tmp_path / f"{tag}.json"))


@pytest.mark.parametrize("frame_in", [True, False],
                         ids=["frame_in", "frame_out"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mass_evaluation_matches_jax(tmp_path, writer, frame_in):
    """One package writes the instances; each scores them with its naive
    backends: the same results.json metric values (1e-6)."""
    root = _write(jwrite if writer == "jax" else twrite, tmp_path / "a")
    want = _score(jmass_eval, jperc.naive_backends(), root, frame_in,
                  tmp_path, "jax")
    got = _score(tmass_eval, tperc.naive_backends(), root, frame_in,
                 tmp_path, "port")
    assert got["_num_instances"] == want["_num_instances"] == 2
    assert set(got["_timings_s"]) == set(want["_timings_s"])
    for k in (FRAME_IN if frame_in else FRAME_OUT):
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    assert got["INO_TrajError"] > 0


def test_writers_write_the_same_files(tmp_path):
    j = _write(jwrite, tmp_path / "jax")
    t = _write(twrite, tmp_path / "port")
    for inst in ("instance0", "instance1"):
        names = sorted(os.listdir(os.path.join(j, inst)))
        assert names == sorted(os.listdir(os.path.join(t, inst)))
        for n in names:
            if n.endswith(".mp4"):
                continue
            with open(os.path.join(j, inst, n), "rb") as a, \
                    open(os.path.join(t, inst, n), "rb") as b:
                if n.endswith(".pkl"):
                    assert pickle.load(a) == pickle.load(b), n
                else:
                    assert a.read() == b.read(), n


def test_frame_counts_must_agree(tmp_path):
    """A missing generated frame: JAX scores the instance at other frame
    indices than the ground truth; the port refuses it and names it."""
    root = _write(twrite, tmp_path / "a")
    os.remove(os.path.join(root, "instance1", f"gen_padded_frame{F - 1}.png"))
    jmass_eval(root, ["INO_VLM"], jperc.naive_backends(), test_num_frames=F,
               is_frame_in=True, store_json_path=str(tmp_path / "j.json"))
    with pytest.raises(ValueError, match="instance1"):
        tmass_eval(root, ["INO_VLM"], tperc.naive_backends(),
                   test_num_frames=F, is_frame_in=True,
                   store_json_path=str(tmp_path / "t.json"))


def test_naive_backends_and_metric_cores_match_jax():
    gt, gen, meta, ref = _instances()[1]
    q = np.array([[30.0, 30.0], [40.0, 36.0]], np.float32)
    for name in ("tracker", "segmenter", "embedder", "judge"):
        jb, tb = jperc.naive_backends()[name], tperc.naive_backends()[name]
        args = {"tracker": (gen, q), "segmenter": (gen, q),
                "embedder": (ref,), "judge": (gen, "p", True)}[name]
        np.testing.assert_array_equal(tb(*args), jb(*args), err_msg=name)
    np.testing.assert_array_equal(tperc.naive_tracker(gen, q),
                                  jperc.naive_tracker(gen, q))
    for fn in ("lk_track", "lk_track_cycle"):
        for a, b in zip(getattr(tlk, fn)(gen, q), getattr(jlk, fn)(gen, q)):
            np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(1)
    a, b = rs.rand(F, 3, 2) * 50, rs.rand(F, 3, 2) * 50
    m1, m2 = rs.rand(F, H, W) > 0.5, rs.rand(F, H, W) > 0.5
    assert tmetrics.traj_error_from_tracks(a, b) == \
        jmetrics.traj_error_from_tracks(a, b)
    assert tmetrics.vseg_mae_from_masks(m1, m2, BOX) == \
        jmetrics.vseg_mae_from_masks(m1, m2, BOX)
    assert tmetrics.relative_dino_from_sims([0.3, -0.1], [0.5, 0.6]) == \
        jmetrics.relative_dino_from_sims([0.3, -0.1], [0.5, 0.6])
    assert tmetrics.region_scaled_canvas(480, 832, BOX) == \
        jmetrics.region_scaled_canvas(480, 832, BOX)
    assert tmetrics.vlm_success_rate(["Yes", "no", "Yes."]) == \
        jmetrics.vlm_success_rate(["Yes", "no", "Yes."])


def test_default_backends_fail_loudly(tmp_path, monkeypatch):
    """Without weights on disk, every real backend fails, and the error
    names the explicit alternative; nothing reaches for the network (an
    empty torch.hub cache, the Hugging Face hub offline)."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="naive") as e:
        tperc.load_default_backends()
    for name in ("tracker", "segmenter", "embedder", "judge"):
        assert f"{name}:" in str(e.value)
    with pytest.raises(RuntimeError, match="NotImplementedError.*ROADMAP"):
        tperc.load_default_backends(qwen_checkpoint=str(tmp_path))
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        tperc.load_default_backends(
            cotracker_checkpoint=str(tmp_path / "none.pth"),
            dinov2_checkpoint=str(tmp_path / "none.pth"),
            sam2_checkpoint=str(tmp_path / "none.pt"),
            vlm_endpoint="http://127.0.0.1:1", device="cpu")


def test_vlm_http_judge_builds_its_request():
    """The OpenAI-compatible judge fails with a connection error (nothing
    listens on the loopback port), not in building the request."""
    import urllib.error
    judge = tperc.load_vlm_judge_http("http://127.0.0.1:1", timeout=0.2)
    with pytest.raises((urllib.error.URLError, OSError)):
        judge(np.zeros((2, 8, 8, 3), np.uint8), "prompt", True)
