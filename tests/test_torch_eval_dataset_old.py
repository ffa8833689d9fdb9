"""The port's paper-v1.0 dataset (``data/frameino_dataset_old.py``, behind
``evaluate --schema old``) against JAX's on the fixture of
``tests/test_frameino_dataset_old.py``: every item equal."""

import numpy as np
import pytest

from frameino_tpu.data import FrameINODatasetOld as JOld
from frameino_tpu_torch.data.frameino_dataset_old import \
    FrameINODatasetOld as TOld
from tests.test_frameino_dataset_old import old_fixture  # noqa: F401


def _make(cls, root, **kw):
    cfg = {"dataset_folder_path": str(root / "videos"),
           "ID_folder_path": str(root / "ids"),
           "height": 32, "width": 64, "preset_decode_fps": 16,
           "train_frame_num": 13, "dot_radius": 45,
           "point_keep_ratio_regular": 1.0, "point_keep_ratio_ID": 1.0}
    return cls(cfg, str(root / "csvs"), seed=0, **kw)


@pytest.mark.parametrize("kw", [
    dict(strict_validation_match=True),
    dict(strict_validation_match=True, FrameOut_only=True,
         one_point_one_obj=True),
    dict()], ids=["frame_in", "frame_out", "random"])
def test_items_equal_jax(old_fixture, kw):  # noqa: F811
    j, t = _make(JOld, old_fixture, **kw), _make(TOld, old_fixture, **kw)
    assert len(t) == len(j) == 2
    for idx in range(len(j)):
        a, b = j[idx], t[idx]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                assert b[k] == a[k], k


def test_evaluate_entry_reads_the_old_schema(old_fixture, tmp_path):  # noqa: F811
    """``evaluate --schema old --smoke`` on the fixture: one instance
    generated, its Main_Reference.png written and scored."""
    import yaml

    from frameino_tpu_torch import evaluate
    cfg = {"download_folder_path": str(old_fixture),
           "validation_csv_relative_path": "csvs",
           "validation_video_relative_path": "videos",
           "validation_ID_relative_path": "ids",
           "target_height": 32, "target_width": 64,
           "train_frame_num_range": [13, 13], "preset_decode_fps": 16,
           "dot_radius": 45, "num_inference_steps": 2,
           "max_text_seq_length": 8}
    path = tmp_path / "old.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    res = evaluate.main(["--config_path", str(path), "--output_dir",
                         str(out), "--smoke", "--num_instances", "1",
                         "--schema", "old"])["results"]
    assert (out / "instance0" / "Main_Reference.png").exists()
    assert res["_num_instances"] == 1 and np.isfinite(res["INO_TrajError"])
