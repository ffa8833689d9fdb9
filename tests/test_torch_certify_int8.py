"""The port's int8 certification (``frameino_tpu_torch/scripts/
certify_int8.py``) against JAX's ``scripts/certify_int8.py``: the same
fixture, the same budgets and their logic, one family certified in
process; both families through subprocesses are ``slow``.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import certify_int8 as jcert  # noqa: E402

from frameino_tpu_torch.data.video_io import decode_video  # noqa: E402
from frameino_tpu_torch.scripts import certify_int8 as C  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread. With six pytest-xdist workers on
    the host's cores, OpenMP regions of many threads over tiny ops wait on
    descheduled threads (a 3 s test read 154 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(data):
    with open(os.path.join(data, "csvs", "d.csv")) as f:
        return list(csv.reader(f))


def test_fixture_and_budgets_match_jax(tmp_path):
    """The port's writers give JAX's validation set (CSV rows, ID crop,
    clip) and the Wan eval config JAX's keys; the budgets are JAX's."""
    assert C.BUDGETS == jcert.BUDGETS and C.MIN_PSNR_DB == jcert.MIN_PSNR_DB
    jcfg = jcert.make_fixture(str(tmp_path / "jax"))
    configs = C.make_fixture(str(tmp_path / "port"))
    jdata = str(tmp_path / "jax" / "data")
    tdata = str(tmp_path / "port" / "data")
    assert _rows(tdata) == _rows(jdata)
    for rel in (("ids", "obj0.png"),):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(tdata, *rel))),
            np.asarray(Image.open(os.path.join(jdata, *rel))))
    np.testing.assert_array_equal(
        decode_video(os.path.join(tdata, "videos", "v0.mp4")),
        decode_video(os.path.join(jdata, "videos", "v0.mp4")))
    with open(jcfg) as f:
        want = yaml.safe_load(f)
    with open(configs["wan"]) as f:
        got = yaml.safe_load(f)
    for k, v in want.items():
        if k != "download_folder_path":
            assert got[k] == v, k
    assert os.path.samefile(got["download_folder_path"], tdata)
    with open(configs["cogvideox"]) as f:
        cog = yaml.safe_load(f)
    assert (cog["target_height"], cog["target_width"],
            cog["train_frame_num_range"]) == (32, 32, [9, 9])


def test_budget_logic():
    """Every budgeted metric both runs have is held to its budget (a VLM
    flip fails at budget 0); a metric the run lacks is skipped; the clips'
    PSNR must reach MIN_PSNR_DB, and a missing clip fails."""
    base = {"INO_TrajError": 10.0, "INO_VSeg_MAE": 1.0,
            "Relative_DINO": 0.1, "INO_VLM": 1.0}
    near = dict(base, INO_TrajError=11.9, INO_VSeg_MAE=5.9,
                Relative_DINO=0.149)
    r = C.compare(base, near, 30.0)
    assert r["pass"] and r["psnr_pass"]
    assert set(r["metrics"]) == set(C.BUDGETS)
    for metric, bad in (("INO_TrajError", 12.1), ("INO_VSeg_MAE", 6.1),
                        ("Relative_DINO", 0.151), ("INO_VLM", 0.5)):
        r = C.compare(base, dict(base, **{metric: bad}), 30.0)
        assert not r["pass"] and not r["metrics"][metric]["pass"], metric
    out = {k: v for k, v in base.items() if k != "Relative_DINO"}
    assert set(C.compare(out, out, 30.0)["metrics"]) == \
        set(C.BUDGETS) - {"Relative_DINO"}
    assert not C.compare(base, base, C.MIN_PSNR_DB - 1e-9)["pass"]
    assert C.compare(base, base, C.MIN_PSNR_DB)["pass"]
    r = C.compare(base, base, None)
    assert not r["pass"] and r["generated_psnr_db"] is None


def test_certify_wan_in_process(tmp_path):
    """One family through ``evaluate --smoke`` twice in this process: the
    budgets hold, the two clips agree to more than MIN_PSNR_DB, and the
    report goes where ``--report`` says."""
    report_path = tmp_path / "report.json"
    rc = C.main(["--output_dir", str(tmp_path / "out"), "--families", "wan",
                 "--device", "cpu", "--report", str(report_path)],
                in_process=True)
    report = json.loads(report_path.read_text())
    assert rc == 0 and report["certified"] is True
    assert report["device"] == "cpu"
    wan = report["wan"]
    assert wan["pass"] and set(wan["metrics"]) == set(C.BUDGETS)
    assert wan["generated_psnr_db"] >= C.MIN_PSNR_DB
    assert not (tmp_path / "out" / "INT8_PARITY.json").exists()
    # the wan int8 side with its VAE quantized too certifies as well
    vae_report = tmp_path / "vae.json"
    assert C.main(["--output_dir", str(tmp_path / "vae"), "--families", "wan",
                   "--device", "cpu", "--quantize_vae", "--report",
                   str(vae_report)], in_process=True) == 0
    vae = json.loads(vae_report.read_text())
    assert vae["certified"] is True and vae["wan"]["pass"]
    assert vae["wan"]["generated_psnr_db"] >= C.MIN_PSNR_DB


def test_certify_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """``--device`` defaults to cuda, which raises without a card (no
    fallback to the CPU); on the card the families run at full width with
    their own text lengths, on the CPU the tiny models under --smoke."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        C.main(["--output_dir", str(tmp_path / "out"), "--families", "wan"])
    assert C.parse_args(["--output_dir", "x"]).device == "cuda"
    configs = C.make_fixture(str(tmp_path / "card"), "cuda")
    for family, n in (("wan", 512), ("cogvideox", 226)):
        with open(configs[family]) as f:
            assert yaml.safe_load(f)["max_text_seq_length"] == n
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return C.subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(C.subprocess, "run", fake_run)
    out = tmp_path / "run"
    out.mkdir()
    (out / "results.json").write_text("{}")
    for device in ("cuda", "cpu"):
        C.run_eval(configs["wan"], str(out), "wan", True, device=device)
        argv = calls[-1]
        assert argv[argv.index("--device") + 1] == device
        assert ("--smoke" in argv) == (device == "cpu")
        assert argv[argv.index("--quantize") + 1] == "int8"


@pytest.mark.slow
def test_certify_both_families_subprocess(tmp_path):
    rc = C.main(["--output_dir", str(tmp_path), "--device", "cpu"])
    report = json.loads((tmp_path / "int8_parity.json").read_text())
    assert rc == 0 and report["certified"]
    assert report["wan"]["pass"] and report["cogvideox"]["pass"]
