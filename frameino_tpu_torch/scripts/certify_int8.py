"""int8 serving quality certification: the metrics of bf16 and int8 serving
side by side (counterpart of ``scripts/certify_int8.py``).

Runs ``python -m frameino_tpu_torch.evaluate --backends naive`` twice a
family on one synthetic validation set (JAX's fixture, written with
``data/fixture.py``), the same seed and config with and without
``--quantize int8``, then holds each metric's difference under JAX's
budgets and the generated clips of the two runs to ``MIN_PSNR_DB`` of each
other. This is the gate behind quoting the port's int8 serving: it may be
called "matching" only when the certification passes.

    python -m frameino_tpu_torch.scripts.certify_int8 --output_dir DIR \\
        [--device cuda|cpu] [--families wan cogvideox] [--report PATH]

``--device cuda`` (the default; it raises without a card) certifies the
card's int8 path, K7 then ``torch._int_mm`` and JAX's dequant, at the
families' full widths on seeded random weights (``evaluate`` without
``--smoke``, each text length the model's own): the tiny models' head
dims (24 and 16) are outside the card's attention kernels (64 and 128).
``--device cpu`` runs JAX's certification, the tiny models under
``evaluate --smoke``, with the kernels' plain versions.

The report goes to ``--report`` (default ``DIR/int8_parity.json``); the
exit code is 0 when every family passes. ``certify_family(...,
in_process=True)`` runs the two evaluations in this process.

Differences from JAX: JAX's script looks for ``instance0/generated.mp4``,
a file the artifact contract does not write (it writes ``gen_video.mp4``),
so JAX never checked the PSNR; here the clips are read and a missing clip
fails the family. The tiny CogVideoX runs at its sample grid, 9 frames at
32x32: at JAX's 13 frames it decodes 16, which the port's mass evaluation
refuses to score (JAX scores the mismatched frames silently).
``--quantize_vae`` (the int8 Wan VAE) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

from frameino_tpu_torch.models.quant import VAE_NOT_PORTED
from frameino_tpu_torch.scripts import pick_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# |metric(int8) - metric(bf16)| must stay under these. TrajError is pixels
# at the 256x384 eval canvas; VSeg_MAE is mask-area percent; Relative_DINO
# is cosine-similarity space; VLM is a yes-rate in [0, 1] and must not
# flip on the fixture.
BUDGETS = {
    "INO_TrajError": 2.0,
    "INO_VSeg_MAE": 5.0,
    "Relative_DINO": 0.05,
    "INO_VLM": 0.0,
}
MIN_PSNR_DB = 20.0       # the bf16 and int8 generated pixels
EVAL_TIMEOUT_S = 1800
FIXTURE_HWF = (48, 64, 30)
# each family's eval shape (height, width, frames): JAX's for Wan, the tiny
# CogVideoX's sample grid for CogVideoX
EVAL_SHAPES = {"wan": (32, 64, 13), "cogvideox": (32, 32, 9)}
# the text tokens each family's prompt embedding holds: the tiny models'
# (JAX's fixture) on the CPU, the full-width models' own on the card
TEXT_LEN = {"cpu": {"wan": 8, "cogvideox": 8},
            "cuda": {"wan": 512, "cogvideox": 226}}


def make_fixture(root: str, device: str = "cpu") -> Dict[str, str]:
    """JAX's fixture: one random 30-frame 64x48 clip (seed 0), a 20x16 ID
    crop, two CSV rows tracking one point from (2, 5) at (1, 0.5) a frame;
    an eval config a family (2 steps, at ``EVAL_SHAPES``, with
    ``TEXT_LEN[device]`` text tokens). Returns {family: the config's
    path}."""
    from frameino_tpu_torch.data.fixture import (write_eval_config,
                                                 write_fixture_dataset)
    H, W, F = FIXTURE_HWF
    track = [[[2 + 1.0 * t, 5 + 0.5 * t]] for t in range(F)]
    data = write_fixture_dataset(root, H, W, F, track=track,
                                 box=[[500, [5, 2], [62, 46]]],
                                 id_hw=(20, 16))
    return {family: write_eval_config(
        os.path.join(root, f"eval_{family}.yaml"), data, h, w, f, steps=2,
        min_train_frame_num=9, dot_radius=45,
        max_text_seq_length=TEXT_LEN[device][family], seed=0)
        for family, (h, w, f) in EVAL_SHAPES.items()}


def run_eval(cfg_path: str, out_dir: str, family: str, quantize: bool,
             in_process: bool = False, device: str = "cpu") -> Dict:
    """One ``evaluate`` run on ``device`` (one frame-in instance, the naive
    backends; the tiny models under ``--smoke`` on the CPU); returns its
    results.json."""
    argv = ["--config_path", cfg_path, "--output_dir", out_dir,
            "--mode", "frame_in", "--family", family, "--device", device,
            "--num_instances", "1", "--backends", "naive"]
    if device == "cpu":
        argv.append("--smoke")
    if quantize:
        argv += ["--quantize", "int8"]
    if in_process:
        from frameino_tpu_torch import evaluate
        evaluate.main(argv)
    else:
        r = subprocess.run(
            [sys.executable, "-m", "frameino_tpu_torch.evaluate", *argv],
            capture_output=True, text=True, timeout=EVAL_TIMEOUT_S, cwd=REPO)
        if r.returncode != 0:
            raise RuntimeError(f"{family} quantize={quantize} failed:\n"
                               + r.stderr[-3000:])
    with open(os.path.join(out_dir, "results.json")) as f:
        return json.load(f)


def video_psnr(path_a: str, path_b: str) -> float:
    from frameino_tpu_torch.data.video_io import decode_video
    a = decode_video(path_a).astype(np.float64)
    b = decode_video(path_b).astype(np.float64)
    n = min(len(a), len(b))
    mse = float(np.mean((a[:n] - b[:n]) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def compare(bf16: Dict, int8: Dict, psnr) -> Dict:
    """The family's report: each budgeted metric both runs have, its delta
    against its budget, and the clips' PSNR (None: a clip is missing, which
    fails) against MIN_PSNR_DB."""
    report = {"metrics": {}, "pass": True}
    for metric, budget in BUDGETS.items():
        if metric not in bf16:
            continue
        delta = abs(float(int8[metric]) - float(bf16[metric]))
        ok = delta <= budget
        report["metrics"][metric] = {
            "bf16": float(bf16[metric]), "int8": float(int8[metric]),
            "delta": delta, "budget": budget, "pass": ok}
        report["pass"] &= ok
    report["generated_psnr_db"] = psnr
    report["psnr_pass"] = bool(psnr is not None and psnr >= MIN_PSNR_DB)
    report["pass"] &= report["psnr_pass"]
    return report


def certify_family(cfg_path: str, out_root: str, family: str,
                   in_process: bool = False, device: str = "cpu") -> Dict:
    dirs = {q: os.path.join(out_root, f"{family}_{'int8' if q else 'bf16'}")
            for q in (False, True)}
    runs = {q: run_eval(cfg_path, d, family, q, in_process, device)
            for q, d in dirs.items()}
    clips = [os.path.join(d, "instance0", "gen_video.mp4")
             for d in dirs.values()]
    psnr = video_psnr(*clips) if all(map(os.path.exists, clips)) else None
    return compare(runs[False], runs[True], psnr)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the full-width models) or cpu (the "
                        "tiny models)")
    p.add_argument("--families", nargs="+", default=["wan", "cogvideox"],
                   choices=["wan", "cogvideox"])
    p.add_argument("--report", default=None,
                   help="the certification JSON (default "
                        "<output_dir>/int8_parity.json)")
    p.add_argument("--quantize_vae", action="store_true",
                   help="the int8 Wan VAE: not ported")
    return p.parse_args(argv)


def main(argv=None, in_process: bool = False) -> int:
    args = parse_args(argv)
    if args.quantize_vae:
        raise SystemExit(f"--quantize_vae: {VAE_NOT_PORTED}")
    device = pick_device(args.device).type
    os.makedirs(args.output_dir, exist_ok=True)
    configs = make_fixture(args.output_dir, device)
    report, ok = {"device": torch.cuda.get_device_name()
                  if device == "cuda" else "cpu"}, True
    for family in args.families:
        report[family] = certify_family(configs[family], args.output_dir,
                                        family, in_process, device)
        ok &= report[family]["pass"]
        print(f"{family}: {'PASS' if report[family]['pass'] else 'FAIL'} "
              f"psnr {report[family]['generated_psnr_db']} "
              f"{json.dumps(report[family]['metrics'])}")
    report["certified"] = bool(ok)
    out = args.report or os.path.join(args.output_dir, "int8_parity.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"int8 certification {'PASSED' if ok else 'FAILED'} -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
