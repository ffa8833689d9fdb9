"""The slice as a whole: the port's ``python -m frameino_tpu_torch.evaluate
--smoke --device cpu`` against JAX's ``scripts/run_frameino_mass_evaluation.py
--smoke`` on one synthetic validation set (``data/fixture.py``), the tiny
Wan2.2 weights of JAX's smoke run carried across (``init_wan_dit`` at
``key(0)``, the VAE at ``fold_in(key, 1)``, written as checkpoint
directories for the port) and JAX's initial latents (``normal(key(idx))``)
handed to the port."""

import json
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest

from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.pipelines.wan_i2v import latent_shape
from frameino_tpu_torch import evaluate, serve
from frameino_tpu_torch.data.fixture import (write_eval_config,
                                             write_fixture_dataset)
from frameino_tpu_torch.models import pretrained
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (wan_dit_from_jax,
                                               wan_vae_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, F = 32, 64, 13
METRICS = ("INO_TrajError", "INO_VSeg_MAE", "Relative_DINO", "INO_VLM")


def _jax_smoke_weights_as_dirs(root):
    """JAX's smoke Wan models (its script's ``build_pipeline``) as the
    port's checkpoint directories."""
    dcfg, vcfg = serve.smoke_configs()
    jvcfg = jvae.WanVAEConfig(
        base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
        temperal_downsample=(True,), is_residual=False,
        scale_factor_temporal=2, scale_factor_spatial=2,
        latents_mean=tuple([0.0] * 4), latents_std=tuple([1.0] * 4))
    key = jax.random.key(0)
    dit_p = jax.tree.map(np.asarray, jdit.init_wan_dit(
        key, jdit.tiny_config(in_channels=8, out_channels=4)))
    # jitted: the same draws as the script's eager init, a third the time
    vae_p = jax.tree.map(np.asarray, jax.jit(
        jvae.init_wan_vae, static_argnums=1)(jax.random.fold_in(key, 1),
                                             jvcfg))
    dit = tdit.WanDiT(dcfg, device="meta")
    dit.load_state_dict(wan_dit_from_jax(dit_p, dcfg), strict=True,
                        assign=True)
    vae = tvae.WanVAE(vcfg, device="meta")
    vae.load_state_dict(wan_vae_from_jax(vae_p, vcfg), strict=True,
                        assign=True)
    pretrained.save_pretrained(os.path.join(root, "transformer"), dcfg, dit)
    pretrained.save_pretrained(os.path.join(root, "vae"), vcfg, vae)
    return jvcfg


def _frames(inst, kind):
    n = len([f for f in os.listdir(inst) if f.startswith(kind)])
    return np.stack([cv2.imread(os.path.join(inst, f"{kind}{i}.png"))
                     for i in range(n)]).astype(np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_slice")
    data = write_fixture_dataset(str(root), 48, 64, 30, start=(16.0, 12.0))
    jcfg_path = write_eval_config(str(root / "jax.yaml"), data, H, W, F,
                                  max_text_seq_length=8)
    jvcfg = _jax_smoke_weights_as_dirs(str(root / "weights"))
    tcfg_path = write_eval_config(
        str(root / "port.yaml"), data, H, W, F, max_text_seq_length=8,
        pretrained_transformer_path=str(root / "weights" / "transformer"),
        pretrained_vae_path=str(root / "weights" / "vae"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "scripts", "run_frameino_mass_evaluation.py"),
         "--config_path", jcfg_path, "--output_dir", str(root / "jax"),
         "--smoke", "--num_instances", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    shape = latent_shape(jvcfg, 1, F, H, W)

    def latents_for(idx):
        import torch
        return torch.from_numpy(np.array(
            jax.random.normal(jax.random.key(idx), shape)))
    results = evaluate.main(["--config_path", tcfg_path, "--output_dir",
                             str(root / "port"), "--smoke", "--device",
                             "cpu", "--num_instances", "1"],
                            latents_for=latents_for)["results"]
    with open(root / "jax" / "results.json") as f:
        return root, results, json.load(f)


def test_generated_frames_match_jax(runs):
    """The ground truth is the same clip; the generated frames agree to one
    uint8 level (fp32 pipelines agree to 1e-5, and the cast truncates)."""
    root, _, _ = runs
    j, t = root / "jax" / "instance0", root / "port" / "instance0"
    for kind in ("gt_padded_frame", "gt_frame"):
        np.testing.assert_array_equal(_frames(t, kind), _frames(j, kind))
    for kind in ("gen_padded_frame", "gen_frame"):
        got, want = _frames(t, kind), _frames(j, kind)
        assert got.shape == want.shape == ((F, H, W, 3) if "padded" in kind
                                           else got.shape)
        assert np.abs(got - want).max() <= 1


def test_metrics_match_jax(runs):
    """The naive metrics of the port's run equal JAX's on its own run; the
    port scoring JAX's directory (``--evaluate-only``) equals JAX to
    1e-6."""
    root, results, want = runs
    assert results["_num_instances"] == want["_num_instances"] == 1
    assert set(results["_timings_s"]) == set(METRICS)
    for k in METRICS:
        assert results[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    again = evaluate.main(["--config_path", str(root / "jax.yaml"),
                           "--output_dir", str(root / "jax"),
                           "--evaluate-only", "--device", "cpu"]
                          )["results"]
    for k in METRICS:
        assert again[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


@pytest.mark.parametrize("extra", [
    ["--family", "cogvideox"], ["--mode", "frame_out"],
    ["--quantize", "int8"]], ids=["cogvideox", "frame_out", "int8"])
def test_port_entry_options(runs, extra):
    """The tiny CogVideoX (its 9-frame 32x32 sample grid, 8 text tokens),
    frame-out and the int8 DiT through the port's entry on the same
    validation set: one instance with finite scores."""
    root, _, _ = runs
    cog = "cogvideox" in extra
    cfg = write_eval_config(str(root / f"opt_{extra[-1]}.yaml"),
                            str(root / "data"), 32 if cog else H,
                            32 if cog else W, 9 if cog else F,
                            max_text_seq_length=8)
    res = evaluate.main(["--config_path", cfg, "--output_dir",
                         str(root / f"opt_{extra[-1]}"), "--smoke",
                         "--num_instances", "1", *extra])["results"]
    assert res["_num_instances"] == 1
    for k in METRICS if "frame_out" not in extra else (
            "INO_TrajError", "INO_VSeg_MAE", "INO_VLM"):
        assert np.isfinite(res[k]), k


def test_port_entry_refuses_the_int8_vae(runs):
    """``--smoke --quantize int8 --quantize_vae`` serves the wan family with
    the int8 DiT and the int8 VAE and scores finite metrics; CogVideoX
    refuses ``--quantize_vae``, as JAX's entry does."""
    root, _, _ = runs
    out = evaluate.main(["--config_path", str(root / "jax.yaml"),
                         "--output_dir", str(root / "vae8"), "--smoke",
                         "--num_instances", "1", "--quantize", "int8",
                         "--quantize_vae"])
    results = out["results"]
    assert results and all(np.isfinite(float(v)) for v in results.values()
                           if isinstance(v, (int, float)))
    assert (root / "vae8" / "instance0" / "gen_video.mp4").exists()
    with pytest.raises(SystemExit, match="wan family only"):
        evaluate.main(["--config_path", str(root / "jax.yaml"),
                       "--output_dir", str(root / "cog8"), "--smoke",
                       "--family", "cogvideox", "--quantize_vae"])
