"""The PyTorch port's serving slice on the CPU: the Wan2.2 FrameINO
pipeline against the JAX pipeline, the HTTP server round trip, the serve
entry point, and the port's independence from jax.
"""

import base64
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as jweights
from frameino_tpu.pipelines import wan_i2v as jpipe
from frameino_tpu_torch import serve
from frameino_tpu_torch.app.server import PipelineServer
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.pipelines import wan_i2v as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, F = 16, 16, 9


@pytest.fixture(scope="module")
def pipes():
    """The smoke configs with the same seeded weights on both sides: torch
    init, loaded into JAX trees by the JAX package's diffusers loaders."""
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
    return jp, tp


def _conditions(seed=7, B=1):
    rs = np.random.RandomState(seed)
    image = np.tanh(rs.randn(B, 3, H, W)).astype(np.float32)
    traj = np.tanh(rs.randn(B, 3, F, H, W)).astype(np.float32)
    ids = np.tanh(rs.randn(B, 3, 1, H, W)).astype(np.float32)
    text = rs.randn(B, 7, 16).astype(np.float32)
    latents = rs.randn(B, 4, 5, H // 2, W // 2).astype(np.float32)
    return image, traj, ids, text, latents


def _run_both(jp, tp, *, steps, guidance, ids=True, output_type="np"):
    image, traj, idf, text, latents = _conditions()
    common = dict(height=H, width=W, num_frames=F, output_type=output_type,
                  num_inference_steps=steps, guidance_scale=guidance)
    ref = jp(jnp.asarray(image), prompt_embeds=jnp.asarray(text),
             traj_tensor=jnp.asarray(traj),
             id_tensor=jnp.asarray(idf) if ids else None,
             latents=jnp.asarray(latents), attn_impl="xla", **common)
    got = tp(torch.from_numpy(image), prompt_embeds=torch.from_numpy(text),
             traj_tensor=torch.from_numpy(traj),
             id_tensor=torch.from_numpy(idf) if ids else None,
             latents=torch.from_numpy(latents), **common)
    return np.asarray(ref), (got.numpy() if isinstance(got, torch.Tensor)
                             else got)


def test_pipeline_matches_jax(pipes):
    """Trajectory + ID frame, batch CFG, 3 steps, decoded video."""
    ref, got = _run_both(*pipes, steps=3, guidance=5.0)
    assert got.shape == ref.shape == (1, 3, F, H, W)
    assert np.isfinite(got).all()
    # fp32 on both sides: reordered sums through VAE encodes, 3 DiT steps
    # at guidance 5 and the decode (1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_pipeline_latents_match_jax_without_id(pipes):
    """No ID frame, no CFG (guidance 1): the latent output."""
    ref, got = _run_both(*pipes, steps=2, guidance=1.0, ids=False,
                         output_type="latent")
    assert got.shape == (1, 4, 5, H // 2, W // 2)
    # fp32, 2 steps: reordered sums only (1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_cfg_modes_and_expert_split_agree(pipes):
    """Sequential CFG == batch CFG; a two-expert split over identical
    experts == one expert; frame 0 is the clean condition."""
    _, tp = pipes
    image, traj, ids, text, latents = _conditions(seed=3)
    args = [torch.from_numpy(a) for a in (image, traj, ids, text, latents)]

    def run(pipe, **kw):
        return pipe(args[0], prompt_embeds=args[3], traj_tensor=args[1],
                    id_tensor=args[2], latents=args[4], height=H, width=W,
                    num_frames=F, num_inference_steps=4, guidance_scale=4.0,
                    output_type="latent", **kw)

    batch = run(tp)
    # batch 2 vs 2 x batch 1 through the same fp32 ops (1e-5)
    torch.testing.assert_close(run(tp, cfg_mode="sequential"), batch,
                               atol=1e-5, rtol=1e-5)
    split = tpipe.WanImageToVideoPipeline(
        tp.dit, tp.vae, tpipe.WanPipelineConfig(boundary_ratio=0.9),
        dit_2=tp.dit)
    # the same ops in the same order: bit-equal
    torch.testing.assert_close(run(split), batch, atol=0, rtol=0)
    cond, _, _ = tpipe.prepare_conditions(tp.vae, args[0], None, None)
    torch.testing.assert_close(batch[:, :, :1], cond, atol=0, rtol=0)


def test_unported_decode_modes_raise(pipes):
    _, tp = pipes
    image, _, _, text, _ = _conditions()
    for mode in ("hybrid", "tiled", "streaming"):
        with pytest.raises(NotImplementedError, match="queue 1, item 2"):
            tp(torch.from_numpy(image), prompt_embeds=torch.from_numpy(text),
               height=H, width=W, num_frames=F, decode_mode=mode)


# ---------------------------------------------------------------------------
# server and entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    srv = PipelineServer(serve.build_pipeline(smoke=True, random_init=False),
                         default_steps=2)
    httpd, port = srv.start_background()
    yield port
    httpd.shutdown()
    httpd.server_close()


def _b64_png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _b64_npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.load(r)


def test_healthz_reports_torch_device(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server}/healthz") as r:
        h = json.load(r)
    assert h["status"] == "ok" and h["device"] == "cpu"
    assert h["pipeline"] == "WanImageToVideoPipeline"


@pytest.mark.parametrize("with_id", [True, False])
def test_generate_roundtrip(server, with_id):
    img = np.random.default_rng(0).integers(0, 255, (32, 64, 3),
                                            dtype=np.uint8)
    req = {"image_b64": _b64_png(img),
           "prompt_embeds_b64": _b64_npy(np.zeros((8, 16), np.float32)),
           "trajectories": [[[5, 5], [40, 20]]],
           "height": 32, "width": 64, "num_frames": 9,
           "num_inference_steps": 2}
    if with_id:
        req["id_image_b64"] = _b64_png(img[:16, :16].copy())
    out = _post(server, req)
    assert out["num_frames"] == 9
    assert out["height"] == 32 and out["width"] == 64
    # 32x64 rounds up to the 64-grid bucket and is cropped back
    assert out["bucket"] == [9, 64, 64]
    assert len(base64.b64decode(out["video_b64"])) > 100


@pytest.mark.parametrize("body", [{}, {"image_b64": "", "decode_mode": "x"}])
def test_bad_request_is_400(server, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body)
    assert e.value.code == 400
    assert "error" in json.load(e.value)


def test_unported_decode_mode_is_400(server):
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"image_b64": _b64_png(img),
                       "prompt_embeds_b64": _b64_npy(
                           np.zeros((8, 16), np.float32)),
                       "num_frames": 5, "num_inference_steps": 1,
                       "decode_mode": "hybrid"})
    assert e.value.code == 400
    assert "NotImplementedError" in json.load(e.value)["error"]


@pytest.mark.parametrize("kw,item", [
    (dict(smoke=True, random_init=False, text_encoder="umt5"), "item 1"),
    (dict(smoke=True, random_init=False, quantize="int8"), "item 3"),
    (dict(smoke=True, random_init=False, family="cogvideox",
          quantize="int8"), "item 5"),
    (dict(smoke=False, random_init=False), "item 7"),
])
def test_serve_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.build_pipeline(**kw)


def test_serve_args():
    a = serve.parse_args(["--smoke", "--port", "0", "--bucket_grid", "32"])
    assert a.smoke and not a.random_init and a.bucket_grid == 32
    with pytest.raises(SystemExit):
        serve.parse_args(["--smoke", "--random_init"])


def test_port_never_imports_jax(tmp_path):
    """Importing the package, its server and entry points, serving one
    smoke request of each family and taking one smoke train step leaves
    jax and every module of the JAX package (frameino_tpu) unimported."""
    code = textwrap.dedent("""
        import base64, io, json, os, sys
        import numpy as np
        import frameino_tpu_torch
        from frameino_tpu_torch import serve, train
        from frameino_tpu_torch.app.server import PipelineServer
        from frameino_tpu_torch.core import checkpoint, config  # noqa: F401
        from frameino_tpu_torch.data import prompt_cache  # noqa: F401
        from frameino_tpu_torch.data.fixture import write_fixture_dataset
        from frameino_tpu_torch.training import (optim, surgery,  # noqa
                                                 trainer, validation)
        from frameino_tpu_torch.models import weights  # noqa: F401
        from frameino_tpu_torch.models import cogvideox_vae_streaming  # noqa
        from frameino_tpu_torch.ops import attention  # noqa: F401
        from frameino_tpu_torch.schedulers import cogvideox_dpm  # noqa: F401
        from PIL import Image
        b = io.BytesIO()
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(b, "PNG")
        e = io.BytesIO()
        # 8 text tokens: the tiny CogVideoX's max_text_seq_length
        np.save(e, np.zeros((8, 16), np.float32))
        for family in ("wan", "cogvideox"):
            srv = PipelineServer(serve.build_pipeline(
                smoke=True, random_init=False, family=family))
            out = srv.handle_generate({
                "image_b64": base64.b64encode(b.getvalue()).decode(),
                "prompt_embeds_b64": base64.b64encode(e.getvalue()).decode(),
                "num_frames": 5, "num_inference_steps": 1,
                "trajectories": [[[2, 2], [10, 12]]]})
            assert out["num_frames"] == 5, out
        root = sys.argv[1]
        data = write_fixture_dataset(root, 32, 32, 12)
        cfg = {"download_folder_path": data,
               "train_csv_relative_path": "csvs",
               "train_video_relative_path": "videos",
               "train_ID_relative_path": "ids", "target_height": 16,
               "target_width": 16, "sample_accelerate_factor": 1,
               "train_frame_num_range": [9, 9], "min_train_frame_num": 9,
               "dot_radius": 40, "max_train_steps": 1, "seed": 0,
               "output_folder": os.path.join(root, "ckpts"),
               "max_text_seq_length": 8, "resume_from_checkpoint": "latest"}
        with open(os.path.join(root, "t.yaml"), "w") as f:
            json.dump(cfg, f)
        assert train.main(["--config_path", os.path.join(root, "t.yaml"),
                           "--smoke"])["step"] == 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "frameino_tpu"
                     or m.startswith("frameino_tpu."))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
