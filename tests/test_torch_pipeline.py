"""The PyTorch port's serving slice on the CPU: the Wan2.2 FrameINO
pipeline against the JAX pipeline, the HTTP server round trip, the serve
entry point, and the port's independence from jax.
"""

import base64
import copy
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_dit as jcdit
from frameino_tpu.models import cogvideox_vae as jcvae
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as jweights
from frameino_tpu.pipelines import cogvideox_i2v as jcpipe
from frameino_tpu.pipelines import wan_i2v as jpipe
from frameino_tpu_torch import serve
from frameino_tpu_torch.app.server import PipelineServer
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import cogvideox_vae as tcvae
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.quant import QuantLinear
from frameino_tpu_torch.pipelines import cogvideox_i2v as tcpipe
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


def _device_tree(params):
    """Fresh device arrays of a numpy tree: the JAX pipelines then
    quantize on the device under jit, as they serve (a numpy tree takes
    the host quantizer, whose scales may differ by one ulp)."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), params)


def test_int8_pipeline_matches_jax(pipes):
    """quantize="int8" on both sides, the same float weights quantized by
    each, trajectory + ID frame, batch CFG, 3 steps, decoded video. The
    int8 weights are bit-equal (tests/test_torch_quant.py); activations in
    fp32 reach the quantizer through sums in another order, and one that
    lands on the other side of a rounding boundary moves its code by one
    step of its row's scale. None does here: the fp32 pipeline test's
    1e-3 holds unwidened."""
    jp, tp = pipes
    jq = jpipe.WanImageToVideoPipeline(
        jp.dit_cfg, _device_tree(jp.dit_params), jp.vae_cfg, jp.vae_params,
        jpipe.WanPipelineConfig(), quantize="int8")
    tq = tpipe.WanImageToVideoPipeline(copy.deepcopy(tp.dit), tp.vae,
                                       tpipe.WanPipelineConfig(),
                                       quantize="int8")
    assert sum(isinstance(m, QuantLinear) for m in tq.dit.modules()) == 20
    ref, got = _run_both(jq, tq, steps=3, guidance=5.0)
    assert got.shape == ref.shape == (1, 3, F, H, W)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    # and int8 moved the output: the float pipeline is not what matched
    _, fp = _run_both(jp, tp, steps=3, guidance=5.0)
    assert np.abs(fp - got).max() > 1e-3


def test_int8_cogvideox_pipeline_matches_jax():
    """The tiny CogVideoX FrameINO pipeline with quantize="int8" on both
    sides (DDIM, trajectory + ID frame, dynamic CFG, 3 steps, latents);
    the fp32 CogVideoX pipeline test's 1e-3, unwidened as above."""
    dcfg = tcdit.tiny_config(use_frame_in=True)
    vcfg = tcvae.tiny_vae_config()
    gen = torch.Generator().manual_seed(11)
    dit = tcdit.init_cogvideox_dit(dcfg, gen)
    vae = tcvae.init_cogvideox_vae(vcfg, gen)
    with torch.no_grad():
        # posterior std 3e-7: the two sides' different noise does not count
        vae.encoder.conv_out.conv.bias[vcfg.latent_channels:] = -100.0

    def np_sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    jdcfg = jcdit.tiny_config(use_frame_in=True)
    jvcfg = jcvae.tiny_vae_config()
    jp = jcpipe.CogVideoXImageToVideoPipeline(
        jdcfg, _device_tree(jweights.cogvideox_dit_from_state_dict(
            np_sd(dit), jdcfg)),
        jvcfg, jweights.cogvideox_vae_from_state_dict(np_sd(vae), jvcfg),
        quantize="int8")
    tp = tcpipe.CogVideoXImageToVideoPipeline(dit, vae, quantize="int8")
    assert sum(isinstance(m, QuantLinear) for m in dit.modules()) == 12
    rs = np.random.RandomState(9)
    image = np.tanh(rs.randn(1, 3, 16, 16)).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, 9, 16, 16)).astype(np.float32)
    idf = np.tanh(rs.randn(1, 3, 16, 16)).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    latents = rs.randn(1, 3, 4, 4, 4).astype(np.float32)
    common = dict(height=16, width=16, num_frames=9, num_inference_steps=3,
                  guidance_scale=6.0, output_type="latent")
    ref = np.asarray(jp(jnp.asarray(image), prompt_embeds=jnp.asarray(text),
                        traj_tensor=jnp.asarray(traj),
                        id_tensor=jnp.asarray(idf),
                        latents=jnp.asarray(latents), attn_impl="xla",
                        **common))
    got = tp(torch.from_numpy(image), prompt_embeds=torch.from_numpy(text),
             traj_tensor=torch.from_numpy(traj),
             id_tensor=torch.from_numpy(idf),
             latents=torch.from_numpy(latents), **common).numpy()
    assert got.shape == ref.shape == (1, 3, 4, 4, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_unported_decode_modes_raise(pipes):
    """Every decode mode of the JAX pipeline is ported ("full",
    "streaming", "tiled", "hybrid"); a mode it does not have raises,
    where JAX would decode "full" without a word."""
    _, tp = pipes
    image, _, _, text, _ = _conditions()
    for mode in ("sliced", "Hybrid"):
        with pytest.raises(ValueError, match="decode_mode must be one of"):
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
    # JAX's key, named as jax.default_backend() names the platform
    assert h["backend"] == "cpu"
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
    """A decode mode the pipeline does not have answers 400."""
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"image_b64": _b64_png(img),
                       "prompt_embeds_b64": _b64_npy(
                           np.zeros((8, 16), np.float32)),
                       "num_frames": 5, "num_inference_steps": 1,
                       "decode_mode": "sliced"})
    assert e.value.code == 400
    assert "ValueError: decode_mode" in json.load(e.value)["error"]


@pytest.mark.parametrize("kw,err,match", [
    (dict(smoke=True, text_encoder="/no/such/umt5"), FileNotFoundError,
     "umt5"),
    (dict(), ValueError, "exactly one"),
    (dict(smoke=True, transformer="/x"), ValueError, "exactly one"),
    (dict(transformer="/x", device="cpu"), ValueError, "both"),
])
def test_serve_unported_options_raise(kw, err, match):
    """build_pipeline needs exactly one source of weights (checkpoint
    directories, --smoke or --random_init), both checkpoint directories,
    and a text encoder directory that exists."""
    with pytest.raises(err, match=match):
        serve.build_pipeline(**kw)


def _smoke_request(frames=5):
    img = np.random.default_rng(1).integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8)
    # 8 text tokens: the tiny CogVideoX's max_text_seq_length
    return {"image_b64": _b64_png(img),
            "prompt_embeds_b64": _b64_npy(np.zeros((8, 16), np.float32)),
            "num_frames": frames, "num_inference_steps": 1,
            "trajectories": [[[2, 2], [10, 12]]],
            "id_image_b64": _b64_png(img[:8, :8].copy())}


@pytest.mark.parametrize("family,per_block", [("wan", 10),
                                              ("cogvideox", 6)])
def test_serve_int8_smoke_pipeline_answers(family, per_block):
    """``build_pipeline(smoke=True, quantize="int8")`` quantizes the DiT's
    block matmuls and serves a request through the server."""
    pipe = serve.build_pipeline(smoke=True, random_init=False, family=family,
                                quantize="int8")
    n_q = sum(isinstance(m, QuantLinear) for m in pipe.dit.modules())
    assert n_q == per_block * pipe.dit_cfg.num_layers
    out = PipelineServer(pipe).handle_generate(_smoke_request())
    assert out["num_frames"] == 5 and len(base64.b64decode(
        out["video_b64"])) > 100
    a = serve.parse_args(["--smoke", "--quantize", "int8", "--family",
                          family])
    assert a.quantize == "int8" and a.family == family


def test_serve_args():
    a = serve.parse_args(["--smoke", "--port", "0", "--bucket_grid", "32"])
    assert a.smoke and not a.random_init and a.bucket_grid == 32
    with pytest.raises(SystemExit):
        serve.parse_args(["--smoke", "--random_init"])


def test_port_never_imports_jax(tmp_path):
    """Importing the package, its server and entry points, its mesh and
    parallel modules, serving one smoke request of each family and one of
    the int8 Wan pipeline, serving a prompt request from checkpoint
    directories (the safetensors writer and reader, UMT5), taking one
    smoke train step of each family, one smoke mass-evaluation round and
    one call of each perception model (DINOv2, CoTracker, SAM2) at its tiny
    config, a greedy generation of the tiny Qwen2.5-VL in int8, two steps of
    the convergence run and the int8 certification's import, one step of
    the tiny Wan2.1 I2V pipeline with its CLIP image encoder, and the
    curation chain (its modules' import, one classical ``process_video`` on
    a fixture clip, one tiny OneFormer and one tiny VGGT forward) leaves jax
    and every module of the JAX package (frameino_tpu) unimported."""
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
        from frameino_tpu_torch.core import meshes  # noqa: F401
        from frameino_tpu_torch.parallel import (multihost,  # noqa: F401
                                                 sharding)
        from frameino_tpu_torch.schedulers import cogvideox_dpm  # noqa: F401
        from PIL import Image
        b = io.BytesIO()
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(b, "PNG")
        e = io.BytesIO()
        # 8 text tokens: the tiny CogVideoX's max_text_seq_length
        np.save(e, np.zeros((8, 16), np.float32))
        for family, q in (("wan", None), ("cogvideox", None),
                          ("wan", "int8")):
            srv = PipelineServer(serve.build_pipeline(
                smoke=True, random_init=False, family=family, quantize=q))
            out = srv.handle_generate({
                "image_b64": base64.b64encode(b.getvalue()).decode(),
                "prompt_embeds_b64": base64.b64encode(e.getvalue()).decode(),
                "num_frames": 5, "num_inference_steps": 1,
                "trajectories": [[[2, 2], [10, 12]]]})
            assert out["num_frames"] == 5, out
        root = sys.argv[1]
        # serving from checkpoint directories, a prompt through UMT5
        import torch
        from frameino_tpu_torch.models import (pretrained, t5_encoder,
                                               wan_dit, wan_vae)
        dcfg, vcfg = serve.smoke_configs()
        tcfg = t5_encoder.tiny_config(d_model=dcfg.text_dim)
        g = torch.Generator().manual_seed(0)
        for sub, cfg, m in (
                ("transformer", dcfg, wan_dit.init_wan_dit(dcfg, g)),
                ("vae", vcfg, wan_vae.init_wan_vae(vcfg, g)),
                ("text_encoder", tcfg, t5_encoder.init_t5_encoder(tcfg, g))):
            pretrained.save_pretrained(os.path.join(root, sub), cfg, m)

        def tokenizer(prompts, max_length, **kw):
            ids = np.zeros((len(prompts), max_length), np.int64)
            ids[:, :3] = [5, 6, 1]
            return {"input_ids": ids, "attention_mask": (ids > 0) * 1}
        pipe = serve.build_pipeline(
            transformer=os.path.join(root, "transformer"),
            vae=os.path.join(root, "vae"),
            text_encoder=os.path.join(root, "text_encoder"),
            tokenizer=tokenizer, device="cpu")
        out = PipelineServer(pipe).handle_generate({
            "image_b64": base64.b64encode(b.getvalue()).decode(),
            "prompt": "a cat", "num_frames": 5, "num_inference_steps": 1,
            "trajectories": [[[2, 2], [10, 12]]]})
        assert out["num_frames"] == 5, out
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
        # one CogVideoX smoke train step (32x32: the tiny DiT's grid)
        from frameino_tpu_torch import train_cogvideox
        from frameino_tpu_torch.scripts import \
            precompute_prompt_embeddings  # noqa: F401
        cfg.update(target_height=32, target_width=32,
                   output_folder=os.path.join(root, "cog_ckpts"))
        with open(os.path.join(root, "c.yaml"), "w") as f:
            json.dump(cfg, f)
        assert train_cogvideox.main(["--config_path",
                                     os.path.join(root, "c.yaml"),
                                     "--smoke"])["step"] == 1
        # one mass-evaluation round (naive backends) on a fixture, and the
        # perception models at their tiny configs
        from frameino_tpu_torch import evaluate
        from frameino_tpu_torch.data.fixture import write_eval_config
        from frameino_tpu_torch.models import cotracker, dinov2, sam2
        from frameino_tpu_torch.models.sam2_video import \
            make_segmenter_adapter
        data = write_fixture_dataset(os.path.join(root, "eval"), 48, 64, 30,
                                     start=(16.0, 12.0))
        ecfg = write_eval_config(os.path.join(root, "e.yaml"), data, 32, 64,
                                 13, max_text_seq_length=8)
        res = evaluate.main(["--config_path", ecfg, "--output_dir",
                             os.path.join(root, "eval_out"), "--smoke",
                             "--device", "cpu", "--num_instances", "1"])
        assert res["results"]["_num_instances"] == 1, res
        g = torch.Generator().manual_seed(0)
        clip = np.random.RandomState(0).randint(0, 255, (3, 24, 32, 3)
                                                ).astype(np.uint8)
        q = np.array([[10.0, 12.0]], np.float32)
        assert cotracker.make_tracker_adapter(cotracker.init_cotracker(
            cotracker.tiny_cotracker_config(), g))(clip, q).shape == (3, 1, 2)
        assert make_segmenter_adapter(sam2.init_sam2(
            sam2.tiny_sam2_config(), g))(clip, q).shape == (3, 24, 32)
        assert dinov2.make_embedder_adapter(dinov2.init_dinov2(
            dinov2.tiny_dinov2_config(), g), input_size=28)(clip[0]).shape \
            == (32,)
        from frameino_tpu_torch.models import qwen_vl
        from frameino_tpu_torch.scripts import (certify_int8,  # noqa: F401
                                                train_overfit)
        torch.set_num_threads(1)    # tiny ops beside other xdist workers
        qcfg = qwen_vl.tiny_qwen_vl_config()
        qm = qwen_vl.quantize_qwen_int8(qwen_vl.init_qwen_vl(qcfg, g))
        ids = np.asarray([1, 2, 62] + [61] * 4 + [3], np.int64)
        vis = qm.vision(torch.zeros(16, qcfg.vision.patch_dim),
                        qwen_vl.vision_layout((1, 4, 4), qcfg.vision))
        assert len(qwen_vl.QwenVLGenerator(qm, 2).generate(
            ids, vis, qwen_vl.get_rope_index(ids, (1, 4, 4), qcfg))) >= 1
        assert train_overfit.main(
            ["--device", "cpu", "--steps", "2", "--sample_steps", "1",
             "--out", os.path.join(root, "conv.json")],
            shape=(5, 16, 16)) == 1
        # one step of the tiny Wan2.1 I2V pipeline with its CLIP encoder
        from frameino_tpu_torch.models import clip_vision
        from frameino_tpu_torch.pipelines import wan_i2v
        from frameino_tpu_torch.scripts import verify_checkpoint  # noqa
        clip = clip_vision.init_clip_vision(clip_vision.tiny_config(), g)
        d21 = wan_dit.tiny_config(in_channels=10, out_channels=4,
                                  image_dim=16, added_kv_proj_dim=48)
        pipe21 = wan_i2v.WanImageToVideoPipeline(
            wan_dit.init_wan_dit(d21, g), wan_vae.init_wan_vae(vcfg, g),
            wan_i2v.WanPipelineConfig(expand_timesteps=False),
            image_encoder=clip_vision.make_image_encoder(clip.cfg, clip))
        lat = pipe21(torch.zeros(1, 3, 16, 16),
                     prompt_embeds=torch.zeros(1, 4, 16), height=16,
                     width=16, num_frames=5, num_inference_steps=1,
                     output_type="latent")
        assert lat.shape[1] == 4 and bool(torch.isfinite(lat).all())
        # dataset curation: one classical process_video on a fixture clip,
        # one tiny OneFormer and one tiny VGGT forward
        import argparse
        from frameino_tpu_torch.data.video_io import write_video
        from frameino_tpu_torch.evaluation import perception  # noqa: F401
        from frameino_tpu_torch.models import oneformer, swin, vggt
        from frameino_tpu_torch.preprocess import (  # noqa: F401
            camera_pose, captioning, csv_io, panoptic_oneformer)
        from frameino_tpu_torch.scripts import run_preprocess_pipeline
        rs = np.random.RandomState(0)
        bg = rs.randint(10, 60, (64, 96, 3)).astype(np.uint8)
        frames = np.stack([bg] * 40)
        for t in range(40):
            frames[t, 8 + t // 2:24 + t // 2, 6 + t:22 + t] = (220, 180, 60)
        os.makedirs(os.path.join(root, "raw"))
        write_video(os.path.join(root, "raw", "c.mp4"), frames)
        run_preprocess_pipeline.process_video(
            "c.mp4", os.path.join(root, "raw"), os.path.join(root, "ids"),
            argparse.Namespace(
                min_frames=20, min_size=32, max_aspect=2.5,
                cut_threshold=0.5, min_clarity=5.0, min_motion=2.0,
                num_points=5, keep_boxes=5, seed=0,
                caption_backend="template"))
        ocfg = oneformer.OneFormerConfig(
            swin=swin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                                 num_heads=(2, 2, 4, 4), window_size=4),
            num_classes=7, hidden_dim=32, num_queries=6, nheads=4,
            dim_feedforward=64, enc_ffn_dim=48, enc_layers=2, dec_layers=3,
            enc_points=2, mask_dim=32)
        cls, _ = oneformer.oneformer_forward(
            ocfg, oneformer.init_oneformer(ocfg, g), torch.zeros(1, 64, 64, 3),
            torch.from_numpy(oneformer.task_tokens("panoptic"))[None])
        assert cls.shape == (1, 6, 8)
        vcfg2 = vggt.tiny_vggt_config()
        poses, _ = vggt.vggt_camera_forward(
            vcfg2, vggt.init_vggt(vcfg2, g), torch.rand(1, 2, 8, 8, 3))
        assert poses.shape == (1, 2, 4, 4)
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
                         timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
