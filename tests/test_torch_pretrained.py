"""Checkpoint directories in the port: its safetensors reader and writer
(``models/safetensors_io.py``) against the ``safetensors`` package,
``from_pretrained`` against the JAX package's on the same fp32 files,
``load_pipeline_dir``, and the serve and train entry points on tiny
checkpoint directories written into ``tmp_path`` (CPU).
"""

import base64
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import pretrained as JP
from frameino_tpu.models import t5_encoder as jt5
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.models import weights as JW
from frameino_tpu_torch import serve, train
from frameino_tpu_torch.app.server import PipelineServer
from frameino_tpu_torch.data.fixture import write_fixture_dataset
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import cogvideox_vae as tcvae
from frameino_tpu_torch.models import pretrained as P
from frameino_tpu_torch.models import safetensors_io as SIO
from frameino_tpu_torch.models import t5_encoder as tt5
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import load_safetensors_dir

# the weights the two loaders give, and the Wan VAE's and DiT's forwards
# on them (fp32, tiny shapes): 1e-6, as tests/test_pretrained.py holds
# JAX's loader
LOAD_TOL = VAE_TOL = DIT_TOL = 1e-6
# the encoders' forwards: tests/test_t5_encoder.py's limit against
# transformers
T5_TOL = dict(atol=2e-4, rtol=2e-3)

VAE_KW = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              temperal_downsample=(True,), is_residual=False,
              scale_factor_temporal=2, scale_factor_spatial=2,
              latents_mean=tuple(np.linspace(-1, 1, 4).tolist()),
              latents_std=tuple(np.linspace(0.5, 2.5, 4).tolist()))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _sample(dtype, seed=0):
    g = _gen(seed)
    if dtype.is_floating_point:
        def make(*s):
            return torch.randn(s, generator=g).to(dtype)
    else:
        info = torch.iinfo(dtype)

        def make(*s):
            return torch.randint(max(info.min, -1000), min(info.max, 1000),
                                 s, generator=g, dtype=dtype)
    return {"w": make(3, 5), "b": make(7), "scalar": make(),
            "empty": make(0, 4), "block.0.x": make(2, 3, 4)}


# ---------------------------------------------------------------------------
# safetensors_io against the package
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.float16,
          torch.int32]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_reads_the_package_files(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    want = _sample(dtype)
    path = str(tmp_path / "a.safetensors")
    st.save_file(want, path, metadata={"format": "pt"})
    got = SIO.load_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    assert SIO.read_header(path)[1] == {"format": "pt"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_package_reads_the_writer_files(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    want = _sample(dtype, seed=1)
    # mixed widths: each tensor must still start aligned
    want["mixed_i8"] = torch.arange(5, dtype=torch.int8)
    path = str(tmp_path / "b.safetensors")
    SIO.save_file(want, path, metadata={"format": "pt"})
    got = st.load_file(path)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert SIO.read_header(path)[2] % 8 == 0
    for k, v in SIO.load_file(path).items():
        assert torch.equal(v, want[k]), k


def test_reader_maps_the_file_without_a_copy(tmp_path):
    """The tensors are views of one private map of the file: writing to
    one changes neither the file nor the others."""
    path = str(tmp_path / "c.safetensors")
    SIO.save_file({"a": torch.zeros(4), "b": torch.ones(4)}, path)
    t = SIO.load_file(path)
    assert t["a"].untyped_storage().data_ptr() \
        == t["b"].untyped_storage().data_ptr()
    t["a"][0] = 5.0
    assert SIO.load_file(path)["a"][0] == 0.0


def test_load_safetensors_dir_reads_sorted_files(tmp_path):
    """One file, or every *.safetensors of a directory in sorted order (a
    later file's tensor of the same name wins), as JAX's reader."""
    SIO.save_file({"x": torch.zeros(2), "y": torch.ones(3)},
                  str(tmp_path / "a.safetensors"))
    SIO.save_file({"x": torch.full((2,), 2.0)},
                  str(tmp_path / "b.safetensors"))
    (tmp_path / "notes.txt").write_text("not weights")
    got = load_safetensors_dir(str(tmp_path))
    ref = JW.load_safetensors_dir(str(tmp_path))
    assert set(got) == set(ref) == {"x", "y"}
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert set(load_safetensors_dir(str(tmp_path / "a.safetensors"))) \
        == {"x", "y"}
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# from_pretrained against JAX's
# ---------------------------------------------------------------------------

def _tree_equal(a, b, tol=LOAD_TOL):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for (path, x), y in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=0, err_msg=str(path))


def _np_sd(module):
    return {k: v.detach().float().numpy() for k, v in
            module.state_dict().items()}


def test_wan_vae_from_pretrained_matches_jax(tmp_path):
    cfg = tvae.WanVAEConfig(**VAE_KW)
    model = tvae.init_wan_vae(cfg, _gen(0))
    d = str(tmp_path / "vae")
    P.save_pretrained(d, cfg, model)
    got_cfg, got = P.from_pretrained(d, device="cpu")
    jcfg, params = JP.from_pretrained(d)
    assert got_cfg == cfg                     # the statistics included
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    assert isinstance(got, tvae.WanVAE) and not got.training
    _tree_equal(JW.wan_vae_from_state_dict(_np_sd(got), jcfg), params)
    video = np.tanh(np.random.RandomState(1).randn(1, 3, 5, 16, 16)
                    ).astype(np.float32)
    ref = np.asarray(jvae.encode_moments(jcfg, params, jnp.asarray(video)))
    out = got.encode_moments(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(out, ref, atol=VAE_TOL, rtol=VAE_TOL)
    torch.testing.assert_close(
        got.encode_moments(torch.from_numpy(video)),
        model.encode_moments(torch.from_numpy(video)), atol=0, rtol=0)


@pytest.mark.parametrize("cj,match", [
    ({"base_dim": 8, "z_dim": 4}, "latents_mean"),
    ({"base_dim": 8, "z_dim": 4, "latents_mean": [0.0] * 3,
      "latents_std": [1.0] * 3}, "latents stats length"),
])
def test_wan_vae_refuses_missing_stats(tmp_path, cj, match):
    """No fallback to the unit placeholder statistics (JAX's refusal)."""
    d = tmp_path / "vae_bad"
    os.makedirs(d)
    (d / "config.json").write_text(json.dumps(
        {"_class_name": "AutoencoderKLWan", **cj}))
    for loader in (P.from_pretrained, JP.from_pretrained):
        with pytest.raises(ValueError, match=match):
            loader(str(d))


def test_wan_dit_from_pretrained_matches_jax(tmp_path):
    cfg = tdit.tiny_config()
    model = tdit.init_wan_dit(cfg, _gen(1))
    d = str(tmp_path / "transformer")
    P.save_pretrained(d, cfg, model)
    got_cfg, got = P.from_pretrained(d, device="cpu")
    jcfg, params = JP.from_pretrained(d)
    assert got_cfg == cfg
    _tree_equal(JW.wan_dit_from_state_dict(_np_sd(got), jcfg), params)
    rs = np.random.RandomState(2)
    x = rs.randn(1, cfg.in_channels, 2, 4, 4).astype(np.float32)
    t = np.asarray([500.0], np.float32)
    text = rs.randn(1, 4, cfg.text_dim).astype(np.float32)
    ref = jdit.wan_dit_forward(jcfg, params, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(text), attn_impl="xla")
    out = got(torch.from_numpy(x), torch.from_numpy(t),
              torch.from_numpy(text))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DIT_TOL,
                               rtol=DIT_TOL)
    # a bf16 load casts every floating tensor
    _, m16 = P.from_pretrained(d, device="cpu", dtype=torch.bfloat16)
    assert {p.dtype for p in m16.parameters()} == {torch.bfloat16}


def test_wan21_dit_and_clip_configs_load(tmp_path):
    """The released Wan2.1-I2V-14B transformer config (image_dim,
    added_kv_proj_dim) and its CLIP ViT-H/14 image encoder config
    (CLIPVisionModelWithProjection) give the port's WAN21_I2V_14B and
    CLIP_VIT_H_14 (full-width meta modules: no weights drawn)."""
    from frameino_tpu_torch.models import clip_vision as tclip
    dit = dict(tdit.WAN21_I2V_14B.__dict__, patch_size=[1, 2, 2],
               _class_name="WanTransformer3DModel")
    cfg = P.wan_dit_config_from_json(dit)
    assert cfg == tdit.WAN21_I2V_14B
    assert JP.wan_dit_config_from_json(dit) == jdit.WAN21_I2V_14B
    m = tdit.WanDiT(cfg, device="meta")
    assert tuple(m.blocks[0].attn2.add_k_proj.weight.shape) == (5120, 5120)
    assert tuple(m.condition_embedder.image_embedder.ff.net[0].proj.weight
                 .shape) == (1280, 1280)
    clip = {"architectures": ["CLIPVisionModelWithProjection"],
            "hidden_size": 1280, "intermediate_size": 5120,
            "num_hidden_layers": 32, "num_attention_heads": 16,
            "image_size": 224, "patch_size": 14, "hidden_act": "gelu",
            "layer_norm_eps": 1e-5, "projection_dim": 1024}
    assert P.clip_vision_config_from_json(clip) == tclip.CLIP_VIT_H_14
    assert P.clip_vision_config_from_json(
        {"architectures": ["CLIPModel"], "vision_config": clip}) \
        == tclip.CLIP_VIT_H_14
    n = sum(p.numel() for p in tclip.CLIPVision(tclip.CLIP_VIT_H_14,
                                                device="meta").parameters())
    assert 630e6 < n < 635e6


def test_cogvideox_dit_from_pretrained_matches_jax(tmp_path):
    """The reference's use_FrameIn spelling; a file without the position
    table (diffusers stores only a learned one) takes the sincos table."""
    cfg = tcdit.tiny_config(use_frame_in=True)
    model = tcdit.init_cogvideox_dit(cfg, _gen(2))
    d = str(tmp_path / "cog")
    P.save_pretrained(d, cfg, model)
    assert json.load(open(os.path.join(d, "config.json")))["use_FrameIn"]
    got_cfg, got = P.from_pretrained(d, device="cpu")
    jcfg, params = JP.from_pretrained(d)
    assert got_cfg == cfg and got_cfg.use_frame_in
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    _tree_equal(JW.cogvideox_dit_from_state_dict(_np_sd(got), jcfg), params)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "patch_embed.pos_embedding"}
    SIO.save_file(sd, os.path.join(d, "model.safetensors"))
    _, got = P.from_pretrained(d, device="cpu")
    torch.testing.assert_close(got.patch_embed.pos_embedding,
                               model.patch_embed.pos_embedding, atol=0,
                               rtol=0)


def test_cogvideox_vae_from_pretrained_matches_jax(tmp_path):
    cfg = tcvae.tiny_vae_config()
    model = tcvae.init_cogvideox_vae(cfg, _gen(3))
    d = str(tmp_path / "cogvae")
    P.save_pretrained(d, cfg, model)
    got_cfg, got = P.from_pretrained(d, device="cpu")
    jcfg, params = JP.from_pretrained(d)
    assert got_cfg == cfg
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    _tree_equal(JW.cogvideox_vae_from_state_dict(_np_sd(got), jcfg), params)
    for a, b in zip(got.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def _hf_t5(kind):
    """A tiny transformers encoder (seeded) and its config."""
    torch.manual_seed(0)
    kw = dict(vocab_size=64, d_model=16, d_kv=4, num_heads=2, d_ff=32,
              num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
              feed_forward_proj="gated-gelu", is_encoder_decoder=False)
    if kind == "t5":
        from transformers import T5Config, T5EncoderModel
        return T5EncoderModel(T5Config(**kw)).eval()
    from transformers import UMT5Config, UMT5EncoderModel
    return UMT5EncoderModel(UMT5Config(**kw)).eval()


@pytest.mark.parametrize("kind", ["t5", "umt5"])
def test_t5_from_pretrained_matches_jax(tmp_path, kind):
    """A directory that transformers' ``save_pretrained`` wrote (its
    config.json, its safetensors with the tied embedding folded): the same
    config and weights as JAX's loader reads, the same encoding."""
    hf = _hf_t5(kind)
    d = str(tmp_path / kind)
    hf.save_pretrained(d, safe_serialization=True)
    got_cfg, got = P.from_pretrained(d, device="cpu")
    jcfg, params = JP.from_pretrained(d)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    assert got_cfg.per_layer_relative_bias == (kind == "umt5")
    _tree_equal(JW.t5_from_state_dict(_np_sd(got), jcfg), params)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (2, 10)).astype(np.int64)
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    ref = np.asarray(jt5.t5_encode(jcfg, params, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    out = tt5.t5_encode(got, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, **T5_TOL)
    # and the port's writer round-trips it
    P.save_pretrained(str(tmp_path / "again"), got_cfg, got)
    again_cfg, again = P.from_pretrained(str(tmp_path / "again"),
                                         device="cpu")
    assert again_cfg == got_cfg
    for k, v in got.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_load_pipeline_dir_skips_scheduler_and_tokenizer(tmp_path):
    vae_cfg = tvae.WanVAEConfig(**VAE_KW)
    P.save_pretrained(str(tmp_path / "vae"), vae_cfg,
                      tvae.init_wan_vae(vae_cfg, _gen(0)))
    dit_cfg = tdit.tiny_config()
    P.save_pretrained(str(tmp_path / "transformer"), dit_cfg,
                      tdit.init_wan_dit(dit_cfg, _gen(1)))
    os.makedirs(tmp_path / "scheduler")
    (tmp_path / "scheduler" / "config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler"}))
    os.makedirs(tmp_path / "tokenizer")
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text("{}")
    (tmp_path / "model_index.json").write_text("{}")
    out = P.load_pipeline_dir(str(tmp_path), device="cpu")
    assert set(out) == {"transformer", "vae"}
    assert out["vae"][0] == vae_cfg and isinstance(out["vae"][1],
                                                    tvae.WanVAE)
    assert set(JP.load_pipeline_dir(str(tmp_path))) == set(out)


# ---------------------------------------------------------------------------
# the entry points on checkpoint directories
# ---------------------------------------------------------------------------

class StubTokenizer:
    """Stands in for ``transformers.AutoTokenizer``: one id a character
    (1 + its code mod vocab - 1), then the end id 1, padded with 0."""

    def __init__(self, vocab):
        self.vocab = vocab

    def __call__(self, prompts, padding, max_length, truncation,
                 return_tensors):
        assert padding == "max_length" and truncation \
            and return_tensors == "np"
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, p in enumerate(prompts):
            toks = [1 + ord(c) % (self.vocab - 1) for c in p]
            toks = toks[:max_length - 1] + [1]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}


def write_tiny_checkpoints(root):
    """The smoke Wan models (its VAE with non-unit statistics) and a tiny
    UMT5 of the DiT's text width as diffusers / transformers directories;
    returns the in-memory modules."""
    dit_cfg, vae_cfg = serve.smoke_configs()
    vae_cfg = dataclasses.replace(vae_cfg, latents_mean=VAE_KW["latents_mean"],
                                  latents_std=VAE_KW["latents_std"])
    t5_cfg = tt5.tiny_config(d_model=dit_cfg.text_dim)
    mods = {"transformer": (dit_cfg, tdit.init_wan_dit(dit_cfg, _gen(4))),
            "vae": (vae_cfg, tvae.init_wan_vae(vae_cfg, _gen(5))),
            "text_encoder": (t5_cfg, tt5.init_t5_encoder(t5_cfg, _gen(6)))}
    for sub, (cfg, m) in mods.items():
        P.save_pretrained(os.path.join(root, sub), cfg, m)
    return mods


def _png(h, w):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (h, w, 3), dtype=np.uint8), "RGB").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_serve_from_checkpoint_dirs_answers_a_prompt(tmp_path):
    """build_pipeline(transformer=, vae=, text_encoder=) on the CPU loads
    the directories bit-equal to the modules written and serves a
    ``prompt`` request through the UMT5 encoder."""
    mods = write_tiny_checkpoints(str(tmp_path))
    tok = StubTokenizer(64)
    pipe = serve.build_pipeline(
        transformer=str(tmp_path / "transformer"), vae=str(tmp_path / "vae"),
        text_encoder=str(tmp_path / "text_encoder"), tokenizer=tok,
        device="cpu")
    assert pipe.device.type == "cpu" and pipe.vae_cfg == mods["vae"][0]
    for (cfg, m), loaded in ((mods["transformer"], pipe.dit),
                             (mods["vae"], pipe.vae),
                             (mods["text_encoder"],
                              pipe.text_encoder_fn.model)):
        for k, v in m.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
    emb = pipe.text_encoder_fn(["a red ball rolls left"])
    t = tok(["a red ball rolls left"], padding="max_length", max_length=512,
            truncation=True, return_tensors="np")
    want = tt5.encode_and_mask(mods["text_encoder"][1],
                               torch.from_numpy(t["input_ids"]),
                               torch.from_numpy(t["attention_mask"]))
    assert emb.shape == (1, 512, 16) and emb.dtype == torch.float32
    torch.testing.assert_close(emb, want, atol=0, rtol=0)
    out = PipelineServer(pipe).handle_generate({
        "image_b64": _png(16, 16), "prompt": "a red ball rolls left",
        "num_frames": 5, "num_inference_steps": 1,
        "trajectories": [[[2, 2], [10, 12]]]})
    assert (out["num_frames"], out["height"], out["width"]) == (5, 16, 16)


def test_serve_main_warms_up_and_exits(tmp_path, capsys):
    """--warmup serves one synthetic request a shape; --warmup_only then
    prints one WARMSTART_JSON line and returns without binding a port."""
    write_tiny_checkpoints(str(tmp_path))
    serve.main(["--transformer", str(tmp_path / "transformer"), "--vae",
                str(tmp_path / "vae"), "--device", "cpu", "--warmup",
                "16x16x5:1,32x32x5:1", "--warmup_only"])
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("WARMSTART_JSON: ")]
    assert len(line) == 1
    shapes = json.loads(line[0].split(": ", 1)[1])["shapes"]
    assert [(s["shape"], s["steps"]) for s in shapes] \
        == [("16x16x5", 1), ("32x32x5", 1)]


def test_text_encoder_without_transformers_says_what_to_do(tmp_path,
                                                           monkeypatch):
    import builtins
    write_tiny_checkpoints(str(tmp_path))
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name.startswith("transformers"):
            raise ImportError("no transformers")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="install transformers"):
        serve.build_text_encoder_fn(str(tmp_path / "text_encoder"),
                                    device="cpu")


def test_train_takes_a_step_from_pretrained_weights(tmp_path, monkeypatch):
    """pretrained_transformer_path loads the DiT's safetensors (one file or
    a checkpoint directory) into the YAML's (here the smoke) config: the
    first step sees exactly the file's weights, and its loss follows
    them."""
    from frameino_tpu_torch.training import trainer
    from tests.test_torch_train_cli import _config
    data = write_fixture_dataset(str(tmp_path), 48, 64, 30)
    dit_cfg, _ = serve.smoke_configs()
    orig, seen = trainer.train_step, []

    def step(state, *args, **kw):
        seen.append({k: v.detach().clone()
                     for k, v in state.model.state_dict().items()})
        return orig(state, *args, **kw)
    monkeypatch.setattr(trainer, "train_step", step)

    def run(name, path=None):
        # one prefetch thread: the dataset's one random.Random is then
        # drawn in batch order, so every run sees the same batch
        kw = dict(max_train_steps=1, first_iter_validation=False,
                  experiment_name=name, checkpointing_steps=100,
                  dataloader_num_workers=1)
        if path:
            kw["pretrained_transformer_path"] = path
        cfg = _config(str(tmp_path), data, **kw)
        return train.main(["--config_path", cfg, "--smoke"])["history"][0]

    own = tdit.init_wan_dit(dit_cfg, _gen(0))       # the config's seed 0
    SIO.save_file(own.state_dict(), str(tmp_path / "own.safetensors"))
    other = tdit.init_wan_dit(dit_cfg, _gen(9))
    P.save_pretrained(str(tmp_path / "other"), dit_cfg, other)
    seeded = run("seeded")
    from_own = run("own", str(tmp_path / "own.safetensors"))
    from_other = run("other", str(tmp_path / "other"))
    for got, want in zip(seen, (own, own, other)):
        for k, v in want.state_dict().items():
            assert torch.equal(got[k], v), k
    # the same weights, batch and draws: the same loss
    assert from_own["loss"] == seeded["loss"]
    assert abs(from_other["loss"] - seeded["loss"]) > 1e-2
