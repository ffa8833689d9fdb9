"""The port's checkpoint verification harness
(``frameino_tpu_torch/scripts/verify_checkpoint.py``) on the CPU: its
selftest; ``compare`` of each of the six models on a directory the port
writes against a golden the JAX package computes there, in the layout of
the JAX script's ``dump``; the JAX script's own ``compare_*`` on the same
files; planted faults; the bf16 verdict; goldens made by the port's own
forward.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_dit as jcdit
from frameino_tpu.models import cogvideox_vae as jcvae
from frameino_tpu.models import pretrained as JP
from frameino_tpu.models import t5_encoder as jt5
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.schedulers import ddim as jddim
from frameino_tpu.schedulers import flow_match_euler as jfm
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import cogvideox_vae as tcvae
from frameino_tpu_torch.models import pretrained as P
from frameino_tpu_torch.models import safetensors_io as SIO
from frameino_tpu_torch.models import t5_encoder as tt5
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.scripts import verify_checkpoint as V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

VAE_KW = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              temperal_downsample=(True,), is_residual=False,
              scale_factor_temporal=2, scale_factor_spatial=2,
              latents_mean=tuple(np.linspace(-1, 1, 4).tolist()),
              latents_std=tuple(np.linspace(0.5, 2.5, 4).tolist()))
WAN21_KW = dict(in_channels=12, out_channels=4, image_dim=8,
                added_kv_proj_dim=48)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread beside the other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    """The JAX package's ``scripts/verify_checkpoint.py``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import verify_checkpoint
    return verify_checkpoint


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _write(tmp_path, name, cfg, module):
    d = str(tmp_path / name)
    P.save_pretrained(d, cfg, module)
    return d


def _save(tmp_path, g, name="golden.npz"):
    path = str(tmp_path / name)
    np.savez(path, **g)
    return path


# ---------------------------------------------------------------------------
# Goldens computed by the JAX package on the port's directories
# ---------------------------------------------------------------------------

def _golden_umt5(d):
    cfg, params = JP.from_pretrained(d)
    ids = np.random.RandomState(0).randint(2, cfg.vocab_size, (2, 16))
    attn = np.ones_like(ids)
    attn[1, 10:] = 0
    h = jt5.t5_encode(cfg, params, jnp.asarray(ids), jnp.asarray(attn))
    return {"input_ids": ids, "attention_mask": attn,
            "hidden_states": np.asarray(h)}


def _golden_wan_dit(d, jax_script):
    cfg, params = JP.from_pretrained(d)
    g = V.wan_dit_inputs(cfg, 0)
    g["output"] = np.asarray(jdit.wan_dit_forward(
        cfg, params, jnp.asarray(g["latents"]), jnp.asarray(g["timestep"]),
        jnp.asarray(g["text"]), attn_impl="xla"))
    n = cfg.num_layers
    g["num_blocks"] = np.array(n)
    for name, i in zip(V.BLOCK_TAPS, (0, n // 2, n - 1)):
        g[name] = np.asarray(jax_script.wan_dit_block_tap(cfg, params, g, i))
    return g


def _golden_wan_vae(d):
    cfg, params = JP.from_pretrained(d)
    g = {"pixels": V._seeded((1, 3, 9, 64, 64), 0, 0.5),
         "latents": V._seeded((1, cfg.z_dim, 3, 8, 8), 1)}
    g["enc_mode"] = np.asarray(jvae.encode(cfg, params,
                                           jnp.asarray(g["pixels"])))
    g["decoded"] = np.asarray(jvae.decode(cfg, params,
                                          jnp.asarray(g["latents"])))
    return g


def _golden_cog_vae(d):
    cfg, params = JP.from_pretrained(d)
    g = {"pixels": V._seeded((1, 3, 9, 64, 64), 0, 0.5),
         "latents": V._seeded((1, cfg.latent_channels, 3, 8, 8), 1)}
    g["enc_mode"] = np.asarray(jcvae.encode(
        cfg, params, jnp.asarray(g["pixels"]), sample_mode="argmax"))
    g["decoded"] = np.asarray(jcvae.decode(cfg, params,
                                           jnp.asarray(g["latents"])))
    return g


def _golden_cog_dit(d):
    cfg, params = JP.from_pretrained(d)
    F, H, W = 2, cfg.sample_height, cfg.sample_width
    g = {"latents": V._seeded((1, F, cfg.in_channels, H, W), 0),
         "text": V._seeded((1, cfg.max_text_seq_length, cfg.text_embed_dim),
                           1),
         "timestep": np.array([500.0], np.float32)}
    rope = tuple(jnp.asarray(r)
                 for r in jcdit.cogvideox_rope(cfg, F, H, W))
    g["output"] = np.asarray(jcdit.cogvideox_forward(
        cfg, params, jnp.asarray(g["latents"]), jnp.asarray(g["text"]),
        jnp.asarray(g["timestep"]), image_rotary_emb=rope, attn_impl="xla"))
    return g


def _model_dir(tmp_path, model, jax_script):
    """(directory the port wrote, golden JAX computed on it)."""
    g = _gen(0)
    if model == "umt5":
        cfg = tt5.tiny_config()
        d = _write(tmp_path, model, cfg, tt5.init_t5_encoder(cfg, g))
        return d, _golden_umt5(d)
    if model == "wan_dit":
        cfg = tdit.tiny_config(num_layers=3)
        d = _write(tmp_path, model, cfg, tdit.init_wan_dit(cfg, g))
        return d, _golden_wan_dit(d, jax_script)
    if model == "wan_vae":
        cfg = tvae.WanVAEConfig(**VAE_KW)
        d = _write(tmp_path, model, cfg, tvae.init_wan_vae(cfg, g))
        return d, _golden_wan_vae(d)
    if model == "cog_vae":
        cfg = tcvae.tiny_vae_config()
        d = _write(tmp_path, model, cfg, tcvae.init_cogvideox_vae(cfg, g))
        return d, _golden_cog_vae(d)
    if model == "cog_dit":
        cfg = tcdit.tiny_config()
        d = _write(tmp_path, model, cfg, tcdit.init_cogvideox_dit(cfg, g))
        return d, _golden_cog_dit(d)
    d = str(tmp_path / model)
    os.makedirs(d)
    with open(os.path.join(d, "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "num_train_timesteps": 1000, "shift": 5.0}, f)
    sig, ts = jfm.inference_sigmas(jfm.FlowMatchEulerConfig(shift=5.0), 12)
    return d, {"class_name": np.array("FlowMatchEulerDiscreteScheduler"),
               "timesteps": np.asarray(ts, np.float64),
               "sigmas": np.asarray(sig, np.float64)}


MODELS = ["umt5", "wan_dit", "wan_vae", "cog_vae", "cog_dit", "scheduler"]


@pytest.mark.parametrize("model", MODELS)
def test_compare_passes_on_a_jax_golden(tmp_path, jax_script, model):
    """The port's ``compare`` (the entry point, ``--device cpu``) passes on
    each model, every tensor of the golden checked (the Wan DiT's three
    block taps too); the JAX script's ``compare_*`` passes on the same
    files, but for the Wan VAE, whose JAX comparer hands the channels-first
    golden to the channels-last encoder and raises."""
    d, g = _model_dir(tmp_path, model, jax_script)
    path = _save(tmp_path, g)
    rc = V.main(["compare", "--model", model, "--checkpoint", d,
                 "--golden", path, "--device", "cpu"])
    assert rc == 0
    lines, ok = V.compare(model, d, path, CPU)
    assert ok and all(line.startswith("PASS") for line in lines)
    if model == "wan_dit":
        assert len(lines) == 4
    with jax.default_matmul_precision("highest"):
        if model == "wan_vae":
            with pytest.raises(ValueError):
                jax_script.COMPARERS[model](d, dict(np.load(path)),
                                            jax_script.TOL[model])
            return
        _, jok = jax_script.COMPARERS[model](d, dict(np.load(path)),
                                             jax_script.TOL[model])
    assert jok


def _swap_tensors(d, a, b):
    """Plant a fault in a checkpoint: tensors ``a`` and ``b`` swapped."""
    path = os.path.join(d, "model.safetensors")
    # copies: the reader maps the file that is rewritten below
    sd = {k: v.clone() for k, v in SIO.load_file(path).items()}
    sd[a], sd[b] = sd[b], sd[a]
    SIO.save_file(sd, path)


@pytest.mark.parametrize("model,a,b", [
    ("wan_dit", "blocks.0.attn1.to_q.weight", "blocks.2.attn1.to_q.weight"),
    ("umt5", "encoder.block.0.layer.0.SelfAttention.q.weight",
     "encoder.block.1.layer.0.SelfAttention.q.weight"),
    ("wan_vae", "encoder.conv_in.weight", "encoder.conv_in.weight")])
def test_planted_faults_fail(tmp_path, jax_script, model, a, b):
    """A checkpoint with one block's to_q swapped with another's, or a
    golden whose decode was moved, fails with exit code 1."""
    d, g = _model_dir(tmp_path, model, jax_script)
    if a == b:
        g["decoded"] = g["decoded"] + 1e-2
    else:
        _swap_tensors(d, a, b)
    path = _save(tmp_path, g)
    assert V.main(["compare", "--model", model, "--checkpoint", d,
                   "--golden", path, "--device", "cpu"]) == 1


def test_wan21_dit_with_image_states(tmp_path, jax_script):
    """A Wan2.1 I2V directory: JAX's comparer and the port's pass on a
    golden without ``image`` (the dump's layout); the port's takes the
    golden's ``image`` key into the image branch (JAX's forward on it as
    the reference), and fails when the states are left out of the
    replay."""
    cfg = tdit.tiny_config(**WAN21_KW)
    d = _write(tmp_path, "wan21", cfg, tdit.init_wan_dit(cfg, _gen(1)))
    g = _golden_wan_dit(d, jax_script)
    path = _save(tmp_path, g, "plain.npz")
    assert V.compare("wan_dit", d, path, CPU)[1]
    with jax.default_matmul_precision("highest"):
        assert jax_script.compare_wan_dit(d, dict(np.load(path)),
                                          jax_script.TOL["wan_dit"])[1]
    jcfg, params = JP.from_pretrained(d)
    gi = V.wan_dit_inputs(jcfg, 0, with_image=True)
    gi["output"] = np.asarray(jdit.wan_dit_forward(
        jcfg, params, jnp.asarray(gi["latents"]), jnp.asarray(gi["timestep"]),
        jnp.asarray(gi["text"]), jnp.asarray(gi["image"]), attn_impl="xla"))
    path = _save(tmp_path, gi, "image.npz")
    assert V.compare("wan_dit", d, path, CPU)[1]
    gi.pop("image")
    assert not V.compare("wan_dit", d, _save(tmp_path, gi, "no_image.npz"),
                         CPU)[1]


def test_bf16_verdict_is_relative_l2(tmp_path, monkeypatch):
    """``--dit_dtype bf16``: the elementwise line is printed unjudged and
    the verdict is the relative L2 against DIT_BF16_REL_L2 (a failure with
    no limit set); the port's own fp32 golden passes its fp32 compare
    exactly."""
    cfg = tdit.tiny_config(**WAN21_KW)
    model = tdit.init_wan_dit(cfg, _gen(2))
    d = _write(tmp_path, "w", cfg, model)
    path = _save(tmp_path, V.golden_wan_dit(model, with_image=True))
    lines, ok = V.compare("wan_dit", d, path, CPU)
    assert ok and "max_abs=0.000e+00" in lines[0]
    monkeypatch.setattr(V, "DIT_BF16_REL_L2", None)
    lines, ok = V.compare("wan_dit", d, path, CPU, torch.bfloat16)
    assert not ok and len(lines) == 8
    assert lines[0].startswith("(elementwise) wan_dit.output")
    r = float(lines[1].split("rel_l2=")[1].split()[0])
    assert 0 < r < 0.1
    monkeypatch.setattr(V, "DIT_BF16_REL_L2", 1.5 * r)
    assert V.compare("wan_dit", d, path, CPU, torch.bfloat16)[0][1] \
        .startswith("PASS wan_dit.output")


def test_port_goldens_match_the_vae_and_umt5(tmp_path):
    """The port's fp32 goldens of a tiny Wan VAE and UMT5 (the card run's
    references) pass their compare; the DDIM tables of a CogVideoX
    scheduler config against JAX's."""
    vcfg = tvae.WanVAEConfig(**VAE_KW)
    vae = tvae.init_wan_vae(vcfg, _gen(3))
    d = _write(tmp_path, "vae", vcfg, vae)
    assert V.compare("wan_vae", d, _save(tmp_path, V.golden_wan_vae(vae),
                                         "v.npz"), CPU)[1]
    tcfg = tt5.tiny_config()
    enc = tt5.init_t5_encoder(tcfg, _gen(4))
    d = _write(tmp_path, "umt5", tcfg, enc)
    assert V.compare("umt5", d, _save(tmp_path, V.golden_umt5(enc), "u.npz"),
                     CPU)[1]
    d = str(tmp_path / "ddim")
    os.makedirs(d)
    with open(os.path.join(d, "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "CogVideoXDDIMScheduler",
                   "snr_shift_scale": 1.0}, f)
    jcfg = jddim.DDIMConfig(snr_shift_scale=1.0)
    g = {"class_name": np.array("CogVideoXDDIMScheduler"),
         "alphas_cumprod": np.asarray(jddim.ddim_alphas_cumprod(jcfg),
                                      np.float64),
         "timesteps": np.asarray(jddim.inference_timesteps(jcfg, 10),
                                 np.float64)}
    assert V.compare("scheduler", d, _save(tmp_path, g, "s.npz"), CPU)[1]


def test_selftest_on_the_cpu(tmp_path):
    """``selftest --device cpu``: the transformers UMT5 golden, the three
    DiT round trips (Wan2.2, Wan2.1 I2V, CogVideoX) and the scheduler."""
    assert V.main(["selftest", "--tmpdir", str(tmp_path), "--device",
                   "cpu"]) == 0


def test_card_is_the_default_device():
    """Without a card the default device raises; a float32 DiT on the card
    is refused (its kernels take bf16)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        V.main(["selftest", "--tmpdir", "unused"])
    with pytest.raises(ValueError, match="bf16"):
        V.compare("wan_dit", "unused", "unused", torch.device("cuda"),
                  torch.float32)
