"""The PyTorch port's trainer on the CPU against the JAX package: three
train steps against ``make_train_step`` fed the same timestep indices and
noise, the optimizer against optax, the stratified sampler, the
patch-embedding surgery, the dataset copy, and checkpoint resume. Tiny
configs, fp32; inputs drawn from a seed with numpy (or JAX's own draws,
handed to the port).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frameino_tpu.data.frameino_dataset import (FrameINODataset as JDataset,
                                                FrameINODatasetConfig as JDCfg)
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.schedulers import flow_match_euler as jfm
from frameino_tpu.training import optim as joptim
from frameino_tpu.training import surgery as jsurgery
from frameino_tpu.training import trainer as jtrainer
from frameino_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                restore_checkpoint,
                                                save_checkpoint)
from frameino_tpu_torch.data.fixture import write_fixture_dataset
from frameino_tpu_torch.data.frameino_dataset import (FrameINODataset,
                                                      FrameINODatasetConfig)
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (wan_dit_from_jax,
                                               wan_vae_from_jax)
from frameino_tpu_torch.schedulers import flow_match_euler as tfm
from frameino_tpu_torch.training import optim as toptim
from frameino_tpu_torch.training import surgery as tsurgery
from frameino_tpu_torch.training import trainer as ttrainer
from frameino_tpu_torch.training.noise_sampler import \
    stratified_timestep_indices

# the tiny VAE / DiT and trainer config of tests/test_training.py
VAE_KW = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              temperal_downsample=(True,), is_residual=False, patch_size=None,
              scale_factor_temporal=2, scale_factor_spatial=2,
              latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
DIT_KW = dict(in_channels=8, out_channels=4)
JTCFG = jtrainer.TrainerConfig(compute_dtype=jnp.float32, remat=False,
                               attn_impl="xla")
TTCFG = ttrainer.TrainerConfig(compute_dtype=torch.float32, remat=False)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0, B=2, F=9, H=16, W=16):
    rs = np.random.RandomState(seed)

    def a(*shape, tanh=True):
        x = rs.randn(*shape)
        return (np.tanh(x) if tanh else x).astype(np.float32)
    return {"video_tensor": a(B, F, 3, H, W),
            "first_frame_tensor": a(B, 3, H, W),
            "traj_tensor": a(B, F, 3, H, W),
            "ID_tensor": a(B, 1, 3, H, W),
            "prompt_embeds": a(B, 7, 16, tanh=False)}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_draws(key, step, x0_shape):
    """The draws inside the JAX step: fold_in(key, step), split, randint
    indices, normal noise (world size 1)."""
    k_idx, k_noise = jax.random.split(jax.random.fold_in(key, step))
    idx = jax.random.randint(k_idx, (x0_shape[0],), 0, 1000)
    noise = jax.random.normal(k_noise, x0_shape, jnp.float32)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(
        np.array(noise))


def test_train_steps_match_jax():
    """Three steps of AdamW (lr 1e-3, warmup 1, clip 1.0) from the same
    weights: loss and grad_norm at each step, every parameter after."""
    jvcfg, tvcfg = jvae.WanVAEConfig(**VAE_KW), tvae.WanVAEConfig(**VAE_KW)
    jdcfg, tdcfg = jdit.tiny_config(**DIT_KW), tdit.tiny_config(**DIT_KW)
    vae_params = jvae.init_wan_vae(jax.random.key(0), jvcfg)
    dit_params = jdit.init_wan_dit(jax.random.key(1), jdcfg)
    ocfg = dict(learning_rate=1e-3, lr_warmup_steps=1)
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**ocfg))
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.array, dit_params),
                                       opt)
    jstep = jtrainer.make_train_step(jdcfg, jvcfg, JTCFG, opt)

    model = tdit.WanDiT(tdcfg, device="meta")
    model.load_state_dict(wan_dit_from_jax(_tree_np(dit_params), tdcfg),
                          assign=True)
    vae = tvae.WanVAE(tvcfg, device="meta")
    vae.load_state_dict(wan_vae_from_jax(_tree_np(vae_params), tvcfg),
                        assign=True)
    state = ttrainer.init_train_state(model, toptim.OptimizerConfig(**ocfg))

    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = jax.random.key(42)
    x0_shape = (2, 4, 5, 8, 8)            # 9 frames -> 5 latent frames
    for i in range(3):
        draws = _jax_draws(key, i, x0_shape)
        jstate, jm = jstep(jstate, vae_params,
                           {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tm = ttrainer.train_step(state, vae, TTCFG, tbatch, seed=0,
                                 draws=draws)
        # fp32 through the VAE encodes, 2 blocks forward and backward
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 3
    want = wan_dit_from_jax(_tree_np(jstate.params), tdcfg)
    start = wan_dit_from_jax(_tree_np(dit_params), tdcfg)
    for name, p in model.named_parameters():
        # Adam's m / sqrt(v) is ~sign(g) for every element, so compare the
        # two steps' movement per tensor: relative L2 1e-3
        moved, ref = p.detach() - start[name], want[name] - start[name]
        err = float((moved - ref).norm() / ref.norm().clamp(min=1e-12))
        assert err <= 1e-3, (name, err)


def test_loss_draws_its_own_noise_per_step():
    """Without explicit draws each step takes its indices and noise from
    a generator seeded by (seed, step): the same step repeats exactly,
    another step differs."""
    tdcfg = tdit.tiny_config(**DIT_KW)
    model = tdit.init_wan_dit(tdcfg, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    lat = [torch.from_numpy(rs.randn(*s).astype(np.float32))
           for s in ((1, 4, 3, 4, 4), (1, 4, 1, 4, 4), (1, 4, 3, 4, 4),
                     (1, 4, 1, 4, 4))]
    text = torch.zeros(1, 5, 16)

    def loss(step):
        gen = ttrainer.step_generator(7, step, "cpu")
        return ttrainer.wan_fm_loss(model, TTCFG, *lat, text, gen).item()
    assert loss(0) == loss(0) and loss(0) != loss(1)


def test_training_sigma_lookup_matches_jax():
    cfg = tfm.FlowMatchEulerConfig()
    np.testing.assert_array_equal(
        tfm.flow_match_sigmas(cfg),
        np.asarray(jfm.flow_match_sigmas(jfm.FlowMatchEulerConfig())))
    idx = np.array([0, 17, 500, 999])
    tab = torch.from_numpy(tfm.flow_match_sigmas(cfg))
    jtab = jnp.asarray(jfm.flow_match_sigmas(jfm.FlowMatchEulerConfig()))
    np.testing.assert_array_equal(
        (tab * cfg.num_train_timesteps)[torch.from_numpy(idx)].numpy(),
        np.asarray((jtab * cfg.num_train_timesteps)[idx]))


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

def _run_both(ocfg, grad_seq):
    """Apply the gradient sequence with optax (make_optimizer) and with
    the port; returns the two parameter trajectories."""
    p0 = {"w": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3),
          "b": np.array([0.5, -0.25], np.float32)}
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**ocfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = toptim.make_optimizer(toptim.OptimizerConfig(**ocfg), tp)
    traj_j, traj_t = [], []
    for g in grad_seq:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        traj_j.append({k: np.asarray(v) for k, v in jp.items()})
        traj_t.append({k: v.numpy().copy() for k, v in tp.items()})
    return traj_j, traj_t


def _grads(n, scale, seed=0):
    rs = np.random.RandomState(seed)
    return [{"w": (scale * rs.randn(2, 3)).astype(np.float32),
             "b": (scale * rs.randn(2)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("case", [
    # warmup: lr 0 on the first update, then the ramp; gradients above and
    # below the clip norm
    dict(ocfg=dict(learning_rate=1e-2, lr_warmup_steps=3), scale=3.0),
    dict(ocfg=dict(learning_rate=1e-2, lr_warmup_steps=3), scale=0.05),
    dict(ocfg=dict(learning_rate=1e-2, lr_scheduler="constant",
                   optimizer="adam", max_grad_norm=0.5), scale=1.0),
    dict(ocfg=dict(learning_rate=1e-2, lr_scheduler="cosine",
                   lr_warmup_steps=2, max_train_steps=6), scale=1.0),
    # MultiSteps over 2
    dict(ocfg=dict(learning_rate=1e-2, lr_scheduler="constant",
                   gradient_accumulation_steps=2), scale=2.0),
], ids=["warmup_clipped", "warmup_unclipped", "adam_clip", "cosine",
        "accumulate_2"])
def test_optimizer_matches_optax(case):
    traj_j, traj_t = _run_both(case["ocfg"], _grads(6, case["scale"]))
    for j, t in zip(traj_j, traj_t):
        for k in j:
            # fp32, the same operations in the same order: 1e-6
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=1e-6)


def test_warmup_first_update_is_zero_and_nonfinite_is_skipped():
    ocfg = dict(learning_rate=1e-2, lr_warmup_steps=2,
                skip_nonfinite_updates=True)
    grads = _grads(4, 1.0)
    grads[2] = {k: np.full_like(v, np.nan) for k, v in grads[2].items()}
    traj_j, traj_t = _run_both(ocfg, grads)
    p0_w = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(traj_t[0]["w"], p0_w)       # lr 0
    assert not np.array_equal(traj_t[1]["w"], p0_w)
    np.testing.assert_array_equal(traj_t[2]["w"], traj_t[1]["w"])  # NaN
    for j, t in zip(traj_j, traj_t):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["adafactor", "prodigy"])
def test_unported_optimizers_raise(name):
    """adafactor and prodigy are ported (tests/test_torch_optim_rules.py
    holds them to optax); a rule the JAX package does not have raises as
    JAX's ``make_optimizer`` does."""
    toptim.make_optimizer(toptim.OptimizerConfig(optimizer=name),
                          {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="unsupported optimizer"):
        toptim.make_optimizer(toptim.OptimizerConfig(optimizer=name + "8bit"),
                              {"w": torch.zeros(2)})


def test_clip_reports_the_unclipped_norm():
    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([12.0])}
    assert float(toptim.global_norm(g.values())) == 13.0
    assert float(toptim.global_norm(g.values())) == float(
        optax.global_norm({"a": jnp.asarray([3.0, 4.0]),
                           "b": jnp.asarray([12.0])}))


# ---------------------------------------------------------------------------
# sampler, surgery, dataset
# ---------------------------------------------------------------------------

class TestStratifiedSampling:
    """The properties tests/test_training.py holds the JAX sampler to."""

    def test_single_shard_uniform(self):
        idx = stratified_timestep_indices(torch.Generator().manual_seed(0),
                                          4096, 1000, 1)
        assert idx.shape == (4096,)
        assert int(idx.min()) >= 0 and int(idx.max()) < 1000

    def test_strata_cover_schedule(self):
        B, W = 8, 4
        idx = stratified_timestep_indices(torch.Generator().manual_seed(1),
                                          B, 1000, W).numpy()
        per_rank = B // W
        for b in range(B):
            lo = (b // per_rank) * 250
            assert lo <= idx[b] < lo + 250, (b, idx[b])

    def test_world_size_not_dividing(self):
        idx = stratified_timestep_indices(torch.Generator().manual_seed(2),
                                          6, 1000, 3).numpy()
        assert idx.min() >= 0 and idx.max() < 1000


def test_surgery_matches_jax_through_the_bridge():
    """Widen 8 -> 12 input channels: JAX surgery then the bridge equals
    the bridge then the port's surgery, and the new channels are zero."""
    cfg8 = tdit.tiny_config(in_channels=8, out_channels=4)
    cfg12 = dataclasses.replace(cfg8, in_channels=12)
    params = jdit.init_wan_dit(jax.random.key(4),
                               jdit.tiny_config(in_channels=8,
                                                out_channels=4))
    want = wan_dit_from_jax(_tree_np(jsurgery.wan_stage1_surgery(
        params, 8, 12)), cfg12)
    got = tsurgery.wan_stage1_surgery(wan_dit_from_jax(_tree_np(params),
                                                       cfg8), 12)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    assert not got["patch_embedding.weight"][:, 8:].any()
    model = tdit.WanDiT(cfg12, device="meta")
    model.load_state_dict(got, assign=True)


def test_dataset_copy_matches_jax(tmp_path):
    """The same fixture and seed through both datasets: identical arrays
    and prompt."""
    data = write_fixture_dataset(str(tmp_path), 48, 64, 30)
    kw = dict(target_height=32, target_width=64, sample_accelerate_factor=1,
              train_frame_num_range=(13, 13), min_train_frame_num=9,
              drop_FrameIn_prob=0.3)
    for seed in (0, 1):
        j = JDataset(JDCfg(**kw), data, "csvs", "videos", "ids", seed=seed)
        t = FrameINODataset(FrameINODatasetConfig(**kw), data, "csvs",
                            "videos", "ids", seed=seed)
        for i in range(len(j)):
            a, b = j[i], t[i]
            assert a["text_prompt"] == b["text_prompt"]
            for key in ("video_tensor", "traj_tensor", "first_frame_tensor",
                        "ID_tensor", "traj_imgs_np", "merge_frames"):
                np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tiny_state(seed=0):
    tdcfg = tdit.tiny_config(**DIT_KW)
    model = tdit.init_wan_dit(tdcfg, torch.Generator().manual_seed(seed))
    return ttrainer.init_train_state(
        model, toptim.OptimizerConfig(learning_rate=1e-3, lr_warmup_steps=2))


def test_checkpoint_resume_continues_exactly(tmp_path):
    """2 steps, save, restore into a fresh state, 1 step == 3 steps
    uninterrupted (bit-equal parameters and moments); the rolling limit
    keeps the newest checkpoints."""
    rs = np.random.RandomState(0)
    batch = {"video_latents": rs.randn(1, 4, 3, 4, 4),
             "first_frame_latent": rs.randn(1, 4, 1, 4, 4),
             "traj_latents": rs.randn(1, 4, 3, 4, 4),
             "id_latents": rs.randn(1, 4, 1, 4, 4),
             "prompt_embeds": rs.randn(1, 5, 16)}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    straight = _tiny_state()
    for _ in range(3):
        ttrainer.train_step(straight, None, TTCFG, batch, seed=3)

    first = _tiny_state()
    for _ in range(2):
        ttrainer.train_step(first, None, TTCFG, batch, seed=3)
    root = str(tmp_path / "ckpts")
    save_checkpoint(root, 1, first, total_limit=2)
    save_checkpoint(root, 2, first, metadata={"epoch_seed": 5},
                    total_limit=2)
    save_checkpoint(root, 2, first, metadata={"epoch_seed": 5},
                    total_limit=2)                      # idempotent
    latest = latest_checkpoint(root)
    assert latest.endswith("checkpoint-2")
    assert sorted(os.listdir(root)) == ["checkpoint-1", "checkpoint-2"]
    resumed, meta = restore_checkpoint(latest, _tiny_state(seed=9))
    assert meta == {"epoch_seed": 5} and resumed.step == 2
    ttrainer.train_step(resumed, None, TTCFG, batch, seed=3)
    for (n, a), (_, b) in zip(straight.model.named_parameters(),
                              resumed.model.named_parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
    for n in straight.optimizer.mu:
        torch.testing.assert_close(straight.optimizer.nu[n],
                                   resumed.optimizer.nu[n], atol=0, rtol=0)
    assert resumed.optimizer.count == straight.optimizer.count == 3
    save_checkpoint(root, 3, resumed, total_limit=2)
    assert sorted(os.listdir(root)) == ["checkpoint-2", "checkpoint-3"]
