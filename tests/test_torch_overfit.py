"""The port's convergence run (``frameino_tpu_torch/scripts/train_overfit.py``)
on the CPU against JAX's ``scripts/train_overfit_tpu.py``: the clip, the
PSNR helper, the probe loss, and a few steps of the overfit loop (JAX's
recipe: fp32 parameters and moments, bf16 compute) fed JAX's draws, at a
clip the gate can afford. The full 1,200-step run and its gates are
``slow`` here and run on the card (``chip_smoke.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import train_overfit_tpu as jscript  # noqa: E402

from frameino_tpu.training import (OptimizerConfig as JOptCfg,  # noqa: E402
                                   TrainerConfig as JTrainerConfig,
                                   init_train_state as jinit_state,
                                   make_optimizer as jmake_optimizer,
                                   make_train_step)
from frameino_tpu_torch.models import wan_dit as tdit  # noqa: E402
from frameino_tpu_torch.models.weights import wan_dit_from_jax  # noqa: E402
from frameino_tpu_torch.scripts import train_overfit as T  # noqa: E402
from frameino_tpu_torch.training.optim import OptimizerConfig  # noqa: E402
from frameino_tpu_torch.training.trainer import TrainerConfig  # noqa: E402

SMALL = (5, 16, 16)      # 3 latent frames of 8x8 + the ID frame: 64 tokens


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread. With six pytest-xdist workers on
    the host's cores, OpenMP regions of many threads over tiny ops wait on
    descheduled threads (a 3 s test read 154 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_shape(monkeypatch):
    """Points the JAX script's module constants at the small clip."""
    def set_shape(shape):
        for name, n in zip("FHW", shape):
            monkeypatch.setattr(jscript, name, n)
    return set_shape


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_configs_clip_and_psnr_match_jax(jax_shape):
    for field in dataclasses.fields(T.DIT_CFG):
        assert getattr(T.DIT_CFG, field.name) == getattr(jscript.DIT_CFG,
                                                         field.name)
    for field in dataclasses.fields(T.VAE_CFG):
        assert getattr(T.VAE_CFG, field.name) == getattr(jscript.VAE_CFG,
                                                         field.name)
    for shape in (T.SHAPE, SMALL):
        jax_shape(shape)
        for a, b in zip(T.synthetic_clip(shape), jscript.synthetic_clip()):
            np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(0)
    a, b = rs.randn(3, 7).astype(np.float32), rs.randn(3, 7)
    assert T.psnr(a, b, 2.0) == jscript.psnr(a, b, 2.0)
    assert T.psnr(a, a, 2.0) == jscript.psnr(a, a, 2.0)
    assert T.gates(5.01, 20.01, 25.01) == dict.fromkeys(T.GATES, True)
    assert T.gates(5.0, 20.0, 25.0) == dict.fromkeys(T.GATES, False)


def _latents(shape, seed=0):
    """Random stand-ins of the encoded clip (video, first frame,
    trajectory, ID) at the small clip's latent shape."""
    rs = np.random.RandomState(seed)
    f = (shape[0] - 1) // 2 + 1
    h, w = shape[1] // 2, shape[2] // 2
    z = T.VAE_CFG.z_dim
    return [rs.randn(1, z, n, h, w).astype(np.float32)
            for n in (f, 1, f, 1)]


@pytest.fixture(scope="module")
def dit_params():
    return jax.tree.map(np.asarray, jscript.wan_dit.init_wan_dit(
        jax.random.key(1), jscript.DIT_CFG))


def _port_model(params):
    model = tdit.WanDiT(T.DIT_CFG, device="meta")
    model.load_state_dict(wan_dit_from_jax(params, T.DIT_CFG), assign=True)
    return model


# relative difference of a bf16-compute loss between the port and JAX: the
# same inputs and weights, bf16 rounding at different places (JAX rounds
# each dense's fp32 kernel to bf16 as it multiplies and keeps the norms,
# biases and modulation tables in fp32; the port computes with one bf16
# copy of every tensor); read 6e-5 (probe) and up to 1.4e-4 (steps)
BF16_LOSS_RTOL = 2e-3


def test_probe_matches_jax(jax_shape, dit_params):
    jax_shape(SMALL)
    video, ff, traj, idl = _latents(SMALL)
    x0 = np.concatenate([ff, video[:, :, 1:]], axis=2)
    prompt = np.random.RandomState(1).randn(1, 16, 64).astype(np.float32)
    jprobe = jscript.make_probe_loss(jnp.asarray(x0), jnp.asarray(traj),
                                     jnp.asarray(idl), jnp.asarray(prompt))
    want = float(jprobe(jax.tree.map(jnp.asarray, dit_params)))
    noise = np.asarray(jax.random.normal(jax.random.key(123), x0.shape,
                                         jnp.float32))
    model = _port_model(dit_params).to(torch.bfloat16)
    t = [torch.from_numpy(np.array(a)) for a in (x0, traj, idl, prompt, noise)]
    got = float(T.make_probe(model, *t)())
    assert abs(got - want) <= BF16_LOSS_RTOL * want


def _jax_draws(step, x0_shape):
    """The draws inside JAX's step (``fold_in(key(42), step)``)."""
    k_idx, k_noise = jax.random.split(
        jax.random.fold_in(jax.random.key(42), step))
    idx = jax.random.randint(k_idx, (x0_shape[0],), 0, 1000)
    noise = jax.random.normal(k_noise, x0_shape, jnp.float32)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(noise))


def test_overfit_steps_match_jax(jax_shape, dit_params):
    """Four steps of the script's loop against JAX's step with the script's
    optimizer (lr 1e-3, 20 warm-up steps, cosine to step 40, no weight
    decay) and bf16 compute over fp32 state, on the same latents: each
    step's loss within BF16_LOSS_RTOL; the fp32 master weights moved as
    JAX's parameters moved, within 5e-2 relative L2 a tensor (Adam's
    m / sqrt(v) amplifies a bf16 rounding of a small gradient element to a
    whole lr step; the k biases, whose true gradient is 0 under the
    softmax, read up to 3.3e-2)."""
    jax_shape(SMALL)
    steps = 4
    video, ff, traj, idl = _latents(SMALL)
    prompt = np.random.RandomState(1).randn(1, 16, 64).astype(np.float32)
    names = ("video_latents", "first_frame_latent", "traj_latents",
             "id_latents")
    ocfg = dict(learning_rate=1e-3, lr_warmup_steps=20,
                lr_scheduler="cosine", max_train_steps=40,
                weight_decay=0.0)
    opt = jmake_optimizer(JOptCfg(**ocfg))
    jstate = jinit_state(jax.tree.map(jnp.array, dit_params), opt)
    jstep = make_train_step(jscript.DIT_CFG, jscript.VAE_CFG,
                            JTrainerConfig(remat=False), opt)
    jbatch = {n: jnp.asarray(a) for n, a in zip(names,
                                                (video, ff, traj, idl))}
    jbatch["prompt_embeds"] = jnp.asarray(prompt)
    want = []
    for _ in range(steps):
        jstate, m = jstep(jstate, None, jbatch, jax.random.key(42))
        want.append(float(m["loss"]))

    model = _port_model(dit_params)
    tocfg = OptimizerConfig(**ocfg)
    tcfg = TrainerConfig(optimizer=tocfg, remat=False)
    state = T.init_state(model, tocfg, torch.float32, torch.bfloat16)
    master = state.optimizer.master
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    latents = {n: torch.from_numpy(a) for n, a in zip(
        names, (video, ff, traj, idl))}
    latents["prompt_embeds"] = torch.from_numpy(prompt)
    x0_shape = (1, T.VAE_CFG.z_dim, video.shape[2], *video.shape[3:])
    out = T.train(state, tcfg, latents, steps, lambda: torch.zeros(()),
                  draws=lambda i: _jax_draws(i, x0_shape))
    np.testing.assert_allclose(out["loss_hist"], want, rtol=BF16_LOSS_RTOL)
    assert [r[0] for r in out["probe_curve"]] == [0, steps - 1]
    start = wan_dit_from_jax(dit_params, T.DIT_CFG)
    ref = wan_dit_from_jax(jax.tree.map(np.asarray, jstate.params),
                           T.DIT_CFG)
    for name, p in master.items():
        assert p.dtype == torch.float32
        moved, jmoved = p - start[name], ref[name] - start[name]
        if float(jmoved.norm()) > 0:
            assert _rel(moved, jmoved) <= 5e-2, name
        # the compute copy is the master's bf16 rounding
        assert torch.equal(dict(model.named_parameters())[name].detach(),
                           p.to(torch.bfloat16))


def test_script_runs_both_state_dtypes(tmp_path):
    """The entry at the small clip, a few steps: a finite report under
    ``--out`` with every key, gates as booleans (not passed in 3 steps),
    exit code 1."""
    for dtype in ("fp32", "bf16"):
        out = tmp_path / f"{dtype}.json"
        rc = T.main(["--device", "cpu", "--state_dtype", dtype, "--steps",
                     "3", "--sample_steps", "2", "--out", str(out)],
                    shape=SMALL)
        report = json.loads(out.read_text())
        assert rc == 1 and report["ok"] is False
        assert report["finite"] and report["state_dtype"] == dtype
        assert report["gates"].keys() == T.GATES.keys()
        assert [r[0] for r in report["probe_curve"]] == [0, 2]
        # the CPU runs the kernels' plain versions: no launch counted
        assert set(report["launches"].values()) == {0}


@pytest.mark.slow
def test_convergence_gates_pass_in_fp32(tmp_path):
    """The full run on the CPU (tens of minutes): JAX's three gates."""
    out = tmp_path / "fp32.json"
    r = subprocess.run(
        [sys.executable, "-m", "frameino_tpu_torch.scripts.train_overfit",
         "--device", "cpu", "--state_dtype", "fp32", "--steps", "1200",
         "--lr_scheduler", "cosine", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=6 * 3600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert all(json.loads(out.read_text())["gates"].values())
