"""The PyTorch port's CogVideoX trainer on the CPU against the JAX package:
the DDIM training functions, the VAE's sampled encode, the differentiable
DiT (remat off and on), ``cog_vpred_loss`` and its gradients in Stage 2 and
``--stage1``, one whole ``cog_train_step`` against ``make_cog_train_step``,
and the stage-1 surgery. Tiny configs in fp32; inputs drawn from a seed
with numpy, and JAX's own random draws handed to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cogvideox_dit as jdit
from frameino_tpu.models import cogvideox_vae as jvae
from frameino_tpu.schedulers import ddim as jddim
from frameino_tpu.training import cog_trainer as jcog
from frameino_tpu.training import optim as joptim
from frameino_tpu.training import surgery as jsurgery
from frameino_tpu.training.trainer import init_train_state as jinit_state
from frameino_tpu_torch.models import cogvideox_dit as tdit
from frameino_tpu_torch.models import cogvideox_vae as tvae
from frameino_tpu_torch.models.weights import (cogvideox_dit_from_jax,
                                               cogvideox_vae_from_jax)
from frameino_tpu_torch.schedulers import ddim as tddim
from frameino_tpu_torch.training import cog_trainer as tcog
from frameino_tpu_torch.training import optim as toptim
from frameino_tpu_torch.training import surgery as tsurgery
from frameino_tpu_torch.training import trainer as ttrainer

# the tiny DiT of tests/test_cog_training.py: in 12 = 4 noisy + 4 image + 4
# trajectory latent channels
JDIT, TDIT = jdit.tiny_config(), tdit.tiny_config()
JVAE, TVAE = jvae.tiny_vae_config(), tvae.tiny_vae_config()
# fp32 on both sides: the loss to 1e-5 relative, the gradients to 1e-4
# relative L2 per tensor (the same products summed in another order)
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def dit_params():
    return jdit.init_cogvideox_dit(jax.random.key(1), JDIT)


def _model(params, cfg=TDIT):
    """The port's DiT on copies of the JAX weights (a numpy view of a JAX
    array may share its memory, and the optimizer updates in place)."""
    m = tdit.CogVideoXDiT(cfg, device="meta")
    m.load_state_dict({k: v.clone() for k, v in cogvideox_dit_from_jax(
        _np(params), cfg).items()}, assign=True)
    return m.train()


def _grads_to_state_dict(grads, cfg=TDIT):
    """JAX parameter gradients under the port's names (the bridge is
    linear, so it carries a gradient tree as it carries the weights)."""
    return cogvideox_dit_from_jax(_np(grads), cfg)


def _assert_grads_match(model, want):
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        err = _rel_l2(p.grad.numpy(), want[name].numpy())
        assert err <= GRAD_REL_L2, (name, err)


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def test_ddim_training_functions_match_jax():
    assert dataclasses.asdict(tddim.DDIMConfig()) == dataclasses.asdict(
        jddim.DDIMConfig())
    np.testing.assert_array_equal(
        tddim.ddim_alphas_cumprod(tddim.DDIMConfig()),
        jddim.ddim_alphas_cumprod(jddim.DDIMConfig()))
    ac = jddim.ddim_alphas_cumprod(jddim.DDIMConfig()).astype(np.float32)
    rs = np.random.RandomState(0)
    x0, noise = (rs.randn(3, 2, 4, 5, 5).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 517, 999])
    for jfn, tfn in ((jddim.ddim_add_noise, tddim.ddim_add_noise),
                     (jddim.get_velocity, tddim.get_velocity)):
        want = np.asarray(jfn(jnp.asarray(ac), x0, noise, jnp.asarray(t)))
        got = tfn(torch.from_numpy(ac), torch.from_numpy(x0),
                  torch.from_numpy(noise), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the differentiable DiT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_differentiable_forward_and_gradients_match_jax(dit_params, remat):
    """Output and every parameter gradient of <out, cotangent> against
    ``jax.value_and_grad`` of ``cogvideox_forward(differentiable=True)``:
    3 latent frames + the ID frame of 4x4, 8 text tokens."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 4, 12, 4, 4).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    t = np.array([321.0], np.float32)
    ct = rs.randn(1, 4, 4, 4, 4).astype(np.float32)
    cos, sin = jdit.cogvideox_rope(JDIT, 3, 4, 4,
                                   duplicate_first_frame_for_id=True)

    def f(params):
        out = jdit.cogvideox_forward(JDIT, params, jnp.asarray(x),
                                     jnp.asarray(text), jnp.asarray(t),
                                     image_rotary_emb=(cos, sin),
                                     attn_impl="xla", differentiable=True,
                                     remat=remat)
        return jnp.sum(out * ct), out

    (_, want_out), grads = jax.value_and_grad(f, has_aux=True)(dit_params)
    model = _model(dit_params)
    out = model(torch.from_numpy(x), torch.from_numpy(text),
                torch.from_numpy(t), (torch.from_numpy(np.asarray(cos)),
                                      torch.from_numpy(np.asarray(sin))),
                differentiable=True, remat=remat)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(ct)).sum().backward()
    _assert_grads_match(model, _grads_to_state_dict(grads))


def test_forward_without_differentiable_keeps_no_graph(dit_params):
    model = _model(dit_params)
    rs = np.random.RandomState(3)
    cos, sin = tdit.cogvideox_rope(TDIT, 3, 4, 4)
    out = model(torch.from_numpy(rs.randn(1, 3, 12, 4, 4).astype(np.float32)),
                torch.zeros(1, 8, 16), torch.tensor([10.0]), (cos, sin))
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------

def _loss_draws(k_loss, B, shape):
    k_t, k_n = jax.random.split(k_loss)
    return {"t": torch.from_numpy(np.asarray(jax.random.randint(
                k_t, (B,), 0, 1000))),
            "noise": torch.from_numpy(np.asarray(jax.random.normal(
                k_n, shape, jnp.float32)))}


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
@pytest.mark.parametrize("stage1", [False, True], ids=["stage2", "stage1"])
def test_vpred_loss_and_gradients_match_jax(dit_params, remat, stage1):
    """``cog_vpred_loss`` on given latents with JAX's t and noise: loss
    and every parameter gradient against ``jax.value_and_grad``."""
    rs = np.random.RandomState(4)
    B, F, z, h, w = 1, 3, 4, 4, 4

    def lat(frames):
        return rs.randn(B, frames, z, h, w).astype(np.float32)
    video, traj = lat(F), lat(F)
    first = np.concatenate([lat(1), np.zeros((B, F - 1, z, h, w),
                                              np.float32)], axis=1)
    id_lat = None if stage1 else lat(1)
    text = rs.randn(B, 8, 16).astype(np.float32)
    key = jax.random.key(11)
    jcfg = jcog.CogTrainerConfig(compute_dtype=jnp.float32, remat=remat,
                                 attn_impl="xla", use_frame_in=not stage1)

    def f(params):
        return jcog.cog_vpred_loss(
            JDIT, jcfg, params, jnp.asarray(video), jnp.asarray(first),
            jnp.asarray(traj), None if id_lat is None else jnp.asarray(id_lat),
            jnp.asarray(text), key)

    loss, grads = jax.value_and_grad(f)(dit_params)
    model = _model(dit_params)
    tcfg = tcog.CogTrainerConfig(compute_dtype=torch.float32, remat=remat,
                                 use_frame_in=not stage1)
    got = tcog.cog_vpred_loss(
        model, tcfg, torch.from_numpy(video), torch.from_numpy(first),
        torch.from_numpy(traj),
        None if id_lat is None else torch.from_numpy(id_lat),
        torch.from_numpy(text),
        tcog.CogDraws(given=_loss_draws(key, B, video.shape)))
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    got.backward()
    _assert_grads_match(model, _grads_to_state_dict(grads))


def test_steps_draw_their_own_noise_per_step(dit_params):
    """Without draws each step takes them from a generator seeded by
    (seed, step): the same step repeats exactly, another step differs."""
    rs = np.random.RandomState(6)
    B, F, z, h, w = 1, 3, 4, 4, 4
    lat = [torch.from_numpy(rs.randn(B, n, z, h, w).astype(np.float32))
           for n in (F, F, F, 1)]
    text = torch.zeros(B, 8, 16)
    model = _model(dit_params)
    cfg = tcog.CogTrainerConfig(compute_dtype=torch.float32, remat=False)

    def loss(step):
        d = tcog.CogDraws(ttrainer.step_generator(7, step, "cpu"))
        with torch.no_grad():
            return tcog.cog_vpred_loss(model, cfg, *lat, text, d).item()
    assert loss(0) == loss(0) and loss(0) != loss(1)
    with pytest.raises(KeyError, match="noise"):
        tcog.cog_vpred_loss(model, cfg, *lat, text,
                            tcog.CogDraws(given={"t": torch.tensor([3])}))


# ---------------------------------------------------------------------------
# surgery
# ---------------------------------------------------------------------------

def test_cogvideox_surgery_matches_jax_through_the_bridge(dit_params):
    """Widen 12 -> 16 input channels: JAX surgery then the bridge equals
    the bridge then the port's surgery; the new channels are zero and the
    widened model gives the old output on zero extra channels."""
    cfg16 = dataclasses.replace(TDIT, in_channels=16)
    want = cogvideox_dit_from_jax(_np(jsurgery.cogvideox_stage1_surgery(
        dit_params, 12, 16, 2)), cfg16)
    got = tsurgery.cogvideox_stage1_surgery(
        cogvideox_dit_from_jax(_np(dit_params), TDIT), 16)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    assert not got["patch_embed.proj.weight"][:, 12:].any()
    wide = tdit.CogVideoXDiT(cfg16, device="meta")
    wide.load_state_dict(got, assign=True)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(1, 3, 12, 4, 4).astype(np.float32))
    rope = tdit.cogvideox_rope(TDIT, 3, 4, 4)
    args = (torch.from_numpy(rs.randn(1, 8, 16).astype(np.float32)),
            torch.tensor([5.0]), rope)
    torch.testing.assert_close(
        wide(torch.cat([x, torch.randn(1, 3, 4, 4, 4) * 0], dim=2), *args),
        _model(dit_params).eval()(x, *args))
