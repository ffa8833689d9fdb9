"""The PyTorch port's CogVideoX train step on the CPU against the JAX
package: the VAE's sampled encode with JAX's noise, and one whole
``cog_train_step`` (encodes, loss, clip, update) against the jitted
``make_cog_train_step`` fed the same draws. Tiny configs in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from frameino_tpu.models import cogvideox_dit as jdit
from frameino_tpu.models import cogvideox_vae as jvae
from frameino_tpu.training import cog_trainer as jcog
from frameino_tpu.training import optim as joptim
from frameino_tpu.training.trainer import init_train_state as jinit_state
from frameino_tpu_torch.models import cogvideox_vae as tvae
from frameino_tpu_torch.models.weights import (cogvideox_dit_from_jax,
                                               cogvideox_vae_from_jax)
from frameino_tpu_torch.training import cog_trainer as tcog
from frameino_tpu_torch.training import optim as toptim
from frameino_tpu_torch.training import trainer as ttrainer
from test_torch_cog_training import (JDIT, JVAE, LOSS_RTOL, TDIT, TVAE,
                                     _loss_draws, _model, _np)


# ---------------------------------------------------------------------------
# the VAE's sampled encode
# ---------------------------------------------------------------------------

def test_vae_sampled_encode_matches_jax():
    """encode(sample_mode="sample") with JAX's noise: 1e-5 (fp32)."""
    params = jvae.init_cogvideox_vae(jax.random.key(0), JVAE)
    vae = tvae.CogVideoXVAE(TVAE, device="meta")
    vae.load_state_dict(cogvideox_vae_from_jax(_np(params), TVAE),
                        assign=True)
    rs = np.random.RandomState(1)
    video = np.tanh(rs.randn(1, 3, 5, 16, 16)).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jax.jit(lambda p, v: jvae.encode(
        JVAE, p, v, sample_mode="sample", key=key))(params,
                                                     jnp.asarray(video)))
    noise = jax.random.normal(key, want.shape, jnp.float32)
    got = vae.encode(torch.from_numpy(video), "sample",
                     noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # argmax is the sample at zero noise
    torch.testing.assert_close(
        vae.encode(torch.from_numpy(video), "argmax"),
        vae.encode(torch.from_numpy(video), "sample",
                   noise=torch.zeros(want.shape)))


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

def _jax_draws(key, step, B, F, h, w, first_shape, id_shape, z=4):
    """The draws of JAX's step: fold_in(key, step) -> (k_enc, k_loss);
    split(k_enc, 8) for the encodes; split(k_loss) for t and the noise."""
    k_enc, k_loss = jax.random.split(jax.random.fold_in(key, step))
    ks = jax.random.split(k_enc, 8)
    post = (B, z, F, h, w)
    one = (B, z, 1, h, w)

    def normal(k, shape):
        return torch.from_numpy(np.asarray(jax.random.normal(
            k, shape, jnp.float32)))

    out = {"post_video": normal(ks[0], post), "post_traj": normal(ks[1], post),
           "post_first": normal(ks[3], one), "post_id": normal(ks[5], one)}
    for tag, k, shape in (("first", ks[2], first_shape),
                          ("id", ks[4], id_shape)):
        k1, k2 = jax.random.split(k)
        out[f"aug_{tag}_sigma"] = normal(k1, (1,))
        out[f"aug_{tag}_noise"] = normal(k2, shape)
    out.update(_loss_draws(k_loss, B, (B, F, z, h, w)))
    return out


def _pixel_batch(seed=5, B=1, F=9, H=16, W=16):
    rs = np.random.RandomState(seed)

    def a(*shape):
        return np.tanh(rs.randn(*shape)).astype(np.float32)
    return {"video_tensor": a(B, F, 3, H, W),
            "first_frame_tensor": a(B, 3, H, W),
            "traj_tensor": a(B, F, 3, H, W),
            "ID_tensor": a(B, 3, H, W),
            "prompt_embeds": rs.randn(B, 8, 16).astype(np.float32)}


def test_train_step_matches_make_cog_train_step():
    dit_params = jdit.init_cogvideox_dit(jax.random.key(1), JDIT)
    """Stage 2, remat on, AdamW (lr 1e-3, no warmup, eps 1e-6): one whole
    step (encodes with their augment noise and posterior samples, the
    loss, the clip and the update) against JAX's jitted step fed the same draws:
    loss, grad_norm and every updated parameter."""
    vae_params = jvae.init_cogvideox_vae(jax.random.key(0), JVAE)
    # eps 1e-6: Adam's first update is g / (|g| + eps), and a sixth of the
    # AdaLN weights' gradient elements are 0 up to fp32 rounding (< 1e-9,
    # the signs of their sums arbitrary); with eps 1e-10 such an element
    # moves by up to lr on one side and not at all on the other
    ocfg = dict(learning_rate=1e-3, lr_warmup_steps=0,
                lr_scheduler="constant", epsilon=1e-6)
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**ocfg))
    jcfg = jcog.CogTrainerConfig(compute_dtype=jnp.float32, remat=True,
                                 attn_impl="xla")
    jstate = jinit_state(jax.tree.map(jnp.array, dit_params), opt)
    batch = _pixel_batch()
    key = jax.random.key(42)
    jstate, jm = jcog.make_cog_train_step(JDIT, JVAE, jcfg, opt)(
        jstate, vae_params, {k: jnp.asarray(v) for k, v in batch.items()},
        key)

    vae = tvae.CogVideoXVAE(TVAE, device="meta")
    vae.load_state_dict(cogvideox_vae_from_jax(_np(vae_params), TVAE),
                        assign=True)
    model = _model(dit_params)
    state = ttrainer.init_train_state(model, toptim.OptimizerConfig(**ocfg))
    draws = _jax_draws(key, 0, 1, 3, 4, 4, (1, 3, 1, 16, 16),
                          (1, 3, 1, 16, 16))
    tm = tcog.cog_train_step(
        state, vae, tcog.CogTrainerConfig(compute_dtype=torch.float32),
        {k: torch.from_numpy(v) for k, v in batch.items()}, seed=0,
        draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 1
    want = cogvideox_dit_from_jax(_np(jstate.params), TDIT)
    start = cogvideox_dit_from_jax(_np(dit_params), TDIT)
    for name, p in model.named_parameters():
        # the movement per tensor, relative L2 1e-3
        moved, ref = p.detach() - start[name], want[name] - start[name]
        err = float((moved - ref).norm() / ref.norm().clamp(min=1e-12))
        assert err <= 1e-3, (name, err)
