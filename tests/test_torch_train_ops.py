"""The PyTorch port's training ops on the CPU against the JAX package: K6's
plain version (forward and gradients) against JAX's ``flash_attention_train``
run in Pallas interpret mode, and the DiT's differentiable forward and
parameter gradients, remat on and off, against ``jax.grad`` of
``wan_dit_forward(..., differentiable=True)``. Inputs and weights are drawn
from a seed with numpy or the JAX initializer and handed to both sides
(fp32 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.ops import attention as jattn
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models.weights import wan_dit_from_jax
from frameino_tpu_torch.ops import attention as A


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("skv", [100, 37])
def test_flash_attention_train_ref_matches_jax_kernel(skv):
    """[1, 2, 100, 64] self (Skv 100) and cross (Skv 37) attention: the
    output and dQ/dK/dV of a random-cotangent loss, against the bundled
    Pallas forward and backward kernels (interpret mode), padded to a
    128 multiple with segment ids as the JAX wrapper does."""
    rs = np.random.RandomState(skv)
    q = rs.randn(1, 2, 100, 64).astype(np.float32)
    k, v = (rs.randn(1, 2, skv, 64).astype(np.float32) for _ in range(2))
    do = rs.randn(1, 2, 100, 64).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.flash_attention_train(q, k, v, block_multiple=128)
        return jnp.sum(o * do), o

    with pltpu.force_tpu_interpret_mode():
        (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = A.flash_attention_train(*leaves)              # CPU: the plain path
    (o * torch.from_numpy(do)).sum().backward()
    # fp32 on both sides; the TPU kernel's blocked online softmax against
    # one softmax: 2e-3, as tests/test_ops_attention.py holds the forward
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=2e-3, rtol=2e-3)
    for got, want in zip(leaves, jgrads):
        np.testing.assert_allclose(_np(got.grad), np.asarray(want),
                                   atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("bh,skv,d,keys", [
    (24, 5460, 128, 128),   # Wan self-attention: 24 x 43 = 1,032 blocks
    (24, 512, 128, 64),     # Wan cross-attention: 24 x 4 = 96 < 132 SMs
    (3, 777, 128, 64),      # ragged, 3 x 7 = 21 blocks
    (22, 777, 128, 128),    # ragged, 22 x 7 = 154 blocks fill 132 SMs
    (24, 5460, 64, 64),     # head_dim 64 always takes one warpgroup
    (6, 1111, 64, 64)])
def test_k6_backward_keys_per_block(bh, skv, d, keys):
    """K6's backward takes 128 keys a block (two consumer warpgroups)
    only where those blocks fill an H100's 132 SMs, and head_dim 128."""
    assert A._k6_bwd_keys_per_block(bh, skv, 132, d) == keys


@pytest.fixture(scope="module")
def dit_pair():
    jcfg = jdit.tiny_config(in_channels=8, out_channels=4)
    tcfg = tdit.tiny_config(in_channels=8, out_channels=4)
    params = jdit.init_wan_dit(jax.random.key(3), jcfg)
    model = tdit.WanDiT(tcfg, device="meta")
    model.load_state_dict(wan_dit_from_jax(jax.tree.map(np.asarray, params),
                                           tcfg), assign=True)
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("remat", [False, True])
def test_differentiable_dit_grads_match_jax(dit_pair, remat):
    """Scalar timesteps (the training form), a random-weighted sum of the
    prediction as the loss: the output and the gradient of every parameter
    (the JAX gradient tree mapped to state-dict names by the same bridge
    that carries the weights)."""
    jcfg, tcfg, params, model = dit_pair
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, 3, 4, 6).astype(np.float32)
    t = np.array([812.0, 96.5], np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    w = rs.randn(2, 4, 3, 4, 6).astype(np.float32)

    def jloss(p):
        out = jdit.wan_dit_forward(jcfg, p, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(ctx), attn_impl="xla",
                                   differentiable=True, remat=remat)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    want = wan_dit_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)

    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx), differentiable=True, remat=remat)
    assert out.requires_grad
    (out * torch.from_numpy(w)).sum().backward()
    # fp32, 2 blocks: reordered sums only (1e-4)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        ref = want[name].numpy()
        assert g is not None, name
        # relative L2 per parameter, fp32 through forward and backward
        err = np.linalg.norm(_np(g) - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err <= 1e-4, (name, err)


def test_serving_forward_stays_out_of_autograd(dit_pair):
    """Without ``differentiable`` the forward builds no graph; with it the
    precomputed text K/V are refused (they must be projected in the
    graph)."""
    _, _, _, model = dit_pair
    x = torch.randn(1, 8, 3, 4, 6)
    t = torch.tensor([500.0])
    ctx = torch.randn(1, 7, 16)
    assert not model(x, t, ctx).requires_grad
    kv = model.precompute_text_kv(ctx)
    with pytest.raises(ValueError, match="graph"):
        model(x, t, text_kv=kv, differentiable=True)
