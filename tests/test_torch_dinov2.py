"""The port's DINOv2 (``frameino_tpu_torch/models/dinov2.py``) against
JAX's at the tiny config: the same seeded numpy weights, loaded into JAX
through ``dinov2_from_state_dict`` and into the port through
``load_state_dict``; fp32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import dinov2 as jdino
from frameino_tpu_torch.models import dinov2 as tdino
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.models.safetensors_io import save_file

# fp32 sums in another order through 2 blocks
REL_L2 = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded_state_dict(model: torch.nn.Module, seed: int):
    """Every tensor of ``model`` drawn from one numpy seed: norm gains
    around 1, LayerScale gammas around 0.5, the rest N(0, 0.1)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = 0.1 * rs.randn(*v.shape)
        if "norm" in k and k.endswith("weight"):
            a += 1.0
        elif k.endswith("gamma"):
            a += 0.5
        sd[k] = a.astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = tdino.tiny_dinov2_config(), jdino.tiny_dinov2_config()
    sd = seeded_state_dict(tdino.Dinov2(cfg, device="meta"), 0)
    m = tdino.Dinov2(cfg, device="meta")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True, assign=True)
    params = jdino.dinov2_from_state_dict(dict(sd), jcfg)
    return jcfg, params, m.eval(), sd


@pytest.mark.parametrize("hw", [(28, 28), (35, 49)],
                         ids=["pretrain_grid", "interpolated_grid"])
def test_embedding_matches_jax(pair, hw):
    jcfg, params, m, _ = pair
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    grid = (hw[0] // jcfg.patch_size, hw[1] // jcfg.patch_size)
    pe = jdino.interpolate_pos_embed(np.asarray(params["pos_embed"]), grid,
                                     jcfg)
    want = np.asarray(jdino.dinov2_forward(params, jnp.asarray(x), jcfg,
                                           pos_embed=jnp.asarray(pe)))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, jcfg.dim)
    assert _rel_l2(got, want) <= REL_L2
    # the interpolated table itself: torch's bicubic against JAX's numpy
    np.testing.assert_allclose(m.interpolate_pos_embed(grid).detach().numpy(),
                               pe, rtol=1e-5, atol=1e-6)


def test_embedder_adapters_agree(pair):
    """``make_embedder_adapter`` on both sides, one uint8 image, the
    reference's 224-pixel preprocessing."""
    jcfg, params, m, _ = pair
    img = np.random.RandomState(2).randint(0, 255, (40, 30, 3)
                                           ).astype(np.uint8)
    want = jdino.make_embedder_adapter(params, jcfg, input_size=28)(img)
    got = tdino.make_embedder_adapter(m, input_size=28)(img)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel_l2(got, want) <= REL_L2


def test_bridge_round_trip():
    """dinov2_from_state_dict(dinov2_to_state_dict(init_dinov2(key))) is
    the tree itself, and the state dict loads strict."""
    cfg, jcfg = tdino.tiny_dinov2_config(), jdino.tiny_dinov2_config()
    params = jax.tree.map(np.asarray, jdino.init_dinov2(jax.random.key(3),
                                                        jcfg))
    sd = tweights.dinov2_to_state_dict(params, cfg)
    tdino.Dinov2(cfg, device="meta").load_state_dict(sd, strict=True,
                                                     assign=True)
    back = jdino.dinov2_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                        jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 params, jax.tree.map(np.asarray, back))


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_checkpoint_loader(pair, tmp_path, fmt):
    jcfg, params, m, sd = pair
    path = str(tmp_path / f"dino.{fmt}")
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "pth":
        torch.save(tensors, path)
    else:
        save_file(tensors, path)
    embed = tdino.load_dinov2_torch(path, tdino.tiny_dinov2_config(),
                                    input_size=28, device="cpu")
    img = np.random.RandomState(4).randint(0, 255, (20, 20, 3)
                                           ).astype(np.uint8)
    np.testing.assert_array_equal(
        embed(img), tdino.make_embedder_adapter(m, input_size=28)(img))
