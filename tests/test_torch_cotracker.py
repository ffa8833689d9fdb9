"""The port's CoTracker3 (``frameino_tpu_torch/models/cotracker.py``)
against JAX's at the tiny config: the same seeded numpy weights, loaded
into JAX through ``cotracker_from_state_dict`` and into the port through
``load_state_dict``; fp32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import cotracker as jct
from frameino_tpu_torch.models import cotracker as tct
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.models.safetensors_io import save_file

# fp32 through 2 refinement iterations of the tiny tracker
REL_L2 = 1e-4
T, H, W = 6, 20, 28


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded_state_dict(model: torch.nn.Module, seed: int):
    """Every tensor drawn from one numpy seed (norm gains around 1); the
    time table is the sincos one, as the released checkpoint's."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        scale = 0.1 if "fnet" not in k else 0.3
        a = scale * rs.randn(*v.shape)
        if "norm" in k and k.endswith("weight"):
            a += 1.0
        sd[k] = a.astype(np.float32)
    cfg = model.cfg
    sd["time_emb"] = tct.sincos_time_embed(cfg.input_dim, cfg.window_len)
    return sd


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = tct.tiny_cotracker_config(), jct.tiny_cotracker_config()
    sd = seeded_state_dict(tct.CoTracker(cfg, device="meta"), 0)
    m = tct.CoTracker(cfg, device="meta")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True, assign=True)
    return jcfg, jct.cotracker_from_state_dict(sd, jcfg), m.eval(), sd


def _inputs(seed=1, n=5):
    rs = np.random.RandomState(seed)
    video = rs.randint(0, 255, (1, T, 3, H, W)).astype(np.float32)
    q = np.stack([rs.randint(0, 3, n), rs.uniform(0, W - 1, n),
                  rs.uniform(0, H - 1, n)], -1).astype(np.float32)[None]
    return video, q


def test_forward_matches_jax(pair):
    """Tracks, visibility and confidence after all iterations, queries on
    several frames."""
    jcfg, params, m, _ = pair
    video, q = _inputs()
    v = jct._resize_bilinear_ac(jnp.asarray(video[0]), jcfg.model_resolution)
    want = jct.cotracker_forward(jcfg, params, v[None], jnp.asarray(q))
    got = m(torch.from_numpy(np.array(v))[None], torch.from_numpy(q))
    for name, g, w in zip(("coords", "vis", "conf"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g.numpy(), w) <= REL_L2, (name, _rel_l2(g.numpy(), w))


@pytest.mark.parametrize("backward", [False, True])
def test_predict_matches_jax(pair, backward):
    """The hub wrapper: resize to the model resolution and back, and the
    backward-tracking splice before each query frame."""
    jcfg, params, m, _ = pair
    video, q = _inputs(2)
    wc, wv = jct.cotracker_predict(jcfg, params, jnp.asarray(video),
                                   jnp.asarray(q), backward_tracking=backward)
    gc, gv = tct.cotracker_predict(m, torch.from_numpy(video),
                                   torch.from_numpy(q),
                                   backward_tracking=backward)
    assert _rel_l2(gc.numpy(), wc) <= REL_L2
    assert gv.shape == wv.shape


def test_tracker_adapters_agree(pair):
    """``make_tracker_adapter`` on both sides, uint8 frames: the int
    tracks are equal except where a coordinate lies within 1e-3 of an
    integer (the adapters truncate)."""
    jcfg, params, m, _ = pair
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 255, (T, H, W, 3)).astype(np.uint8)
    queries = rs.uniform(2, 18, (4, 2)).astype(np.float32)
    want = jct.make_tracker_adapter(params, jcfg)(frames, queries)
    got = tct.make_tracker_adapter(m)(frames, queries)
    assert got.dtype == np.int64 and got.shape == want.shape == (T, 4, 2)
    video = torch.from_numpy(frames).float().permute(0, 3, 1, 2)[None]
    qq = torch.tensor([[0.0, float(x), float(y)] for x, y in queries])[None]
    coords = tct.cotracker_predict(m, video, qq)[0][0].numpy()
    near = np.abs(coords - np.round(coords)) < 1e-3
    np.testing.assert_array_equal(got[~near], want[~near])


def test_bridge_round_trip():
    cfg, jcfg = tct.tiny_cotracker_config(), jct.tiny_cotracker_config()
    params = jax.tree.map(np.asarray, jax.jit(
        jct.init_cotracker, static_argnums=1)(jax.random.key(4), jcfg))
    sd = tweights.cotracker_to_state_dict(params)
    tct.CoTracker(cfg, device="meta").load_state_dict(sd, strict=True,
                                                      assign=True)
    back = jct.cotracker_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 params, jax.tree.map(np.asarray, back))


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_checkpoint_loader(pair, tmp_path, fmt):
    """``scaled_offline.pth`` holds the state dict under ``model``; a
    checkpoint without ``time_emb`` takes the sincos table."""
    jcfg, params, m, sd = pair
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()
               if k != "time_emb"}
    path = str(tmp_path / f"ct.{fmt}")
    if fmt == "pth":
        torch.save({"model": tensors}, path)
    else:
        save_file(tensors, path)
    track = tct.load_cotracker_torch(path, tct.tiny_cotracker_config(),
                                     device="cpu")
    rs = np.random.RandomState(5)
    frames = rs.randint(0, 255, (T, H, W, 3)).astype(np.uint8)
    queries = rs.uniform(2, 18, (3, 2)).astype(np.float32)
    np.testing.assert_array_equal(track(frames, queries),
                                  tct.make_tracker_adapter(m)(frames,
                                                              queries))
