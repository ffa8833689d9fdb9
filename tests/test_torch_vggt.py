"""The port's VGGT-1B (VGGT4Track camera path) against the JAX package's,
on the CPU.

Weights are drawn with numpy under the released names
(``vggt_param_table``) and handed to both packages. With its attention in
fp32 (``_bf16_attention`` replaced by ``ops.attention.attention_ref``) the
port is held to JAX's forward within max abs 1e-5; with the bf16 cast it makes
at K3 on the card (q, k, v in bf16, everything else fp32) it is held
within a relative L2 of ``BF16_REL_L2`` (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import vggt as J
from frameino_tpu_torch.models import vggt as T
from frameino_tpu_torch.ops.attention import attention_ref

ATOL = 1e-5
# relative L2 of the poses and intrinsics with q, k, v cast to bf16 at
# every attention against JAX's fp32: each bf16 rounding is 2^-9
# relative, and the tiny model's 10 attentions compound a few of them
# (read 4.5e-4 on the poses)
BF16_REL_L2 = 5e-3

CFG = T.tiny_vggt_config()
JCFG = J.tiny_vggt_config()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pair():
    """The numpy weights (FoV outputs biased positive, as released
    checkpoints predict them), a 3-frame 8x12 clip, and one jitted JAX
    forward."""
    sd = T.vggt_param_table(CFG).draw_numpy(0)
    sd["camera_head.pose_branch.fc2.bias"][7:] = 1.0
    imgs = np.random.RandomState(0).rand(1, 3, 8, 12, 3).astype(np.float32)
    params = J.vggt_from_state_dict(sd, JCFG)
    fwd = jax.jit(lambda p, im: J.vggt_camera_forward(JCFG, p, im))
    want = [np.asarray(o) for o in fwd(params, jnp.asarray(imgs))]
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    return dict(sd=sd, tsd=tsd, imgs=imgs, params=params, want=want)


def test_released_table_matches_jax_tree():
    """At VGGT-1B's widths every name of the port's table sits at its path
    in JAX's (unstacked) init tree with the transposed shape, and covers
    every leaf (``jax.eval_shape``: no weights drawn)."""
    table = T.vggt_param_table(T.VGGT_1B)
    tree = jax.eval_shape(lambda: J.init_vggt(jax.random.key(0)))
    for name, e in table.items():
        node = tree
        for key in e.path:
            node = node[key]
        shape = tuple(node.shape)
        if e.layout == "linear":
            shape = shape[::-1]
        elif e.layout == "conv":
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert shape == e.shape, name
    assert len(table) == len(jax.tree.leaves(tree))
    n = sum(int(np.prod(e.shape)) for e in table.values())
    assert 1.0e9 < n < 1.3e9, n


@pytest.fixture
def fp32_attention(monkeypatch):
    """The port's VGGT with fp32 attention (no bf16 cast), JAX's
    numerics."""
    monkeypatch.setattr(T, "_bf16_attention", attention_ref)


@pytest.mark.parametrize("out", ["poses", "intrinsics"])
def test_camera_forward_matches_jax(pair, out, fp32_attention):
    i = ["poses", "intrinsics"].index(out)
    got = T.vggt_camera_forward(CFG, pair["tsd"], torch.from_numpy(
        pair["imgs"]))[i].numpy()
    assert got.shape == pair["want"][i].shape == [(1, 3, 4, 4),
                                                  (1, 3, 3, 3)][i]
    np.testing.assert_allclose(got, pair["want"][i], rtol=1e-5, atol=ATOL)


def test_bf16_attention_stays_near_jax(pair):
    """The card's numerics: q, k, v cast to bf16 at each K3 call."""
    poses, intrs = T.vggt_camera_forward(CFG, pair["tsd"], torch.from_numpy(
        pair["imgs"]))
    for got, want in ((poses, pair["want"][0]), (intrs, pair["want"][1])):
        assert _rel_l2(got.numpy(), want) < BF16_REL_L2


def test_every_attention_goes_through_k3(pair, monkeypatch):
    """``flash_attention_inference`` (K3 on the card) takes every
    attention, bf16 by default: vit_depth + 2 x depth + trunk depth x
    iterations calls (88 at VGGT-1B: 24 + 48 + 16)."""
    seen = []
    real = T.flash_attention_inference

    def counting(q, k, v):
        seen.append((q.dtype, tuple(q.shape)))
        return real(q, k, v)
    monkeypatch.setattr(T, "flash_attention_inference", counting)
    T.vggt_camera_forward(CFG, pair["tsd"], torch.from_numpy(pair["imgs"]))
    c = CFG
    assert len(seen) == (c.vit_depth + 2 * c.depth
                         + c.cam_trunk_depth * c.cam_iterations)
    assert {d for d, _ in seen} == {torch.bfloat16}
    P = 1 + c.num_register_tokens + 4 * 6
    assert seen[c.vit_depth] == (torch.bfloat16, (3, 2, P, 8))     # frame
    assert seen[c.vit_depth + 1] == (torch.bfloat16, (1, 2, 3 * P, 8))
    full = T.VGGT_1B
    assert full.vit_depth + 2 * full.depth \
        + full.cam_trunk_depth * full.cam_iterations == 88


def test_estimator_from_released_checkpoints_matches_jax(pair, tmp_path,
                                                        monkeypatch,
                                                        fp32_attention):
    """A ``.pt`` (in a "model" wrapper) and a ``.safetensors`` written by
    the port load through JAX's ``load_vggt_camera`` and the port's to the
    same ``camera_info`` (fp32 attention), from uint8 frames through
    ``preprocess_frames`` (both packages' at a 28-pixel target width in
    place of 518: the tiny model's attention over 518-wide frames would
    take tens of GB)."""
    import functools

    from frameino_tpu_torch.models.safetensors_io import save_file
    for mod in (T, J):
        monkeypatch.setattr(mod, "preprocess_frames", functools.partial(
            mod.preprocess_frames, target=28))
    extra = {"depth_head.proj.weight": torch.zeros(2, 2)}
    torch.save({"model": {**pair["tsd"], **extra}}, tmp_path / "v.pt")
    save_file(pair["tsd"], str(tmp_path / "v.safetensors"))
    frames = np.random.RandomState(2).randint(0, 255, (3, 20, 28, 3)).astype(
        np.uint8)
    for name in ("v.pt", "v.safetensors"):
        path = str(tmp_path / name)
        est = T.load_vggt_camera(path, CFG, device="cpu")
        jest = J.load_vggt_camera(path, JCFG)
        got, want = est(frames), jest(frames)
        assert sorted(got) == sorted(want) == ["focal_x", "focal_y",
                                               "rotation", "translation"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=ATOL,
                                       err_msg=k)
    with pytest.raises(FileNotFoundError):
        T.load_vggt_camera(str(tmp_path / "none.pt"), CFG, device="cpu")


def test_jax_trees_bridge_to_the_port(pair):
    """JAX's scanned tree (``vggt_from_state_dict``) and an unstacked one
    (``init_vggt``'s layout) map back through ``vggt_from_jax`` to the
    same tensors."""
    back = T.vggt_from_jax(pair["params"], CFG)
    assert sorted(back) == sorted(pair["sd"])
    for k, v in pair["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    agg = dict(pair["params"]["aggregator"])
    for kind in ("frame", "global"):
        stack = agg.pop(f"{kind}_stack")
        agg[f"{kind}0"] = jax.tree.map(lambda x: x[0], stack)
    unstacked = T.vggt_from_jax(dict(pair["params"], aggregator=agg), CFG)
    for k in back:
        assert torch.equal(unstacked[k], back[k]), k


def test_preprocess_and_pose_decoding_match_jax():
    frames = np.random.RandomState(3).randint(0, 255, (2, 100, 200, 3)
                                              ).astype(np.uint8)
    np.testing.assert_array_equal(T.preprocess_frames(frames, 56),
                                  J.preprocess_frames(frames, 56))
    tall = np.random.RandomState(4).randint(0, 255, (1, 400, 200, 3)
                                            ).astype(np.uint8)
    np.testing.assert_array_equal(T.preprocess_frames(tall, 56),
                                  J.preprocess_frames(tall, 56))
    rs = np.random.RandomState(1)
    enc = np.concatenate([rs.randn(2, 3, 7), np.abs(rs.randn(2, 3, 2)) + .5],
                         -1).astype(np.float32)
    got = T.pose_encoding_to_extri_intri(torch.from_numpy(enc), (100, 200))
    want = J.pose_encoding_to_extri_intri(jnp.asarray(enc), (100, 200))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    cos_t, sin_t = T.rope2d_tables(64, 21, 37, 5)
    cos_j, sin_j = J.rope2d_tables(64, 21, 37, 5)
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
