"""The port's Swin, OneFormer and OneFormerSegmenter against the JAX
package's, on the CPU.

Weights are drawn with numpy under the released detectron2 names
(``oneformer_param_table``) and handed to both packages (JAX's through its
own ``oneformer_from_state_dict``), whose tree maps back through the
port's ``from_jax``. The deformable sampling runs K13's plain
version here. Tolerances: fp32, max abs 2e-5 on logits of order 1e-1 (the
two read ~3e-7 apart: the same operations, summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import oneformer as J
from frameino_tpu.models import swin as JS
from frameino_tpu.preprocess import panoptic_oneformer as JPO
from frameino_tpu_torch.models import oneformer as T
from frameino_tpu_torch.models import swin as TS
from frameino_tpu_torch.preprocess import panoptic_oneformer as TPO

ATOL = 2e-5


def tiny_of_config(cfg=T.OneFormerConfig, swin=TS.SwinConfig):
    """A tiny OneFormer (four 1-block Swin stages of 16-128 channels,
    hidden 32, 4 heads, 6 queries, 2 encoder and 3 decoder layers)."""
    return cfg(swin=swin(embed_dim=16, depths=(1, 1, 1, 1),
                         num_heads=(2, 2, 4, 4), window_size=4),
               num_classes=7, hidden_dim=32, num_queries=6, nheads=4,
               dim_feedforward=64, enc_ffn_dim=48, enc_layers=2,
               dec_layers=3, class_dec_layers=2, enc_points=2, mask_dim=32,
               task_seq_len=77)


TCFG = tiny_of_config()
JCFG = tiny_of_config(J.OneFormerConfig, JS.SwinConfig)


def _torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _shape_of(entry, leaf):
    shape = tuple(leaf.shape)
    if entry.layout == "linear":
        return shape[::-1]
    if entry.layout == "conv":
        return (shape[3], shape[2], shape[0], shape[1])
    return shape


@pytest.mark.parametrize("model", ["swin_l", "oneformer_coco_swin_l"])
def test_released_table_matches_jax_tree(model):
    """At the released widths, every name of the port's table sits at its
    path in JAX's tree (``jax.eval_shape`` of JAX's init: no weights
    drawn) with the transposed shape, and the table covers every leaf."""
    if model == "swin_l":
        table = TS.swin_param_table(TS.SWIN_L)
        tree = jax.eval_shape(lambda: JS.init_swin(jax.random.key(0)))
    else:
        table = T.oneformer_param_table(T.ONEFORMER_COCO_SWIN_L)
        tree = jax.eval_shape(lambda: J.init_oneformer(jax.random.key(0)))
    for name, e in table.items():
        node = tree
        for key in e.path:
            node = node[key]
        assert _shape_of(e, node) == e.shape, name
    assert len(table) == len(jax.tree.leaves(tree))
    if model == "oneformer_coco_swin_l":
        n = sum(int(np.prod(e.shape)) for e in table.values())
        assert 200e6 < n < 240e6, n           # Swin-L OneFormer, ~219M


def test_swin_matches_jax():
    cfg, jcfg = TS.tiny_swin_config(), JS.tiny_swin_config()
    sd = TS.swin_param_table(cfg).draw_numpy(0)
    x = np.random.RandomState(1).randn(1, 37, 45, 3).astype(np.float32)
    want = jax.jit(lambda p, a: JS.swin_forward(jcfg, p, a))(
        JS.swin_from_state_dict(sd, jcfg), jnp.asarray(x))
    got = TS.swin_forward(cfg, _torch(sd), torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["res2", "res3"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def forward_pair():
    """One JAX forward (jitted) and the port's on the same numpy weights
    and input."""
    sd = T.oneformer_param_table(TCFG).draw_numpy(0)
    x = np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32)
    task = J.task_tokens("panoptic")[None]
    params = J.oneformer_from_state_dict(sd, JCFG)
    fwd = jax.jit(lambda p, a, t: J.oneformer_forward(JCFG, p, a, t))
    want = [np.asarray(o) for o in fwd(params, jnp.asarray(x),
                                       jnp.asarray(task))]
    got = [o.numpy() for o in T.oneformer_forward(
        TCFG, _torch(sd), torch.from_numpy(x), torch.from_numpy(task))]
    return dict(sd=sd, x=x, task=task, fwd=fwd, want=want, got=got)


@pytest.mark.parametrize("out", ["class_logits", "mask_logits"])
def test_oneformer_matches_jax(forward_pair, out):
    i = ["class_logits", "mask_logits"].index(out)
    want, got = forward_pair["want"][i], forward_pair["got"][i]
    assert got.shape == want.shape == [(1, 6, 8), (1, 6, 16, 24)][i]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_jax_tree_bridges_to_the_port(forward_pair):
    """JAX's tree of the numpy state dict (``oneformer_from_state_dict``)
    maps back through the port's ``from_jax`` to the same tensors, bit for
    bit: the bridge both ways (the forward of those weights is the one
    held above; JAX's init tree's paths are held at full width by
    ``test_released_table_matches_jax_tree``)."""
    sd = forward_pair["sd"]
    back = T.oneformer_param_table(TCFG).from_jax(
        J.oneformer_from_state_dict(sd, JCFG))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_task_tokens_and_panoptic_fusion_match_jax(forward_pair):
    for task in ("panoptic", "instance", "semantic"):
        np.testing.assert_array_equal(T.task_tokens(task),
                                      J.task_tokens(task))
    cls = forward_pair["want"][0][0]
    masks = np.repeat(np.repeat(forward_pair["want"][1][0], 2, 1), 2, 2)
    for thr in (0.0, 0.3):
        want = J.panoptic_inference(cls, masks, [0, 1, 2],
                                    object_mask_threshold=thr)
        got = T.panoptic_inference(cls, masks, [0, 1, 2],
                                   object_mask_threshold=thr)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert TPO.COCO_PANOPTIC_CLASSES == JPO.COCO_PANOPTIC_CLASSES
    assert TPO.MOTIONABLE_OBJECT == JPO.MOTIONABLE_OBJECT


def test_segmenter_gives_jax_segments(forward_pair):
    """``OneFormerSegmenter`` (resize, pad, forward, upsample, fusion) gives
    JAX's labels and masks; ``motionable_only`` keeps the same subset."""
    sd = forward_pair["sd"]
    img = np.random.RandomState(0).randint(0, 255, (40, 56, 3)).astype(
        np.uint8)
    kw = dict(cfg=None, min_size=32, max_size=64, object_mask_threshold=0.0)
    jseg = JPO.OneFormerSegmenter(J.oneformer_from_state_dict(sd, JCFG),
                                  **dict(kw, cfg=JCFG))
    tseg = TPO.OneFormerSegmenter(_torch(sd), **dict(kw, cfg=TCFG))
    want, got = jseg(img), tseg(img)
    assert want and [lab for lab, _ in got] == [lab for lab, _ in want]
    for (lab, g), (_, w) in zip(got, want):
        assert g.shape == (40, 56) and g.dtype == bool
        np.testing.assert_array_equal(g, w, err_msg=lab)
    jseg.motionable_only = tseg.motionable_only = True
    assert [lab for lab, _ in tseg(img)] == [lab for lab, _ in jseg(img)]


def test_released_checkpoint_loads_on_both_sides(tmp_path):
    """A ``.pth`` the port writes in the released layout (a "model" dict
    with the keys JAX skips: relative-position indices, text encoder,
    criterion) loads through JAX's ``load_oneformer_segmenter`` into the
    tree the port's state dict maps to, and through the port's loader to
    the same tensors. The released structure (Swin depths 2/2/18/2, 6
    encoder and 9 decoder layers) at narrow widths: JAX's loader reads the
    layer counts from its default config."""
    cfg = T.OneFormerConfig(
        swin=TS.SwinConfig(embed_dim=8, num_heads=(1, 1, 1, 1),
                           window_size=2),
        num_classes=5, hidden_dim=32, num_queries=4, nheads=4,
        dim_feedforward=16, enc_ffn_dim=16, mask_dim=16)
    table = T.oneformer_param_table(cfg)
    sd = table.draw(torch.Generator().manual_seed(5))
    extra = {"backbone.layers.0.blocks.0.attn.relative_position_index":
             torch.zeros(4, 4, dtype=torch.long),
             "text_encoder.token_embedding.weight": torch.zeros(3, 2),
             "criterion.empty_weight": torch.ones(6)}
    path = str(tmp_path / "oneformer.pth")
    torch.save({"model": {**sd, **extra}, "iteration": 0}, path)
    jseg = JPO.load_oneformer_segmenter(path)
    back = table.from_jax(jseg.params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    tseg = TPO.load_oneformer_segmenter(path, cfg=cfg, device="cpu")
    assert sorted(tseg.sd) == sorted(sd)
    assert all(torch.equal(tseg.sd[k], sd[k]) for k in sd)
    del sd["sem_seg_head.predictor.class_embed.bias"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="class_embed"):
        TPO.load_oneformer_segmenter(path, cfg=cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        TPO.load_oneformer_segmenter(str(tmp_path / "none.pth"))
