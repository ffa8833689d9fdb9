"""The port's Qwen2.5-VL (``frameino_tpu_torch/models/qwen_vl.py``) on the
CPU against the JAX package's: the host-side layout and tables, the vision
tower, the text logits (one prefill chunk and more), greedy tokens, the
int8 tree, the weight bridge, the port's bf16 against its fp32, JAX's bf16
generator defect, and the judge from a checkpoint directory. Tiny config,
fp32; the state dict is drawn from a numpy seed under the names
``qwen_vl_from_state_dict`` reads (transformers' Qwen2.5-VL is not
imported).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import qwen_vl as J
from frameino_tpu_torch.evaluation import perception as tperc
from frameino_tpu_torch.models import qwen_vl as T
from frameino_tpu_torch.models.safetensors_io import save_file
from frameino_tpu_torch.models.weights import qwen_vl_from_jax

CFG = T.tiny_qwen_vl_config()
JCFG = J.tiny_qwen_vl_config()
GRIDS = [(1, 8, 8), (2, 4, 6)]
# relative L2 of the port against JAX in fp32: the same operations in the
# same order; only the sums of the matmuls and reductions run in another
# order
REL_L2 = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread. With six pytest-xdist workers on
    the host's cores, OpenMP regions of many threads over tiny ops wait on
    descheduled threads (a 3 s test read 154 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def tiny_state_dict(seed=0):
    """Every tensor of the tiny model under transformers' names, drawn with
    numpy: weights and biases N(0, 0.3), norm weights 1 + N(0, 0.1)."""
    shapes = {k: tuple(v.shape) for k, v in
              T.QwenVL(CFG, device="meta").state_dict().items()}
    rs = np.random.RandomState(seed)
    return {k: ((1.0 + 0.1 * rs.randn(*s)) if k.endswith(
        ("norm.weight", "norm1.weight", "norm2.weight", "ln_q.weight"))
        else 0.3 * rs.randn(*s)).astype(np.float32)
        for k, s in sorted(shapes.items())}


@pytest.fixture(scope="module")
def pair():
    sd = tiny_state_dict()
    params = J.qwen_vl_from_state_dict(dict(sd), JCFG)
    model = T.qwen_vl_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG)
    return sd, params, model


def _pixels(grid, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((int(np.prod(grid)), CFG.vision.patch_dim),
                               dtype=np.float32)


def _video_prompt(grid):
    t, h, w = grid
    n_vis = t * (h // 2) * (w // 2)
    return np.asarray([1, 2, CFG.vision_start_token_id]
                      + [CFG.video_token_id] * n_vis + [3, 4, 5], np.int64)


def _jax_text(params, embeds, pos, S):
    """JAX's ``text_forward`` under ``jit`` (XLA's K7 arithmetic: the amax
    times fp32(1/127), as the JAX generator runs it)."""
    t = JCFG.text
    cos, sin = J.mrope_tables(pos, t)
    caches = [(jnp.zeros((1, t.num_kv_heads, S, t.head_dim)),
               jnp.zeros((1, t.num_kv_heads, S, t.head_dim)))
              for _ in range(t.num_layers)]
    mask = jnp.where(jnp.arange(S)[None, :] <= jnp.arange(S)[:, None],
                     0.0, -1e30)
    fn = jax.jit(functools.partial(J.text_forward, cfg=t))
    out, _ = fn(params, jnp.asarray(embeds), jnp.asarray(cos),
                jnp.asarray(sin), caches, 0, mask)
    return np.asarray(out)


def _port_logits(model, embeds, pos):
    S = embeds.shape[1]
    cos, sin = T.mrope_tables(pos, model.cfg.text)
    with torch.no_grad():
        h = model.text_forward(torch.from_numpy(embeds).to(model.dtype),
                               torch.from_numpy(cos), torch.from_numpy(sin),
                               model.new_caches(1, S), 0,
                               T.causal_mask(S, S))
        return model.logits(h).float().numpy()


# ---------------------------------------------------------------------------
# host-side arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS + [(2, 20, 30)])
def test_layout_tables_and_rope_index_equal_jax(grid):
    for tcfg, jcfg in ((CFG, JCFG), (T.QWEN25_VL_32B, J.QWEN25_VL_32B)):
        got = T.vision_layout(grid, tcfg.vision)
        want = J.vision_layout(grid, jcfg.vision)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ids = np.asarray([1, 2, tcfg.vision_start_token_id]
                         + [tcfg.video_token_id]
                         * (grid[0] * grid[1] * grid[2] // 4) + [3, 4],
                         np.int64)
        for spg in (1.0, 0.5):
            pos = T.get_rope_index(ids, grid, tcfg, second_per_grid_t=spg)
            np.testing.assert_array_equal(
                pos, J.get_rope_index(ids, grid, jcfg,
                                      second_per_grid_t=spg))
            for a, b in zip(T.mrope_tables(pos, tcfg.text),
                            J.mrope_tables(pos, jcfg.text)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(T.get_rope_index(ids, None, tcfg),
                                      J.get_rope_index(ids, None, jcfg))


# ---------------------------------------------------------------------------
# the model against JAX in fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_vision_tower_matches_jax(pair, grid):
    _, params, model = pair
    pixels = _pixels(grid, 1)
    want = J.qwen_vision_forward(params, jnp.asarray(pixels),
                                 J.vision_layout(grid, JCFG.vision),
                                 JCFG.vision)
    with torch.no_grad():
        got = model.vision(torch.from_numpy(pixels),
                           T.vision_layout(grid, CFG.vision))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= REL_L2


@pytest.mark.parametrize("S", [11, 700])
def test_text_logits_match_jax(pair, S):
    """One prefill chunk (11 rows) and two (700: 512 + a ragged 188)."""
    _, params, model = pair
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((1, S, CFG.text.hidden_size),
                                 dtype=np.float32)
    pos = rng.integers(0, 30, (3, S))
    assert _rel(_port_logits(model, embeds, pos),
                _jax_text(params, embeds, pos, S)) <= REL_L2


def _generate_both(params, model, grid, max_new):
    pixels = _pixels(grid, 3)
    ids = _video_prompt(grid)
    pos = J.get_rope_index(ids, grid, JCFG, is_video=True)
    vis = J.qwen_vision_forward(params, jnp.asarray(pixels),
                                J.vision_layout(grid, JCFG.vision),
                                JCFG.vision)
    want = J.QwenVLGenerator(params, JCFG, max_new).generate(ids, vis, pos)
    gen = T.QwenVLGenerator(model, max_new)
    with torch.no_grad():
        tvis = model.vision(torch.from_numpy(pixels),
                            T.vision_layout(grid, CFG.vision))
    got = gen.generate(ids, tvis, T.get_rope_index(ids, grid, CFG))
    return got, want, gen


def test_generate_matches_jax(pair):
    """Greedy tokens equal; each step's logits finite."""
    _, params, model = pair
    got, want, gen = _generate_both(params, model, (2, 4, 6), 6)
    assert got == want and len(got) >= 1
    assert len(gen.logits) == len(got)
    assert all(bool(torch.isfinite(x).all()) for x in gen.logits)
    assert len(gen.timings["decode_s"]) == len(got) - 1


def test_int8_tree_matches_jax(pair):
    """JAX's ``quantize_qwen_int8`` on the fp32 tree against the port's on
    the fp32 model: the weight codes and scales bit-equal (the bridge of
    JAX's int8 tree loads into the port's quantized model as it is),
    logits within REL_L2 (K7's plain version is bit-equal to XLA's
    quantizer; only the dequantized sums' order differs) and the same
    greedy tokens."""
    sd, params, _ = pair
    qparams = J.quantize_qwen_int8(params)
    model = T.quantize_qwen_int8(T.qwen_vl_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG))
    bridged = qwen_vl_from_jax(jax.tree.map(np.asarray, qparams), CFG)
    own = model.state_dict()
    assert bridged.keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(bridged[k], v), k
    rng = np.random.default_rng(6)
    S = 9
    embeds = rng.standard_normal((1, S, CFG.text.hidden_size),
                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(S), (3, S))
    assert _rel(_port_logits(model, embeds, pos),
                _jax_text(qparams, embeds, pos, S)) <= REL_L2
    got, want, _ = _generate_both(qparams, model, (1, 4, 4), 4)
    assert got == want


def test_bridge_round_trip_uses_every_parameter(pair):
    """JAX tree -> the port's state dict gives back the checkpoint's
    tensors, key for key; the legacy names load the same; a key the model
    does not have is refused."""
    sd, params, model = pair
    back = qwen_vl_from_jax(jax.tree.map(np.asarray, params), CFG)
    assert back.keys() == sd.keys() == model.state_dict().keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    def legacy(k):
        if k.startswith("model.visual."):
            return k[len("model."):]
        if k.startswith("model.language_model."):
            return "model." + k[len("model.language_model."):]
        return k
    tensors = {legacy(k): torch.from_numpy(v) for k, v in sd.items()}
    tensors["model.rotary_emb.inv_freq"] = torch.zeros(3)
    m2 = T.qwen_vl_from_state_dict(tensors, CFG)
    for k, v in m2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    extra = dict(tensors, **{"model.visual.extra.weight": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        T.qwen_vl_from_state_dict(extra, CFG)


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

# relative L2 of the port's bf16 model from its fp32 one on the tiny config
# (2 text layers, 3 vision blocks): bf16 keeps 8 bits of mantissa, so each
# rounding moves a value by up to 2^-9 relative and a few dozen of them
# compound through a layer
BF16_REL_L2 = 5e-2


def test_bf16_against_fp32(pair):
    sd, _, model = pair
    m16 = T.qwen_vl_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG,
        dtype=torch.bfloat16)
    grid = (2, 4, 6)
    layout = T.vision_layout(grid, CFG.vision)
    px = torch.from_numpy(_pixels(grid, 4))
    with torch.no_grad():
        v32, v16 = model.vision(px, layout), m16.vision(px, layout)
    assert v16.dtype == torch.bfloat16
    assert _rel(v16.float().numpy(), v32.numpy()) <= BF16_REL_L2
    rng = np.random.default_rng(7)
    embeds = rng.standard_normal((1, 13, CFG.text.hidden_size),
                                 dtype=np.float32)
    pos = rng.integers(0, 20, (3, 13))
    assert _rel(_port_logits(m16, embeds, pos),
                _port_logits(model, embeds, pos)) <= BF16_REL_L2
    ids = _video_prompt(grid)
    toks = T.QwenVLGenerator(m16, 4).generate(
        ids, v16, T.get_rope_index(ids, grid, CFG))
    assert len(toks) >= 1 and all(0 <= t < CFG.text.vocab_size
                                  for t in toks)


def test_jax_bf16_generator_raises(pair):
    """The reference defect the port departs from: JAX's generator cannot
    run a bf16 tree (fp32 M-RoPE tables promote k, and the bf16 cache
    update refuses it)."""
    _, params, _ = pair
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    ids = np.arange(1, 6)
    with pytest.raises(TypeError, match="bfloat16.*float32|float32.*bfloat16"):
        J.QwenVLGenerator(p16, JCFG, 2).generate(
            ids, None, J.get_rope_index(ids, None, JCFG))


# ---------------------------------------------------------------------------
# the judge from a checkpoint directory
# ---------------------------------------------------------------------------

class StubProcessor:
    """transformers' processor contract at the tiny config: a fixed video
    prompt, the frames folded into patch rows, token 7 decoding to "Yes"."""

    GRID = (2, 4, 6)

    def apply_chat_template(self, messages, tokenize, add_generation_prompt):
        content = messages[0]["content"]
        assert content[0]["type"] == "video" and content[0]["fps"] == 1
        return content[1]["text"]

    def __call__(self, text, videos, return_tensors):
        frames = videos[0].numpy().astype(np.float32) / 127.5 - 1.0
        n = int(np.prod(self.GRID)) * CFG.vision.patch_dim
        pixels = np.resize(frames.reshape(-1), n).reshape(
            -1, CFG.vision.patch_dim)
        return {"input_ids": _video_prompt(self.GRID)[None],
                "pixel_values_videos": pixels,
                "video_grid_thw": np.asarray([self.GRID]),
                "second_per_grid_ts": np.asarray([1.0])}

    def batch_decode(self, seqs, skip_special_tokens):
        return [" ".join("Yes" if t == 7 else f"t{t}" for t in seqs[0])]


def _write_checkpoint(path, sd):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(T.qwen_vl_config_to_json(CFG), f)
    save_file({k: torch.from_numpy(v) for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))


def test_judge_from_checkpoint_dir(pair, tmp_path, monkeypatch):
    """The port's writer makes a checkpoint directory; the judge loaded from
    it answers from the same greedy tokens as the model generating
    directly; ``--qwen_checkpoint`` reaches it through
    ``load_default_backends``; a mesh raises and names queue 1 item 12."""
    sd, _, model = pair
    ckpt = str(tmp_path / "qwen")
    _write_checkpoint(ckpt, sd)
    assert T.qwen_vl_config_from_json(os.path.join(ckpt, "config.json")) \
        == CFG
    frames = np.random.RandomState(0).randint(0, 255, (4, 8, 8, 3)
                                              ).astype(np.uint8)
    judge = tperc.load_qwen_judge_checkpoint(
        ckpt, device="cpu", dtype=torch.float32, processor=StubProcessor())
    proc = StubProcessor()
    inputs = proc("", [torch.from_numpy(frames).permute(0, 3, 1, 2)], "np")
    grid = StubProcessor.GRID
    with torch.no_grad():
        vis = model.vision(torch.from_numpy(inputs["pixel_values_videos"]),
                           T.vision_layout(grid, CFG.vision))
    ids = inputs["input_ids"][0]
    toks = T.QwenVLGenerator(model, 8).generate(
        ids, vis, T.get_rope_index(ids, grid, CFG))
    want = "Yes" if 7 in toks else "No"
    assert judge(frames, "a prompt", True) == want
    assert judge(frames, "a prompt", False) == want

    seen = {}

    def fake_loader(path, device):
        seen.update(path=path, device=device)
        return tperc.naive_judge
    monkeypatch.setattr(tperc, "load_qwen_judge_checkpoint", fake_loader)
    monkeypatch.setattr(tperc, "load_cotracker", lambda device: None)
    monkeypatch.setattr(tperc, "load_sam2", lambda device: None)
    monkeypatch.setattr(tperc, "load_dinov2", lambda device: None)
    backends = tperc.load_default_backends(device="cpu",
                                           qwen_checkpoint=ckpt)
    assert backends["judge"] is tperc.naive_judge
    assert seen == dict(path=ckpt, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        T.load_qwen_vl_torch(ckpt, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        T.shard_qwen_params(None, None, CFG)


def test_random_init_is_seeded_and_quantizes_in_place():
    """``init_qwen_vl`` draws every tensor from its generator (the same
    seed, the same model); ``quantize_qwen_int8`` swaps exactly the 7
    products of each text layer."""
    a = T.init_qwen_vl(CFG, torch.Generator().manual_seed(3))
    b = T.init_qwen_vl(CFG, torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    T.quantize_qwen_int8(a)
    quant = [n for n, m in a.named_modules()
             if type(m).__name__ == "QuantLinear"]
    assert len(quant) == 7 * CFG.text.num_layers
    assert all(".language_model.layers." in n for n in quant)
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(CFG)
