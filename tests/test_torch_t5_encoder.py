"""The port's T5 / UMT5 encoder (``models/t5_encoder.py``) against the JAX
package's ``t5_encode`` and against transformers' ``T5EncoderModel`` /
``UMT5EncoderModel`` built from a config (CPU, tiny random weights, fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.models import t5_encoder as jt5
from frameino_tpu.models import weights as JW
from frameino_tpu_torch.models import t5_encoder as tt5

# tests/test_t5_encoder.py's limit for JAX against transformers
TOL = dict(atol=2e-4, rtol=2e-3)

HF_KW = dict(vocab_size=64, d_model=16, d_kv=4, num_heads=2, d_ff=32,
             num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
             feed_forward_proj="gated-gelu", is_encoder_decoder=False)


def _hf(kind, seed=0):
    torch.manual_seed(seed)
    if kind == "t5":
        from transformers import T5Config, T5EncoderModel
        return T5EncoderModel(T5Config(**HF_KW)).eval()
    from transformers import UMT5Config, UMT5EncoderModel
    return UMT5EncoderModel(UMT5Config(**HF_KW)).eval()


def _port(hf, kind):
    cfg = tt5.tiny_config(per_layer_relative_bias=kind == "umt5")
    model = tt5.T5Encoder(cfg, device="meta")
    model.load_state_dict(tt5.from_state_dict_names(hf.state_dict()),
                          assign=True)
    return cfg, model.eval()


def _inputs(seed=0, B=2, S=10):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 64, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 7:] = 0
    return ids, mask


@pytest.mark.parametrize("kind", ["t5", "umt5"])
def test_encoder_matches_transformers_and_jax(kind):
    hf = _hf(kind)
    cfg, model = _port(hf, kind)
    ids, mask = _inputs()
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)
                 ).last_hidden_state.numpy()
    got = tt5.t5_encode(model, torch.from_numpy(ids),
                        torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 10, 16)
    np.testing.assert_allclose(got, ref, **TOL)
    jcfg = jt5.tiny_config(per_layer_relative_bias=kind == "umt5")
    params = JW.t5_from_state_dict(
        {k: v.numpy() for k, v in hf.state_dict().items()}, jcfg)
    ref_j = np.asarray(jt5.t5_encode(jcfg, params, jnp.asarray(ids),
                                     jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref_j, **TOL)
    # without a mask every position attends
    np.testing.assert_allclose(
        tt5.t5_encode(model, torch.from_numpy(ids)).numpy(),
        np.asarray(jt5.t5_encode(jcfg, params, jnp.asarray(ids))), **TOL)


def test_umt5_has_a_bias_table_a_layer_and_t5_shares_layer_0s():
    for kind, want in (("umt5", [True, True]), ("t5", [True, False])):
        _, model = _port(_hf(kind), kind)
        assert [b.layer[0].SelfAttention.relative_attention_bias is not None
                for b in model.encoder.block] == want


def test_encode_and_mask_zero_fills():
    cfg = tt5.tiny_config()
    model = tt5.init_t5_encoder(cfg, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (1, 6)))
    mask = torch.tensor([[1, 1, 1, 0, 0, 0]])
    out = tt5.encode_and_mask(model, ids, mask, max_sequence_length=12)
    assert out.shape == (1, 12, cfg.d_model)
    assert torch.all(out[0, 3:] == 0) and out[0, :3].abs().sum() > 0
    # cut to the length when the ids are longer
    assert tt5.encode_and_mask(model, ids, mask,
                               max_sequence_length=4).shape == (1, 4, 16)
    # the same recipe as JAX's on the same weights
    jcfg = jt5.tiny_config()
    params = JW.t5_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    ref = jt5.encode_and_mask(jcfg, params, jnp.asarray(ids.numpy()),
                              jnp.asarray(mask.numpy()),
                              max_sequence_length=12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_embed_tokens_name_and_missing_prefix_load():
    """A file with the embedding as ``encoder.embed_tokens`` only, or the
    stack saved without its ``encoder.`` prefix, loads to the same
    module."""
    hf = _hf("umt5")
    sd = hf.state_dict()
    _, want = _port(hf, "umt5")
    renamed = {("encoder.embed_tokens.weight" if k == "shared.weight"
                else k): v for k, v in sd.items()}
    bare = {k[len("encoder."):] if k.startswith("encoder.") else k: v
            for k, v in sd.items() if k != "encoder.embed_tokens.weight"}
    for variant in (renamed, bare):
        m = tt5.T5Encoder(want.cfg, device="meta")
        m.load_state_dict(tt5.from_state_dict_names(variant), assign=True)
        for k, v in want.state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k


def test_bucket_function_matches_transformers_and_jax():
    from transformers.models.t5.modeling_t5 import T5Attention
    rel = np.arange(-300, 301).reshape(1, -1)
    got = tt5.relative_position_bucket(rel, 32, 128)
    ref = T5Attention._relative_position_bucket(
        torch.from_numpy(rel), bidirectional=True, num_buckets=32,
        max_distance=128).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tt5.position_bias_indices(20, tt5.UMT5_XXL),
        jt5.position_bias_indices(20, jt5.UMT5_XXL))


def test_configs_match_jax():
    import dataclasses
    for name in ("UMT5_XXL", "T5_XXL_V11"):
        assert dataclasses.asdict(getattr(tt5, name)) \
            == dataclasses.asdict(getattr(jt5, name))
    with pytest.raises(NotImplementedError, match="gated"):
        tt5.T5Encoder(tt5.tiny_config(gated_act=False), device="meta")


def test_random_init_is_seeded_and_bf16_follows_fp32():
    """The seeded init repeats; the encoder in bf16 stays near fp32 (its
    norms' variance and its softmax in fp32)."""
    cfg = tt5.tiny_config(num_layers=3)
    a = tt5.init_t5_encoder(cfg, torch.Generator().manual_seed(3))
    b = tt5.init_t5_encoder(cfg, torch.Generator().manual_seed(3))
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v), k
    m16 = tt5.T5Encoder(cfg, device="meta", dtype=torch.bfloat16)
    m16.load_state_dict({k: v.bfloat16() for k, v in a.state_dict().items()},
                        assign=True)
    ids, mask = (torch.from_numpy(x) for x in _inputs(4))
    want = tt5.t5_encode(a, ids, mask)
    got = tt5.t5_encode(m16, ids, mask)
    assert got.dtype == torch.bfloat16
    rel = ((got.float() - want).norm() / want.norm()).item()
    assert rel < 3e-2
