"""The PyTorch port's int8 w8a8 serving path on the CPU against the JAX
package: K7's plain version (the per-row activation quantizer), the weight
quantizer, ``dense_int8``, the layer selection, the weight bridge of
quantized trees and the tiny quantized DiTs of both families.

Inputs are drawn with numpy from a seed and handed to both sides. The JAX
side runs jitted, as its pipelines run it: XLA then multiplies the absmax
by the fp32-rounded 1/127 where the source divides by 127, and the port
computes that, so the quantizers and ``dense_int8`` are bit-equal.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.core.tree import flatten
from frameino_tpu.models import cogvideox_dit as jcog
from frameino_tpu.models import quant as jquant
from frameino_tpu.models import wan_dit as jwan
from frameino_tpu.ops import dyn_quant as jdq
from frameino_tpu.ops import linear as jlinear
from frameino_tpu_torch.models import cogvideox_dit as tcog
from frameino_tpu_torch.models import quant
from frameino_tpu_torch.models import wan_dit as twan
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models import weights as tweights
from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.ops import dyn_quant
from frameino_tpu_torch.ops.linear import dense_int8
from frameino_tpu_torch.pipelines import cogvideox_i2v as tcpipe
from frameino_tpu_torch.pipelines import wan_i2v as twpipe


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


@jax.jit
def _jax_xla_quantize(x):
    """The activation quantizer of JAX's ``dense_int8`` (its XLA branch,
    ``frameino_tpu/ops/linear.py:43-46``), jitted."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0,
                    1e-12)
    return jnp.round(xf / s).astype(jnp.int8), s


def _crafted_rows(d):
    """Row 0: scale exactly 1.0 (127 * fp32(1/127) rounds to 1), so its
    halves sit on half-way points and must go to even (2.5 -> 2, 3.5 -> 4,
    126.5 -> 126; half away from zero gives 3, 4, 127). Row 1: zeros,
    whose scale takes the 1e-12 floor."""
    halves = np.array([127, 2.5, 3.5, -2.5, -0.5, 0.5, 126.5, -126.5, 1.5,
                       -1.5, 64.5, -64.5], np.float32)
    row = np.resize(halves, d)
    row[0] = 127.0
    return np.stack([row, np.zeros(d, np.float32)])


def _activations(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    # rows of different magnitudes, as the DiT's activations have
    return x * np.exp(rs.randn(*shape[:-1], 1)).astype(np.float32)


ROWS = {"13x256": (13, 256), "2x9x384": (2, 9, 384), "64x3072": (64, 3072),
        "40x14336": (40, 14336), "halfway+zero": None}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(ROWS))
def test_dyn_quant_ref_is_bit_equal_to_jax(case, dtype):
    """K7's plain version against JAX's jitted XLA formula and the Pallas
    kernel in interpret mode: every code and every scale bit-equal."""
    shape = ROWS[case]
    x = _crafted_rows(256) if shape is None else _activations(shape, 0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(_np(xt), dtype=jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    before = A.launch_counts()["dynamic_quantize_rows"]
    q, s = dyn_quant.dynamic_quantize_rows(xt)          # CPU: plain version
    assert A.launch_counts()["dynamic_quantize_rows"] == before
    assert q.dtype == torch.int8 and q.shape == xt.shape
    assert s.dtype == torch.float32 and s.shape == (*xt.shape[:-1], 1)
    for ref_q, ref_s in (_jax_xla_quantize(xj),
                         jdq.dynamic_quantize_rows(xj, interpret=True)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    if shape is None:
        assert s[0].item() == 1.0 and s[1].item() == np.float32(1e-12)
        np.testing.assert_array_equal(q[0, :12].numpy(),
                                      [127, 2, 4, -2, 0, 0, 126, -126, 2, -2,
                                       64, -64])
        assert not q[1].any()


def test_dyn_quant_scale_multiplies_by_the_fp32_reciprocal():
    """A division by 127 moves some scales by one ulp: the port must take
    the reciprocal (as XLA does), and the plain numpy formula must not be
    what it matches."""
    x = torch.from_numpy(_activations((2000, 64), 1))
    amax = x.abs().amax(-1, keepdim=True)
    _, s = dyn_quant.dynamic_quantize_rows_ref(x)
    divided = torch.clamp_min(amax / 127.0, 1e-12)
    assert not torch.equal(s, divided)
    assert torch.all((s - divided).abs() <= torch.finfo(torch.float32).eps
                     * divided)


@pytest.mark.parametrize("shape", [(3, 16, 8), (2, 256, 128)])
def test_weight_quantizer_matches_jax(shape):
    """Bit-equal to JAX's device quantizer (jitted, as the pipelines run
    it); scales within one ulp of its host (numpy, true division) one."""
    w = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jq, js = jquant._quantize_device(jnp.asarray(w))
    hq, hs = jquant._quantize_kernel_host(w)
    for i in range(shape[0]):
        q, s = quant.quantize_weight(torch.from_numpy(w[i].T.copy()))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy().T, np.asarray(jq[i]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js[i]))
        assert np.all(np.abs(s.numpy() - hs[i]) <= np.spacing(hs[i]))
        assert np.abs(q.numpy()).max() <= 127


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_int8_matches_jax(dtype):
    """The same x, int8 kernel, scales and bias through the port's
    ``dense_int8`` and ``jax.jit(dense_int8)``. The integer product is
    exact and the epilogue the same IEEE operations in the same order, but
    XLA's CPU backend contracts the last multiply and the bias add into one
    fused multiply-add, where the port rounds the product first. bf16
    outputs are bit-equal (the rounding to bf16 hides that); fp32 outputs
    may differ by the product's rounding: one fp32 ulp of y * s, plus one
    of the output."""
    rs = np.random.RandomState(3)
    w = rs.randn(256, 128).astype(np.float32) * 0.05
    b = rs.randn(128).astype(np.float32)
    kq, ks = jquant._quantize_device(jnp.asarray(w))
    wq = torch.from_numpy(np.asarray(kq).T.copy())
    scale = torch.from_numpy(np.array(ks))
    xt = torch.from_numpy(_activations((3, 17, 256), 4)).to(dtype)
    xj = jnp.asarray(_np(xt), dtype=jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    ref = np.asarray(jax.jit(jlinear.dense_int8)(
        xj, {"kernel_q": kq, "scale": ks, "bias": jnp.asarray(b)}),
        np.float32)
    got = dense_int8(xt, wq, scale, torch.from_numpy(b))
    assert got.dtype == dtype and got.shape == (3, 17, 128)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(_np(got), ref)
        return
    product = dense_int8(xt, wq, scale, None, out_dtype=torch.float32)
    assert product.dtype == torch.float32
    limit = np.spacing(np.abs(product.numpy())) + np.spacing(np.abs(ref))
    assert np.all(np.abs(got.numpy() - ref) <= limit)


def test_dense_int8_rejects_mismatched_shapes():
    xq = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        dense_int8(torch.zeros(2, 16), xq, torch.ones(4))
    with pytest.raises(ValueError):
        dense_int8(torch.zeros(2, 8), xq, torch.ones(5))


# ---------------------------------------------------------------------------
# layer selection, bridge, tiny DiTs
# ---------------------------------------------------------------------------

WAN_FLOAT = re.compile(r"condition_embedder\..*|proj_out")
COG_FLOAT = re.compile(r"patch_embed\.text_proj|time_embedding\..*|"
                       r"(transformer_blocks\.\d+\.)?norm\w*\.linear|"
                       r"proj_out")
WAN_KW = dict(in_channels=8, out_channels=4)


def _jax_kernel_q_per_block(qparams):
    return sum(1 for k in flatten(qparams)
               if k.startswith("blocks.") and k.endswith(".kernel_q"))


@pytest.mark.parametrize("family", ["wan", "cogvideox"])
def test_layer_selection_matches_jax(family):
    """Exactly JAX's ``_QUANT_PATTERNS``: 10 layers a Wan block, 6 a
    CogVideoX block; every other linear layer stays float."""
    if family == "wan":
        m = twan.init_wan_dit(twan.tiny_config(**WAN_KW),
                              torch.Generator().manual_seed(0))
        jp = jwan.init_wan_dit(jax.random.key(0), jwan.tiny_config(**WAN_KW))
        per_block, keep, blocks = 10, WAN_FLOAT, "blocks"
    else:
        m = tcog.init_cogvideox_dit(tcog.tiny_config(),
                                    torch.Generator().manual_seed(0))
        jp = jcog.init_cogvideox_dit(jax.random.key(0), jcog.tiny_config())
        per_block, keep, blocks = 6, COG_FLOAT, "transformer_blocks"
    assert _jax_kernel_q_per_block(jquant.quantize_dit_int8(jp)) == per_block
    n_layers = m.cfg.num_layers
    assert len(quant.quantized_layer_names(m)) == per_block * n_layers
    assert quant.quantize_dit_int8(m) is m
    quantized = [n for n, x in m.named_modules()
                 if isinstance(x, quant.QuantLinear)]
    for i in range(n_layers):
        assert sum(n.startswith(f"{blocks}.{i}.") for n in quantized) \
            == per_block
    floats = [n for n, x in m.named_modules()
              if isinstance(x, torch.nn.Linear)]
    assert floats and all(keep.fullmatch(n) for n in floats), floats
    with pytest.raises(ValueError, match="no layers matched"):
        quant.quantize_dit_int8(m)


def _bridge_pair(family):
    """(JAX cfg, float params, int8 params, port model quantized by the
    port, port model loaded from JAX's int8 tree)."""
    if family == "wan":
        jcfg, tcfg = jwan.tiny_config(**WAN_KW), twan.tiny_config(**WAN_KW)
        params = jwan.init_wan_dit(jax.random.key(1), jcfg)
        bridge, cls = tweights.wan_dit_from_jax, twan.WanDiT
    else:
        jcfg = jcog.tiny_config(use_frame_in=True)
        tcfg = tcog.tiny_config(use_frame_in=True)
        params = jcog.init_cogvideox_dit(jax.random.key(1), jcfg)
        bridge, cls = tweights.cogvideox_dit_from_jax, tcog.CogVideoXDiT
    qparams = jquant.quantize_dit_int8(params)
    to_np = jax.tree.map(np.asarray, params)
    fmodel = cls(tcfg, device="meta")
    fmodel.load_state_dict(bridge(to_np, tcfg), assign=True, strict=True)
    own = quant.quantize_dit_int8(copy.deepcopy(fmodel).eval())
    loaded = quant.quantize_dit_int8(copy.deepcopy(fmodel).eval())
    missing = loaded.load_state_dict(
        bridge(jax.tree.map(np.asarray, qparams), tcfg), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return jcfg, qparams, own, loaded


@pytest.mark.parametrize("family", ["wan", "cogvideox"])
def test_bridged_int8_dit_matches_jax(family):
    """A JAX-quantized tiny DiT bridged into the port against JAX's jitted
    int8 forward, fp32 on both sides. Relative L2 <= 1e-3: the quantized
    weights are the same, but an fp32 activation that differs in its last
    bits from reordered sums upstream can flip one code (one step of its
    row's scale). The port quantizing its own bridged float weights gives
    JAX's int8 tree bit for bit."""
    jcfg, qparams, own, loaded = _bridge_pair(family)
    sd_own, sd_loaded = own.state_dict(), loaded.state_dict()
    assert sd_own.keys() == sd_loaded.keys()
    for k in sd_own:
        assert torch.equal(sd_own[k], sd_loaded[k]), k
    assert any(k.endswith(".weight_q") for k in sd_own)

    rs = np.random.RandomState(5)
    if family == "wan":
        x = rs.randn(2, 8, 3, 4, 6).astype(np.float32)
        t = np.array([999.0, 357.5], np.float32)
        ctx = rs.randn(2, 7, 16).astype(np.float32)
        mask = np.ones((2, 18), np.float32)
        mask[:, :6] = 0.0
        ref = jax.jit(lambda p, *a: jwan.wan_dit_forward(
            jcfg, p, a[0], a[1], a[2], timestep_mask=a[3],
            attn_impl="xla"))(qparams, *map(jnp.asarray, (x, t, ctx, mask)))
        got = loaded(*map(torch.from_numpy, (x, t, ctx)),
                     timestep_mask=torch.from_numpy(mask))
    else:
        F, H, W = 3, 8, 8
        x = rs.randn(2, F + 1, jcfg.in_channels, H, W).astype(np.float32)
        text = rs.randn(2, 8, 16).astype(np.float32)
        t = np.array([999.0, 400.0], np.float32)
        cj, sj = jcog.cogvideox_rope(jcfg, F, H, W,
                                     duplicate_first_frame_for_id=True)
        ref = jax.jit(lambda p, *a: jcog.cogvideox_forward(
            jcfg, p, a[0], a[1], a[2], image_rotary_emb=(a[3], a[4]),
            attn_impl="xla"))(qparams, *map(jnp.asarray, (x, text, t)),
                              cj, sj)
        rope = tcog.cogvideox_rope(loaded.cfg, F, H, W,
                                   duplicate_first_frame_for_id=True)
        got = loaded(*map(torch.from_numpy, (x, text, t)), rope)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel


def test_quantize_options_raise():
    dit = twan.init_wan_dit(twan.tiny_config(**WAN_KW),
                            torch.Generator().manual_seed(0))
    vae = tvae.init_wan_vae(tvae.WanVAEConfig(
        base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
        temperal_downsample=(True,), is_residual=False,
        scale_factor_temporal=2, scale_factor_spatial=2,
        latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4),
        torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        twpipe.WanImageToVideoPipeline(dit, vae, quantize_vae=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        quant.quantize_wan_vae_int8(vae)
    with pytest.raises(ValueError, match="quantize"):
        twpipe.WanImageToVideoPipeline(dit, vae, quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        tcpipe.CogVideoXImageToVideoPipeline(None, None, quantize="fp8")
    # neither refusal touched the DiT
    assert quant.quantized_layer_names(dit)
    assert not any(isinstance(m, quant.QuantLinear) for m in dit.modules())
