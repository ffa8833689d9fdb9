"""K13, multi-scale deformable attention: its plain version against the JAX
package's ``ms_deform_attn`` on the CPU, and the CUDA kernel against the
plain version on the card (marked ``cuda``; skips without one).

Tolerance: fp32, max abs 1e-5 (the plain version reads 0.0 from JAX: the
same gather, step by step). Locations outside [0, 1] sample zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from frameino_tpu_torch.ops import ms_deform_attn as M

ATOL = 1e-5

# (batch, levels (H_l, W_l), queries, heads, channels, points)
SHAPES = {
    "oneformer_tiny": (1, ((2, 3), (4, 6), (8, 12)), 37, 4, 8, 2),
    "ragged": (2, ((5, 7), (3, 1), (1, 1)), 11, 3, 5, 3),
    "one_level_d32": (1, ((6, 10),), 9, 8, 32, 4),
    "d48": (1, ((4, 4), (2, 2)), 6, 2, 48, 4),
}


def _inputs(B, shapes, Q, H, D, P, seed=0, lo=-0.3, hi=1.3):
    rs = np.random.RandomState(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rs.randn(B, S, H, D).astype(np.float32)
    loc = rs.uniform(lo, hi, (B, Q, H, L, P, 2)).astype(np.float32)
    w = rs.rand(B, Q, H, L, P).astype(np.float32)
    return value, loc, w


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_jax(name):
    B, shapes, Q, H, D, P = SHAPES[name]
    value, loc, w = _inputs(B, shapes, Q, H, D, P)
    want = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                               jnp.asarray(w)))
    before = M.ms_deform_attn.launches
    got = M.ms_deform_attn(torch.from_numpy(value), shapes,
                           torch.from_numpy(loc), torch.from_numpy(w))
    assert M.ms_deform_attn.launches == before      # the CPU runs no kernel
    assert got.shape == (B, Q, H * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_out_of_range_locations_sample_zeros():
    """Every location outside the levels (x or y < -1/W or > 1 + 1/W)
    samples only zero padding; one just inside keeps its corner."""
    B, shapes, Q, H, D, P = SHAPES["ragged"]
    value, loc, w = _inputs(B, shapes, Q, H, D, P)
    far = loc.copy()
    far[..., 0] = np.where(np.arange(Q)[None, :, None, None, None] % 2,
                           -2.0, 3.0)
    got = M.ms_deform_attn_ref(torch.from_numpy(value), shapes,
                               torch.from_numpy(far), torch.from_numpy(w))
    assert float(got.abs().max()) == 0.0
    want = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(far),
                               jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the top-left corner's centre: one sample, weight w, value row 0
    one = np.zeros_like(loc)
    one[..., 0] = 0.5 / np.array([s[1] for s in shapes])[None, None, None,
                                                          :, None]
    one[..., 1] = 0.5 / np.array([s[0] for s in shapes])[None, None, None,
                                                          :, None]
    got = M.ms_deform_attn_ref(torch.from_numpy(value), shapes,
                               torch.from_numpy(one), torch.from_numpy(w))
    starts = np.concatenate([[0], np.cumsum([h * w_ for h, w_ in shapes])])
    want = sum(w[:, :, :, lvl].sum(-1)[..., None]
               * value[:, None, starts[lvl]] for lvl in range(len(shapes)))
    np.testing.assert_allclose(got.numpy(), want.reshape(B, Q, -1),
                               rtol=1e-6, atol=ATOL)


def test_levels_must_cover_the_value_rows():
    value, loc, w = _inputs(1, ((2, 2),), 3, 1, 4, 1)
    with pytest.raises(ValueError, match="rows"):
        M.ms_deform_attn(torch.from_numpy(value), ((2, 3),),
                         torch.from_numpy(loc), torch.from_numpy(w))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K13 is a CUDA kernel with no CPU "
                    "mode")
    B, shapes, Q, H, D, P = SHAPES[name]
    value, loc, w = _inputs(B, shapes, Q, H, D, P)
    args = [torch.from_numpy(a) for a in (value, loc, w)]
    want = M.ms_deform_attn_ref(args[0], shapes, args[1], args[2])
    before = M.ms_deform_attn.launches
    got = M.ms_deform_attn(args[0].cuda(), shapes, args[1].cuda(),
                           args[2].cuda())
    assert M.ms_deform_attn.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=ATOL)
    with pytest.raises(TypeError, match="float32"):
        M.ms_deform_attn(args[0].cuda().half(), shapes, args[1].cuda(),
                         args[2].cuda())
