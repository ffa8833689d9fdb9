"""K13, multi-scale deformable attention: its plain version against the JAX
package's ``ms_deform_attn`` on the CPU (at uniform locations and at the
encoder's own pattern), a replay of the kernel's work map, a numpy replay
of the plain version's rounding order tied to the kernel's source, and the
CUDA kernel against the plain version on the card
(marked ``cuda``; skips without one).

Tolerance: fp32, max abs 1e-5 (the plain version reads 0.0 from JAX: the
same gather, step by step). Locations outside [0, 1] sample zeros.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frameino_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from frameino_tpu_torch.ops import ms_deform_attn as M
from frameino_tpu_torch.scripts.tune_ms_deform_attn import (
    encoder_sampling_locations)

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


@pytest.mark.parametrize("shapes,heads,points", [
    (((2, 3), (4, 6), (8, 12)), 4, 2),
    (((5, 7), (3, 1), (1, 1)), 8, 3),
])
def test_encoder_pattern_plain_version_matches_jax(shapes, heads, points):
    """The encoder's own locations (each query near its own pixel, Deformable
    DETR's initial offsets plus noise) through the plain version and JAX's
    function; queries are the value rows."""
    loc = encoder_sampling_locations(shapes, 2, heads, points, seed=3)
    S = sum(h * w for h, w in shapes)
    assert loc.shape == (2, S, heads, len(shapes), points, 2)
    value, _, w = _inputs(2, shapes, S, heads, 8, points, seed=4)
    want = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                               jnp.asarray(w)))
    got = M.ms_deform_attn(torch.from_numpy(value), shapes,
                           torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # each query's point 0 of head 0 (direction (1, 0)) lies one pixel of
    # each level right of its reference point, give or take the noise
    ref = loc[0, :, 0, :, 0] - np.array([[1 / w_, 0] for _, w_ in shapes])
    x_ref = np.concatenate([((np.arange(h * w_) % w_) + 0.5) / w_
                            for h, w_ in shapes])
    noise = (ref[..., 0] - x_ref[:, None]) * np.array([w_ for _, w_ in
                                                       shapes])
    assert 0.5 < noise.std() < 1.5 and abs(noise.mean()) < 0.5


def _source():
    return (Path(M.__file__).resolve().parents[1] / "csrc"
            / "ms_deform_attn.cu").read_text()


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+)",
                         _source()).group(1))


# (batch, queries, heads, channels): OneFormer's, a ragged one, and two
# channel counts that are not 8 lanes of 4 (a second, narrower pass; 1
# channel a lane where D is not a multiple of 4)
WORK_MAPS = {"oneformer": (1, 21168, 8, 32), "ragged": (2, 333, 5, 40),
             "d5": (2, 11, 3, 5), "d48": (1, 6, 2, 48)}


@pytest.mark.parametrize("name", sorted(WORK_MAPS))
def test_work_map_covers_every_query_head_and_channel_once(name):
    """A replay of the kernel's work map (block = (b * tiles + tile) * H +
    h, then warp, then quarter-warp, then the lanes' channels in passes of
    8 lanes): every (b, q, h) is written by exactly one quarter-warp, and
    each of its D channels by exactly one lane in one pass."""
    assert (M.WARPS_PER_BLOCK, M.QUERIES_PER_WARP) == (
        _source_constant("kWarpsPerBlock"),
        _source_constant("kQueriesPerWarp"))
    B, Q, H, D = WORK_MAPS[name]
    lanes = 32 // M.QUERIES_PER_WARP
    tiles = -(-Q // M.QUERIES_PER_BLOCK)
    blk, warp, quarter = np.meshgrid(np.arange(B * tiles * H),
                                     np.arange(M.WARPS_PER_BLOCK),
                                     np.arange(M.QUERIES_PER_WARP),
                                     indexing="ij")
    h = blk % H
    tile = (blk // H) % tiles
    b = blk // (H * tiles)
    q = tile * M.QUERIES_PER_BLOCK + warp * M.QUERIES_PER_WARP + quarter
    live = q < Q
    seen = np.zeros((B, Q, H), np.int64)
    np.add.at(seen, (b[live], q[live], h[live]), 1)
    assert (seen == 1).all()
    assert (~live).sum() == B * H * (tiles * M.QUERIES_PER_BLOCK - Q)
    vec = 4 if D % 4 == 0 else 1
    chans = np.zeros(D, np.int64)
    for d0 in range(0, D, lanes * vec):
        for j in range(lanes):
            d = d0 + j * vec
            if d < D:
                chans[d:d + vec] += 1
    assert (chans == 1).all()


def _replay(value, shapes, loc, w):
    """The arithmetic in numpy fp32, in the order that
    ``test_kernel_source_rounds_in_the_replayed_order`` reads from the
    kernel's source: per sample x =
    loc * W - 0.5 rounded twice, the four corners (zero outside) times
    (1 - fx)(1 - fy), fx(1 - fy), (1 - fx)fy, fx fy summed left to right,
    times the weight, added to the level's sum; each level added to the
    output. Returns [B, Q, H * D]."""
    f32 = np.float32
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    one, half = f32(1), f32(0.5)
    acc = np.zeros((B, Q, H, D), f32)
    start = 0
    bi = np.arange(B)[:, None, None]
    hi = np.arange(H)[None, None, :]
    for lvl, (hl, wl) in enumerate(shapes):
        level = np.zeros_like(acc)
        for p in range(P):
            x = loc[:, :, :, lvl, p, 0] * f32(wl) - half
            y = loc[:, :, :, lvl, p, 1] * f32(hl) - half
            x0, y0 = np.floor(x), np.floor(y)
            fx, fy = x - x0, y - y0
            ux, uy = one - fx, one - fy
            s = None
            for dx, dy, cw in ((0, 0, ux * uy), (1, 0, fx * uy),
                               (0, 1, ux * fy), (1, 1, fx * fy)):
                ix, iy = (x0 + dx).astype(np.int64), (y0 + dy).astype(np.int64)
                inside = (ix >= 0) & (ix < wl) & (iy >= 0) & (iy < hl)
                rows = start + np.clip(iy, 0, hl - 1) * wl + np.clip(
                    ix, 0, wl - 1)
                g = np.where(inside[..., None], value[bi, rows, hi], f32(0))
                term = g * cw[..., None]
                s = term if s is None else s + term
            level = level + s * w[:, :, :, lvl, p, None]
        acc = acc + level
        start += hl * wl
    assert acc.dtype == np.float32
    return acc.reshape(B, Q, H * D)


@pytest.mark.parametrize("pattern", ["uniform", "encoder"])
def test_kernel_rounding_order_is_the_plain_versions(pattern):
    """The order of products and sums (each rounded on its own) that the
    kernel's source spells out, replayed in numpy, is bit-equal to the
    plain version in fp32 on the ragged inputs, at locations outside the
    levels and at the encoder's. This pins the plain version's order; the
    test below ties the kernel's source to the replay, and only the card
    check (phase 24 of chip_smoke.py, max abs 0) sees the compiled
    kernel."""
    B, shapes, Q, H, D, P = SHAPES["ragged"]
    value, loc, w = _inputs(B, shapes, Q, H, D, P)
    if pattern == "encoder":
        Q = sum(h * w_ for h, w_ in shapes)
        value, _, w = _inputs(B, shapes, Q, H, D, P, seed=1)
        loc = encoder_sampling_locations(shapes, B, H, P, seed=1)
    want = M.ms_deform_attn_ref(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_array_equal(_replay(value, shapes, loc, w),
                                  want.numpy())


def _device_function(src, signature):
    """The body of the ``__device__`` function whose head starts with
    ``signature``, without spaces."""
    start = src.index(signature)
    body = src[src.index("{", start) + 1:src.index("\n}", start)]
    return re.sub(r"\s+", "", body)


def test_kernel_source_rounds_in_the_replayed_order():
    """The kernel's float arithmetic as ``_replay`` does it, read from
    ``csrc/ms_deform_attn.cu``: the corner sum ((v0 w0 + v1 w1) + v2 w2)
    + v3 w3, the level sum acc + s * a and the level added, each through
    ``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn`` (which nvcc never
    contracts into a fused multiply-add) with no bare float ``*``, ``+`` or
    ``-``; x = loc * W - 0.5 rounded twice, the fractions, and the corner
    weights (1 - fx)(1 - fy), fx(1 - fy), (1 - fx)fy, fx fy in that
    order."""
    src = _source()
    helpers = {
        "float bilinear(float v0": "return__fadd_rn(__fadd_rn(__fadd_rn("
        "__fmul_rn(v0,w0),__fmul_rn(v1,w1)),__fmul_rn(v2,w2)),"
        "__fmul_rn(v3,w3));",
        "float axpy(float acc": "return__fadd_rn(acc,__fmul_rn(s,a));",
        "float add(float a": "return__fadd_rn(a,b);",
    }
    for signature, body in helpers.items():
        assert _device_function(src, signature) == body, signature
    for signature in ("float4 bilinear(float4", "float4 axpy(float4",
                      "float4 add(float4"):
        lanes = re.sub(r"__f(mul|add)_rn\(", "", _device_function(
            src, signature))
        assert not re.search(r"[-+*]", lanes), signature
    kernel = re.sub(r"\s+", "", src[src.index("ms_deform_attn_kernel("):
                                    src.index("template <int kL, int kP, "
                                              "int kVec>\nint launch")])
    for line in (
            "constfloatx=__fsub_rn(__fmul_rn(__ldg(loc_r+2*i),wl),0.5f);",
            "constfloaty=__fsub_rn(__fmul_rn(__ldg(loc_r+2*i+1),hl),0.5f);",
            "fx=__fsub_rn(x,x0f);", "fy=__fsub_rn(y,y0f);",
            "constfloatux=__fsub_rn(1.f,gx[g]),uy=__fsub_rn(1.f,gy[g]);",
            "constVs=bilinear(v[g][0],v[g][1],v[g][2],v[g][3],"
            "__fmul_rn(ux,uy),__fmul_rn(gx[g],uy),__fmul_rn(ux,gy[g]),"
            "__fmul_rn(gx[g],gy[g]));",
            "lvl=axpy(lvl,s,ga[g]);", "acc=add(acc,lvl);"):
        assert line in kernel, line


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["uniform", "encoder"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_plain_version(name, pattern):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K13 is a CUDA kernel with no CPU "
                    "mode")
    B, shapes, Q, H, D, P = SHAPES[name]
    value, loc, w = _inputs(B, shapes, Q, H, D, P)
    if pattern == "encoder":
        Q = sum(h * w_ for h, w_ in shapes)
        value, _, w = _inputs(B, shapes, Q, H, D, P)
        loc = encoder_sampling_locations(shapes, B, H, P)
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
