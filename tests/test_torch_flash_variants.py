"""The port's experiment flash forwards (K8-K12) and its two experiment
scripts against the JAX scripts that hold the TPU kernels.

The same numpy inputs go through ``scripts/bench_flash_variants.py`` and
``scripts/bench_attn_d64.py`` (their Pallas kernels in interpret mode, on
the CPU) and through ``frameino_tpu_torch.ops.flash_variants`` (on the CPU
its plain versions, which the CUDA kernels are held to on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX scripts are plain modules of scripts/
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench_attn_d64 as jd64  # noqa: E402
import bench_flash_variants as jfv  # noqa: E402

from frameino_tpu_torch.ops import attention as tattn  # noqa: E402
from frameino_tpu_torch.ops import flash_variants as FV  # noqa: E402
from frameino_tpu_torch.scripts import bench_attn_d64 as td64  # noqa: E402
from frameino_tpu_torch.scripts import (  # noqa: E402
    bench_flash_variants as tfv)

BLOCK = 128   # the JAX side's block_q = block_k

JAX_VARIANTS = {
    "v1": jfv.flash_v1,
    "v2": jfv.flash_v2,
    "v12": functools.partial(jfv.flash_v2, ones_col=True),
    "v3": jfv.flash_v3,
    "v123": functools.partial(jfv.flash_v3, static_ones=True)}
PORT_VARIANTS = {
    "v1": FV.flash_v1,
    "v2": FV.flash_v2,
    "v12": functools.partial(FV.flash_v2, ones_col=True),
    "v3": FV.flash_v3,
    "v123": functools.partial(FV.flash_v3, static_ones=True)}


def _pair(a, dtype="bf16"):
    """numpy array -> (jax array, torch tensor) of the same values."""
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "fp32": (jnp.float32, torch.float32)}[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.abs(x))) - 7)


def _qkv(seed, b, h, s, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))


def _assert_close_bf16(got, ref):
    """Both sides return bf16 and differ in the order of their fp32 sums
    and in the shift p is rounded to bf16 against (a running maximum over
    128-key blocks on the JAX side, the row maximum or the bound here):
    at most 2 bf16 ulp of max|ref| at any element, 3e-3 in relative L2."""
    g, r = _np(got), _np(ref)
    assert np.abs(g - r).max() <= 2 * _bf16_ulp(np.abs(r).max())
    assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 3e-3


@pytest.fixture
def interpret(monkeypatch):
    """The JAX scripts' Pallas kernels in interpret mode:
    ``bench_flash_variants`` has a module switch, ``bench_attn_d64`` none."""
    monkeypatch.setattr(jfv, "INTERPRET", True)
    monkeypatch.setattr(jd64.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("s", [256, 300])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", list(JAX_VARIANTS))
def test_variant_matches_jax_script(interpret, name, d, s):
    """K9-K12's plain versions == the scripts' Pallas kernels, on a
    sequence that is a multiple of the JAX block and one that is padded."""
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a) for a in _qkv(11, 1, 2, s, d))
    scale = d ** -0.5
    ref = JAX_VARIANTS[name](qj, kj, vj, scale=scale, block_q=BLOCK,
                             block_k=BLOCK)
    got = PORT_VARIANTS[name](qt, kt, vt, scale=scale, block_q=BLOCK,
                              block_k=BLOCK)
    assert got.shape == (1, 2, s, d) and got.dtype == torch.bfloat16
    _assert_close_bf16(got, ref)


@pytest.mark.parametrize("s", [256, 300])
@pytest.mark.parametrize("heads", [2, 4])
def test_packed_flash_matches_jax_script(interpret, heads, s):
    """K8's plain version == the script's block-diagonal Pallas kernel."""
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a)
                                    for a in _qkv(12, 1, heads, s, 64))
    ref = jd64.packed_flash(qj, kj, vj, block_q=BLOCK, block_k=BLOCK)
    got = FV.packed_flash(qt, kt, vt, block_q=BLOCK, block_k=BLOCK)
    assert got.shape == (1, heads, s, 64) and got.dtype == torch.bfloat16
    _assert_close_bf16(got, ref)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_quant_rows_bit_equal(dtype):
    """Codes and scales equal the script's un-jitted ``_quant_rows`` bit for
    bit: true division by 127, half to even, the 1e-6 floor (a zero row
    and a row whose maximum is under it), the clip."""
    rs = np.random.RandomState(13)
    x = (rs.randn(3, 40, 64) * np.exp(rs.randn(3, 40, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] = 3e-7 * rs.randn(64)
    x[1, 2, :4] = [2.5, -2.5, 0.5, 127.0]      # half-way points at scale 1
    x[1, 2, 4:] = 0.0
    xj, xt = _pair(x, dtype)
    codes_j, scales_j = jfv._quant_rows(xj)
    codes_t, scales_t = FV._quant_rows(xt)
    assert codes_t.dtype == torch.int8 and scales_t.dtype == torch.float32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j))
    floor = np.float32(1e-6) / np.float32(127.0)
    assert not codes_t[0, 0].any() and codes_t[0, 1].any()
    assert scales_t[0, 0].item() == floor and scales_t[0, 1].item() == floor
    assert codes_t[1, 2, :4].tolist() == [2, -2, 0, 127]


@pytest.mark.parametrize("d", [64, 128])
def test_bounds_match_jax_script(d):
    """``_bound`` and the bound K11 takes from the codes, to fp32 rounding
    (two ulps: the norms' sums run in another order)."""
    (qj, qt), (kj, kt), _ = (_pair(a) for a in _qkv(14, 2, 3, 70, d))
    scale = d ** -0.5
    got = FV._bound(qt, kt, scale)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfv._bound(qj, kj, scale)),
                               rtol=2.5e-7)
    # scripts/bench_flash_variants.py, flash_v3: the static branch
    qi, qs = jfv._quant_rows(qj)
    ki, ks = jfv._quant_rows(kj)
    qs = qs * (scale * jfv._LOG2E)
    qn = jnp.sqrt(jnp.sum(jnp.square(qi.astype(jnp.float32)), -1,
                          keepdims=True))
    kn = jnp.sqrt(jnp.sum(jnp.square(ki.astype(jnp.float32)), -1,
                          keepdims=True))
    want = jnp.max(qn * qs) * jnp.max(kn * ks)
    codes = FV.quantize_qk(qt, kt, scale)
    np.testing.assert_array_equal(codes[1].numpy(), np.asarray(qs))
    np.testing.assert_allclose(FV.int8_bound(*codes).numpy(),
                               np.asarray(want), rtol=2.5e-7)


def test_pack_unpack_exact():
    """``pack`` lays head pairs side by side as the script's does, and
    ``unpack`` is its inverse."""
    x = np.random.RandomState(15).randn(2, 6, 5, 64).astype(np.float32)
    want = x.reshape(2, 3, 2, 5, 64).transpose(0, 1, 3, 2, 4).reshape(
        6, 5, 128)
    xt = torch.from_numpy(x)
    packed = FV.pack(xt)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(packed[1, :, 64:].numpy(), x[0, 3])
    assert torch.equal(FV.unpack(packed, 2), xt)


def test_ones_column_sums_the_rounded_p(interpret):
    """With the ones column, l sums the bf16-ROUNDED probabilities. Key 0
    carries the row maximum and every other key the same p = 2**-3 * (1 +
    0.3 * 2**-7), which bf16 rounds down by 0.23%: 255 equal biases that
    do not average out. ``flash_v1`` must follow the JAX ``flash_v1``, and
    both must stand apart from K3's plain version, which sums fp32 p."""
    S, D = 256, 64
    scale = D ** -0.5
    gain = np.float32(scale * FV.LOG2E)
    delta = 3.0 - np.log2(1.0 + 0.3 * 2.0 ** -7)
    q = np.zeros((1, 1, S, D), np.float32)
    q[..., 0] = 1.0
    k = np.zeros((1, 1, S, D), np.float32)
    k[0, 0, 1:, 0] = -delta / gain
    v = np.random.RandomState(16).randn(1, 1, S, D).astype(np.float32)
    # fp32 q and k (exact logits), bf16 v: p is rounded to v's dtype, and
    # the fp32 output shows the 0.2% that a bf16 one would hide
    (qj, qt), (kj, kt) = _pair(q, "fp32"), _pair(k, "fp32")
    vj, vt = _pair(v, "bf16")
    ref = _np(jfv.flash_v1(qj, kj, vj, scale=scale, block_q=BLOCK,
                           block_k=BLOCK))
    got = _np(FV.flash_v1(qt, kt, vt, scale=scale))
    lane_sum = _np(tattn.flash_fwd_ref(qt[0], kt[0], vt[0],
                                       scale * FV.LOG2E))[None]
    top = np.abs(ref).max()
    # fp32 sums in another order
    assert np.abs(got - ref).max() <= 1e-5 * top
    assert np.abs(lane_sum - ref).max() >= 1e-3 * top
    # the static ones-column body rounds the same p the same way
    got12 = _np(FV.flash_v2(qt, kt, vt, scale=scale, ones_col=True))
    ref12 = _np(jfv.flash_v2(qj, kj, vj, scale=scale, block_q=BLOCK,
                             block_k=BLOCK, ones_col=True))
    assert np.abs(got12 - ref12).max() <= 1e-5 * top


# ---------------------------------------------------------------------------
# the ported scripts
# ---------------------------------------------------------------------------

TINY_SHAPES = {"cog": dict(B=1, H=2, D=64, S=200),
               "wan": dict(B=1, H=2, D=128, S=130)}


@pytest.mark.parametrize("check_only", [False, True])
def test_ported_flash_variants_script_on_cpu(capsys, check_only):
    """``--device cpu`` runs the plain versions at the size given: one
    check line per variant and shape, one timing line each unless
    ``--check_only``, and the rows come back."""
    argv = ["--device", "cpu", "--check_s", "96", "--iters", "1"]
    rows = tfv.main(argv + (["--check_only"] if check_only else []),
                    shapes=TINY_SHAPES)
    out = capsys.readouterr().out
    assert out.count("===") == 2 and out.count("max|diff|") == 10
    assert out.count("TFLOP/s") == (0 if check_only else 12)
    checks = [r for r in rows if "max_abs" in r]
    times = [r for r in rows if "ms" in r]
    assert len(checks) == 10 and len(times) == (0 if check_only else 12)
    assert [r["variant"] for r in checks[:5]] == ["v1", "v2", "v12", "v3",
                                                 "v123"]
    for r in checks:
        # the limits chip_smoke.py holds the card's run to
        assert r["max_abs"] <= (5e-2 if "3" in r["variant"] else 2e-2)
    if not check_only:
        assert "[cpu, host clock]" in out
        # each kernel's own tile: 192 q rows at head_dim 64, 128 at 128
        assert out.count(" (tile 192x128): ") == 6
        assert out.count(" (tile 128x128): ") == 6
        assert [r["variant"] for r in times[:6]] == ["v0", "v1", "v2", "v12",
                                                    "v3", "v123"]


def test_ported_attn_d64_script_on_cpu(capsys, monkeypatch):
    monkeypatch.setitem(td64.INT8RATE, "M", 32)
    monkeypatch.setitem(td64.INT8RATE, "N", 64)
    monkeypatch.setitem(td64.INT8RATE, "iters", 2)
    rows = td64.main(["--device", "cpu"], shape=(1, 4, 150))
    out = capsys.readouterr().out
    assert [line for line in out.splitlines() if line.startswith("===")] \
        == ["=== sweep ===", "=== packed ===", "=== int8rate ==="]
    assert out.count("bq=") == 2 and "direct D=64 (192,128):" in out
    assert "packed bq= 128 bk=  128" in out
    assert out.count("dot bf16 K=") == 2 and out.count("dot int8 K=") == 2
    assert [r["exp"] for r in rows] == ["sweep"] + ["packed"] * 3 \
        + ["int8rate"] * 4
    assert rows[1]["check_max_abs"] < 5e-2
    only = td64.main(["--device", "cpu", "--exp", "packed"],
                     shape=(1, 2, 70))
    assert [r["exp"] for r in only] == ["packed"] * 3


@pytest.mark.parametrize("script", [tfv, td64], ids=["flash_variants",
                                                     "attn_d64"])
def test_ported_scripts_need_a_card(script):
    """Without ``--device cpu`` the scripts run on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default run is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main([])
    with pytest.raises(ValueError):
        script.main(["--device", "tpu"])


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a CUDA source includes with quotes changes
    the name of its built library, so a stale one is never loaded."""
    from frameino_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "_CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("constexpr int kTile = 64;\n")
    before = cuda_build._so_path("a"), cuda_build._so_path("b")
    (tmp_path / "g.cuh").write_text("constexpr int kTile = 128;\n")
    assert cuda_build._so_path("a") != before[0]
    assert cuda_build._so_path("b") == before[1]
    # the sources of the experiment kernels K8-K12 do share a header, the
    # Hopper helpers; none includes the mma.sync helpers of
    # flash_common.cuh any more, which are gone
    monkeypatch.undo()
    shared = (cuda_build._CSRC / "sm90_common.cuh").read_bytes()
    for name in ("flash_packed", "flash_variants", "flash_int8"):
        assert shared in cuda_build._source_bytes(
            cuda_build._CSRC / f"{name}.cu", set())
    assert not (cuda_build._CSRC / "flash_common.cuh").exists()
    for src in cuda_build._CSRC.glob("*.cu*"):
        assert b'"flash_common.cuh"' not in src.read_bytes(), src.name


def test_experiment_modules_never_import_jax():
    """The kernels' module and both ported scripts, run on the CPU in a
    fresh interpreter, leave jax and the JAX package unimported."""
    code = textwrap.dedent("""
        import sys
        from frameino_tpu_torch.ops import flash_variants  # noqa: F401
        from frameino_tpu_torch.scripts import (bench_attn_d64,
                                                bench_flash_variants)
        bench_flash_variants.main(
            ["--device", "cpu", "--check_s", "64", "--iters", "1"],
            shapes={"cog": dict(B=1, H=2, D=64, S=70),
                    "wan": dict(B=1, H=1, D=128, S=66)})
        bench_attn_d64.INT8RATE.update(M=32, N=64, iters=1)
        bench_attn_d64.main(["--device", "cpu"], shape=(1, 2, 70))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "frameino_tpu"
                     or m.startswith("frameino_tpu."))
        assert not bad, bad
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
