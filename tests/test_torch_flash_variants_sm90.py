"""K9 and K10, the bf16 experiment flash forwards of
``csrc/flash_variants.cu``, on the CPU: their shared-memory layout, the
byte map between what TMA writes and what the wgmma descriptors read, the
ragged mask on the last key tile, the C interface, the build of the source
and the tuning script's host side.

The kernel runs only on a card (``tests/test_torch_cuda.py``, which also
holds ``flash_variants_config`` to ``variants_smem_layout``); its plain
versions are held to the JAX script's kernels in
``tests/test_torch_flash_variants.py``. Here the kernel's address and index
arithmetic is replayed in numpy:

- TMA writes bf16 element (r, c) of a column block (64 columns, rows of
  128 bytes) at the shared address ``sw(base + 128 r + 2 c + b)`` for its
  bytes b = 0, 1, where ``sw`` XORs the 16-byte chunk bits [4, 7) of an
  address with its bits [7, 10) (the 128-byte swizzle); a tile of D columns
  is D / 64 such blocks one after the other;
- a K-major wgmma descriptor (start address, 8-row groups 1024 bytes
  apart) reads byte b of row r of its 16-column k slice at ``sw(start + (r
  // 8) 1024 + (r % 8) 128 + b)``; the kernel starts the k-th slice at
  ``base + (k // 4) block + 32 (k % 4)``;
- the wgmma accumulator gives thread (warp, lane) the columns ``8 j + 2 (lane
  % 4) + (e & 1)`` of rows ``16 warp + lane / 4 (+ 8 for e >= 2)``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.ops import flash_variants as FV

SMEM_LIMIT = 232448     # dynamic shared memory a block can have (H100)
KEYS = 128              # keys a K/V tile


def _sw(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma(base, block, r, col, byte):
    """Where TMA wrote byte ``byte`` of bf16 element (r, col) of a tile
    whose column blocks are ``block`` bytes apart."""
    return _sw(base + (col // 64) * block + r * 128 + 2 * (col % 64) + byte)


def _desc(start, r, b):
    return _sw(start + (r // 8) * 1024 + (r % 8) * 128 + b)


def _operands(lay):
    """(name, tile base, column block bytes, first row, rows) of every
    K-major operand an S product reads: each consumer's 64 rows of both Q
    buffers, and the 128 keys of each K stage."""
    out = []
    for buf in range(2):
        for w in range(lay["consumer_wgs"]):
            out.append((f"q{buf}.{w}", lay["q"] + buf * lay["q_tile"],
                        lay["q_block"], 64 * w, 64))
    for s in range(lay["stages"]):
        out.append((f"k{s}", lay["k"] + s * lay["kv_tile"], lay["kv_block"],
                    0, KEYS))
    return out


@pytest.mark.parametrize("head_dim", [64, 128])
def test_layout_fits_and_keeps_tiles_on_their_swizzle_phase(head_dim):
    """Every tile and column block starts on a 1024-byte boundary (the
    128-byte swizzle repeats every 8 rows), each consumer's Q rows start a
    row group, the regions follow each other without overlap, and the
    block fits the card's shared memory."""
    lay = FV.variants_smem_layout(head_dim)
    assert lay["keys"] == KEYS and lay["swizzle"] == 128
    assert lay["q_rows"] == 64 * lay["consumer_wgs"]
    assert lay["column_blocks"] == head_dim // 64
    assert lay["q_tile"] == lay["column_blocks"] * lay["q_block"]
    assert lay["kv_tile"] == lay["column_blocks"] * lay["kv_block"]
    assert lay["q_block"] == lay["q_rows"] * 128
    assert lay["kv_block"] == KEYS * 128
    order = ["q", "k", "v", "ones", "bars"]
    sizes = dict(q=2 * lay["q_tile"], k=lay["stages"] * lay["kv_tile"],
                 v=lay["stages"] * lay["kv_tile"], ones=512)
    for a, b in zip(order, order[1:]):
        assert lay[a] + sizes[a] == lay[b], (a, b)
    for size in ("q_block", "kv_block", "q_tile", "kv_tile"):
        assert lay[size] % 1024 == 0, size
    for name in ("q", "k", "v", "ones"):
        assert lay[name] % 1024 == 0, name
    assert lay["bars"] % 8 == 0
    for _, base, _, r0, _ in _operands(lay):
        assert (base + r0 * 128) % 1024 == 0
    # q_full, q_empty, q_ready (2 each) and four barriers a stage, then the
    # slack that aligns the dynamic base to 1024
    assert lay["smem_bytes"] == lay["bars"] + (6 + 4 * lay["stages"]) * 8 \
        + 1024
    assert lay["smem_bytes"] <= SMEM_LIMIT


def test_a_third_stage_does_not_fit_at_head_dim_128():
    """Two K/V stages are all that fit beside the Q buffers at D =
    128."""
    lay = FV.variants_smem_layout(128)
    assert lay["stages"] == 2
    assert lay["smem_bytes"] + 2 * lay["kv_tile"] > SMEM_LIMIT


@pytest.mark.parametrize("head_dim", [64, 128])
def test_descriptor_reads_the_byte_tma_wrote(head_dim):
    """For every Q and K operand tile, every (row, k slice, byte) a
    descriptor addresses is where TMA wrote byte b % 2 of that row's
    column 16 k + b // 2, and each byte of the operand's rows is read
    once."""
    lay = FV.variants_smem_layout(head_dim)
    kk = np.arange(head_dim // 16)[None, :, None]
    b = np.arange(32)[None, None, :]
    for name, base, block, r0, rows in _operands(lay):
        r = np.arange(rows)[:, None, None]
        start = base + (kk // 4) * block + r0 * 128 + 32 * (kk % 4)
        got = _desc(start, r, b)
        want = _tma(base, block, r0 + r, 16 * kk + b // 2, b % 2)
        assert np.array_equal(got, want), name
        # each byte of the operand's rows once, and nothing else
        mine = np.concatenate([
            np.arange(base + cb * block + r0 * 128,
                      base + cb * block + (r0 + rows) * 128)
            for cb in range(head_dim // 64)])
        assert np.array_equal(np.sort(got.ravel()), mine)


def test_the_byte_map_is_not_vacuous():
    """A slice started 16 bytes off, or an SBO of one row (no swizzle
    phase per row group), reads other bytes than TMA wrote."""
    r = np.arange(64)[:, None, None]
    kk = np.arange(4)[None, :, None]
    b = np.arange(32)[None, None, :]
    want = _tma(0, 8192, r, 16 * kk + b // 2, b % 2)
    assert np.array_equal(_desc(32 * kk, r, b), want)
    assert not np.array_equal(_desc(32 * kk + 16, r, b), want)
    wrong_sbo = _sw(32 * kk + (r // 8) * 128 + (r % 8) * 128 + b)
    assert not np.array_equal(wrong_sbo, want)


def _masked_keys(s, every_tile=False, fault=None):
    """The kernel's mask replayed: per key tile n0, on the last tile only
    (``n0 + 128 > s``), each thread (t = lane % 4) sets s = -1e30 for its
    columns 8 j + 2 t + (e & 1) that are >= s. Returns the masked keys
    of the tiles [0, n_kv * 128) for each of a row group's 8 rows x 2 (lo,
    hi) and checks that every row sees each column of a tile once."""
    n_kv = -(-s // KEYS)
    j, t, e = np.meshgrid(np.arange(16), np.arange(4), np.arange(4),
                          indexing="ij")
    cols = (8 * j + 2 * t + (e & 1)).ravel()
    half = (e >> 1).ravel()
    for h in (0, 1):
        assert sorted(cols[half == h]) == list(range(KEYS))
    masked = set()
    for n0 in range(0, n_kv * KEYS, KEYS):
        if not every_tile and n0 + KEYS <= s:
            continue
        keys = n0 + cols
        hit = keys >= s if fault is None else fault(keys, s)
        masked.update(int(x) for x in keys[hit])
    return masked, n_kv


@pytest.mark.parametrize("s", [5590, 15906, 777, 300, 129])
def test_last_tile_mask_masks_exactly_the_keys_past_the_end(s):
    """At the experiment sequences (5,590 and 15,906), the ragged 777 and
    the card tests' 300 and 129: the mask on the last key tile alone
    masks exactly the keys at or past S (the zero-filled rows TMA loads),
    the same set as a mask on every tile."""
    masked, n_kv = _masked_keys(s)
    assert masked == set(range(s, n_kv * KEYS))
    assert len(masked) == (-s) % KEYS
    assert masked == _masked_keys(s, every_tile=True)[0]


def test_last_tile_mask_replay_rejects_an_off_by_one():
    """The replay is not vacuous: ``key > s`` leaks key s."""
    masked, n_kv = _masked_keys(777, fault=lambda keys, s: keys > s)
    assert 777 not in masked and masked != set(range(777, n_kv * KEYS))


def test_variants_config_is_registered_and_typed():
    """``flash_variants_config`` is a C function of the source, registered
    beside ``flash_variant_bf16`` with two int arguments
    (``tests/test_torch_cuda_build.py::test_argtypes_match_the_c_interface``
    holds the argtypes to the declarations)."""
    fns = cuda_build._CUDA_SOURCES["flash_variants"]
    assert set(fns) == {"flash_variant_bf16", "flash_variants_config"}
    assert fns["flash_variants_config"] == [cuda_build.ctypes.c_int] * 2
    text = (cuda_build._CSRC / "flash_variants.cu").read_text()
    assert 'extern "C" int flash_variants_config(int head_dim, int what)' \
        in text


def test_bf16_flash_runs_its_plain_version_on_the_cpu():
    """``bf16_flash`` on CPU tensors is the plain version on the bound it
    is given (each body); the wrappers' CPU route is unchanged."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 150, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    bound = FV._bound(q, k, 0.125).reshape(1)
    assert torch.equal(FV.bf16_flash(q, k, v, None, 1, scale=0.125),
                       FV.flash_v1_ref(q, k, v, scale=0.125))
    assert torch.equal(FV.bf16_flash(q, k, v, bound, 2, scale=0.125),
                       FV.flash_v2_ref(q, k, v, scale=0.125))
    assert torch.equal(FV.bf16_flash(q, k, v, bound, 12, scale=0.125),
                       FV.flash_v12_ref(q, k, v, scale=0.125))
    for fn in (FV.flash_v1, FV.flash_v2, FV.flash_v12):
        before = fn.launches
        assert torch.equal(fn(q, k, v, scale=0.125),
                           getattr(FV, fn.__name__ + "_ref")(q, k, v,
                                                             scale=0.125))
        assert fn.launches == before
    with pytest.raises(ValueError, match="body"):
        FV.bf16_flash(q, k, v, None, 3, scale=0.125)
    with pytest.raises(ValueError, match="bound"):
        FV.bf16_flash(q, k, v, None, 12, scale=0.125)
    with pytest.raises(ValueError, match="bound"):
        FV.bf16_flash(q, k, v, bound, 1, scale=0.125)


FAKE_NVCC = """\
import os, sys
with open(os.path.join(os.path.dirname(sys.argv[0]), "calls"), "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
print("ptxas info    : Used 168 registers")
open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"")
"""


def test_variants_source_builds_for_sm90a_on_the_hopper_helpers(
        tmp_path, monkeypatch):
    """csrc/flash_variants.cu is one nvcc of its own for sm_90a with
    ptxas's report, its library's name covers csrc/sm90_common.cuh, no
    source includes the mma.sync helpers of csrc/flash_common.cuh (which
    are gone), and it is typed with both C functions."""
    tools = tmp_path / "tools"
    tools.mkdir()
    nvcc = tools / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "_load",
                        lambda so, source, partial=False: (so, source))
    got = cuda_build.build_cuda_libs(["flash_variants"])
    (call,) = (tools / "calls").read_text().splitlines()
    args = call.split()
    assert Path(args[-1]).name == "flash_variants.cu"
    assert "arch=compute_90a,code=sm_90a" in args and "-Xptxas=-v" in args
    assert "Used 168 registers" in cuda_build.BUILD_LOG["flash_variants"]
    assert got["flash_variants"][1] == "flash_variants"
    src = cuda_build._source_bytes(cuda_build._CSRC / "flash_variants.cu",
                                   set())
    assert (cuda_build._CSRC / "sm90_common.cuh").read_bytes() in src
    assert b'"flash_common.cuh"' not in src
    assert not (cuda_build._CSRC / "flash_common.cuh").exists()
    for name in cuda_build._CUDA_SOURCES:
        assert b'"flash_common.cuh"' not in cuda_build._source_bytes(
            cuda_build._CSRC / f"{name}.cu", set()), name


@pytest.mark.cuda
def test_variants_source_compiles_with_nvcc_for_sm90a(tmp_path):
    """The real nvcc compiles csrc/flash_variants.cu for sm_90a without a
    spill or a serialised wgmma in any kernel (skips where there is no
    nvcc: the CUDA toolkit is on the card's machine)."""
    nvcc = cuda_build._nvcc()
    if not (shutil.which(nvcc) or os.path.exists(nvcc)):
        pytest.skip("needs nvcc: the CUDA toolkit is not installed here")
    out = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
         f"-I{cuda_build._CSRC}", "-o", str(tmp_path / "lib.so"),
         str(cuda_build._CSRC / "flash_variants.cu")],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    log = out.stdout + out.stderr
    assert log.count("Compiling entry") == 6     # 3 bodies x 2 head dims
    assert "serialized" not in log
    assert " 0 bytes spill stores" in log and not any(
        "spill stores" in line and " 0 bytes spill stores" not in line
        for line in log.splitlines())


def test_tuning_script_builds_the_port_beside_each_version(monkeypatch,
                                                           capsys):
    """``scripts/tune_flash_variants.py`` hands the port's source and every
    ``--alt`` / ``--probe`` file to ``build_cuda_libs`` in one call, as
    versions of ``flash_variants``, prints each kernel's registers and
    spills, and runs the three bodies through their C entry, each on the
    library it is given (on the CPU: the plain versions)."""
    from frameino_tpu_torch.scripts import tune_flash_int8 as TI
    from frameino_tpu_torch.scripts import tune_flash_variants as T
    seen = {}

    def fake_build(names, alts):
        seen.update(names=names, alts=alts)
        return {"flash_variants": "lib", **{n: f"lib_{n}" for n in alts}}
    monkeypatch.setattr(cuda_build, "build_cuda_libs", fake_build)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {
        "flash_variants": "ptxas info    : Compiling entry function '_ZN12"
                          "_GLOBAL__N_120flash_variant_kernelILi64ELb0ELb1E"
                          "Li3ELi4EEEvv'\n    0 bytes stack frame, 4 bytes "
                          "spill stores, 6 bytes spill loads\nptxas info   "
                          " : Used 128 registers"})
    libs = TI.build({"parent": "/old/flash_variants.cu"}, T.SOURCE)
    assert libs == {TI.PORT: "lib", "parent": "lib_parent"}
    assert seen == dict(names=["flash_variants"], alts={
        "parent": ("flash_variants", "/old/flash_variants.cu")})
    out = capsys.readouterr().out
    assert "flash_variant_kernel<64, 0, 1, 3, 4>" in out
    assert "4 bytes spill stores" in out and "Used 128 registers" in out
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 140, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    bodies = T.bf16_bodies(q, k, v, 0.125)
    assert list(bodies) == list(FV.BF16_BODIES)
    for name, launch in bodies.items():
        assert torch.equal(launch(None), getattr(FV, name + "_ref")(
            q, k, v, scale=0.125))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(ValueError, match="port"):
        T.main(["--alt", f"{TI.PORT}=x.cu"])
