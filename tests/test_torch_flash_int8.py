"""K11 and K12, the int8-QK^T flash forwards of ``csrc/flash_int8.cu``, on
the CPU: their shared-memory layout, the byte map between what TMA writes
and what the wgmma descriptors read, the ring of key scales that the
producer's warp 1 fills, and the build of the source.

The kernel runs only on a card (``tests/test_torch_cuda.py``, which also
holds ``flash_int8_config`` to ``int8_smem_layout``); its plain version
``int8_flash_ref`` is held to the JAX script's kernels in
``tests/test_torch_flash_variants.py``. Here the kernel's address
arithmetic is replayed in numpy:

- TMA writes element (r, c) of a box of rows of W bytes (W = 128: the
  128-byte swizzle; W = 64: the 64-byte one) at the shared address
  ``sw(base + r W + c)``, where ``sw`` XORs the 16-byte chunk bits [4, 4 +
  log2(W / 16)) of an address with its bits [7, 7 + log2(W / 16));
- a K-major wgmma descriptor (start address, 8-row groups SBO bytes apart)
  reads byte b of row r of its 32-byte k slice at ``sw(start + (r // 8) SBO
  + (r % 8) W + b)``; the kernel starts the k-th slice at ``base + 32 k``
  with SBO = 8 W.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.ops import flash_variants as FV

SMEM_LIMIT = 232448     # dynamic shared memory a block can have (H100)
SMS = 132


def _sw(addr, row_bytes):
    mask = row_bytes // 16 - 1
    return addr ^ (((addr >> 7) & mask) << 4)


def _tma(base, r, c, row_bytes):
    return _sw(base + r * row_bytes + c, row_bytes)


def _desc(start, sbo, row_bytes, r, b):
    return _sw(start + (r // 8) * sbo + (r % 8) * row_bytes + b, row_bytes)


def _operand_bases(lay, head_dim):
    """(name, tile base, first row, rows) of every K-major int8 operand a
    wgmma reads: each consumer's 64 rows of both Q buffers, and the 128
    keys of each K stage."""
    out = []
    for buf in range(2):
        for w in range(lay["consumer_wgs"]):
            out.append((f"q{buf}.{w}", lay["q"] + buf * lay["q_tile"],
                        64 * w, 64))
    for s in range(lay["stages"]):
        out.append((f"k{s}", lay["k"] + s * lay["k_tile"], 0, lay["keys"]))
    return out


@pytest.mark.parametrize("head_dim", [64, 128])
def test_layout_fits_and_keeps_tiles_on_their_swizzle_phase(head_dim):
    """Every tile starts on a 1024-byte boundary (the swizzle repeats every
    8 rows of W bytes, 1024 or 512), the regions do not overlap, and the
    block fits the card's shared memory."""
    lay = FV.int8_smem_layout(head_dim)
    assert lay["swizzle"] == head_dim and lay["keys"] == 128
    assert lay["q_rows"] == 64 * lay["consumer_wgs"]
    order = ["q", "k", "v", "ks", "ones", "bars"]
    sizes = dict(q=2 * lay["q_tile"], k=lay["stages"] * lay["k_tile"],
                 v=lay["stages"] * lay["v_tile"],
                 ks=lay["ks_slots"] * lay["keys"] * 4, ones=512)
    for a, b in zip(order, order[1:]):
        assert lay[a] + sizes[a] == lay[b], (a, b)
    for name in ("q", "k", "v", "ks"):
        assert lay[name] % 1024 == 0, name
    for tile in ("q_tile", "k_tile", "v_tile"):
        assert lay[tile] % 1024 == 0, tile
    assert lay["smem_bytes"] <= SMEM_LIMIT
    for _, base, r0, _ in _operand_bases(lay, head_dim):
        assert (base + r0 * head_dim) % (8 * head_dim) == 0


@pytest.mark.parametrize("head_dim", [64, 128])
def test_descriptor_reads_the_byte_tma_wrote(head_dim):
    """For every operand tile, every (row, k slice, byte) a descriptor
    addresses is where TMA wrote that row's byte 32 k + b, and the bytes of
    a tile's rows are each read once."""
    lay = FV.int8_smem_layout(head_dim)
    w = lay["swizzle"]
    for name, base, r0, rows in _operand_bases(lay, head_dim):
        r = np.arange(rows)[:, None, None]
        kk = np.arange(head_dim // 32)[None, :, None]
        b = np.arange(32)[None, None, :]
        start = base + r0 * w + 32 * kk
        got = _desc(start, 8 * w, w, r, b)
        want = _tma(base, r0 + r, 32 * kk + b, w)
        assert np.array_equal(got, want), name
        assert len(np.unique(got)) == rows * head_dim
        assert got.min() >= base + r0 * w
        assert got.max() < base + (r0 + rows) * w


def test_a_64_byte_row_needs_the_64_byte_swizzle():
    """The map is not vacuous: the 128-byte swizzle's descriptor on rows
    of 64 bytes, or an SBO of one row group too many, reads other bytes
    than TMA wrote."""
    r = np.arange(64)[:, None, None]
    kk = np.arange(2)[None, :, None]
    b = np.arange(32)[None, None, :]
    want = _tma(0, r, 32 * kk + b, 64)
    wrong_swizzle = _sw(32 * kk + (r // 8) * 512 + (r % 8) * 64 + b, 128)
    assert not np.array_equal(wrong_swizzle, want)
    assert not np.array_equal(_desc(32 * kk, 1024, 64, r, b), want)


def _schedule(bh, s, head_dim, sms=SMS):
    """Per persistent block, the (batch*head, key tile) of each step of its
    walk, in the order of the kernel's loops: tiles blockIdx.x, +grid, ...,
    each over all key tiles."""
    lay = FV.int8_smem_layout(head_dim)
    n_q = -(-s // lay["q_rows"])
    n_kv = -(-s // lay["keys"])
    tiles = bh * n_q
    grid = min(tiles, sms)
    return [[(tile // n_q, n) for tile in range(blk, tiles, grid)
             for n in range(n_kv)] for blk in range(grid)], n_kv


def _replay_scales(ks, s, head_dim, consumer_slot=None, sms=SMS):
    """The ring of key scales of every block, replayed: warp 1 fills slot
    it % slots (lane i storing keys n0 + i + 32 j, 0 past S) as soon as the
    slot's ks_empty barrier has completed for its previous fill, and never
    more than ``slots`` steps ahead; a consumer thread (t = lane % 4)
    waits for the slot's ks_full parity and reads index 8 j + 2 t + e as
    key n0 + 8 j + 2 t + e. ``consumer_slot(it, n, slots)`` overrides the
    consumer's slot (a planted fault). Returns the (block, step) count."""
    lay = FV.int8_smem_layout(head_dim)
    slots, keys = lay["ks_slots"], lay["keys"]
    bh = ks.shape[0]
    walks, n_kv = _schedule(bh, s, head_dim, sms)
    idx = np.arange(keys)
    lane, j = idx % 32, idx // 32
    jj, t, e = np.meshgrid(np.arange(16), np.arange(4), np.arange(2),
                           indexing="ij")
    read_idx = (8 * jj + 2 * t + e).ravel()
    steps = 0
    for walk in walks:
        ring = np.full((slots, keys), np.nan, np.float32)
        full_done = np.zeros(slots, int)    # completions of ks_full[slot]
        empty_done = np.zeros(slots, int)   # ... and of ks_empty[slot]
        filled = 0
        for it, (b, n) in enumerate(walk):
            while filled < len(walk) and filled < it + slots:
                slot = filled % slots
                if filled >= slots:
                    # warp 1 waits for parity ((filled / slots) - 1) & 1:
                    # the (filled / slots)-th completion of ks_empty
                    assert empty_done[slot] == filled // slots
                    assert ((empty_done[slot] - 1) & 1) == \
                        ((filled // slots) - 1) & 1
                fb, fn = walk[filled]
                key = fn * keys + lane + 32 * j
                ring[slot, lane + 32 * j] = np.where(
                    key < s, ks[fb, np.minimum(key, s - 1)], 0.0)
                full_done[slot] += 1
                filled += 1
            # the consumer: n counts key tiles of this q tile, it the
            # block's steps over all of them
            slot = it % slots if consumer_slot is None else \
                consumer_slot(it, n, slots)
            assert full_done[slot] == it // slots + 1
            assert ((full_done[slot] - 1) & 1) == (it // slots) & 1
            key = n * keys + read_idx
            got = ring[slot, read_idx]
            want = np.where(key < s, ks[b, np.minimum(key, s - 1)], 0.0)
            np.testing.assert_array_equal(got, want)
            empty_done[slot] += 1
            steps += 1
    return steps


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s,bh", [(5590, 8), (15906, 4), (777, 96)])
def test_key_scale_ring_stages_each_tile_for_its_softmax(s, bh, head_dim):
    """At the experiment sequences (the Wan eval's 5,590, CogVideoX's
    15,906) and the ragged 777, with grids where each block walks several
    q tiles on one ring, every softmax reads its own key tile's scales
    (zeros past S), a slot is never refilled before its softmax is done,
    and the barrier parities the threads wait for are the completions they
    need."""
    ks = np.random.default_rng(s).random((bh, s), np.float32) + 0.5
    steps = _replay_scales(ks, s, head_dim)
    lay = FV.int8_smem_layout(head_dim)
    assert steps == bh * -(-s // lay["q_rows"]) * -(-s // lay["keys"])


def test_key_scale_ring_rejects_a_slot_counted_per_q_tile():
    """The replay is not vacuous: a consumer that counts its slot by the
    key tile of its q tile (n) rather than by the block's step (it) reads
    another tile's scales once a block walks a second q tile whose key
    tiles are no multiple of the ring (777 keys: 7 tiles)."""
    ks = np.random.default_rng(0).random((96, 777), np.float32) + 0.5
    with pytest.raises(AssertionError):
        _replay_scales(ks, 777, 64,
                       consumer_slot=lambda it, n, slots: n % slots)


def test_int8_flash_runs_its_plain_version_on_the_cpu():
    """``int8_flash`` on CPU tensors is ``int8_flash_ref`` (both bodies);
    the wrappers' CPU route is unchanged."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 150, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    codes = FV.quantize_qk(q, k, 0.125)
    bound = FV.int8_bound(*codes).reshape(1)
    assert torch.equal(FV.int8_flash(*codes, v), FV.int8_flash_ref(*codes, v))
    assert torch.equal(FV.int8_flash(*codes, v, bound),
                       FV.int8_flash_ref(*codes, v, bound))
    assert torch.equal(FV.flash_v3(q, k, v, scale=0.125),
                       FV.int8_flash_ref(*codes, v))
    assert torch.equal(FV.flash_v123(q, k, v, scale=0.125),
                       FV.int8_flash_ref(*codes, v, bound))


FAKE_NVCC = """\
import os, sys
with open(os.path.join(os.path.dirname(sys.argv[0]), "calls"), "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
print("ptxas info    : Used 168 registers")
open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"")
"""


def test_int8_source_builds_for_sm90a_on_the_hopper_helpers(tmp_path,
                                                            monkeypatch):
    """csrc/flash_int8.cu is one nvcc of its own for sm_90a with ptxas's
    report, its library's name covers csrc/sm90_common.cuh, and it is
    typed with both C functions."""
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
    got = cuda_build.build_cuda_libs(["flash_int8"])
    (call,) = (tools / "calls").read_text().splitlines()
    args = call.split()
    assert Path(args[-1]).name == "flash_int8.cu"
    assert "arch=compute_90a,code=sm_90a" in args and "-Xptxas=-v" in args
    assert "Used 168 registers" in cuda_build.BUILD_LOG["flash_int8"]
    assert got["flash_int8"][1] == "flash_int8"
    header = (cuda_build._CSRC / "sm90_common.cuh").read_bytes()
    assert header in cuda_build._source_bytes(
        cuda_build._CSRC / "flash_int8.cu", set())
    assert set(cuda_build._CUDA_SOURCES["flash_int8"]) == {
        "flash_variant_int8", "flash_int8_config"}
    assert "flash_variant_int8" not in cuda_build._CUDA_SOURCES[
        "flash_variants"]


def test_tuning_script_builds_the_port_beside_each_version(monkeypatch,
                                                           capsys):
    """``scripts/tune_flash_int8.py`` hands the port's source and every
    ``--alt`` / ``--probe`` file to ``build_cuda_libs`` in one call, as versions
    of ``flash_int8``, and prints each kernel's registers and spills."""
    from frameino_tpu_torch.scripts import tune_flash_int8 as T
    seen = {}

    def fake_build(names, alts):
        seen.update(names=names, alts=alts)
        return {"flash_int8": "lib", **{n: f"lib_{n}" for n in alts}}
    monkeypatch.setattr(cuda_build, "build_cuda_libs", fake_build)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {
        "flash_int8": "ptxas info    : Compiling entry function '_ZN12_GLOBA"
                      "L__N_119flash_int_qk_kernelILi64ELb1ELi3ELi4EEEvv'\n"
                      "    0 bytes stack frame, 8 bytes spill stores, 8 "
                      "bytes spill loads\nptxas info    : Used 128 registers"})
    libs = T.build({"parent": "/old/flash_variants.cu"})
    assert libs == {T.PORT: "lib", "parent": "lib_parent"}
    assert seen == dict(names=["flash_int8"], alts={
        "parent": ("flash_int8", "/old/flash_variants.cu")})
    out = capsys.readouterr().out
    assert "flash_int_qk_kernel<64, 1, 3, 4>" in out
    assert "8 bytes spill stores" in out and "Used 128 registers" in out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(ValueError, match="port"):
        T.main(["--probe", f"{T.PORT}=x.cu"])
