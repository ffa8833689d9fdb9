"""K8, the head-pair-packed flash forward of ``csrc/flash_packed.cu``, on
the CPU: its shared-memory layout, the byte map between what TMA writes
and what each head's wgmma descriptors read, the O store into the packed
row, the ragged mask on the last key tile, the order of a consumer's
batches, the C interface, the build of the source and the tuning script's
host side.

The kernel runs only on a card (``tests/test_torch_cuda.py``, which also
holds ``flash_packed_config`` to ``packed_smem_layout``); its plain
version is held to the JAX script's kernel in
``tests/test_torch_flash_variants.py``. Here the kernel's address and
index arithmetic is replayed in numpy:

- a packed row is [head A | head B], 64 bf16 lanes each; TMA writes bf16
  element (r, c) of a packed tile at the shared address ``sw(base + (c //
  64) block + 128 r + 2 (c % 64) + b)`` for its bytes b = 0, 1, where
  ``sw`` XORs the 16-byte chunk bits [4, 7) of an address with its bits
  [7, 10) (the 128-byte swizzle): head h is column block h;
- a K-major descriptor (8-row groups 1024 bytes apart) reads byte b of row
  r of its 16-column k slice at ``sw(start + (r // 8) 1024 + (r % 8) 128 +
  b)``; the kernel starts head h's k-th slice at ``base + h block + 32
  k``;
- an MN-major descriptor (rows = keys, 8-key groups 1024 bytes apart, one
  64-wide atom) reads byte b of column n of key k of its 16-key slice at
  ``sw(start + (k // 8) 1024 + (k % 8) 128 + 2 n + b)``; the kernel
  starts head h's k-th slice of V at ``base + h block + 2048 k``;
- the wgmma accumulator gives thread (warp, lane) the columns ``8 j + 2
  (lane % 4) + (e & 1)`` of rows ``16 warp + lane / 4 (+ 8 for e >=
  2)``.
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
HEAD = 64               # lanes of one head in a packed row


def _sw(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma(base, block, r, col, byte):
    """Where TMA wrote byte ``byte`` of bf16 element (r, col) of a packed
    tile whose column blocks are ``block`` bytes apart."""
    return _sw(base + (col // 64) * block + r * 128 + 2 * (col % 64) + byte)


def _desc_k(start, r, b):
    """The byte a K-major descriptor at ``start`` reads for row r, byte b
    of its 16-column slice."""
    return _sw(start + (r // 8) * 1024 + (r % 8) * 128 + b)


def _desc_mn(start, k, n, b):
    """The byte an MN-major descriptor at ``start`` reads for key k of its
    16-key slice, column n (< 64), byte b."""
    return _sw(start + (k // 8) * 1024 + (k % 8) * 128 + 2 * n + b)


def _s_operands(lay):
    """(name, tile base, first row, rows) of every K-major operand an S
    product reads: each consumer's 64 rows of both Q buffers, and the 128
    keys of each K stage."""
    out = []
    for buf in range(2):
        for w in range(lay["consumer_wgs"]):
            out.append((f"q{buf}.{w}", lay["q"] + buf * lay["q_tile"],
                        64 * w, 64))
    for s in range(lay["stages"]):
        out.append((f"k{s}", lay["k"] + s * lay["kv_tile"], 0, KEYS))
    return out


def test_layout_fits_and_keeps_tiles_on_their_swizzle_phase():
    """Every tile and head's column block starts on a 1024-byte boundary
    (the 128-byte swizzle repeats every 8 rows), each consumer's Q rows
    start a row group, the regions follow each other without overlap, and
    the block fits the card's shared memory."""
    lay = FV.packed_smem_layout()
    assert lay["keys"] == KEYS and lay["swizzle"] == 128
    assert lay["q_rows"] == 64 * lay["consumer_wgs"]
    assert lay["column_blocks"] == 2
    assert lay["q_tile"] == 2 * lay["q_block"]
    assert lay["kv_tile"] == 2 * lay["kv_block"]
    assert lay["q_block"] == lay["q_rows"] * 128
    assert lay["kv_block"] == KEYS * 128
    order = ["q", "k", "v", "bars"]
    sizes = dict(q=2 * lay["q_tile"], k=lay["stages"] * lay["kv_tile"],
                 v=lay["stages"] * lay["kv_tile"])
    for a, b in zip(order, order[1:]):
        assert lay[a] + sizes[a] == lay[b], (a, b)
    for size in ("q_block", "kv_block", "q_tile", "kv_tile"):
        assert lay[size] % 1024 == 0, size
    for name in ("q", "k", "v"):
        assert lay[name] % 1024 == 0, name
    assert lay["bars"] % 8 == 0
    for name, base, r0, _ in _s_operands(lay):
        block = lay["q_block"] if name.startswith("q") else lay["kv_block"]
        for h in range(2):
            assert (base + h * block + r0 * 128) % 1024 == 0, (name, h)
    # q_full, q_empty, q_ready (2 each) and four barriers a stage, then the
    # slack that aligns the dynamic base to 1024
    assert lay["smem_bytes"] == lay["bars"] + (6 + 4 * lay["stages"]) * 8 \
        + 1024
    assert lay["smem_bytes"] <= SMEM_LIMIT


def test_a_third_stage_does_not_fit():
    """Two K/V stages are all that fit beside the two Q buffers of 128
    packed rows."""
    lay = FV.packed_smem_layout()
    assert lay["stages"] == 2
    assert lay["smem_bytes"] + lay["kv_tile"] * 2 > SMEM_LIMIT


def _s_reads(lay, head, base, r0, rows, block):
    """(got, want): the bytes head ``head``'s S descriptors read for every
    (row, k slice, byte) of an operand, and the bytes TMA wrote for packed
    column 64 head + 16 k + b // 2 of those rows."""
    r = np.arange(rows)[:, None, None]
    kk = np.arange(HEAD // 16)[None, :, None]
    b = np.arange(32)[None, None, :]
    got = _desc_k(base + head * block + r0 * 128 + 32 * kk, r, b)
    want = _tma(base, block, r0 + r, HEAD * head + 16 * kk + b // 2, b % 2)
    return got, want


@pytest.mark.parametrize("head", [0, 1], ids=["head_a", "head_b"])
def test_s_descriptor_reads_the_byte_tma_wrote(head):
    """For every Q and K operand, head h's descriptor of k slice kk reads,
    for each (row, byte), where TMA wrote packed column 64 h + 16 kk + b //
    2 of that row, and each byte of the head's column block once."""
    lay = FV.packed_smem_layout()
    for name, base, r0, rows in _s_operands(lay):
        block = lay["q_block"] if name.startswith("q") else lay["kv_block"]
        got, want = _s_reads(lay, head, base, r0, rows, block)
        assert np.array_equal(got, want), name
        mine = np.arange(base + head * block + r0 * 128,
                         base + head * block + (r0 + rows) * 128)
        assert np.array_equal(np.sort(got.ravel()), mine), name


def test_s_byte_map_rejects_a_swapped_head_and_a_slice_off_by_16():
    """The replay is not vacuous: head A's descriptor started at head B's
    column block, or a k slice started 16 bytes off, reads other bytes
    than TMA wrote."""
    lay = FV.packed_smem_layout()
    base, block = lay["k"], lay["kv_block"]
    r = np.arange(KEYS)[:, None, None]
    kk = np.arange(4)[None, :, None]
    b = np.arange(32)[None, None, :]
    want = _tma(base, block, r, 16 * kk + b // 2, b % 2)    # head A
    assert np.array_equal(_desc_k(base + 32 * kk, r, b), want)
    assert not np.array_equal(_desc_k(base + block + 32 * kk, r, b), want)
    assert not np.array_equal(_desc_k(base + 32 * kk + 16, r, b), want)


@pytest.mark.parametrize("head", [0, 1], ids=["head_a", "head_b"])
def test_v_descriptor_reads_the_heads_column_block(head):
    """Head h's MN-major V descriptor of 16-key slice kk reads, for key k,
    column n and byte b, where TMA wrote packed column 64 h + n of key 16
    kk + k: column block h; head 1 - h's descriptor does not."""
    lay = FV.packed_smem_layout()
    block = lay["kv_block"]
    k = np.arange(16)[:, None, None, None]
    n = np.arange(HEAD)[None, :, None, None]
    b = np.arange(2)[None, None, :, None]
    kk = np.arange(KEYS // 16)[None, None, None, :]
    for s in range(lay["stages"]):
        base = lay["v"] + s * lay["kv_tile"]
        got = _desc_mn(base + head * block + 2048 * kk, k, n, b)
        want = _tma(base, block, 16 * kk + k, HEAD * head + n, b)
        assert np.array_equal(got, want)
        assert np.array_equal(
            np.sort(got.ravel()),
            np.arange(base + head * block, base + (head + 1) * block))
        other = _desc_mn(base + (1 - head) * block + 2048 * kk, k, n, b)
        assert not np.array_equal(other, want)


def _store_map(lay, col0=lambda h: HEAD * h):
    """{head: (packed row, packed column, accumulator column)} that each
    consumer thread's store_head writes for accumulator element (j, e) of
    head h (its first lane ``col0(h)``), over a q tile."""
    w, warp, lane, j, e = np.meshgrid(
        np.arange(lay["consumer_wgs"]), np.arange(4), np.arange(32),
        np.arange(HEAD // 8), np.arange(4), indexing="ij")
    g, t = lane >> 2, lane & 3
    row = 64 * w + 16 * warp + g + 8 * (e >> 1)
    acc_col = 8 * j + 2 * t + (e & 1)
    return {h: (row, col0(h) + acc_col, acc_col) for h in (0, 1)}


def _store_is_right(stores):
    return all(np.array_equal(col // HEAD, np.full_like(col, h))
               and np.array_equal(col % HEAD, acc_col)
               for h, (_, col, acc_col) in stores.items())


def test_o_store_writes_each_heads_lanes_of_the_packed_row():
    """store_head of head h writes accumulator column c to lane 64 h + c
    of the packed row, and the two heads of the consumers write each
    element of a [128, 128] tile once; a head-swapped store (head A's O
    into head B's lanes) is caught."""
    lay = FV.packed_smem_layout()
    stores = _store_map(lay)
    assert _store_is_right(stores)
    seen = np.zeros((lay["q_rows"], 2 * HEAD), dtype=int)
    for row, col, _ in stores.values():
        np.add.at(seen, (row.ravel(), col.ravel()), 1)
    assert (seen == 1).all()
    assert not _store_is_right(_store_map(lay, col0=lambda h: HEAD * (1 - h)))


def _masked_keys(s, fault=None):
    """The kernel's mask replayed: per key tile n0, on the last tile only
    (``n0 + 128 > s``), each thread (t = lane % 4) sets s = -1e30 for its
    columns 8 j + 2 t + (e & 1) that are >= s; both heads run the same
    mask. Returns the masked keys of the tiles [0, n_kv * 128)."""
    n_kv = -(-s // KEYS)
    j, t, e = np.meshgrid(np.arange(16), np.arange(4), np.arange(4),
                          indexing="ij")
    cols = (8 * j + 2 * t + (e & 1)).ravel()
    masked = set()
    for n0 in range(0, n_kv * KEYS, KEYS):
        if n0 + KEYS <= s:
            continue
        keys = n0 + cols
        hit = keys >= s if fault is None else fault(keys, s)
        masked.update(int(x) for x in keys[hit])
    return masked, n_kv


@pytest.mark.parametrize("s", [15906, 19126, 777, 300, 129, 128, 1])
def test_last_tile_mask_masks_exactly_the_keys_past_the_end(s):
    """At the experiment's 15,906 tokens, the CogVideoX serving 19,126,
    the ragged 777, the card tests' 300 and 129, a whole tile and one key:
    the mask on the last key tile alone masks exactly the keys at or past
    S (the zero-filled rows TMA loads)."""
    masked, n_kv = _masked_keys(s)
    assert masked == set(range(s, n_kv * KEYS))
    assert len(masked) == (-s) % KEYS


def test_last_tile_mask_replay_rejects_an_off_by_one():
    """The replay is not vacuous: ``key > s`` leaks key s, ``key >= s -
    1`` drops the last valid key."""
    for fault in (lambda keys, s: keys > s, lambda keys, s: keys >= s - 1):
        masked, n_kv = _masked_keys(777, fault=fault)
        assert masked != set(range(777, n_kv * KEYS))


# the registers each product reads or writes: one S tile, each head's O
# and P
_REGS = {"S": lambda head: {"s"},
         "PV": lambda head: {f"acc_{head}", f"p_{head}"}}


def _batches(n_kv, v_done_late=True, retire=True):
    """A consumer's batches over one q tile as csrc/flash_packed.cu issues
    them: ops ("loop",) (the top of a loop iteration, and its exit),
    ("issue", product), ("commit",), ("wait", n), ("done", ring, tile),
    ("q_empty",), ("softmax", head, tile). ``v_done_late=False`` plants a
    fault: V stage n freed in batch 1 of tile n; ``retire=False`` another:
    P_B V_B left in flight across the loop's back edge (the schedule that
    made ptxas serialise every wgmma)."""
    ops = [("issue", ("S", "A", 0)), ("commit",), ("wait", 0),
           ("softmax", "A", 0)]

    def batch_1(n):
        ops.extend([("issue", ("S", "B", n)), ("commit",),
                    ("issue", ("PV", "A", n)), ("commit",), ("wait", 1),
                    ("done", "k", n)])
        if n == n_kv - 1:
            ops.append(("q_empty",))
        ops.append(("softmax", "B", n))
        if not v_done_late:
            ops.append(("done", "v", n))

    for n in range(n_kv - 1):
        ops.append(("loop",))
        batch_1(n)
        ops.extend([("issue", ("S", "A", n + 1)), ("commit",),
                    ("issue", ("PV", "B", n)), ("commit",), ("wait", 1),
                    ("softmax", "A", n + 1)] + [("wait", 0)] * retire)
        if v_done_late:
            ops.append(("done", "v", n))
    ops.append(("loop",))
    batch_1(n_kv - 1)
    ops.extend([("issue", ("PV", "B", n_kv - 1)), ("commit",), ("wait", 0)])
    if v_done_late:
        ops.append(("done", "v", n_kv - 1))
    return ops


def _check_batches(ops, n_kv):
    """Runs the batches against wgmma's commit-group semantics (wait n:
    all but the newest n groups complete) and checks what the kernel
    relies on: a product issued only while no product in flight shares a
    register with it (one S tile; each head's O and P), and an S issued
    only once the previous one was softmaxed; a head's softmax (which
    reads S, rescales its O and rewrites its P) only once its S and its
    previous P V completed, and its P V issued only after it; a K (V)
    stage freed once after both heads' products reading it completed; Q
    freed after the last S; nothing in flight across the loop's back edge
    (ptxas then serialises every wgmma); every product issued once and
    complete at the end."""
    groups, open_group, complete = [], [], set()
    issued, softmaxed, last_s = [], set(), None
    freed = {"k": [], "v": []}

    def in_flight():
        return [p for g in groups + [open_group] for p in g]

    for op in ops:
        if op[0] == "loop":
            assert not in_flight(), op
        elif op[0] == "issue":
            kind, head, n = op[1]
            mine = _REGS[kind](head)
            assert all(not (mine & _REGS[p[0]](p[1])) for p in in_flight()
                       ), op
            if kind == "S":
                assert last_s is None or last_s[1:] in softmaxed, op
                last_s = op[1]
            else:
                assert (head, n) in softmaxed, op
            open_group.append(op[1])
            issued.append(op[1])
        elif op[0] == "commit":
            groups.append(open_group)
            open_group = []
        elif op[0] == "wait":
            keep = len(groups) - op[1]
            for g in groups[:keep]:
                complete.update(g)
            groups = groups[keep:]
        elif op[0] == "softmax":
            _, head, n = op
            assert ("S", head, n) in complete, op
            assert not any(_REGS[p[0]](p[1]) & ({"s"} | _REGS["PV"](head))
                           for p in in_flight()), op
            if n > 0:
                assert ("PV", head, n - 1) in complete, op
            softmaxed.add((head, n))
        elif op[0] == "done":
            _, ring, n = op
            kind = "S" if ring == "k" else "PV"
            assert {(kind, "A", n), (kind, "B", n)} <= complete, op
            freed[ring].append(n)
        elif op[0] == "q_empty":
            assert all(("S", h, n) in complete for h in "AB"
                       for n in range(n_kv)), op
    assert not in_flight()
    products = {(kind, h, n) for kind in ("S", "PV") for h in "AB"
                for n in range(n_kv)}
    assert len(issued) == len(products) and complete == products
    assert freed["k"] == list(range(n_kv)) and \
        freed["v"] == list(range(n_kv))


@pytest.mark.parametrize("n_kv", [1, 2, 3, 125, 150])
def test_consumer_batches_respect_the_commit_groups(n_kv):
    """The interleave of the two heads (S_B,n | P_A,n V_A, then S_A,n+1 |
    P_B,n V_B, P_A V_A in flight from the one batch into the other, the
    first and last batches peeled) at 1, 2 and 3 key tiles and at the
    experiment's 125 and CogVideoX's 150."""
    _check_batches(_batches(n_kv), n_kv)


@pytest.mark.parametrize("fault", [dict(v_done_late=False),
                                   dict(retire=False)],
                         ids=["v_stage_freed_early", "pv_in_flight"])
def test_batch_replay_rejects_a_planted_fault(fault):
    """The replay is not vacuous: a V stage freed in batch 1 of its tile
    (P_B V_B not yet issued), or P_B V_B left in flight across the loop's
    back edge, is caught."""
    with pytest.raises(AssertionError):
        _check_batches(_batches(3, **fault), 3)


def test_packed_config_is_registered_and_typed():
    """``flash_packed_config`` is a C function of the source, registered
    beside ``flash_packed_bf16`` with one int argument
    (``tests/test_torch_cuda_build.py::test_argtypes_match_the_c_interface``
    holds the argtypes to the declarations)."""
    fns = cuda_build._CUDA_SOURCES["flash_packed"]
    assert set(fns) == {"flash_packed_bf16", "flash_packed_config"}
    assert fns["flash_packed_config"] == [cuda_build.ctypes.c_int]
    text = (cuda_build._CSRC / "flash_packed.cu").read_text()
    assert 'extern "C" int flash_packed_config(int what)' in text
    assert "mma.sync" not in text and "wgmma" in text


def test_packed_rows_run_their_plain_version_on_the_cpu():
    """``packed_rows`` on CPU tensors is the plain version on the packed
    rows, each half K3's plain version of its head; the wrapper's CPU
    route is ``pack`` -> that -> ``unpack`` and counts no launch."""
    from frameino_tpu_torch.ops import attention as A
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(2, 4, 150, HEAD, generator=g).to(torch.bfloat16)
               for _ in range(3))
    qp, kp, vp = (FV.pack(t) for t in (q, k, v))
    rows = FV.packed_rows(qp, kp, vp)
    assert torch.equal(rows, FV.packed_rows_ref(qp, kp, vp))
    c = HEAD ** -0.5 * A.LOG2E
    for h in range(2):
        sl = slice(HEAD * h, HEAD * (h + 1))
        assert torch.equal(rows[..., sl], A.flash_fwd_ref(
            qp[..., sl], kp[..., sl], vp[..., sl], c))
    before = FV.packed_flash.launches
    assert torch.equal(FV.packed_flash(q, k, v),
                       FV.unpack(rows, q.shape[0]))
    assert torch.equal(FV.packed_flash_ref(q, k, v),
                       FV.unpack(rows, q.shape[0]))
    assert FV.packed_flash.launches == before


FAKE_NVCC = """\
import os, sys
with open(os.path.join(os.path.dirname(sys.argv[0]), "calls"), "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
print("ptxas info    : Used 168 registers")
open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"")
"""


def test_packed_source_builds_for_sm90a_on_the_hopper_helpers(
        tmp_path, monkeypatch):
    """csrc/flash_packed.cu is one nvcc of its own for sm_90a with
    ptxas's report, its library's name covers csrc/sm90_common.cuh, and it
    is typed with both C functions; no source of the port includes the
    mma.sync helpers of csrc/flash_common.cuh, which are gone."""
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
    got = cuda_build.build_cuda_libs(["flash_packed"])
    (call,) = (tools / "calls").read_text().splitlines()
    args = call.split()
    assert Path(args[-1]).name == "flash_packed.cu"
    assert "arch=compute_90a,code=sm_90a" in args and "-Xptxas=-v" in args
    assert "Used 168 registers" in cuda_build.BUILD_LOG["flash_packed"]
    assert got["flash_packed"][1] == "flash_packed"
    src = cuda_build._source_bytes(cuda_build._CSRC / "flash_packed.cu",
                                   set())
    assert (cuda_build._CSRC / "sm90_common.cuh").read_bytes() in src
    assert not (cuda_build._CSRC / "flash_common.cuh").exists()
    for name in cuda_build._CUDA_SOURCES:
        text = (cuda_build._CSRC / f"{name}.cu").read_text()
        assert '"flash_common.cuh"' not in text, name


@pytest.mark.cuda
def test_packed_source_compiles_with_nvcc_for_sm90a(tmp_path):
    """The real nvcc compiles csrc/flash_packed.cu for sm_90a without a
    spill or a serialised wgmma (skips where there is no nvcc: the CUDA
    toolkit is on the card's machine)."""
    nvcc = cuda_build._nvcc()
    if not (shutil.which(nvcc) or os.path.exists(nvcc)):
        pytest.skip("needs nvcc: the CUDA toolkit is not installed here")
    out = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
         f"-I{cuda_build._CSRC}", "-o", str(tmp_path / "lib.so"),
         str(cuda_build._CSRC / "flash_packed.cu")],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    log = out.stdout + out.stderr
    assert log.count("Compiling entry") == 1
    assert "serialized" not in log
    assert " 0 bytes spill stores" in log and not any(
        "spill stores" in line and " 0 bytes spill stores" not in line
        for line in log.splitlines())


def test_tuning_script_builds_the_port_beside_each_version(monkeypatch,
                                                           capsys):
    """``scripts/tune_flash_packed.py`` hands the port's source and every
    ``--alt`` / ``--probe`` file to ``build_cuda_libs`` in one call, as
    versions of ``flash_packed``, prints each kernel's registers and
    spills, runs K8 through its C entry on rows packed beforehand, each
    on the library it is given (on the CPU: the plain version), and times
    the CogVideoX shape alone."""
    from frameino_tpu_torch.scripts import tune_flash_int8 as TI
    from frameino_tpu_torch.scripts import tune_flash_packed as T
    seen = {}

    def fake_build(names, alts):
        seen.update(names=names, alts=alts)
        return {"flash_packed": "lib", **{n: f"lib_{n}" for n in alts}}
    monkeypatch.setattr(cuda_build, "build_cuda_libs", fake_build)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {
        "flash_packed": "ptxas info    : Compiling entry function '_ZN12"
                        "_GLOBAL__N_119flash_packed_kernelE14CUtensorMap_"
                        "stS0_S0_P13__nv_bfloat16iiij'\n    0 bytes stack "
                        "frame, 4 bytes spill stores, 6 bytes spill loads\n"
                        "ptxas info    : Used 168 registers"})
    libs = TI.build({"parent": "/old/flash_packed.cu"}, T.SOURCE)
    assert libs == {TI.PORT: "lib", "parent": "lib_parent"}
    assert seen == dict(names=["flash_packed"], alts={
        "parent": ("flash_packed", "/old/flash_packed.cu")})
    out = capsys.readouterr().out
    assert "flash_packed_kernel" in out
    assert "4 bytes spill stores" in out and "Used 168 registers" in out
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 140, HEAD, generator=g).to(torch.bfloat16)
               for _ in range(3))
    bodies = T.packed_bodies(q, k, v, HEAD ** -0.5)
    assert list(bodies) == ["k8"]
    assert torch.equal(bodies["k8"](None),
                       FV.packed_rows_ref(*(FV.pack(t) for t in (q, k, v))))
    assert T.SHAPES == "cog"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(ValueError, match="port"):
        T.main(["--alt", f"{TI.PORT}=x.cu"])
