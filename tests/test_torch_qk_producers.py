"""The launch geometry of the qk-norm + RoPE producers K2, K5 and K4
(``frameino_tpu_torch/ops/attention._producer_geometry``) on the CPU.

The kernels (``csrc/qk_producers.cu``) run only on a card
(``tests/test_torch_cuda.py``); their plain versions are held to the JAX
producers in ``tests/test_torch_ops.py`` and ``test_torch_cogvideox.py``.
Here the kernels' index map is replayed in numpy from the geometry the
wrappers hand them: block b walks the token groups b, b + grid, ...; team
i of a block takes token group * teams_per_block + i; thread t of a team
holds the row's 16-byte vectors v = j * team + t (j < vpt) and writes
vector v of token (b, s) to head v // (D / 8) of out [B*H, S, D] at
vector (t % (D / 8)) of the head's row.
"""

import numpy as np
import pytest
import torch

from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.scripts import tune_qk_producers as T

# (heads, head_dim): the Wan2.2 rows (24 of 128) and their tp = 2 / 4
# shards, Wan2.1-I2V-14B's 40 heads (a team of 160 threads, five warps)
# and Wan2.1-T2V-1.3B's 12 (the tp = 2 shard's width), a ragged 5-head
# shard, the CUDA tests' 3 and 1 heads, CogVideoX (48 of 64) and its
# tests' 3 and 2, and the tiny configs' widths (the CogVideoX tiny DiT's 2
# heads of 16, the sharded tests' 4 heads of 32 and their tp shards)
WIDTHS = [(24, 128), (40, 128), (12, 128), (6, 128), (5, 128), (3, 128),
          (1, 128), (48, 64), (3, 64), (2, 64), (2, 16), (4, 32), (2, 32),
          (1, 32)]


def _replay(heads, head_dim, batch, seq, resident):
    """Every (thread, slot) that touches memory: its token, row vector and
    output vector, in the kernel's order of loops."""
    team, vpt, tpb = A._producer_geometry(heads, head_dim)
    grid = A._producer_grid(batch * seq, tpb, resident)
    hv = head_dim // 8
    nv = heads * hv
    n = batch * seq
    groups = -(-n // tpb)
    grp = np.concatenate([np.arange(b, groups, grid) for b in range(grid)])
    thr = np.arange(team * tpb)
    team_id, t = thr // team, thr % team
    tok = grp[:, None, None] * tpb + team_id[None, :, None]
    v = np.arange(vpt)[None, None, :] * team + t[None, :, None]
    tok, v = np.broadcast_arrays(tok, v)
    dv = np.broadcast_to((t % hv)[None, :, None], v.shape)
    live = (tok < n) & (v < nv)
    tok, v, dv = tok[live], v[live], dv[live]
    b, s, h = tok // seq, tok % seq, v // hv
    out_vec = ((b * heads + h) * seq + s) * hv + dv
    return dict(team=team, vpt=vpt, tpb=tpb, grid=grid, tok=tok, v=v, dv=dv,
                out_vec=out_vec)


@pytest.mark.parametrize("heads,head_dim", WIDTHS)
def test_index_map_covers_each_element_once_at_its_place(heads, head_dim):
    """At ragged token counts (S = 1, 7, 777; B = 1, 2) and persistent
    grids smaller and larger than the token groups, every element of
    [B, S, H*D] is read once and lands at its [B*H, S, D] position."""
    hv = head_dim // 8
    nv = heads * hv
    for batch, seq, resident in ((1, 1, 264), (2, 7, 3), (2, 777, 264),
                                 (1, 777, 5)):
        m = _replay(heads, head_dim, batch, seq, resident)
        n = batch * seq
        # each row vector exactly once
        counts = np.bincount(m["tok"] * nv + m["v"], minlength=n * nv)
        assert counts.min() == 1 and counts.max() == 1, (batch, seq)
        # a thread's vectors sit at one offset in every head: its gains,
        # gamma/beta and cos/sin are one set
        assert np.array_equal(m["dv"], m["v"] % hv)
        # element (b, s, c) of raw -> (b*H + c // D, s, c % D) of out; a
        # vector's 8 columns stay in one head (D % 8 == 0)
        col = m["v"] * 8
        b, s = m["tok"] // seq, m["tok"] % seq
        want = ((b * heads + col // head_dim) * seq + s) * head_dim \
            + col % head_dim
        assert np.array_equal(m["out_vec"] * 8, want)
        assert len(np.unique(m["out_vec"])) == n * nv
        assert 1 <= m["grid"] <= resident


@pytest.mark.parametrize("heads,head_dim", WIDTHS)
def test_reduction_partners_stay_in_their_team_and_head(heads, head_dim):
    """K2's xor tree (offsets below min(team, 32)) pairs threads of one
    team; a team wider than a warp is whole warps. K4's xor steps (offsets
    below D/8) pair the lanes of one head in every slot, within a warp."""
    team, vpt, tpb = A._producer_geometry(heads, head_dim)
    hv = head_dim // 8
    thr = np.arange(team * tpb)
    assert team * tpb <= A._PRODUCER_THREADS
    assert team % hv == 0
    assert (team <= 32 and team & (team - 1) == 0) or team % 32 == 0
    assert team * vpt >= heads * hv and vpt <= A._PRODUCER_MAX_VPT
    off = 1
    while off < min(team, 32):
        assert np.array_equal((thr ^ off) // team, thr // team)
        off *= 2
    off = 1
    while off < hv:
        partner = thr ^ off
        assert np.array_equal(partner // 32, thr // 32)
        for j in range(vpt):
            v = j * team + thr % team
            pv = j * team + partner % team
            assert np.array_equal(pv // hv, v // hv)
        off *= 2


def test_geometry_of_the_serving_rows():
    """The Wan and CogVideoX rows (384 vectors) leave no slot idle; the
    tp shards neither; the ragged 5-head shard idles 16 of 96; Wan2.1's
    40 heads (640 vectors) take one team of 160 threads a block, 4
    vectors a thread."""
    for heads, head_dim in ((24, 128), (48, 64), (12, 128), (6, 128),
                            (40, 128)):
        team, vpt, _ = A._producer_geometry(heads, head_dim)
        assert team * vpt == heads * head_dim // 8
    team, vpt, _ = A._producer_geometry(5, 128)
    assert (team, vpt) == (32, 3)
    assert A._producer_geometry(40, 128) == (160, 4, 1)


@pytest.mark.parametrize("heads,head_dim", WIDTHS)
def test_block_reduction_sums_each_team_once(heads, head_dim):
    """K2's statistic: the xor tree over min(team, 32) lanes, then, for a
    team wider than a warp, each warp's lane 0 writes partial[warp] and
    every thread of the team adds partial[w0 .. w0 + warps) in order: every
    thread ends with its own team's sum, each thread's value counted once
    (thread values 2**t, exact integers, make any double count or foreign
    term show)."""
    team, _, tpb = A._producer_geometry(heads, head_dim)
    n = team * tpb
    ss = [1 << t for t in range(n)]
    width = min(team, 32)
    off = width // 2
    while off:
        ss = [ss[t] + ss[t ^ off] for t in range(n)]
        off //= 2
    if team > 32:
        warps = team // 32
        partial = [ss[w * 32] for w in range(n // 32)]
        ss = [sum(partial[(t // team) * warps + w] for w in range(warps))
              for t in range(n)]
    for t in range(n):
        lo = (t // team) * team
        assert ss[t] == sum(1 << u for u in range(lo, lo + team)), t


@pytest.mark.parametrize("heads,head_dim", [(2, 24), (4, 4), (1, 512),
                                            (300, 128)])
def test_geometry_refuses_what_the_kernels_do_not_take(heads, head_dim):
    """A head_dim that is not a power of two in [8, 256] (the tiny Wan
    DiT's 24 runs only on the CPU), or a row of more than 1,024 vectors."""
    with pytest.raises(ValueError):
        A._producer_geometry(heads, head_dim)


def test_tuning_script_takes_the_kernels_geometries():
    """``scripts/tune_qk_producers.py`` tries another (team, vpt) only
    where the kernel takes it; the port's own geometry always passes."""
    assert T.parse_geometry("128:3") == (128, 3)
    assert T.takes((96, 4), 24, 128) and T.takes((128, 3), 24, 128)
    assert not T.takes((48, 4), 12, 128)     # over a warp, not whole warps
    assert not T.takes((16, 4), 24, 128)     # too few slots for the row
    assert not T.takes((8, 4), 1, 128)       # under a head's 16 vectors
    assert not T.takes((64, 5), 24, 128)     # over 4 vectors a thread
    for heads, head_dim in WIDTHS:
        assert T.takes(A._producer_geometry(heads, head_dim)[:2], heads,
                       head_dim)


def test_tuning_script_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(ValueError, match="port"):
        T.main(["--alt", f"{T.PORT}=x.cu"])
