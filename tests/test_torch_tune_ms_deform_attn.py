"""The host side of K13's comparison script
(``frameino_tpu_torch/scripts/tune_ms_deform_attn.py``) on the CPU: its
command line, its build call, its inputs and the L2 floor's corner
count. The kernels themselves run only on a card (``tests/test_torch_ms_deform_attn.py``)."""

import pytest
import torch

from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.scripts import tune_ms_deform_attn as T


def test_alternatives_are_named_by_their_stem_or_their_name():
    assert T.parse_alt("build/old/ms_deform_attn.cu") == (
        "ms_deform_attn", "build/old/ms_deform_attn.cu")
    assert T.parse_alt("old=a/b.cu") == ("old", "a/b.cu")
    with pytest.raises(SystemExit):
        T.main(["--pattern", "gaussian"])


def test_build_takes_the_port_the_l2_probe_and_each_alternative(
        monkeypatch, capsys):
    """The port's source, the L2 probe and every ``--alt`` go to
    ``build_cuda_libs`` in one call, each alternative as a version of
    ``ms_deform_attn``; ptxas's registers and spills are printed under
    each kernel's name and template arguments."""
    seen = {}

    def fake_build(names, alts):
        seen.update(names=names, alts=alts)
        return {"ms_deform_attn": "lib", "l2_read_probe": "probe",
                **{n: f"lib_{n}" for n in alts}}
    monkeypatch.setattr(cuda_build, "build_cuda_libs", fake_build)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {
        "ms_deform_attn": "ptxas info : Compiling entry function "
                          "'_ZN12_GLOBAL__N_121ms_deform_attn_kernelILi3ELi4"
                          "ELi4EEEvPKf' for 'sm_90a'\n"
                          "ptxas info : Used 80 registers, used 0 barriers",
        "old": "ptxas info : Used 40 registers"})
    libs = T.build({"old": "/src/ms_deform_attn.cu"})
    assert libs == {T.PORT: "lib", "old": "lib_old"}
    assert seen == dict(names=["ms_deform_attn", "l2_read_probe"],
                        alts={"old": ("ms_deform_attn",
                                       "/src/ms_deform_attn.cu")})
    out = capsys.readouterr().out
    assert "ms_deform_attn_kernel<3, 4, 4>" in out
    assert "Used 80 registers" in out and "Used 40 registers" in out


def test_tuning_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(RuntimeError, match="GPU"):
        T.main(["--alt", "old.cu", "--pattern", "encoder"])
    with pytest.raises(ValueError, match="port"):
        T.main(["--alt", f"{T.PORT}=x.cu"])


def test_encoder_pattern_takes_the_value_rows_as_queries():
    """Uniform locations take any number of queries in [lo, hi]; the
    encoder's queries are its value rows, so another count is refused, and
    its locations are ``encoder_sampling_locations``' for the seed."""
    levels = ((3, 5), (2, 2))
    value, loc, w = T.make_inputs("uniform", 0, levels=levels, batch=2,
                                  queries=7, heads=3, channels=4, points=2,
                                  lo=-0.5, hi=1.5, device="cpu")
    assert value.shape == (2, 19, 3, 4)
    assert loc.shape == (2, 7, 3, 2, 2, 2) and w.shape == (2, 7, 3, 2, 2)
    assert -0.5 <= float(loc.min()) and float(loc.max()) <= 1.5
    with pytest.raises(ValueError, match="value rows"):
        T.make_inputs("encoder", 0, levels=levels, queries=7, device="cpu")
    _, loc, _ = T.make_inputs("encoder", 5, levels=levels, batch=2, heads=3,
                              points=2, device="cpu")
    assert torch.equal(loc, torch.from_numpy(
        T.encoder_sampling_locations(levels, 2, 3, 2, seed=5)))


@pytest.mark.parametrize("pattern", T.PATTERNS)
def test_inputs_and_yardsticks(pattern):
    """Each pattern's inputs at small levels (Q = S, softmax weights), and
    the corner count (the L2 floor's reads) against a count of every
    corner one by one."""
    levels = ((3, 5), (2, 2))
    value, loc, w = T.make_inputs(pattern, 0, levels=levels, heads=2,
                                  channels=4, points=3, device="cpu")
    S = 3 * 5 + 2 * 2
    assert value.shape == (1, S, 2, 4) and loc.shape == (1, S, 2, 2, 3, 2)
    torch.testing.assert_close(w.sum((-1, -2)), torch.ones(1, S, 2))
    want = 0
    for b, q, h, lvl, p in torch.cartesian_prod(
            *(torch.arange(n) for n in loc.shape[:5])).tolist():
        hl, wl = levels[lvl]
        x = float(torch.floor(loc[b, q, h, lvl, p, 0] * wl - 0.5))
        y = float(torch.floor(loc[b, q, h, lvl, p, 1] * hl - 0.5))
        want += sum(0 <= x + dx < wl and 0 <= y + dy < hl
                    for dx in (0, 1) for dy in (0, 1))
    assert T.corner_reads(levels, loc) == want > 0
