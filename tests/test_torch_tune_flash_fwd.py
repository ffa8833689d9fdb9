"""The host side of the serving flash kernels' comparison script
(``frameino_tpu_torch/scripts/tune_flash_fwd.py``) on the CPU: the
kernels themselves run only on a card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.scripts import tune_flash_fwd as T


def test_build_takes_the_port_and_each_alternative(monkeypatch, capsys):
    """The port's source and every ``--alt`` go to the builder in one
    call, as versions of ``flash_fwd``; a kernel whose wgmmas ptxas
    serialises is named."""
    seen = {}

    def fake_build(names, alts):
        seen.update(names=names, alts=alts)
        return {"flash_fwd": "lib", **{n: f"lib_{n}" for n in alts}}
    monkeypatch.setattr(cuda_build, "build_cuda_libs", fake_build)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {
        "flash_fwd": "ptxas info : Used 168 registers",
        "pr1": "ptxas info : (C7515) wgmma ... serialized in 'k'"})
    libs = T.build({"pr1": "/src/flash_fwd.cu"})
    assert libs == {T.PORT: "lib", "pr1": "lib_pr1"}
    assert seen == dict(names=["flash_fwd"],
                        alts={"pr1": ("flash_fwd", "/src/flash_fwd.cu")})
    out = capsys.readouterr().out
    assert f"# {T.PORT}: no serialised wgmma" in out
    assert "# pr1: wgmma serialised in" in out and "C7515" in out


def test_tuning_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        T.main([])
    with pytest.raises(ValueError, match="port"):
        T.main(["--alt", f"{T.PORT}=x.cu"])
