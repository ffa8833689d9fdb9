"""The CUDA builder of the port (``frameino_tpu_torch/ops/cuda_build.py``)
on the CPU, with a stand-in for nvcc: which sources it compiles, what it
keeps of nvcc's output, and what a failed build leaves. The libraries
themselves load and run only on a card (``tests/test_torch_cuda.py``)."""

import ctypes
import re
import sys
from pathlib import Path

import pytest

from frameino_tpu_torch.ops import cuda_build

# prints a ptxas line and writes the library, or fails if asked to; each
# call is logged beside it
FAKE_NVCC = """\
import os, sys
with open(os.path.join(os.path.dirname(sys.argv[0]), "calls"), "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
print("ptxas info    : Used 42 registers, 0 bytes spill stores, 0 bytes "
      "spill loads")
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: no")
    sys.exit(2)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"not a library")
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """A csrc/ with one source ``k.cu``, an empty build/, the stand-in
    nvcc, and a loader that records what it would load."""
    csrc, tools = tmp_path / "csrc", tmp_path / "tools"
    csrc.mkdir()
    tools.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// shared\n")
    nvcc = tools / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_CUDA_SOURCES", {"k": {}})
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "_load",
                        lambda so, source, partial=False:
                        (so.name, source, partial))

    def calls():
        log = tools / "calls"
        return log.read_text().splitlines() if log.exists() else []
    return tmp_path, calls


def test_cached_build_keeps_its_log(fake, monkeypatch):
    """nvcc's output is kept beside the library and read back when a
    later process finds the library built: the register and spill report
    holds on a warm build/ too."""
    tmp_path, calls = fake
    first = cuda_build.build_cuda_libs(["k"])
    assert len(calls()) == 1
    log = cuda_build.BUILD_LOG["k"]
    assert "Used 42 registers" in log
    so = cuda_build._so_path("k")
    assert so.exists() and so.with_suffix(".log").read_text() == log
    # a fresh process: nothing loaded, nothing logged
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    assert cuda_build.build_cuda_libs(["k"]) == first
    assert len(calls()) == 1
    assert cuda_build.BUILD_LOG["k"] == log
    # once loaded, a source is neither built nor read again
    assert cuda_build.lib("k") == first["k"] and len(calls()) == 1
    # a library without its log (an older build/) is built again
    so.with_suffix(".log").unlink()
    monkeypatch.setattr(cuda_build, "_libs", {})
    cuda_build.build_cuda_libs(["k"])
    assert len(calls()) == 2 and "Used 42" in cuda_build.BUILD_LOG["k"]


def test_alternative_source_builds_beside_under_its_key(fake, tmp_path):
    """An alternative version of a source (outside csrc/, including its
    headers) is built beside it under its own key, typed as that source
    but allowed to lack some of its functions, and not kept for
    ``lib``."""
    tmp_path, calls = fake
    old = tmp_path / "old" / "k.cu"
    old.parent.mkdir()
    old.write_text('#include "h.cuh"\n// older\n')
    got = cuda_build.build_cuda_libs(["k"], {"old": ("k", old)})
    assert set(got) == {"k", "old"}
    assert got["k"][1:] == ("k", False) and got["old"][1:] == ("k", True)
    assert got["old"][0].startswith("libold_")
    assert len(calls()) == 2
    alt_call = next(c for c in calls() if c.endswith(str(old)))
    assert f"-I{cuda_build._CSRC}" in alt_call.split()
    assert set(cuda_build._libs) == {"k"}
    assert "Used 42 registers" in cuda_build.BUILD_LOG["old"]
    with pytest.raises(ValueError, match="name"):
        cuda_build.build_cuda_libs(["k"], {"k": ("k", old)})


def test_alternative_source_takes_the_header_beside_it(fake, tmp_path):
    """An older version of a source that brings its own copy of a header
    (a header the checkout no longer has, or an older one) is named by
    that copy, as nvcc's quoted include finds it; without one, by the
    header of csrc/."""
    tmp_path, calls = fake
    old = tmp_path / "old" / "k.cu"
    old.parent.mkdir()
    old.write_text('#include "h.cuh"\n#include "gone.cuh"\n')
    (old.parent / "gone.cuh").write_text("// only beside the old source\n")
    first = cuda_build._so_path("old", old)
    (old.parent / "h.cuh").write_text("// the old h\n")
    assert cuda_build._so_path("old", old) != first
    data = cuda_build._source_bytes(old, set())
    assert b"// the old h" in data and b"// shared" not in data
    assert b"// only beside the old source" in data
    got = cuda_build.build_cuda_libs(["k"], {"old": ("k", old)})
    assert got["old"][0] == cuda_build._so_path("old", old).name


def test_failed_build_raises_and_leaves_no_library(fake, monkeypatch):
    """A failed nvcc raises with its output and leaves neither a library
    nor a log, so the next call compiles again."""
    tmp_path, calls = fake
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="error: no"):
        cuda_build.build_cuda_libs(["k"])
    so = cuda_build._so_path("k")
    assert not so.exists() and not so.with_suffix(".log").exists()
    assert cuda_build._libs == {}
    monkeypatch.delenv("FAKE_NVCC_FAIL")
    cuda_build.build_cuda_libs(["k"])
    assert len(calls()) == 2 and so.exists()


def test_every_source_is_compiled_for_sm90a(tmp_path, monkeypatch):
    """The real csrc/: one nvcc per registered source, all for sm_90a,
    the qk producers (K2/K5, K4) among them."""
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
                        lambda so, source, partial=False: source)
    got = cuda_build.build_cuda_libs()
    calls = (tools / "calls").read_text().splitlines()
    compiled = sorted(Path(c.split()[-1]).name for c in calls)
    assert compiled == sorted(f"{n}.cu" for n in cuda_build._CUDA_SOURCES)
    assert "qk_producers.cu" in compiled and got["qk_producers"] == \
        "qk_producers"
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)


_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


@pytest.mark.parametrize("source", sorted(cuda_build._CUDA_SOURCES))
def test_argtypes_match_the_c_interface(source):
    """Each C function's argtypes follow its declaration in the source: a
    64-bit ``c_void_p`` for every pointer and the stream (a ``c_int``
    would cut a device pointer), ``c_int`` and ``c_float`` for the
    scalars; the source exports exactly the registered functions."""
    text = (cuda_build._CSRC / f"{source}.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
    fns = cuda_build._CUDA_SOURCES[source]
    assert sorted(decls) == sorted(fns)
    assert ctypes.sizeof(ctypes.c_void_p) == 8
    for name, argtypes in fns.items():
        params = [a.strip() for a in decls[name].split(",")]
        assert argtypes == [ctypes.c_void_p if "*" in a
                            else _C_TYPES[a.split()[0]] for a in params], name
