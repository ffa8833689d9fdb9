"""The Wan train entry under ``torchrun`` on the CPU: the mesh it lays out
for a world size and a YAML (``training/cli.mesh_config``) against the
rule of JAX's entry (``scripts/train_wan_motion_frameino.py``, run up to
its ``make_mesh`` call), a 4-process ``--smoke`` run over gloo in which
each process collates only its rank's examples of the global batch, and
the CogVideoX entry refusing a ``mesh:`` key (JAX's CogVideoX entry runs
on one process).
"""

import importlib.util
import json
import os
import socket
import sys

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_parallel_worker as W
from frameino_tpu_torch import train_cogvideox
from frameino_tpu_torch.data.fixture import write_fixture_dataset
from frameino_tpu_torch.training import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (world size, --smoke, the YAML's mesh:)
CASES = [(1, False, None), (2, False, None), (4, False, None),
         (6, False, None), (8, False, None), (16, False, None),
         (8, True, None), (4, True, None),
         (8, False, {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}),
         (4, False, {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}),
         (4, True, {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1})]


class _Chosen(Exception):
    pass


def _write_config(path, **kw):
    with open(path, "w") as f:
        json.dump(kw, f)                   # JSON text is valid YAML
    return str(path)


def _jax_choice(monkeypatch, path, world, smoke):
    """The MeshConfig JAX's Wan entry passes to ``make_mesh`` on ``world``
    devices: its ``main`` run with the device count, the parameter inits
    and ``make_mesh`` stubbed (the last raising with its argument)."""
    from frameino_tpu.core import meshes
    from frameino_tpu.models import wan_dit, wan_vae
    spec = importlib.util.spec_from_file_location(
        "_jax_train_entry", os.path.join(REPO, "scripts",
                                         "train_wan_motion_frameino.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def chosen(cfg, *a, **kw):
        raise _Chosen(cfg)
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(wan_dit, "init_wan_dit", lambda *a, **kw: None)
    monkeypatch.setattr(wan_vae, "init_wan_vae", lambda *a, **kw: None)
    monkeypatch.setattr(meshes, "make_mesh", chosen)
    monkeypatch.setattr(sys, "argv", ["train", "--config_path", path]
                        + (["--smoke"] if smoke else []))
    with pytest.raises(_Chosen) as got:
        mod.main()
    return got.value.args[0]


def _case_id(world, smoke, mesh):
    return (f"n{world}" + ("-smoke" if smoke else "")
            + ("-" + "x".join(map(str, mesh.values())) if mesh else ""))


@pytest.mark.parametrize("world,smoke,mesh", CASES,
                         ids=[_case_id(*c) for c in CASES])
def test_mesh_choice_matches_jax_entry(monkeypatch, tmp_path, world, smoke,
                                       mesh):
    """The YAML's mesh where its product is the world size; else dp 2 x
    fsdp n/2 where 4 divides n (not under --smoke); dp 2 x fsdp 2 x tp 2
    under --smoke where 8 divides n; else dp n: JAX's choice with the
    world size in the place of the device count."""
    config = {"seed": 0} if mesh is None else {"seed": 0, "mesh": mesh}
    path = _write_config(tmp_path / "c.yaml", **config)
    want = _jax_choice(monkeypatch, path, world, smoke)
    got = cli.mesh_config(config, world, smoke)
    assert {a: getattr(got, a) for a in ("pp", "dp", "fsdp", "tp", "sp")} == \
        {a: getattr(want, a) for a in ("pp", "dp", "fsdp", "tp", "sp")}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_entry_collates_only_each_ranks_examples(tmp_path):
    """``train.main --smoke`` as 4 torchrun processes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT set; gloo) with the YAML's dp 2 x fsdp 2
    and train_batch_size 2: the global batch is 4 (train_batch_size x dp),
    every process collates its one example of each batch, every rank
    reports the same loss and grad_norm, and the mesh's rank 0 alone
    writes the metrics and the checkpoint."""
    data = write_fixture_dataset(str(tmp_path), 48, 64, 30, rows=4)
    out = os.path.join(str(tmp_path), "ckpts")
    path = _write_config(
        tmp_path / "smoke.yaml", experiment_name="mesh",
        download_folder_path=data, train_csv_relative_path="csvs",
        train_video_relative_path="videos", train_ID_relative_path="ids",
        target_height=32, target_width=64, sample_accelerate_factor=1,
        train_frame_num_range=[13, 13], min_train_frame_num=9,
        dot_radius=7, drop_FrameIn_prob=0.0, max_train_steps=2,
        train_batch_size=2, checkpointing_steps=2, learning_rate=1e-4,
        lr_warmup_steps=1, output_folder=out, max_text_seq_length=8,
        first_iter_validation=False, dataloader_num_workers=1, seed=0,
        mesh={"dp": 2, "fsdp": 2, "tp": 1, "sp": 1})
    mp.spawn(W.train_entry, args=(4, str(tmp_path), ["--config_path", path,
                                                     "--smoke"],
                                  _free_port()), nprocs=4, join=True)
    histories = []
    for r in range(4):
        assert list(np.load(tmp_path / f"collated_{r}.npy")) == [1, 1], r
        assert list(np.load(tmp_path / f"mesh_{r}.npy")) == [2, 2, 1]
        histories.append(np.load(tmp_path / f"history_{r}.npy"))
    assert histories[0].shape == (2, 2) and np.isfinite(histories[0]).all()
    for h in histories[1:]:
        np.testing.assert_array_equal(h, histories[0])
    run = os.path.join(out, "mesh")
    rows = [json.loads(line) for line in open(os.path.join(
        run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert os.path.exists(os.path.join(run, "checkpoint-2", "state.pt"))


def test_cogvideox_entry_refuses_a_mesh(tmp_path):
    """JAX's CogVideoX entry passes no mesh to its step; the port's runs on
    one process and raises on a ``mesh:`` key rather than dropping it."""
    path = _write_config(tmp_path / "c.yaml", seed=0,
                         mesh={"dp": 2, "fsdp": 2})
    with pytest.raises(ValueError, match="one process"):
        train_cogvideox.main(["--config_path", path, "--smoke"])
