"""The PyTorch port's training entry point on the CPU: ``train.main`` with
``--smoke`` on a synthetic dataset trains, checkpoints, validates and
resumes; the options it does not port raise.
"""

import json
import os

import pytest
import torch

from frameino_tpu_torch import train
from frameino_tpu_torch.data.fixture import write_fixture_dataset


def _config(root, data, **kw):
    cfg = {"experiment_name": "smoke", "download_folder_path": data,
           "train_csv_relative_path": "csvs",
           "train_video_relative_path": "videos",
           "train_ID_relative_path": "ids",
           "target_height": 32, "target_width": 64,
           "sample_accelerate_factor": 1, "train_frame_num_range": [13, 13],
           "min_train_frame_num": 9, "dot_radius": 7,
           "drop_FrameIn_prob": 0.0, "max_train_steps": 2,
           "train_batch_size": 1, "checkpointing_steps": 2,
           "checkpoints_total_limit": 2, "gradient_checkpointing": True,
           "learning_rate": 1e-4, "lr_warmup_steps": 1,
           "resume_from_checkpoint": "latest",
           "output_folder": os.path.join(root, "ckpts"),
           "max_text_seq_length": 8, "first_iter_validation": True,
           "num_inference_steps": 2, "seed": 0, **kw}
    path = os.path.join(root, "smoke.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)                 # JSON text is valid YAML
    return path


@pytest.fixture
def smoke_env(tmp_path):
    data = write_fixture_dataset(str(tmp_path), 48, 64, 30)
    return str(tmp_path), data


def test_smoke_train_checkpoint_validate_resume(smoke_env, capsys):
    root, data = smoke_env
    path = _config(root, data)
    out = train.main(["--config_path", path, "--smoke"])
    printed = capsys.readouterr().out
    assert out["step"] == 2 and out["resumed_from"] is None
    assert "step 1 loss" in printed and "step 2 loss" in printed
    assert "done at step 2" in printed
    assert [h["lr"] for h in out["history"]] == [0.0, pytest.approx(1e-4)]
    ckpt = os.path.join(root, "ckpts", "smoke")
    meta = json.load(open(os.path.join(ckpt, "checkpoint-2",
                                       "metadata.json")))
    assert "epoch_seed" in meta and "batches_done" in meta
    assert os.path.exists(os.path.join(ckpt, "checkpoint-2", "state.pt"))
    val = os.path.join(ckpt, "validation_step0")
    for name in ("generated.mp4", "first_frame_canvas.png",
                 "id_reference.png", "prompt.txt"):
        assert os.path.exists(os.path.join(val, name)), name
    rows = [json.loads(line) for line in open(os.path.join(ckpt,
                                                           "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]

    # the rerun resumes at step 2 and takes one more step
    _config(root, data, max_train_steps=3)
    out = train.main(["--config_path", path, "--smoke"])
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "checkpoint-2" in printed
    assert out["step"] == 3 and len(out["history"]) == 1
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("checkpoint")
                  ) == ["checkpoint-2", "checkpoint-3"]


def test_stage1_trains_without_the_id_branch(smoke_env):
    root, data = smoke_env
    path = _config(root, data, max_train_steps=1, first_iter_validation=False,
                   gradient_checkpointing=False)
    out = train.main(["--config_path", path, "--smoke", "--stage1"])
    assert out["step"] == 1 and out["history"][0]["grad_norm"] > 0


def test_unported_and_unavailable_paths_raise(smoke_env, monkeypatch):
    root, data = smoke_env
    # a pretrained path that does not exist raises (JAX trains from random
    # weights without a word)
    path = _config(root, data, pretrained_transformer_path="/x/y")
    with pytest.raises(FileNotFoundError, match="/x/y"):
        train.main(["--config_path", path, "--smoke"])
    path = _config(root, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config_path", path])


def test_optimizer_keys_of_the_config_reach_the_optimizer(smoke_env,
                                                          monkeypatch):
    """gradient_accumulation_steps, max_grad_norm and optimizer are read
    from the YAML: with 2 micro-batches an update a watched weight moves
    on every second step only; optimizer: adafactor trains with it."""
    from frameino_tpu_torch.training import trainer
    root, data = smoke_env
    orig, seen = trainer.train_step, []

    def step(state, *args, **kw):
        watched = state.model.blocks[0].attn1.to_q.weight
        before = watched.detach().clone()
        out = orig(state, *args, **kw)
        seen.append((state.optimizer.cfg, not torch.equal(before, watched)))
        return out

    monkeypatch.setattr(trainer, "train_step", step)
    path = _config(root, data, max_train_steps=4, lr_scheduler="constant",
                   first_iter_validation=False, max_grad_norm=0.5,
                   gradient_accumulation_steps=2, optimizer="adamw")
    out = train.main(["--config_path", path, "--smoke"])
    assert out["step"] == 4
    assert [moved for _, moved in seen] == [False, True, False, True]
    cfg = seen[0][0]
    assert cfg.gradient_accumulation_steps == 2
    assert cfg.max_grad_norm == 0.5 and cfg.optimizer == "adamw"

    seen.clear()
    path = _config(root, data, max_train_steps=5, optimizer="adafactor",
                   lr_scheduler="constant", first_iter_validation=False,
                   experiment_name="smoke_adafactor")
    out = train.main(["--config_path", path, "--smoke"])
    assert out["step"] == 5 and seen[-1][0].optimizer == "adafactor"
    assert seen[-1][1]
