"""The PyTorch port's CogVideoX training entry point on the CPU:
``train_cogvideox.main`` with ``--smoke`` on a synthetic dataset trains,
checkpoints and resumes; reads every optimizer key of the config; loads a
checkpoint directory (with and without ``--surgery``); writes a profiler
trace; and refuses a missing pretrained path and a missing card.
"""

import json
import os

import pytest
import torch

from frameino_tpu_torch import train_cogvideox
from frameino_tpu_torch.core.metrics_logger import TRACE_FILE
from frameino_tpu_torch.data.fixture import write_fixture_dataset
from frameino_tpu_torch.models import cogvideox_dit, pretrained


def _config(root, data, **kw):
    # 9 frames of 32x32: latents 3 x 8 x 8 with the tiny VAE, the tiny
    # DiT's sample grid; 8 text tokens, its max_text_seq_length
    cfg = {"experiment_name": "cog_smoke", "download_folder_path": data,
           "train_csv_relative_path": "csvs",
           "train_video_relative_path": "videos",
           "train_ID_relative_path": "ids",
           "target_height": 32, "target_width": 32,
           "sample_accelerate_factor": 1, "train_frame_num_range": [9, 9],
           "min_train_frame_num": 9, "dot_radius": 40,
           "drop_FrameIn_prob": 0.0, "max_train_steps": 3,
           "train_batch_size": 1, "checkpointing_steps": 3,
           "checkpoints_total_limit": 2, "gradient_checkpointing": True,
           "learning_rate": 1e-4, "lr_warmup_steps": 1,
           "resume_from_checkpoint": "latest",
           "output_folder": os.path.join(root, "ckpts"),
           "max_text_seq_length": 8, "dataloader_num_workers": 1, "seed": 0,
           **kw}
    path = os.path.join(root, "cog.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)                 # JSON text is valid YAML
    return path


@pytest.fixture
def smoke_env(tmp_path):
    data = write_fixture_dataset(str(tmp_path), 48, 64, 12)
    return str(tmp_path), data


def _state(root, step, name="cog_smoke"):
    return torch.load(os.path.join(root, "ckpts", name, f"checkpoint-{step}",
                                   "state.pt"), weights_only=True)


def test_smoke_trains_checkpoints_resumes_and_profiles(smoke_env, capsys):
    root, data = smoke_env
    path = _config(root, data)
    trace_dir = os.path.join(root, "trace")
    out = train_cogvideox.main(["--config_path", path, "--smoke",
                                "--profile_dir", trace_dir])
    printed = capsys.readouterr().out
    assert out["step"] == 3 and out["resumed_from"] is None
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(h["loss"] == h["loss"] and h["grad_norm"] > 0
               for h in out["history"])
    assert "done at step 3" in printed
    # step 2 (the third) traced, with the trainer's ranges
    trace = json.load(open(os.path.join(trace_dir, TRACE_FILE)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"vae_encode", "forward", "backward", "optimizer"} <= names
    saved = _state(root, 3)

    # the rerun resumes at step 3, its state as saved, and takes a 4th
    _config(root, data, max_train_steps=4)
    out = train_cogvideox.main(["--config_path", path, "--smoke"])
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "checkpoint-3" in printed
    assert out["step"] == 4 and len(out["history"]) == 1
    after = _state(root, 4)
    assert after["optimizer"]["count"] == saved["optimizer"]["count"] + 1
    moved = [k for k in saved["model"]
             if not torch.equal(saved["model"][k], after["model"][k])]
    assert "patch_embed.pos_embedding" in moved and len(moved) > 10


def test_stage1_trains_without_the_id_branch(smoke_env):
    root, data = smoke_env
    path = _config(root, data, max_train_steps=1,
                   gradient_checkpointing=False)
    # the motion DiT: no extra ID frame of positions
    out = train_cogvideox.main(["--config_path", path, "--smoke",
                                "--stage1"])
    assert out["step"] == 1 and out["history"][0]["grad_norm"] > 0


def test_optimizer_keys_of_the_config_reach_the_optimizer(smoke_env,
                                                          monkeypatch):
    """The shipped config's Adam betas, epsilon and accumulation (which
    the JAX CLI leaves at 0.999, 1e-10 and 1) reach the optimizer: with 2
    micro-batches an update a watched weight moves on every second step."""
    from frameino_tpu_torch.training import cog_trainer
    root, data = smoke_env
    orig, moved = cog_trainer.cog_train_step, []

    def step(state, *args, **kw):
        w = state.model.transformer_blocks[0].attn1.to_q.weight
        before = w.detach().clone()
        out = orig(state, *args, **kw)
        moved.append(not torch.equal(before, w))
        return out

    monkeypatch.setattr(cog_trainer, "cog_train_step", step)
    path = _config(root, data, max_train_steps=4, lr_scheduler="constant",
                   adam_beta1=0.9, adam_beta2=0.95, adam_epsilon=1e-8,
                   adam_weight_decay=1e-4, gradient_accumulation_steps=2,
                   max_grad_norm=0.5, checkpointing_steps=100)
    out = train_cogvideox.main(["--config_path", path, "--smoke"])
    cfg = out["optimizer"]
    assert (cfg.beta2, cfg.epsilon, cfg.gradient_accumulation_steps,
            cfg.max_grad_norm, cfg.learning_rate) == (0.95, 1e-8, 2, 0.5,
                                                      1e-4)
    assert moved == [False, True, False, True]


@pytest.mark.parametrize("surgery", [False, True], ids=["as_saved",
                                                        "surgery"])
def test_pretrained_directory_loads(smoke_env, surgery):
    """A checkpoint directory written by ``save_pretrained`` is the DiT
    that trains: after one step at the warmup's lr 0 the checkpoint holds
    its weights; with --surgery a base DiT of 4 fewer input channels (the
    tiny VAE's latent channels) is widened with zeros."""
    root, data = smoke_env
    base = cogvideox_dit.tiny_config(in_channels=8 if surgery else 12)
    model = cogvideox_dit.init_cogvideox_dit(base,
                                             torch.Generator().manual_seed(3))
    pretrained.save_pretrained(os.path.join(root, "dit"), base, model)
    path = _config(root, data, max_train_steps=1,
                   pretrained_transformer_path=os.path.join(root, "dit"))
    argv = ["--config_path", path, "--smoke"] + (["--surgery"] if surgery
                                                 else [])
    assert train_cogvideox.main(argv)["step"] == 1
    got = _state(root, 1)["model"]
    for k, v in model.state_dict().items():
        if k == "patch_embed.proj.weight" and surgery:
            assert torch.equal(got[k][:, :8], v) and not got[k][:, 8:].any()
        else:
            assert torch.equal(got[k], v), k


def test_missing_pretrained_path_and_missing_card_raise(smoke_env,
                                                        monkeypatch):
    root, data = smoke_env
    path = _config(root, data, pretrained_transformer_path="/x/y")
    with pytest.raises(FileNotFoundError, match="/x/y"):
        train_cogvideox.main(["--config_path", path, "--smoke"])
    path = _config(root, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cogvideox.main(["--config_path", path])


def test_wan_entry_writes_a_profile_of_step_2(tmp_path):
    """``train.py --profile_dir`` (the Wan entry, which shares the loop)."""
    from frameino_tpu_torch import train
    data = write_fixture_dataset(str(tmp_path), 32, 32, 12)
    path = _config(str(tmp_path), data, target_height=16, target_width=16,
                   experiment_name="wan_smoke", checkpointing_steps=100)
    trace_dir = os.path.join(str(tmp_path), "trace")
    assert train.main(["--config_path", path, "--smoke", "--profile_dir",
                       trace_dir])["step"] == 3
    trace = json.load(open(os.path.join(trace_dir, TRACE_FILE)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"vae_encode", "forward", "backward", "optimizer"} <= names
