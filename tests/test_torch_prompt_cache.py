"""The port's prompt-embedding script against the JAX package's
``scripts/precompute_prompt_embeddings.py`` on the CPU: the same CSV
folder, the same token ids (a stub tokenizer on both sides) and a small
T5 / UMT5 on seeded random weights, one checkpoint directory read by both;
the caches they write hold the same prompts and arrays. The train entries
read the port's cache.
"""

import csv
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from frameino_tpu_torch.data.prompt_cache import (PromptEmbeddingCache,
                                                prompt_key)
from frameino_tpu_torch.models import pretrained, t5_encoder
from frameino_tpu_torch.scripts import precompute_prompt_embeddings as tpre

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ['["a cat walks in", "a cat"]', "a red car", '"a dog runs"',
           "a red car"]


class StubTokenizer:
    """transformers' call signature: ids from each character, padded
    with 0 and cut to max_length, mask 1 over the ids."""

    def __call__(self, prompts, padding, max_length, truncation,
                 return_tensors):
        ids = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            tok = [3 + ord(c) % 60 for c in p][:max_length - 1] + [1]
            ids[i, :len(tok)] = tok
        return {"input_ids": ids,
                "attention_mask": (ids > 0).astype(np.int64)}


def _csv_folder(root):
    folder = os.path.join(root, "csvs")
    os.makedirs(folder)
    with open(os.path.join(folder, "part0.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_path", "Structured_Text_Prompt"])
        for i, p in enumerate(PROMPTS):
            w.writerow([f"v{i}.mp4", p])
    return folder


def _jax_script(monkeypatch, argv):
    """JAX's script's main() with ``argv``, transformers' AutoTokenizer
    replaced by the stub."""
    import transformers
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: StubTokenizer()))
    spec = importlib.util.spec_from_file_location(
        "jax_precompute_prompt_embeddings",
        os.path.join(REPO, "scripts", "precompute_prompt_embeddings.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["precompute_prompt_embeddings.py",
                                      *argv])
    mod.main()


@pytest.mark.parametrize("kind", ["t5", "umt5"])
def test_cache_matches_jax_script(tmp_path, monkeypatch, kind):
    root = str(tmp_path)
    cfg = t5_encoder.tiny_config(per_layer_relative_bias=kind == "umt5")
    model = t5_encoder.init_t5_encoder(cfg, torch.Generator().manual_seed(0))
    enc_dir = os.path.join(root, "encoder")
    pretrained.save_pretrained(enc_dir, cfg, model)
    folder = _csv_folder(root)
    common = ["--csv_folder", folder, "--text_encoder_path", enc_dir,
              "--max_text_len", "24", "--batch_size", "2",
              "--include_empty"]
    n = tpre.main(common + ["--output_dir", os.path.join(root, "port"),
                            "--kind", kind, "--device", "cpu"],
                  tokenizer=StubTokenizer())
    _jax_script(monkeypatch, common + ["--output_dir",
                                       os.path.join(root, "jax")])
    want_index = json.load(open(os.path.join(root, "jax", "index.json")))
    got_index = json.load(open(os.path.join(root, "port", "index.json")))
    assert got_index == want_index and n == len(want_index) == 5
    assert sorted(want_index.values()) == ["", "a cat", "a cat walks in",
                                           "a dog runs", "a red car"]
    for key in want_index:
        got = np.load(os.path.join(root, "port", f"{key}.npy"))
        want = np.load(os.path.join(root, "jax", f"{key}.npy"))
        assert got.shape == want.shape == (24, cfg.d_model)
        # fp32 encoders on the same ids: 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cache = PromptEmbeddingCache(os.path.join(root, "port"), 24, cfg.d_model)
    assert len(cache) == 5
    np.testing.assert_array_equal(
        cache.batch(["a red car"], strict=True)[0],
        np.load(os.path.join(root, "port", prompt_key("a red car") + ".npy")))


def test_kind_must_match_the_encoder(tmp_path):
    cfg = t5_encoder.tiny_config(per_layer_relative_bias=True)   # UMT5
    enc_dir = os.path.join(str(tmp_path), "encoder")
    pretrained.save_pretrained(enc_dir, cfg, t5_encoder.init_t5_encoder(
        cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="not --kind t5"):
        tpre.main(["--csv_folder", _csv_folder(str(tmp_path)),
                   "--text_encoder_path", enc_dir, "--output_dir",
                   os.path.join(str(tmp_path), "c"), "--kind", "t5",
                   "--device", "cpu"], tokenizer=StubTokenizer())
    assert tpre.TEXT_LEN == {"umt5": 512, "t5": 226}
