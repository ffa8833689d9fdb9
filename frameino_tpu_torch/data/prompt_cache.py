"""The precomputed prompt-embedding cache (the port's own copy of
``frameino_tpu/data/prompt_cache.py``; the cache is written by
``scripts/precompute_prompt_embeddings.py``, the port's or the JAX
package's, and read by the train entries).

Layout: ``<dir>/<sha1(prompt)[:16]>.npy`` ([L, text_dim] fp32) plus an
``index.json`` mapping hashes to the original prompt text. Unknown
prompts raise under ``strict``, else fall back to zeros with a miss
counter.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np


def prompt_key(prompt: str) -> str:
    return hashlib.sha1(prompt.encode("utf-8")).hexdigest()[:16]


class PromptEmbeddingCache:
    def __init__(self, cache_dir: str, max_text_len: int, text_dim: int,
                 create: bool = False):
        self.dir = cache_dir
        self.max_text_len = max_text_len
        self.text_dim = text_dim
        self.misses = 0
        self._index: Dict[str, str] = {}
        if create:
            os.makedirs(cache_dir, exist_ok=True)
        idx = os.path.join(cache_dir, "index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                self._index = json.load(f)

    def __len__(self):
        return len(self._index)

    def put(self, prompt: str, embedding: np.ndarray):
        """embedding: [L, text_dim] (L <= max_text_len; zero-padded)."""
        key = prompt_key(prompt)
        emb = np.asarray(embedding, np.float32)
        if emb.shape[0] < self.max_text_len:
            emb = np.pad(emb, ((0, self.max_text_len - emb.shape[0]),
                               (0, 0)))
        np.save(os.path.join(self.dir, f"{key}.npy"), emb)
        self._index[key] = prompt
        with open(os.path.join(self.dir, "index.json"), "w") as f:
            json.dump(self._index, f)

    def get(self, prompt: str, fallback: Optional[np.ndarray] = None,
            strict: bool = False) -> np.ndarray:
        path = os.path.join(self.dir, f"{prompt_key(prompt)}.npy")
        if os.path.exists(path):
            return np.load(path)
        if strict:
            raise KeyError(
                f"prompt not in embedding cache {self.dir!r}: "
                f"{prompt[:80]!r}... — run "
                f"scripts/precompute_prompt_embeddings.py over the train "
                f"CSV, or set prompt_cache_allow_misses: true to train "
                f"with zero embeddings for uncached prompts")
        self.misses += 1
        if fallback is not None:
            return fallback
        return np.zeros((self.max_text_len, self.text_dim), np.float32)

    def batch(self, prompts, strict: bool = False) -> np.ndarray:
        return np.stack([self.get(p, strict=strict) for p in prompts])
