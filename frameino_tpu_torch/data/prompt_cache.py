"""Reader of the precomputed prompt-embedding cache (the port's own copy of
the lookup side of ``frameino_tpu/data/prompt_cache.py``; the cache is
written by ``scripts/precompute_prompt_embeddings.py``).

Layout: ``<dir>/<sha1(prompt)[:16]>.npy`` ([L, text_dim] fp32) plus an
``index.json`` mapping hashes to the original prompt text. Unknown
prompts raise under ``strict``, else fall back to zeros with a miss
counter.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np


def prompt_key(prompt: str) -> str:
    return hashlib.sha1(prompt.encode("utf-8")).hexdigest()[:16]


class PromptEmbeddingCache:
    def __init__(self, cache_dir: str, max_text_len: int, text_dim: int):
        self.dir = cache_dir
        self.max_text_len = max_text_len
        self.text_dim = text_dim
        self.misses = 0

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
