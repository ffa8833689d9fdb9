"""YAML experiment configuration (counterpart of
``frameino_tpu/core/config.py``): a flat dict, as the reference's OmegaConf
configs are read, and ``filter_kwargs`` to adapt it to dataclasses.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict

import yaml


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only keys that ``cls.__init__`` (or dataclass fields) accept."""
    if dataclasses.is_dataclass(cls):
        names = {f.name for f in dataclasses.fields(cls)}
    else:
        names = set(inspect.signature(cls).parameters)
    return {k: v for k, v in kwargs.items() if k in names}
