"""A model's flat parameter table: each released checkpoint name with its
shape, how it is drawn at random, and where the JAX package keeps it.

The curation models (Swin, OneFormer, VGGT) compute from a flat state dict
under the released checkpoints' names, as the JAX modules compute from
their parameter trees. One table per model gives, from the same entries:
the names a checkpoint must hold, a seeded random draw at the JAX inits'
scales, and the bridge from a JAX parameter tree (as numpy arrays) to the
state dict, the inverse of JAX's ``*_from_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Entry:
    shape: Tuple[int, ...]
    init: str                 # "normal" (times scale), "const" (= scale),
    #                           "zeros" or "ones"
    path: Tuple               # the JAX tree's keys (an int indexes a stack)
    layout: Optional[str]     # None, "linear" ([in, out] <-> [out, in]) or
    #                           "conv" (HWIO <-> OIHW)
    scale: float = 0.05


class ParamTable(dict):
    """{released name: Entry}, filled by the helpers below."""

    def add(self, name, shape, init, path, layout=None, scale=0.05):
        self[name] = Entry(tuple(int(s) for s in shape), init, tuple(path),
                           layout, scale)

    def linear(self, name, n_in, n_out, path, bias=True):
        self.add(f"{name}.weight", (n_out, n_in), "normal", (*path, "w"),
                 "linear")
        if bias:
            self.add(f"{name}.bias", (n_out,), "zeros", (*path, "b"))

    def norm(self, name, c, path, keys=("scale", "bias")):
        self.add(f"{name}.weight", (c,), "ones", (*path, keys[0]))
        self.add(f"{name}.bias", (c,), "zeros", (*path, keys[1]))

    def conv(self, name, c_in, c_out, k, path, bias=True):
        self.add(f"{name}.weight", (c_out, c_in, k, k), "normal",
                 (*path, "w"), "conv")
        if bias:
            self.add(f"{name}.bias", (c_out,), "zeros", (*path, "b"))

    def draw(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> StateDict:
        """Seeded random weights on the generator's device: every "normal"
        entry N(0, scale^2) in its table order, biases zero, norm gains
        one, "const" entries their value."""
        dev = generator.device
        out = {}
        for name, e in self.items():
            if e.init == "normal":
                t = torch.randn(e.shape, generator=generator, device=dev,
                                dtype=torch.float32).mul_(e.scale)
            elif e.init == "ones":
                t = torch.ones(e.shape, device=dev)
            elif e.init == "const":
                t = torch.full(e.shape, e.scale, device=dev)
            else:
                t = torch.zeros(e.shape, device=dev)
            out[name] = t.to(dtype)
        return out

    def draw_numpy(self, seed: int) -> Dict[str, np.ndarray]:
        """Values of the same sizes drawn with numpy (tests hand them to
        both packages): "normal" entries as ``draw``, gains and constants
        within 10% of theirs, biases N(0, 0.02^2)."""
        rs = np.random.RandomState(seed)
        out = {}
        for name, e in self.items():
            if e.init == "normal":
                out[name] = (e.scale * rs.randn(*e.shape)).astype(np.float32)
            elif e.init in ("ones", "const"):
                base = 1.0 if e.init == "ones" else e.scale
                out[name] = (base * (1.0 + 0.1 * rs.randn(*e.shape))
                             ).astype(np.float32)
            else:
                out[name] = (0.02 * rs.randn(*e.shape)).astype(np.float32)
        return out

    def from_jax(self, params) -> StateDict:
        """A JAX parameter tree (numpy or JAX arrays) -> this state dict."""
        out = {}
        for name, e in self.items():
            node = params
            for key in e.path:
                node = node[key]
            a = np.asarray(node, np.float32)
            if e.layout == "linear":
                a = a.T
            elif e.layout == "conv":
                a = a.transpose(3, 2, 0, 1)
            if a.shape != e.shape:
                raise ValueError(f"{name}: JAX tree gives {a.shape}, the "
                                 f"table {e.shape}")
            out[name] = torch.from_numpy(np.array(a, order="C"))
        return out

    def take(self, sd, what: str) -> StateDict:
        """The table's tensors out of a checkpoint's state dict; other keys
        are ignored (as JAX's loaders ignore them), a missing or misshaped
        one raises."""
        missing = [n for n in self if n not in sd]
        if missing:
            raise KeyError(f"{what}: checkpoint lacks {missing[:8]} "
                           f"({len(missing)} keys)")
        out = {}
        for name, e in self.items():
            t = sd[name]
            if tuple(t.shape) != e.shape:
                raise ValueError(f"{what}: {name} is {tuple(t.shape)}, "
                                 f"expected {e.shape}")
            out[name] = t
        return out
