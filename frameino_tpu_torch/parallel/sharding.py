"""Sharding of the DiTs' parameters over tp and fsdp (counterpart of
``frameino_tpu/parallel/sharding.py``, its rules for the Wan and
CogVideoX DiTs).

JAX writes its rules on the ``[in, out]`` dense kernels of the plain-dict
trees and lets GSPMD insert the collectives. Here they are written on
diffusers names and ``nn.Linear``'s ``[out, in]`` weights, and each rank
holds only its slice.

tp:

- column-parallel (Wan ``blocks.N.attn1/attn2.to_q/to_k/to_v`` and
  ``ffn.net.0.proj``; CogVideoX ``transformer_blocks.N.attn1.to_q/to_k/
  to_v`` and ``ff.net.0.proj``): the output dim (0) and the bias are cut
  over tp, so a rank computes its contiguous slice of the heads or of the
  FFN hidden width;
- row-parallel (Wan ``attn1/attn2.to_out.0``, ``ffn.net.2``; CogVideoX
  ``attn1.to_out.0``, ``ff.net.2``): the input dim (1) is cut; the partial
  products are all-reduced over tp and the bias, replicated, is added once
  after the sum (``row_parallel``);
- Wan's ``norm_q``/``norm_k`` gains ``[H*D]`` are cut to the rank's heads
  (JAX replicates them and GSPMD slices them where they are used);
  CogVideoX's per-head LayerNorm ``[D]``, shared by every head, is
  replicated;
- everything else is replicated.

fsdp (``fsdp_dim``, JAX's ``_DIT_RULES`` and ``_spec_for``): the
column-parallel weights are cut on their input dim, the row-parallel ones
on their output dim (JAX's ``("fsdp", "tp")`` and ``("tp", "fsdp")`` on
``[in, out]``), ``patch_embedding`` on its output channels, ``proj_out``
and ``text_embedder.linear_1`` on their input dim, the other
``linear_N`` on their output dim; the time-embedding MLPs and
``time_proj`` and the column-parallel biases stay whole; any other tensor
of at least 65,536 elements (counted over every block for a block's
tensor, as JAX counts its stacked leaves) is cut on its largest dim that
divides, in JAX's layout and order. A dim that fsdp does not divide stays
whole. The fsdp cut is taken within the rank's tp slice. Each rank holds
its slice; the DiTs gather a block's slices before the block runs
(``parallel/collectives.gather_fsdp``) and drop them after it.

The batch cut (``batch_slice``, ``run_dp``) and the sp token slice
(``ops/attention.sequence_cut``), taken in the DiTs' forwards and the
trainers, stand in for JAX's ``constrain(x, mesh, "tokens")``. pp is not
ported (``core/meshes.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.models.quant import linear
from frameino_tpu_torch.ops.linear import dense
from frameino_tpu_torch.parallel.collectives import (all_gather_dim,
                                                     gather_fsdp,
                                                     reduce_from_tp)

# (pattern over the full parameter name, the dim cut over tp)
_TP_RULES = (
    # Wan
    (re.compile(r"blocks\.\d+\.(attn[12]\.(to_[qkv]|norm_[qk])"
                r"|ffn\.net\.0\.proj)\.(weight|bias)"), 0),
    (re.compile(r"blocks\.\d+\.(attn[12]\.to_out\.0|ffn\.net\.2)\.weight"),
     1),
    # CogVideoX
    (re.compile(r"transformer_blocks\.\d+\.(attn1\.to_[qkv]"
                r"|ff\.net\.0\.proj)\.(weight|bias)"), 0),
    (re.compile(r"transformer_blocks\.\d+\.(attn1\.to_out\.0|ff\.net\.2)"
                r"\.weight"), 1),
)


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` cut over tp, or None (replicated)."""
    for pat, dim in _TP_RULES:
        if pat.fullmatch(name):
            return dim
    return None


# (pattern over the full name, the dim JAX's rule cuts over fsdp in the
# port's layout, or None: the rule keeps the tensor whole over fsdp);
# the first match decides, as in JAX's _DIT_RULES
_FSDP_RULES = tuple((re.compile(p), d) for p, d in (
    (r".*\.(to_[qkv]|add_[kv]_proj)\.weight", 1),
    (r".*ffn?\.net\.0\.proj\.weight", 1),
    (r".*\.(to_[qkv]|add_[kv]_proj)\.bias", None),
    (r".*ffn?\.net\.0\.proj\.bias", None),
    (r".*\.to_out\.0\.weight", 0),
    (r".*ffn?\.net\.2\.weight", 0),
    (r"(.*\.)?patch_embedding\.weight", 0),
    (r"(.*\.)?proj_out\.weight", 1),
    (r".*text_embedder\.linear_1\.weight", 1),
    (r".*(time_embedder|time_embedding|ofs_embedding)\.linear_\d\.weight",
     None),
    (r".*time_proj\.weight", None),
    (r".*linear_\d\.weight", 0),
))
# JAX's threshold of its default rule, in elements
FSDP_MIN_ELEMENTS = 1 << 16
_BLOCK = re.compile(r"(transformer_)?blocks\.\d+\.")


def _jax_axes(name: str, shape) -> list:
    """The tensor's dims in the JAX tree's layout and order, each as (its
    length, the port's dim, or None where it has no dim of its own): a
    Linear weight ``[out, in]`` is JAX's ``[in, out]``, a patchify conv's
    ``[d, C, ...]`` its ``[C * ..., d]``."""
    if len(shape) == 2 and name.endswith(".weight"):
        return [(shape[1], 1), (shape[0], 0)]
    if len(shape) >= 4 and name.endswith(".weight"):
        return [(math.prod(shape[1:]), None), (shape[0], 0)]
    return [(n, i) for i, n in enumerate(shape)]


def fsdp_dim(name: str, shape, fsdp: int, layers: int = 1
             ) -> Optional[int]:
    """The dim of tensor ``name`` (its whole ``shape``) that JAX's rules
    cut over ``fsdp`` ranks, or None; ``layers``: the DiT's blocks (JAX's
    default rule counts a block's tensor over all of them)."""
    if fsdp <= 1:
        return None
    for pat, dim in _FSDP_RULES:
        if pat.fullmatch(name):
            if dim is None or shape[dim] % fsdp:
                return None
            return dim
    numel = math.prod(shape) * (layers if _BLOCK.match(name) else 1)
    if numel < FSDP_MIN_ELEMENTS:
        return None
    for n, dim in sorted(_jax_axes(name, shape), key=lambda a: -a[0]):
        if n % fsdp == 0:
            return dim          # None: JAX cuts a dim the port has not
    return None


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a tensor is laid out over the mesh: its whole shape and the
    dims cut over tp and over fsdp (None: whole)."""
    shape: Tuple[int, ...]
    tp_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None

    def local_shape(self, mesh: Mesh) -> Tuple[int, ...]:
        s = list(self.shape)
        if self.tp_dim is not None:
            s[self.tp_dim] //= mesh.tp
        if self.fsdp_dim is not None:
            s[self.fsdp_dim] //= mesh.fsdp
        return tuple(s)

    def owned(self, mesh: Mesh) -> bool:
        """Whether this rank counts the tensor's local elements in a sum
        over the whole mesh, so that each element counts once: the first
        rank of every axis over which the tensor is replicated."""
        c = mesh.coords
        return (c["dp"] == 0 and c["sp"] == 0
                and (self.tp_dim is not None or c["tp"] == 0)
                and (self.fsdp_dim is not None or c["fsdp"] == 0))


def num_layers(names) -> int:
    """The count of blocks among the state dict keys ``names``."""
    idx = [int(m.group(0).rstrip(".").rsplit(".", 1)[1])
           for m in map(_BLOCK.match, names) if m]
    return max(idx) + 1 if idx else 1


def cut_of(name: str, shape, mesh: Mesh, layers: int) -> Cut:
    """The ``Cut`` of tensor ``name`` of whole ``shape`` on ``mesh``."""
    tp = tp_dim(name) if mesh.tp > 1 else None
    if tp is not None and shape[tp] % mesh.tp:
        raise ValueError(f"{name}: dim {tp} of {tuple(shape)} does not "
                         f"divide over tp={mesh.tp}")
    fs = fsdp_dim(name, shape, mesh.fsdp, layers)
    if fs is not None:
        n = shape[fs] // (mesh.tp if fs == tp else 1)
        if n % mesh.fsdp:
            raise ValueError(f"{name}: the tp slice of dim {fs} of "
                             f"{tuple(shape)} does not divide over "
                             f"fsdp={mesh.fsdp}")
    return Cut(tuple(shape), tp, fs)


def layout(shapes: Dict[str, tuple], mesh: Mesh) -> Dict[str, Cut]:
    """name -> ``Cut`` for a state dict's whole ``shapes``."""
    layers = num_layers(shapes)
    return {n: cut_of(n, s, mesh, layers) for n, s in shapes.items()}


def _narrow(t, dim, n, r):
    m = t.shape[dim] // n
    return t.narrow(dim, r * m, m)


def shard_state_dict(sd: Dict[str, torch.Tensor],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full ``WanDiT`` or ``CogVideoXDiT`` state
    dict: the tp slice of the tp-cut tensors, then the fsdp slice of that,
    as contiguous copies (so the full tensors can be freed), the rest as
    they are."""
    cuts = layout({n: tuple(t.shape) for n, t in sd.items()}, mesh)
    return {name: shard_tensor(t, cuts[name], mesh)
            for name, t in sd.items()}


def shard_tensor(t: torch.Tensor, cut: Cut, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` laid out as ``cut``:
    a contiguous copy where it is cut, ``t`` itself where it is not."""
    if cut.tp_dim is None and cut.fsdp_dim is None:
        return t
    if cut.tp_dim is not None:
        t = _narrow(t, cut.tp_dim, mesh.tp, mesh.tp_rank)
    if cut.fsdp_dim is not None:
        t = _narrow(t, cut.fsdp_dim, mesh.fsdp, mesh.fsdp_rank)
    return t.clone()


def gather_tensor(t: torch.Tensor, cut: Cut, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice (collective over the fsdp
    and tp groups of the tensor's cuts)."""
    if cut.fsdp_dim is not None:
        t = all_gather_dim(t, cut.fsdp_dim, mesh.fsdp_group)
    if cut.tp_dim is not None:
        t = all_gather_dim(t, cut.tp_dim, mesh.tp_group)
    return t


def gather_state_dict(local: Dict[str, torch.Tensor], mesh: Mesh,
                      cuts: Dict[str, Cut], keep: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: every tensor whole, gathered
    one at a time in the order of ``local`` (collective: every rank of the
    mesh calls it), on the CPU; with ``keep`` False the rank keeps nothing
    (returns {}), so that only one rank holds the whole state."""
    out = {}
    for name, t in local.items():
        whole = gather_tensor(t.detach(), cuts[name], mesh)
        if keep:
            out[name] = whole.to("cpu", copy=whole is t)
        del whole
    return out


@contextlib.contextmanager
def swapped(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters and buffers named in ``tensors`` (dotted
    names under ``module``) replaced by those tensors for the block, as
    ``torch.func.functional_call`` swaps them."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            store = (mod._parameters if leaf in mod._parameters
                     else mod._buffers)
            saved.append((store, leaf, store[leaf]))
            store[leaf] = t
        yield
    finally:
        for store, leaf, old in reversed(saved):
            store[leaf] = old


def fsdp_local_(module: torch.nn.Module, cuts: Dict[str, Cut],
                mesh: Mesh) -> None:
    """Replace, in place, each fsdp-cut parameter or buffer of a module
    built at the rank's tp width by an empty one of the rank's fsdp slice
    (to be filled by ``load_state_dict(shard_state_dict(...))``)."""
    for name, c in cuts.items():
        if c.fsdp_dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        old = getattr(mod, leaf)
        new = torch.empty(c.local_shape(mesh), dtype=old.dtype,
                          device=old.device)
        if leaf in mod._parameters:
            mod._parameters[leaf] = torch.nn.Parameter(
                new, requires_grad=old.requires_grad)
        else:
            mod._buffers[leaf] = new


def mesh_cuts(model: torch.nn.Module, mesh: Optional[Mesh]):
    """A DiT built at its tp width on ``mesh``: the ``Cut`` of every
    parameter and buffer by name (their whole shapes rebuilt from the tp
    cut), the fsdp-cut ones made the rank's slice in place, and those
    grouped by owner: {"" (the top level) or "blocks.N." /
    "transformer_blocks.N.": [(name under it, cut dim)]}. ({}, {})
    without a mesh."""
    if mesh is None:
        return {}, {}
    shapes = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        shape = list(t.shape)
        d = tp_dim(name) if mesh.tp > 1 else None
        if d is not None:
            shape[d] *= mesh.tp
        shapes[name] = tuple(shape)
    cuts = layout(shapes, mesh)
    fsdp_local_(model, cuts, mesh)
    groups = {}
    for name, c in cuts.items():
        if c.fsdp_dim is None:
            continue
        parts = name.split(".")
        prefix = ("" if parts[0] not in ("blocks", "transformer_blocks")
                  else ".".join(parts[:2]) + ".")
        groups.setdefault(prefix, []).append((name[len(prefix):],
                                              c.fsdp_dim))
    return cuts, groups


def gathered(module: torch.nn.Module, names, mesh: Optional[Mesh]):
    """A context in which ``module``'s fsdp-cut tensors ``names`` ((name,
    dim) pairs, None: none) are whole, gathered over the mesh's fsdp
    group through ``gather_fsdp`` (whose backward reduce-scatters their
    gradients)."""
    if not names:
        return contextlib.nullcontext()
    full = {}
    for name, dim in names:
        owner, _, leaf = name.rpartition(".")
        t = getattr(module.get_submodule(owner) if owner else module, leaf)
        full[name] = gather_fsdp(t, dim, mesh.fsdp_group)
    return swapped(module, full)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The rank's slice of a whole ``WanDiT`` or ``CogVideoXDiT``: the same
    class built on ``mesh`` and loaded with ``shard_state_dict`` of the
    whole model's state (the uncut tensors are shared, not copied)."""
    local = type(model)(model.cfg, device="meta", dtype=model.dtype,
                        mesh=mesh)
    local.load_state_dict(shard_state_dict(model.state_dict(), mesh),
                          assign=True)
    return local.train(model.training)


def batch_slice(mesh: Mesh, batch: int) -> Tuple[slice, int]:
    """This rank's examples of a global batch of ``batch``, cut over
    (dp, fsdp) as JAX's ``P(("dp", "fsdp"))``: the dp rank's contiguous
    slice, then, when fsdp divides it, the fsdp rank's contiguous part of
    that. Where fsdp does not divide the dp slice, every fsdp rank runs
    the dp slice whole. Returns (the slice, how many ranks of the batch
    group run each of its examples: 1, or fsdp)."""
    dp, fs = mesh.dp, mesh.fsdp
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over dp={dp}")
    per = batch // dp
    start = mesh.dp_rank * per
    if per % fs == 0:
        n = per // fs
        start += mesh.fsdp_rank * n
        return slice(start, start + n), 1
    return slice(start, start + per), fs


def row_parallel(x, layer, group):
    """A row-parallel layer on one tp rank: ``layer`` holds the rank's
    input rows of the weight and the whole bias; the rank's fp32 partial
    product is summed over ``group`` (``reduce_from_tp``) and the bias
    added once, after the sum. ``group``
    None (tp = 1): the layer as it is."""
    if group is None:
        return linear(x, layer)
    y = reduce_from_tp(dense(x, layer.weight, out_dtype=torch.float32),
                       group)
    return (y + layer.bias.float()).to(x.dtype)


def run_dp(mesh: Mesh, batch: int, run: Callable[[slice], torch.Tensor]):
    """``run(sl)`` on this rank's slice ``sl`` of a batch of ``batch``
    (``batch_slice``), then every slice joined along dim 0, in rank
    order, by an all-gather over the batch group (over the dp group where
    the fsdp ranks of a dp slice ran it whole)."""
    sl, repeats = batch_slice(mesh, batch)
    out = run(sl)
    group = mesh.batch_group if repeats == 1 else mesh.dp_group
    n = mesh.batch if repeats == 1 else mesh.dp
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts)
