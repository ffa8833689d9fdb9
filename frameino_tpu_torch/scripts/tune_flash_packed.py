#!/usr/bin/env python
"""The head-pair-packed flash forward K8 (``csrc/flash_packed.cu``) timed
against other versions of its source on one NVIDIA GPU, in one run.

``--alt NAME=PATH`` adds a file with the same C entry point
(``flash_packed_bf16``): an edited copy of ``flash_packed.cu`` to try a
design choice (a consumer warpgroup a head, say), or the parent's
``mma.sync`` ``flash_packed.cu`` unpacked with ``git archive`` beside its
``flash_common.cuh``. Every version is built by ``ops/cuda_build.py`` (one
nvcc each, all started together; ptxas's registers, spills and serialised
wgmmas printed) and launched on the same packed rows, made beforehand from
the CogVideoX protocol shape [2, 48, 15906, 64], kernel alone
(``packed_rows``), timed with CUDA events in turns (each version once,
then again in reverse order), beside K3 (``v0``, online softmax, on the
unpacked heads), K1 and one ``scaled_dot_product_attention`` call on the
same inputs. Each version's output is held to the port's within 5e-3
relative L2, except a ``--probe NAME=PATH``'s: a copy that computes
something else on purpose, timed to tell what a piece costs. The command
line and the timing are ``tune_flash_int8.py``'s.

Usage: python -m frameino_tpu_torch.scripts.tune_flash_packed
       [--alt NAME=PATH ...] [--probe NAME=PATH ...] [--iters 10]
"""

from __future__ import annotations

from frameino_tpu_torch.ops import flash_variants as FV
from frameino_tpu_torch.scripts import tune_flash_int8

SOURCE = "flash_packed"
SHAPES = "cog"   # K8 takes head_dim 64 only


def packed_bodies(q, k, v, scale):
    """{"k8": launch(library)}: K8 through its C entry on the rows of q,
    k, v packed beforehand (its softmax scale is 64 ** -0.5, the
    shape's)."""
    rows = [FV.pack(t).contiguous() for t in (q, k, v)]
    return {"k8": lambda lib: FV.packed_rows(*rows, library=lib)}


def main(argv=None):
    return tune_flash_int8.run_versions(argv, SOURCE, packed_bodies, SHAPES)


if __name__ == "__main__":
    main()
