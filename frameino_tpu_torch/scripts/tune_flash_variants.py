#!/usr/bin/env python
"""The bf16 experiment flash forwards K9 and K10 (``csrc/flash_variants.cu``)
timed against other versions of their source on one NVIDIA GPU, in one run.

``--alt NAME=PATH`` adds a file with the same C entry point
(``flash_variant_bf16``): an edited copy of ``flash_variants.cu`` to try a
design choice (stages, warpgroups), or the parent's ``mma.sync``
``flash_variants.cu`` unpacked with ``git archive`` beside its
``flash_common.cuh``. Every version is built by ``ops/cuda_build.py`` (one
nvcc each, all started together; ptxas's registers, spills and serialised
wgmmas printed) and launched on the same q, k, v and bound at the
experiment shapes, kernel alone (``bf16_flash``, each of the three
bodies), timed with CUDA events in turns (each version once, then again in
reverse order), beside K3 (``v0``, online softmax), K1 (static bound, on q
pre-scaled and its bound) and one ``scaled_dot_product_attention`` call on
the same inputs. Each version's output is held to the port's within 5e-3
relative L2, except a ``--probe NAME=PATH``'s: a copy that computes
something else on purpose (no exp2, say), timed to tell what a piece
costs. The command line and the timing are ``tune_flash_int8.py``'s.

Usage: python -m frameino_tpu_torch.scripts.tune_flash_variants
       [--alt NAME=PATH ...] [--probe NAME=PATH ...] [--shapes wan,cog]
       [--iters 10]
"""

from __future__ import annotations

from frameino_tpu_torch.ops import flash_variants as FV
from frameino_tpu_torch.scripts import tune_flash_int8

SOURCE = "flash_variants"


def bf16_bodies(q, k, v, scale):
    """{wrapper: launch(library)}: K9 and K10's two bodies through their C
    entry, the static ones on ``_bound``'s bound made beforehand."""
    bound = FV._bound(q, k, scale).reshape(1)
    return {name: (lambda lib, body=body: FV.bf16_flash(
        q, k, v, None if body == 1 else bound, body, scale=scale,
        library=lib)) for name, body in FV.BF16_BODIES.items()}


def main(argv=None):
    return tune_flash_int8.run_versions(argv, SOURCE, bf16_bodies)


if __name__ == "__main__":
    main()
