"""Mixed-dataset batch sampling (the port's own copy of
``frameino_tpu/data/sampler.py``).

Reference ``data_loader/sampler.py`` (MixedBatchSampler): one batch
sampler per sub-dataset (so every batch is homogeneous — critical when
datasets differ in resolution/frame count) with the source dataset drawn
per batch by a size-weighted multinomial. Torch-free reimplementation
yielding global index lists over the concatenated dataset.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class MixedBatchSampler:
    def __init__(self, dataset_sizes: Sequence[int], batch_size: int,
                 drop_last: bool = True, seed: int = 0):
        self.sizes = list(dataset_sizes)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])[:-1]
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        per_ds_batches = []
        for size, off in zip(self.sizes, self.offsets):
            perm = rng.permutation(size) + off
            nb = size // self.batch_size if self.drop_last else \
                -(-size // self.batch_size)
            batches = [perm[i * self.batch_size:(i + 1) * self.batch_size]
                       for i in range(nb)]
            per_ds_batches.append([b for b in batches if len(b)])
        counts = np.array([len(b) for b in per_ds_batches], np.float64)
        while counts.sum() > 0:
            probs = counts / counts.sum()
            ds = rng.choice(len(self.sizes), p=probs)
            yield list(per_ds_batches[ds].pop())
            counts[ds] -= 1

    def __len__(self):
        if self.drop_last:
            return sum(s // self.batch_size for s in self.sizes)
        return sum(-(-s // self.batch_size) for s in self.sizes)


class ResumableEpochIterator:
    """Checkpointable epoch/batch iteration state for the train CLIs.

    The reference resumes only the epoch number
    (``train_code/train_wan_motion_FrameINO.py:1096`` computes
    ``first_epoch = global_step // num_update_steps_per_epoch`` and never
    skips consumed batches), so a mid-epoch restart replays or reshuffles
    data. Here the (epoch_seed, batches_done) pair is saved in the
    checkpoint metadata blob and restored, so a resumed run consumes
    exactly the batches an uninterrupted run would have: the same
    ``MixedBatchSampler`` permutation (seeded by ``epoch_seed``) with the
    first ``batches_done`` batches skipped.

    Usage (both train CLIs)::

        it = ResumableEpochIterator(sampler, start_meta)
        while step < max_steps:
            for batch_idx in it.epoch(default_seed=step):
                ...train...; it.advance()
                save_checkpoint(..., metadata=it.meta())
            it.end_epoch()
    """

    def __init__(self, sampler: MixedBatchSampler, meta=None):
        self.sampler = sampler
        meta = meta or {}
        seed = meta.get("epoch_seed")
        self.epoch_seed = None if seed is None else int(seed)
        self.batches_done = (int(meta.get("batches_done", 0))
                             if self.epoch_seed is not None else 0)

    def epoch(self, default_seed: int) -> List[List[int]]:
        """Batches remaining in the current (possibly resumed) epoch.

        Starts a fresh epoch seeded by ``default_seed`` unless a resumed
        mid-epoch position is pending, in which case the interrupted
        epoch's remainder is replayed.
        """
        if self.epoch_seed is None:
            self.epoch_seed = int(default_seed)
            self.batches_done = 0
        self.sampler.set_epoch(self.epoch_seed)
        return [list(b) for b in self.sampler][self.batches_done:]

    def advance(self):
        """Record one batch as fully consumed (call after the step)."""
        self.batches_done += 1

    def end_epoch(self):
        self.epoch_seed = None
        self.batches_done = 0

    def meta(self) -> dict:
        """JSON-serializable iterator state for checkpoint metadata."""
        return {"epoch_seed": self.epoch_seed,
                "batches_done": self.batches_done}
