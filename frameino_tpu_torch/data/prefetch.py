"""Host-side batch prefetching for the training entry points (the
port's own copy of ``frameino_tpu/data/prefetch.py``).

Counterpart of the reference's ``DataLoader(num_workers=4)`` (reference
``train_code/train_wan_motion_FrameINO.py:971-1011``): ffmpeg decode +
trajectory rasterization are CPU-bound and must overlap the device step.
A thread pool assembles batches ahead of consumption into a bounded
queue; threads (not processes) suffice because the heavy work is in
cv2/ffmpeg/numpy which release the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional


class BatchPrefetcher:
    """Iterate ``(make_batch(idxs) for idxs in index_batches)`` with
    ``depth`` batches prepared ahead by ``num_workers`` threads.

    Exceptions raised inside workers surface on the consumer thread at
    the position of the failing batch (ordering is preserved).
    """

    def __init__(self, make_batch: Callable, index_batches: Iterable,
                 num_workers: int = 2, depth: int = 4):
        self.make_batch = make_batch
        self.batches: List = list(index_batches)
        self.depth = max(1, depth)
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator:
        if not self.batches:
            return iter(())
        slots: List[Optional[queue.Queue]] = [queue.Queue(maxsize=1)
                                              for _ in self.batches]
        next_idx = {"i": 0}
        lock = threading.Lock()
        sem = threading.Semaphore(self.depth)

        def worker():
            while True:
                sem.acquire()
                with lock:
                    i = next_idx["i"]
                    if i >= len(self.batches):
                        sem.release()
                        return
                    next_idx["i"] = i + 1
                try:
                    slots[i].put(("ok", self.make_batch(self.batches[i])))
                except BaseException as e:  # noqa: BLE001 - resurface
                    slots[i].put(("err", e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def gen():
            try:
                for i in range(len(self.batches)):
                    kind, payload = slots[i].get()
                    sem.release()
                    if kind == "err":
                        raise payload
                    yield payload
            finally:
                with lock:
                    next_idx["i"] = len(self.batches)
                # wake any workers parked in sem.acquire so they observe
                # the exhausted index and exit (an early consumer break
                # would otherwise strand them for the process lifetime)
                for _ in range(self.num_workers):
                    sem.release()

        return gen()
