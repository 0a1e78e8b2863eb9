"""Asynchronous host-side sample loader (the port's copy of
``RandomSampleLoader`` from ``singlehdr_tpu.data.loader``).

Replaces the reference's 1+24-process ``RandDatasetReader`` (dataset.py:315-363)
with a thread-pool sampler: one shuffler generating a random index stream and N
workers materializing samples into a bounded queue.  Threads (not processes)
suffice because the heavy lifting — cv2 decode/resize — releases the GIL, and
they avoid pickling 512^2 float32 patches across process boundaries.  The
upload to the card is ``train.loop.SynthBatchPipeline``'s.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Optional

import numpy as np

from singlehdr_tpu_torch.data.datasets import SizedDataset


class RandomSampleLoader:
    """Uniform-without-replacement sample stream over an indexable dataset."""

    def __init__(
        self,
        dataset: SizedDataset,
        batch_size: int,
        n_workers: int = 16,
        seed: int = 0,
        queue_depth: Optional[int] = None,
    ):
        self._dataset = dataset
        self._batch = batch_size
        self._stop = threading.Event()
        self._idx_q: "queue.Queue[int]" = queue.Queue(maxsize=4 * batch_size)
        self._out_q: "queue.Queue[Any]" = queue.Queue(
            maxsize=queue_depth or 4 * batch_size
        )
        self._threads = [
            threading.Thread(
                target=self._shuffle_loop, args=(seed,), daemon=True, name="shuffler"
            )
        ]
        self._threads += [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"loader{i}")
            for i in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    def _shuffle_loop(self, seed: int) -> None:
        rng = np.random.RandomState(seed)
        n = len(self._dataset)
        while not self._stop.is_set():
            # sample a block of indices; full permutations of Cartesian-product
            # datasets (len ~ 1e8) are wasteful, uniform sampling is equivalent
            # for the reference's use (it never completes a permutation epoch)
            for idx in rng.randint(0, n, size=4096):
                if self._stop.is_set():
                    return
                self._idx_q.put(int(idx))

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                idx = self._idx_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._out_q.put(self._dataset[idx])

    def read_batch(self) -> list:
        """Dequeue one batch as a list of per-field stacked arrays."""
        samples = [self._out_q.get() for _ in range(self._batch)]
        n_fields = len(samples[0])
        return [
            np.stack([np.asarray(s[f]) for s in samples], axis=0)
            for f in range(n_fields)
        ]

    def close(self) -> None:
        """Stop and join every thread.  Threads blocked on a full queue wake
        only when an item leaves it, so the queues are drained until all
        threads have seen the stop."""
        self._stop.set()
        while any(t.is_alive() for t in self._threads):
            for q in (self._out_q, self._idx_q):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for t in self._threads:
                t.join(timeout=0.01)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
