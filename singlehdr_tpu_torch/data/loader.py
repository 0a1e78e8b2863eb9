"""Asynchronous host-side sample loader (the port's copy of
``RandomSampleLoader`` from ``singlehdr_tpu.data.loader``).

Replaces the reference's 1+24-process ``RandDatasetReader`` (dataset.py:315-363)
with a thread-pool sampler: one shuffler generating a random index stream and N
workers materializing samples into a bounded queue.  Threads (not processes)
suffice because the heavy lifting — cv2 decode/resize — releases the GIL, and
they avoid pickling 512^2 float32 patches across process boundaries.  The
upload to the card is ``train.loop.SynthBatchPipeline``'s.

``DeviceFeeder`` keeps batches moved to the device in flight, by default
this rank's share of each (``parallel.shard_batch``).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np

from singlehdr_tpu_torch.data.datasets import SizedDataset
from singlehdr_tpu_torch.parallel.mesh import shard_batch


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


class _FeederError:
    """Carries the producer's exception across the queue."""

    def __init__(self, error: BaseException):
        self.error = error


class DeviceFeeder:
    """Keeps ``depth`` ready-to-train device batches in flight.

    ``transform`` runs on the host batch (e.g. the JPEG round-trip);
    ``put_fn`` moves it to the device, by default this rank's
    ``shard_batch`` on ``mesh``.  An exception in ``next_host_batch``,
    ``transform`` or ``put_fn`` ends the producer and is raised by the next
    ``__next__`` (the JAX package's feeder thread dies on one and leaves its
    consumer blocked)."""

    def __init__(
        self,
        next_host_batch: Callable[[], Any],
        put_fn: Optional[Callable[[Any], Any]] = None,
        transform: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
        mesh=None,
    ):
        if put_fn is None:
            if mesh is None:
                raise ValueError("DeviceFeeder needs a put_fn or a mesh")
            put_fn = functools.partial(shard_batch, mesh)
        self._next = next_host_batch
        self._put = put_fn
        self._transform = transform or (lambda x: x)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="feeder")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._put(self._transform(self._next()))
            except Exception as e:  # re-raised by __next__ in the consumer
                item = _FeederError(e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _FeederError):
                return

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if isinstance(item, _FeederError):
            raise item.error
        return item

    def close(self) -> None:
        """Stop the producer and join it."""
        self._stop.set()
        while self._thread.is_alive():
            try:  # unblock the producer if it is waiting on a full queue
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
