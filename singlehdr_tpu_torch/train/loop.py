"""The training loops (counterparts of ``run_synth_training`` and
``run_real_finetune`` in ``singlehdr_tpu.train.loop``): data, degradation,
steps, checkpoints and metrics for per-net pretraining, joint training and
the HDR-Real finetune.

The host half of the feed is the port's copy of the JAX package's numpy code
(the ``RandomSampleLoader`` over ``data.synth.get_train_dataset``, the
``jpeg_roundtrip_batch`` codec).  Per batch, one packed buffer (crf, invcrf,
t as float32, the HDR patch as float16, as in JAX) goes to the card in one
copy from pinned memory; the capture simulation (K1 for the CRF) runs there.
Producer threads prepare batches ahead of the step, so the JPEG round trip of
the next batch overlaps the current step.

Both loops take JAX's ``mesh`` (a ``parallel.DataMesh``): they restore the
checkpoint on every rank, replicate rank 0's state, train each rank on its
share of the global batch (its samples and, on a spatial mesh, its band of
their rows), and write checkpoints and summaries on rank 0 only.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from singlehdr_tpu_torch.data.jpeg import jpeg_roundtrip_batch
from singlehdr_tpu_torch.data.loader import RandomSampleLoader
from singlehdr_tpu_torch.parallel.mesh import (
    band_rows,
    bands,
    check_same_on_bands,
    local_rows,
    replicate,
)
from singlehdr_tpu_torch.ops.degradation import (
    jpeg_quality_ladder,
    loss_mask_from_levels,
    simulate_capture,
)
from singlehdr_tpu_torch.train.checkpoint import CheckpointManager
from singlehdr_tpu_torch.train.metrics import Mean, MetricsWriter
from singlehdr_tpu_torch.train.state import TrainState


@dataclasses.dataclass
class LoopConfig:
    batch_size: int = 16
    iterations: int = 5_000_000     # the reference's "EPOCHS" are iterations
    ckpt_every: int = 1000
    log_every: int = 100
    image_log_every: int = 1000
    n_workers: int = 16
    seed: int = 0
    use_jpeg: bool = True           # False feeds the quantized LDR itself
    prefetch: int = 2               # batches prepared ahead of the step
    prefetch_producers: int = 2     # concurrent next_batch producers


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
                np.dtype(np.uint8): torch.uint8}


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def upload_packed(arrays, device: torch.device) -> list:
    """numpy arrays -> tensors on ``device`` through ONE copy of one packed
    byte buffer (pinned when the device is a GPU)."""
    raw = [np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in arrays]
    host = torch.empty(sum(r.size for r in raw), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.numpy()[:] = np.concatenate(raw)
    buf = host.to(device, non_blocking=True)
    out, off = [], 0
    for a, r in zip(arrays, raw):
        out.append(buf[off:off + r.size].view(_TORCH_DTYPE[a.dtype]).reshape(a.shape))
        off += r.size
    return out


def upload_pair(ldr: np.ndarray, hdr: np.ndarray, device: torch.device) -> tuple:
    """An NHWC (ldr, hdr) host batch -> NCHW tensors on ``device``, through
    one packed upload (``upload_packed``), split and made NCHW on the device."""
    ldr, hdr = upload_packed([np.asarray(ldr, np.float32), np.asarray(hdr, np.float32)], device)
    return to_nchw(ldr), to_nchw(hdr)


class LaggedReadback:
    """Device values read back ``lag`` pushes behind the newest: each pushed
    tensor is copied into pinned host memory as it is pushed, and the host
    waits only for the copy of the one ``lag`` behind (a CUDA event), so the
    device queue stays ``lag`` steps deep without a sync on every step."""

    def __init__(self, lag: int):
        self._lag = lag
        self._pending: collections.deque = collections.deque()
        self._done: list = []

    def push(self, value: torch.Tensor) -> None:
        value = value.detach()
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=value.is_cuda)
        host.copy_(value, non_blocking=True)
        event = None
        if value.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._pending.append((host, event))
        while len(self._pending) > self._lag:
            self._finish()

    def _finish(self) -> None:
        host, event = self._pending.popleft()
        if event is not None:
            event.synchronize()
        self._done.append(host.numpy())

    def drain(self) -> list:
        """Every value pushed, as numpy arrays in push order."""
        while self._pending:
            self._finish()
        return self._done


class SynthBatchPipeline:
    """HDR-Synth step inputs: loader -> upload -> capture simulation on the
    device -> host JPEG -> loss mask.  ``next_batch`` returns NCHW tensors
    ldr / jpeg / clipped_hdr_t / hdr_t, mask [b, 1, 1, 1] and invcrf [b, k]."""

    def __init__(self, dataset, cfg: LoopConfig, device: torch.device):
        self._loader = RandomSampleLoader(dataset, cfg.batch_size, n_workers=cfg.n_workers,
                                          seed=cfg.seed)
        self._cfg = cfg
        self._device = device
        self._qualities = jpeg_quality_ladder(cfg.batch_size)
        self._generator = torch.Generator(device=device).manual_seed(cfg.seed)
        self._lock = threading.Lock()  # the generator is shared by the producers

    def next_batch(self) -> dict:
        hdr, crf, invcrf, t = self._loader.read_batch()
        # float32 fields first: every field then starts at a multiple of its size
        crf, invcrf, t, hdr = upload_packed(
            [np.asarray(crf, np.float32), np.asarray(invcrf, np.float32),
             np.asarray(t, np.float32), np.asarray(hdr, np.float16)], self._device)
        hdr = to_nchw(hdr).float()
        with self._lock:
            sim = simulate_capture(self._generator, hdr, crf, t)
        levels = sim.quantized_u8
        if self._cfg.use_jpeg:
            host = sim.quantized_u8.permute(0, 2, 3, 1).contiguous().cpu().numpy()
            coded = jpeg_roundtrip_batch(host, self._qualities)
            levels = to_nchw(upload_packed([coded], self._device)[0])
        return {
            "ldr": sim.ldr,
            "jpeg": levels.float() / 255.0,
            "clipped_hdr_t": sim.clipped_hdr_t,
            "hdr_t": sim.hdr_t,
            "mask": loss_mask_from_levels(levels),
            "invcrf": invcrf,
        }

    def close(self) -> None:
        self._loader.close()


class _PrefetchError:
    """Carries a producer's exception across the queue."""

    def __init__(self, error: BaseException):
        self.error = error


class _Prefetcher:
    """Runs a batch producer on ``producers`` threads, ``depth`` batches
    ahead; the batch order across producers is not deterministic."""

    def __init__(self, produce: Callable[[], dict], depth: int, producers: int = 1):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    batch = produce()
                except Exception as e:  # re-raised by next() in the consumer
                    batch = _PrefetchError(e)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if isinstance(batch, _PrefetchError):
                    return

        self._threads = [threading.Thread(target=loop, daemon=True, name=f"prefetch{i}")
                         for i in range(max(1, producers))]
        for t in self._threads:
            t.start()

    def next(self) -> dict:
        item = self._q.get()
        if isinstance(item, _PrefetchError):
            raise item.error
        return item

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive() and time.monotonic() < deadline:
                try:  # unblock a producer waiting on a full queue
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)


def rank_feed(cfg: LoopConfig, mesh) -> LoopConfig:
    """The loop config of one rank's feed on a mesh: its data index's share
    of ``cfg.batch_size`` (the global batch, as in JAX) and its seed,
    ``cfg.seed`` itself on data index 0 (a mesh of 1 draws what the meshless
    loop draws) and one drawn from ``(cfg.seed, d)`` on the others, so that
    no two data indices draw the same samples, exposures, curves or noise.
    The S ranks of one data index draw the same samples, and each keeps its
    band of their rows: S times the feed's work for one data index's.  For
    S > 1 the feed has one loader worker and one producer, so that its
    samples, their augmentations and the capture's draws come in one order
    (several threads share the dataset's and the capture's generators in no
    fixed order)."""
    if mesh is None:
        return cfg
    if cfg.batch_size % mesh.data:
        raise ValueError(f"batch {cfg.batch_size} does not split over a data mesh of {mesh.data}")
    seed = cfg.seed if mesh.data_rank == 0 else int(
        np.random.SeedSequence([cfg.seed, mesh.data_rank]).generate_state(1)[0])
    cfg = dataclasses.replace(cfg, batch_size=cfg.batch_size // mesh.data, seed=seed)
    return cfg if bands(mesh) == 1 else dataclasses.replace(cfg, n_workers=1, prefetch_producers=1)


class _NoWriter:
    """The summaries of a rank other than 0: none."""

    def scalar(self, *args) -> None:
        pass

    image = histogram = scalar

    def flush(self) -> None:
        pass

    close = flush


def run_synth_training(*, module_name: str, state: TrainState, step_fn: Callable, dataset,
                       cfg: LoopConfig, ckpt_dir: str, log_dir: str,
                       batch_to_args: Callable[[dict], tuple],
                       writer: Optional[MetricsWriter] = None,
                       image_taps: tuple = (), mesh=None) -> TrainState:
    """Pretraining / joint loop over HDR-Synth (the reference's train.py
    shape): resume from the latest checkpoint in ``ckpt_dir``, train to
    ``cfg.iterations``, checkpoint at step 1 and every ``ckpt_every`` steps
    and at the last step, log the running loss.

    With a data ``mesh`` every rank restores, rank 0's state is replicated,
    and each rank's feed makes its own ``cfg.batch_size / world`` samples a
    step, seeded from ``(cfg.seed, rank)`` (``rank_feed``): the ranks draw
    apart, as the JAX package's processes do, with no stronger guarantee
    (the union of a step is not the meshless loop's batch); on a spatial
    mesh the S ranks of a data index draw the same samples (held by a
    checksum each step, ``check_same_on_bands``) and each trains on its
    band of their rows.  Rank 0 alone saves and logs; the logged
    loss is the global batch's."""
    lead = mesh is None or mesh.rank == 0
    owned_writer = writer is None
    writer = (writer or MetricsWriter(log_dir)) if lead else _NoWriter()
    mgr = CheckpointManager(ckpt_dir)
    state = mgr.restore(state)
    if mesh is not None:
        state = replicate(mesh, state)
    start_step = state.step
    feed = rank_feed(cfg, mesh)
    pipeline = SynthBatchPipeline(dataset, feed, state.device)
    prefetcher = _Prefetcher(pipeline.next_batch, feed.prefetch, feed.prefetch_producers)
    tracker = Mean(f"loss_{module_name}")
    try:
        while state.step < cfg.iterations:
            t0 = time.perf_counter()
            batch = prefetcher.next()
            if bands(mesh) > 1:
                check_same_on_bands(mesh, list(batch.values()))
                batch = band_rows(mesh, batch, spatial_dim=2)
            loss, aux = step_fn(state, *batch_to_args(batch))
            step = state.step
            tracker.update(float(loss))
            if step % cfg.log_every == 0 or step == 1:
                step_time = time.perf_counter() - t0
                writer.scalar(f"{module_name}/loss", tracker.result(), step)
                writer.scalar(f"{module_name}/step_time_s", step_time, step)
                if lead:
                    print(f"[{module_name}] step {step}  loss {tracker.result():.5f}  "
                          f"({step_time:.2f}s/step)", flush=True)
                tracker.reset()
            if step % cfg.image_log_every == 0 or step == 1:
                for tag in image_taps:
                    if tag in aux:
                        writer.image(f"{module_name}/{tag}", aux[tag], step)
                writer.image(f"{module_name}/jpeg", batch["jpeg"], step)
            if lead and (step % cfg.ckpt_every == 0 or step == 1):
                mgr.save(state)
        # the last step, when off the cadence: downstream stages restore it
        if lead and state.step > start_step and state.step != 1 and state.step % cfg.ckpt_every:
            mgr.save(state)
        return state
    finally:
        prefetcher.close()
        pipeline.close()
        mgr.wait()
        mgr.close()
        if owned_writer:
            writer.close()
        else:
            writer.flush()


def pad_tail(batch: tuple, full_bs: int, world: int) -> tuple:
    """JAX's tail rule on a mesh: a batch shorter than ``ceil(full_bs /
    world) * world`` is padded up to it by repeating its last sample (so on
    a mesh of 1 too), which trains the tail's last sample more than once."""
    target = -(-full_bs // world) * world
    short = target - len(batch[0])
    if short <= 0:
        return batch
    return tuple(np.concatenate([a, np.repeat(a[-1:], short, axis=0)]) for a in batch)


def run_real_finetune(*, state: TrainState, step_fn: Callable, pipeline, epochs: int,
                      ckpt_dir: str, log_dir: str,
                      writer: Optional[MetricsWriter] = None, mesh=None) -> TrainState:
    """HDR-Real finetune loop (finetune_real_dataset.py:190-225 shape): resume
    from the latest checkpoint in ``ckpt_dir``, then ``epochs`` passes over
    ``pipeline.epoch()`` (an ``HdrRealPipeline``; the short tail batch is
    trained, as the reference batches without drop_remainder), a checkpoint,
    the epoch's mean loss and time, the stage images and the output's
    histogram after each.  Each batch goes to the state's device in one
    packed upload; step losses are read back a few steps behind the newest
    (``LaggedReadback``), not synced on every step.

    With a data ``mesh`` every rank restores, rank 0's state is replicated,
    every rank reads the same epoch (the pipeline's seed) and trains on its
    share of each batch (its samples and, on a spatial mesh, its band of
    their rows), a short batch padded first over the D data indices
    (``pad_tail``, JAX's rule): a step's union over the ranks is the padded
    global batch.  Rank 0
    alone saves and logs; the logged losses are the global batch's."""
    lead = mesh is None or mesh.rank == 0
    owned_writer = writer is None
    writer = (writer or MetricsWriter(log_dir)) if lead else _NoWriter()
    mgr = CheckpointManager(ckpt_dir)
    state = mgr.restore(state)
    if mesh is not None:
        state = replicate(mesh, state)
    tracker = Mean("loss_ref")
    full_bs = None
    try:
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            tracker.reset()
            aux = {}
            losses = LaggedReadback(lag=4)
            for batch in pipeline.epoch():
                if mesh is not None:
                    full_bs = full_bs or len(batch[0])
                    batch = local_rows(mesh, pad_tail(batch, full_bs, mesh.data))
                _, aux = step_fn(state, *upload_pair(*batch, state.device))
                losses.push(aux["loss_ref"])
            for v in losses.drain():
                tracker.update(v)
            epoch_time = time.perf_counter() - t0
            writer.scalar("ref/loss", tracker.result(), epoch)
            writer.scalar("ref/epoch_time_s", epoch_time, epoch)
            if lead:
                print(f"[ref] epoch {epoch}  loss {tracker.result():.5f}  ({epoch_time:.1f}s)",
                      flush=True)
            for tag in ("c_pred", "b_pred", "a_pred", "out"):
                if tag in aux:
                    writer.image(f"ref/{tag}", aux[tag], epoch)
            if "out" in aux:
                writer.histogram("ref/out_histogram", aux["out"], epoch)
            if lead:
                mgr.save(state)
        return state
    finally:
        mgr.wait()
        mgr.close()
        if owned_writer:
            writer.close()
        else:
            writer.flush()
