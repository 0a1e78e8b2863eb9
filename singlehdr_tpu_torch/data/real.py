"""HDR-Real training pipeline over record files (the port's copy of
``singlehdr_tpu.data.real``: the same draws, the same NHWC numpy batches).

Parse/augment semantics follow the reference input fn
(finetune_real_dataset.py:34-61): HDR renormalized to mean 0.5, LDR scaled to
[0,1], a joint random horizontal flip, and a joint random rot90.  Batches are
shuffled uniformly over the global record index.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from singlehdr_tpu_torch.data.records import RecordDataset


def open_record_dataset(record_dir: str, prefix: str = "train"):
    """Open finetune records: the framework's ``.shdrec`` shards, or —
    when the directory holds the reference's own ``*.tfrecords`` GZIP
    shards (convert_to_tf_record.py output) — the dependency-free
    TFRecord/Example reader, so reference-format data feeds directly."""
    import glob as _glob
    import os as _os

    if _glob.glob(_os.path.join(record_dir, f"{prefix}_*.shdrec")):
        return RecordDataset(record_dir, prefix)
    if _glob.glob(_os.path.join(record_dir, "*.tfrecords")):
        from singlehdr_tpu_torch.data.tfrecord import TfrecordExampleDataset

        return TfrecordExampleDataset(record_dir)
    return RecordDataset(record_dir, prefix)  # raises with the shdrec message


def augment_pair(
    hdr: np.ndarray, ldr: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    if rng.rand() < 0.5:
        hdr = np.flip(hdr, 1)
        ldr = np.flip(ldr, 1)
    k = rng.randint(4)
    hdr = np.rot90(hdr, k)
    ldr = np.rot90(ldr, k)
    return hdr, ldr


class HdrRealPipeline:
    """Iterator of normalized, augmented (ldr f32 [0,1], hdr f32) batches."""

    def __init__(
        self,
        record_dir: str,
        batch_size: int = 4,
        training: bool = True,
        seed: int = 0,
        prefix: str = "train",
    ):
        self._ds = open_record_dataset(record_dir, prefix)
        self._batch = batch_size
        self._training = training
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self._ds)

    def steps_per_epoch(self) -> int:
        return (len(self._ds) + self._batch - 1) // self._batch

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass over the records in shuffled order (last batch may be short
        — the reference batches with drop_remainder=False)."""
        order = self._rng.permutation(len(self._ds))
        for s in range(0, len(order), self._batch):
            idxs = order[s : s + self._batch]
            ldrs, hdrs = [], []
            for i in idxs:
                hdr, ldr_u8 = self._ds[int(i)]
                hdr = 0.5 * hdr / (1e-6 + hdr.mean())
                ldr = ldr_u8.astype(np.float32) / 255.0
                if self._training:
                    hdr, ldr = augment_pair(hdr, ldr, self._rng)
                hdrs.append(np.ascontiguousarray(hdr))
                ldrs.append(np.ascontiguousarray(ldr))
            yield np.stack(ldrs), np.stack(hdrs)
