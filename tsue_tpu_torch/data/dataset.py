"""Sharded batch iteration over fixed-shape arrays.

The port's copy of ``tsue_tpu/data/dataset.py`` (``tests/test_torch_data.py``
holds its batches bit-identical to the original's).  It replaces the
reference's ``DataLoader`` + ``DistributedSampler`` (ref scripts/train.py:
1092-1098): because the dataset is a struct of fixed-shape NumPy arrays,
"loading" is pure indexing — a seeded global permutation, sliced per
process, gathered into contiguous batches.  Each process yields its shard
of every global batch.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from tsue_tpu_torch.data.windowing import WindowedDataset


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class BatchIterator:
    """Epoch iterator with DistributedSampler semantics.

    - seeded per-epoch shuffle (ref ``set_epoch``, scripts/train.py:1153);
    - every process sees the same permutation and takes its strided slice;
    - the tail is padded by wrapping around (like DistributedSampler's
      sample-repetition) so every batch has the full static batch size; a
      ``valid`` mask flags the padding so metrics can ignore it.
    """

    def __init__(self, dataset: WindowedDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 42,
                 process_index: int = 0, process_count: int = 1,
                 drop_remainder: bool = False,
                 group_by_track: bool = False,
                 length_buckets=()):
        if batch_size % process_count != 0:
            raise ValueError(
                f"process_count={process_count} must divide global "
                f"batch_size={batch_size}")
        self.ds = dataset
        self.batch_size = batch_size
        self.per_process = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_remainder = drop_remainder
        self.group_by_track = group_by_track
        self.length_buckets = tuple(sorted(length_buckets))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.ds)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        if n == 0:
            return
        if self.shuffle and self.group_by_track:
            # TrackGroupSampler semantics (ref scripts/im_kim_train_GRN.py:
            # 837-857): shuffle track groups, keep a track's windows
            # contiguous in dataset order
            rng = np.random.default_rng(self.seed + self.epoch)
            tids = np.asarray(self.ds.track_id)
            uniq = list(dict.fromkeys(tids.tolist()))  # first-seen order
            order = rng.permutation(len(uniq))
            perm = np.concatenate(
                [np.nonzero(tids == uniq[g])[0] for g in order])
        elif self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            perm = rng.permutation(n)
        else:
            perm = np.arange(n)
        num_batches = len(self)
        total = num_batches * self.batch_size
        if total > n:
            # wrap around as many times as needed (datasets smaller than
            # half a batch require multiple repeats)
            reps = -(-total // n)
            perm = np.tile(perm, reps)[:total]
            valid_by_pos = np.ones(total, bool)
            valid_by_pos[n:] = False
        else:
            perm = perm[:total]
            valid_by_pos = np.ones(total, bool)

        for b in range(num_batches):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            idx = perm[sl]
            vmask = valid_by_pos[sl]
            # per-process CONTIGUOUS shard: under a ("data", ...) mesh a
            # process's local devices hold consecutive global batch
            # positions, so contiguous slicing makes the assembled global
            # batch row order IDENTICAL to a single-process run — training
            # and per-row dropout are invariant to the process topology
            # (tests/test_two_process.py pins 2x4 == 1x8).  The
            # reference's DistributedSampler strides instead
            # (ref scripts/train.py:1092-1098), which permutes rows.
            lo = self.process_index * self.per_process
            shard = slice(lo, lo + self.per_process)
            batch = self.ds.slice(idx[shard]).as_batch_dict()
            batch["valid"] = vmask[shard].astype(np.float32)
            self._trim_text(batch, idx)
            yield batch

    def _trim_text(self, batch: Dict[str, np.ndarray], global_idx):
        """Trim text arrays to the smallest length bucket covering the
        GLOBAL batch's longest row (config DataConfig.length_buckets).

        The bucket is chosen from the full global index, not the local
        shard, so every process picks the same shape (multi-process jit
        programs must agree).  Pad positions are attention-masked and
        label-masked, so trimming is metric-neutral."""
        if not self.length_buckets or "attention_mask" not in batch:
            return
        width = batch["attention_mask"].shape[1]
        if width <= 1:
            return
        longest = int(self.ds.attention_mask[global_idx].sum(axis=1).max())
        bucket = next((b for b in self.length_buckets if b >= longest),
                      width)
        if bucket >= width:
            return
        for k in ("input_ids", "attention_mask", "labels"):
            if k in batch:
                batch[k] = batch[k][:, :bucket]
