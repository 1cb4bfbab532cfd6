"""Epoch-based data loader (torch port of `lseg_tpu/data/loader.py`).

The same index stream as the reference (at its default seed 0):
`RandomState(epoch)` shuffles `arange(len(dataset))`, the tail that does
not fill a batch is dropped, `set_epoch` reseeds the shuffle and is passed on
to the dataset, and an epoch that runs to its end moves the loader on to
the next one. A thread pool decodes the samples of the next batch while
the current one is used. Batches are {'image': (N, H, W, 3) fp32,
'target': (N, H, W) int64} on an explicit device (a rank's own card).

Data parallel, with the JAX package's multi-process semantics: process
`process_index` of `process_count` loads its contiguous shard of the
epoch-shuffled index stream in batches of `batch_size` (its own rows),
and `__len__` counts the batches of a shard; the global batch b is the
ranks' batches b one after another. With `accumulate > 1` a rank's
batch b is instead its part of each of the global batch's micro-batches
(`parallel.dist.rank_rows`), so that its local micro-batch i and the
other ranks' together are the global micro-batch i, as the train step
needs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from lseg_tpu_torch.parallel.dist import rank_rows


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, device="cuda", process_count: int = 1,
                 process_index: int = 0, accumulate: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.device = torch.device(device)
        self.process_count = process_count
        self.process_index = process_index
        self.accumulate = accumulate
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.dataset) // self.process_count // self.batch_size

    def _stream(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(idx)
        return idx

    def _shard(self, idx: np.ndarray, q: int) -> np.ndarray:
        """Process q's contiguous shard of the index stream `idx`."""
        per = len(idx) // self.process_count
        return idx[q * per:(q + 1) * per]

    def _batches(self):
        bs, w = self.batch_size, self.process_count
        stream = self._stream()
        if w == 1 or self.accumulate == 1:
            idx = self._shard(stream, self.process_index)
            return [idx[b * bs:(b + 1) * bs] for b in range(len(self))]
        shards = [self._shard(stream, q) for q in range(w)]
        rows = rank_rows(w * bs, self.process_index, w,
                         self.accumulate).numpy()
        return [np.concatenate([s[b * bs:(b + 1) * bs] for s in shards])[rows]
                for b in range(len(self))]

    def _collate(self, samples) -> Dict[str, torch.Tensor]:
        pin = self.device.type == "cuda"
        out = {}
        for key, dtype in (("image", torch.float32),
                           ("target", torch.int64)):
            t = torch.from_numpy(np.stack([s[key] for s in samples])).to(
                dtype)
            if pin:
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=pin)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        batches = self._batches()
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(sel):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in sel]

            pending = submit(batches[0]) if batches else []
            for b in range(len(batches)):
                samples = [f.result() for f in pending]
                if b + 1 < len(batches):
                    pending = submit(batches[b + 1])
                yield self._collate(samples)
        self.epoch += 1
