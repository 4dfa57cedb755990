"""Host-side data pipeline: sharded sampling and threaded prefetch (the JAX
package's ``dctseg/data/pipeline.py``).

A deterministic per-epoch shuffle partitioned across data-parallel shards
(``set_epoch`` semantics), worker threads decoding NIfTI and building edge
maps while the device computes, and a bounded prefetch queue.  Batches hold
CPU tensors (images) and numpy arrays (labels); the engines move images to
the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List

import numpy as np
import torch

from dctseg_torch.data.brats import BraTSDataset, Sample


class Batch:
    """Stacked batch: ``x`` a CPU tensor, the rest numpy."""

    def __init__(self, samples: List[Sample]):
        self.x = torch.stack([s.x for s in samples])
        self.target = (np.stack([s.target for s in samples])
                       if samples[0].target is not None else None)
        self.edge = (np.stack([s.edge for s in samples])
                     if samples[0].edge is not None else None)
        self.missing_modal = np.stack([s.missing_modal for s in samples])
        self.names = [s.name for s in samples]
        self.paths = [s.path for s in samples]
        self.affines = [s.affine for s in samples]
        self.source_shapes = [s.source_shape for s in samples]
        self.crop_origins = [s.crop_origin for s in samples]


def shard_indices(n: int, epoch: int, seed: int, shard: int,
                  num_shards: int, shuffle: bool) -> List[int]:
    """DistributedSampler-equivalent: same permutation on every shard
    (seeded by epoch), round-robin partition, padded to equal length."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(n)
    per = -(-n // num_shards)
    padded = np.resize(idx, per * num_shards)  # wrap-around padding
    return list(padded[shard::num_shards])


class PrefetchLoader:
    """Iterates a dataset epoch with worker-thread prefetch."""

    def __init__(self, dataset: BraTSDataset, batch_size: int = 1,
                 shard: int = 0, num_shards: int = 1, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 1000):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_shard = -(-len(self.dataset) // self.num_shards)
        return -(-per_shard // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        indices = shard_indices(len(self.dataset), self.epoch, self.seed,
                                self.shard, self.num_shards, self.shuffle)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]

        job_q: "queue.Queue" = queue.Queue()
        results = {}
        cond = threading.Condition()
        stop = threading.Event()
        nthreads = min(self.num_workers, len(batches))
        # Bound in-flight batches: a permit covers one batch from decode
        # start until the consumer takes it, so workers run at most
        # prefetch*nthreads batches ahead (a full sample is ~50 MB).
        # Acquiring BEFORE pulling a job keeps FIFO progress deadlock-free:
        # the smallest outstanding batch is always held by a permit owner.
        sem = threading.Semaphore(max(1, self.prefetch) * nthreads)

        for bi, b in enumerate(batches):
            job_q.put((bi, b))

        def worker():
            while not stop.is_set():
                while not sem.acquire(timeout=0.5):
                    if stop.is_set():
                        return
                try:
                    bi, idxs = job_q.get_nowait()
                except queue.Empty:
                    sem.release()
                    return
                try:
                    # the crop/augmentation RNG is seeded per (epoch,
                    # sample), so batch content does not depend on which
                    # worker claimed the batch
                    samples = [self.dataset.get(
                        i, (np.random.default_rng(
                            (self.seed, self.epoch, int(i)))
                            if self.dataset.mode == "train" else None))
                        for i in idxs]
                    result = Batch(samples)
                except BaseException as e:  # re-raised by the consumer
                    result = e
                with cond:
                    results[bi] = result
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(nthreads)]
        for t in threads:
            t.start()

        # emit in order; worker exceptions re-raise here instead of hanging
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in results:
                        cond.wait()
                    item = results.pop(bi)
                sem.release()
                if isinstance(item, BaseException):
                    raise item
                yield item
            for t in threads:
                t.join()
        finally:
            stop.set()  # unblock workers if the consumer bails early
