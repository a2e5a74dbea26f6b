"""Data loader with background prefetch (the port's copy of
``mssvt_tpu/datasets/loader.py``).

Replaces the reference's torch DataLoader + DistributedSampler
(ref: pcdet/datasets/__init__.py:45-74) with the JAX package's
framework-free loader: ``dataset[i] -> collate`` on the host, optionally in
one prefetch thread that runs ahead of the consumer by ``prefetch`` batches,
and per-rank sharding as DistributedSampler's rank/num_replicas split. The
same index order, shards and padded last batch (``n_real``) as the JAX
loader, except that a training loader of several ranks repeats its first
frames so that every rank takes as many steps (DistributedSampler's
padding; a DDP step needs all ranks). Unlike it, a failure in the prefetch thread is raised in the
consumer, and leaving an iteration early stops and joins the thread, so two
threads never draw from the dataset's random state at once.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

_END = object()


class _Failure:
    def __init__(self, exc):
        self.exc = exc


class Loader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=0,
                 seed=0, drop_last=True, rank=0, world_size=1, prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.prefetch = prefetch
        self.epoch = 0
        self._merged_epochs = None
        # host seconds spent making each batch (dataset items + collate)
        self.make_seconds = []

    def set_epoch(self, epoch):
        self.epoch = epoch

    def merge_all_iters_to_one_epoch(self, merge: bool = True,
                                     epochs: int = 1):
        """Fold ``epochs`` independently-shuffled passes into one epoch-long
        stream (ref: datasets/__init__.py:69-74 + dataset.py
        merge_all_iters_to_one_epoch)."""
        self._merged_epochs = int(epochs) if merge else None

    def _indices(self):
        n = len(self.dataset)
        if self._merged_epochs:
            parts = []
            for e in range(self._merged_epochs):
                idx_e = np.arange(n)
                if self.shuffle:
                    rng = np.random.default_rng(self.seed + e)
                    idx_e = rng.permutation(n)
                parts.append(idx_e)
            idx = np.concatenate(parts)
        else:
            idx = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                idx = rng.permutation(n)
        # rank sharding (as DistributedSampler); in training every rank gets
        # as many frames (the first ones repeat), since the ranks of a DDP
        # step must take the same number of steps
        if self.drop_last and self.world_size > 1:
            total = -(-len(idx) // self.world_size) * self.world_size
            idx = np.concatenate([idx, idx[:total - len(idx)]])
        idx = idx[self.rank::self.world_size]
        steps = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            steps += 1
        return idx, steps

    def __len__(self):
        _, steps = self._indices()
        return steps

    def _make_batch(self, batch_idx):
        t0 = time.perf_counter()
        samples = [self.dataset[int(i)] for i in batch_idx]
        n_real = len(samples)
        # static shapes: a partial final batch (drop_last=False) is padded by
        # repeating the last sample; `n_real` lets consumers skip the pads
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        batch = self.dataset.collate_batch(samples)
        batch["n_real"] = n_real
        self.make_seconds.append(time.perf_counter() - t0)
        return batch

    def __iter__(self):
        idx, steps = self._indices()
        batches = [
            idx[s * self.batch_size:(s + 1) * self.batch_size]
            for s in range(steps)
        ]
        if self.num_workers <= 0:
            for b in batches:
                yield self._make_batch(b)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set() or not put(self._make_batch(b)):
                        return
                put(_END)
            except Exception as exc:  # handed to the consumer, raised there
                put(_Failure(exc))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join()


def build_dataloader(dataset_cfg, class_names, batch_size, training,
                     workers=4, seed=0, logger=None, root_path=None,
                     rank=0, world_size=1, data_seed=None):
    """Dataset + Loader construction (ref: datasets/__init__.py:45-74).

    ``seed`` orders the shuffle (as the JAX loader's); ``data_seed`` seeds
    the dataset's random state (augmentation, point shuffling), which the
    JAX package leaves to numpy's global stream.
    """
    from . import build_dataset

    dataset = build_dataset(
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger, seed=data_seed,
    )
    loader = Loader(
        dataset, batch_size=batch_size, shuffle=training,
        num_workers=workers, seed=seed, drop_last=training,
        rank=rank, world_size=world_size,
    )
    return dataset, loader
