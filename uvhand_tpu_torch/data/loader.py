"""Data loading: threaded or forked host workers, and device prefetch.

Port of `uvhand_tpu/data/loader.py` (the reference's torch DataLoader and
CUDA-stream prefetcher, `datasets/arctic_prefetcher.py`). `DataLoader` and
`prefetch_samples` are copies: cv2/numpy decode and augmentation run in a
worker pool, batches in the seeded per-epoch order. `device_prefetch` keeps
`buffer` batches in flight to the card: each batch is copied from pinned
host memory with non-blocking copies on a side CUDA stream, the consuming
stream waits for that batch's copies (an event), and every tensor is
recorded on the consuming stream so that the allocator does not hand its
memory to the side stream while the step still reads it. Without these the
copy would either race the step or be a silent synchronize.

Worker modes:
  - "thread" (default): cv2 releases the GIL during imread/warp, so threads
    scale on the decode-heavy path with zero IPC cost,
  - "process": fork-based ProcessPoolExecutor for python-bound __getitem__
    work. The dataset is shared with children copy-on-write via a module
    registry: nothing is pickled per task except the integer index and the
    returned sample.
"""

from __future__ import annotations

import collections
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .arctic import collate

#: fork-inherited dataset registry for process workers (copy-on-write)
_FORK_DATASETS: dict = {}


def _process_getitem(args):
    key, idx = args
    return _FORK_DATASETS[key][idx]


class DataLoader:
    """Minimal deterministic loader: shuffle per epoch, drop_last for train."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        collate_fn: Callable = collate,
        workers_mode: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.workers_mode = workers_mode
        # two pools: batch orchestration and per-sample work. A single pool
        # deadlocks — fetch() runs IN the pool and would block on map() into
        # the same saturated pool.
        self.batch_pool = ThreadPoolExecutor(max_workers=2)
        if workers_mode == "process":
            self._ds_key = id(dataset)
            _FORK_DATASETS[self._ds_key] = dataset
            self.sample_pool = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("fork"),
            )
        else:
            self.sample_pool = ThreadPoolExecutor(max_workers=num_workers)
        self.epoch = 0

    def _get_samples(self, batch_ids):
        if self.workers_mode == "process":
            return list(self.sample_pool.map(
                _process_getitem, [(self._ds_key, int(i)) for i in batch_ids]
            ))
        return list(self.sample_pool.map(self.dataset.__getitem__, batch_ids))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close(self):
        """Stop the worker pools (pending fetches are dropped)."""
        self.batch_pool.shutdown(wait=False, cancel_futures=True)
        self.sample_pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        nb = len(self)
        # pipeline: submit fetches for a couple of batches ahead
        ahead = 3
        futures = collections.deque()

        def fetch(batch_ids):
            return self.collate_fn(self._get_samples(batch_ids))

        submit = 0
        for b in range(nb):
            while submit < min(nb, b + ahead):
                ids = idx[submit * self.batch_size : (submit + 1) * self.batch_size]
                futures.append(self.batch_pool.submit(fetch, ids))
                submit += 1
            yield futures.popleft().result()


def prefetch_samples(dataset, chunks: Sequence[Sequence[int]], ahead: int = 3,
                     workers: int = 8):
    """Yield `[dataset[i] for i in chunk]` per chunk, decoded in a thread
    pool `ahead` chunks in advance. Used by the sequence-eval and
    submission-extraction host loops so cv2 decode overlaps device compute
    (the reference leans on torch DataLoader workers for the same,
    extract_predicts.py:99-130)."""
    sample_pool = ThreadPoolExecutor(max_workers=workers)
    chunk_pool = ThreadPoolExecutor(max_workers=2)
    try:
        def fetch(ids):
            return list(sample_pool.map(dataset.__getitem__, ids))

        futures = collections.deque()
        chunks = list(chunks)
        submit = 0
        for c in range(len(chunks)):
            while submit < min(len(chunks), c + ahead):
                futures.append(chunk_pool.submit(fetch, chunks[submit]))
                submit += 1
            yield futures.popleft().result()
    finally:
        sample_pool.shutdown(wait=False)
        chunk_pool.shutdown(wait=False)


def device_prefetch(iterator, device=None, buffer: int = 2):
    """Yield the batches of `iterator` as tensors on `device` (the CUDA card
    unless `device="cpu"`), copied `buffer` batches ahead of the consumer.

    On the card each batch is pinned and copied with non-blocking copies on
    a side stream; before a batch is yielded the current stream waits for
    its copies (an event recorded after them), and each of its tensors is
    recorded on the current stream (`record_stream`), so its memory is not
    reused until the work queued there has read it. On the CPU it is a
    plain conversion."""
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(stream):
            out = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done, pinned

    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= buffer:
            break
    while queue:
        out, done, _ = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in out.values():
            t.record_stream(current)
        yield out
