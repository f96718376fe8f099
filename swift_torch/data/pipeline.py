"""Host-side input pipeline: batch assembly + background prefetch.

The port's counterpart of ``swift_tpu/data/pipeline.py::BatchLoader``:
batches are assembled ahead of time by a thread pool and handed over through
a bounded queue, as numpy arrays (the trainer moves them to the device).
The native ``.pack`` route and the multistep forcing sequences are not
ported.

Batch dict layout (NHWC):
  ``x``     (B, H, W, C+F) standardized condition
  ``t``     (B, H, W, C)   standardized (residual) target
  ``idx``   (B,)           source indices
  ``delta`` (B, 1)         Δ/10 auxiliary conditioning
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

_PREFETCH = 2  # batches assembled ahead of the consumer


def _collate(samples) -> dict:
    xs, ts, idxs, deltas = [], [], [], []
    for (x, t), (idx, delta) in samples:
        xs.append(x)
        ts.append(t)
        idxs.append(idx)
        deltas.append(delta)
    return {
        "x": np.stack(xs, 0),
        "t": np.stack(ts, 0),
        "idx": np.asarray(idxs, np.int32),
        "delta": np.asarray(deltas, np.float32).reshape(-1, 1),
    }


class BatchLoader:
    """Iterate batches of ``batch_size`` consecutive ``sampler`` indices,
    assembled concurrently by a thread pool (h5py releases the GIL on IO).
    Each sample's Δ is drawn from the dataset's RNG in the producer thread,
    in batch order, so the sample stream is a pure function of the seeds."""

    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def _resolve_specs(self, specs) -> list:
        """(idx, 1, Δ) for each index, Δ drawn here from the dataset's RNG,
        in batch order."""
        ds = self.dataset
        return [(int(i), 1, int(ds._rng.choice(ds.intervals))) for i in specs]

    def _index_batches(self) -> Iterator[list]:
        batch = []
        for spec in self.sampler:
            batch.append(spec)
            if len(batch) == self.batch_size:
                yield batch
                batch = []

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def producer():
            try:
                for specs in self._index_batches():
                    if stop.is_set():
                        break
                    specs = self._resolve_specs(specs)
                    q.put(_collate(list(pool.map(self.dataset.__getitem__, specs))))
                q.put(None)
            except BaseException as e:  # propagate to the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a producer waiting on the full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False)
