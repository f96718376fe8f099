"""Host-side input pipeline: batch assembly + background prefetch.

The port's counterpart of ``swift_tpu/data/pipeline.py::BatchLoader``:
batches are assembled ahead of time by a producer thread (per-file reads on
a thread pool) and handed over through a bounded queue, as numpy arrays
(the trainer moves them to the device).

Batch dict layout (NHWC):
  ``x``     (B, H, W, C+F) standardized condition
  ``t``     (B, H, W, C)   standardized (residual) target
  ``idx``   (B,)           source indices
  ``delta`` (B, 1)         Δ/10 auxiliary conditioning
plus, when ``multistep_forcings`` is set, ``forcings_seq`` of shape
(B, steps, H, W, F): the standardized forcings at each unrolled step's
input time, which the multistep CRPS loss consumes (the reference reads
them from disk inside the loss, loss.py:380-395).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from swift_torch.utils.log import get_logger

logger = get_logger(__name__)

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
    """Iterate batches of ``batch_size`` consecutive ``sampler`` yields (ints
    or ``(idx, offset[, delta])`` tuples), or the batches ``batch_sampler``
    yields, assembled ahead by a producer thread.

    Where ``<root>/<split>.pack`` exists (``swift_torch.native.pack``) and
    ``use_pack`` is set, single-step residual batches come from the
    native loader, one call for each distinct Δ of a batch, scattered back
    in batch order; multistep batches (an offset past 1, or
    ``multistep_forcings``) and datasets without a pack are read file by
    file on a thread pool. A missing Δ is drawn from the dataset's RNG in
    the producer thread, in batch order, so the stream is a pure function of
    the seeds on either route.

    ``set_offset(steps)`` forwards to the sampler; a new ``iter()`` after it
    starts a new producer. Closing an iterator (the trainer closes the old
    one at a switch) stops its producer and joins it: no batch it built
    reaches a later iterator.
    """

    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 4,
                 multistep_forcings: int = 0, batch_sampler=None, use_pack: bool = True):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_sampler = batch_sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.multistep_forcings = multistep_forcings
        self._pack = None
        root = getattr(dataset, "root", None)
        if use_pack and getattr(dataset, "residual", False) and root:
            path = os.path.join(root, f"{getattr(dataset, 'split', 'train')}.pack")
            if os.path.exists(path):
                from swift_torch.native import PackedDataset

                self._pack = PackedDataset(path)
                logger.info(f"BatchLoader: single-step batches from {path} (native loader)"
                            + ("; multistep batches file by file" if multistep_forcings else ""))
        if self._pack is None:
            logger.info("BatchLoader: batches read file by file")

    def set_offset(self, steps: int) -> None:
        """The multistep offset of the samples to come (next ``iter()``)."""
        self.sampler.set_offset(steps)

    def _resolve_specs(self, specs) -> list:
        """Every spec as ``(idx, offset, delta)``, a missing Δ drawn here from
        the dataset's RNG, in batch order. Datasets without interval
        semantics pass through untouched."""
        ds = self.dataset
        if not hasattr(ds, "intervals") or getattr(ds, "_rng", None) is None:
            return list(specs)
        out = []
        for s in specs:
            if isinstance(s, tuple):
                (idx, off), delta = (s[:2], s[2]) if len(s) == 3 else (s, None)
            else:
                idx, off, delta = s, 1, None
            if delta is None:
                delta = int(ds._rng.choice(ds.intervals))
            out.append((int(idx), int(off), int(delta)))
        return out

    def _pack_batch(self, specs) -> Optional[dict]:
        """The native batch of resolved single-step specs, one native call for
        each distinct Δ (the C++ side applies one target std a call); None
        for a multistep batch."""
        if any(s[1] != 1 for s in specs):
            return None
        ds = self.dataset
        idx = np.asarray([i for i, _, _ in specs], np.int64)
        deltas = np.asarray([d for _, _, d in specs], np.int64)
        x_out = t_out = None
        for delta in np.unique(deltas):
            m = deltas == delta
            xs, ts = self._pack.batch(idx[m], idx[m] + int(delta) // 6, idx[m],
                                      ds.x_means.reshape(-1), ds.x_stds.reshape(-1),
                                      ds.t_stds[int(delta)].reshape(-1), len(ds.variables))
            xs, ts = ds.zero_field(xs, int(delta)), ds.zero_field(ts, int(delta))
            if x_out is None:
                x_out = np.empty((len(specs),) + xs.shape[1:], xs.dtype)
                t_out = np.empty((len(specs),) + ts.shape[1:], ts.dtype)
            x_out[m], t_out[m] = xs, ts
        return {"x": x_out, "t": t_out, "idx": idx.astype(np.int32),
                "delta": (deltas.astype(np.float32) / 10.0).reshape(-1, 1)}

    def _index_batches(self) -> Iterator[list]:
        if self.batch_sampler is not None:
            yield from iter(self.batch_sampler)
            return
        batch = []
        for spec in self.sampler:
            batch.append(spec)
            if len(batch) == self.batch_size:
                yield batch
                batch = []

    def stage_forcings(self, specs, samples) -> np.ndarray:
        """(B, steps, H, W, F): for each spec, with its dataset item in
        ``samples`` (whose Δ/10 sets the stride), the standardized forcings
        at idx + i·Δ/6 files for each step i, clamped to the last file (the
        JAX package's input-time indexing, reference loss.py:387)."""
        ds, seqs = self.dataset, []
        for s, (_, d) in zip(specs, [sm[1] for sm in samples]):
            idx = s[0] if isinstance(s, tuple) else s
            delta10 = float(d) * 10
            per_step = []
            for i in range(self.multistep_forcings):
                j = min(int(idx + i * delta10 // 6), len(ds.files) - 1)
                per_step.append(ds.standardize_x(ds.get_forcings(j)))
            seqs.append(np.stack(per_step, 0))
        return np.stack(seqs, 0).astype(np.float32)

    def _build_batch(self, specs, pool) -> dict:
        specs = self._resolve_specs(specs)
        if self._pack is not None and self.multistep_forcings == 0:
            fast = self._pack_batch(specs)
            if fast is not None:
                return fast
        samples = list(pool.map(self.dataset.__getitem__, specs))
        out = _collate(samples)
        if self.multistep_forcings > 0 and getattr(self.dataset, "forcings", None):
            out["forcings_seq"] = self.stage_forcings(specs, samples)
        return out

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for specs in self._index_batches():
                    if stop.is_set() or not put(self._build_batch(specs, pool)):
                        return
                put(None)
            except BaseException as e:  # propagate to the consumer
                put(e)

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
            thread.join()
            pool.shutdown(wait=True)
