"""Index-stream samplers (deterministic generators, numpy only).

The port's own copy of ``swift_tpu/data/samplers.py``, with the reference
semantics (src/swift/data/samplers.py:9-97):

  * ``InfiniteSampler`` — rank-strided infinite shuffled stream with
    windowed reshuffling; ``set_offset(steps)`` switches to the multistep
    finetune mode, skipping indices whose target would run off the end and
    yielding ``(idx, offset)`` pairs (reference :26-52);
  * ``DeltaBatchSampler`` — one shared Δ per batch, yielding
    ``(idx, offset, delta)`` triples (reference :59-82);
  * ``AttributeSubset`` — attribute-delegating subset (reference :90-97).
"""

from __future__ import annotations

import numpy as np


class InfiniteSampler:
    """Infinite shuffled index stream with windowed reshuffling, every
    ``num_replicas``-th position of it for replica ``rank``. The stream is
    the JAX package's for every rank, offset and seed."""

    def __init__(self, dataset, rank: int = 0, num_replicas: int = 1, shuffle: bool = True,
                 seed: int = 0, window_size: float = 0.5):
        if len(dataset) <= 0:
            raise ValueError("empty dataset")
        if num_replicas <= 0 or not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} of {num_replicas} replicas")
        if not 0 <= window_size <= 1:
            raise ValueError(f"window_size {window_size} outside [0, 1]")
        self.dataset = dataset
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size
        self.offset = 1
        # files consumed per extra multistep offset at the widest Δ (the JAX
        # package's guard: the reference reserves one step only)
        intervals = getattr(dataset, "intervals", [6])
        self.max_step_files = max(intervals) // 6 if intervals else 1

    def set_offset(self, offset: int) -> None:
        """How far ahead to offset the dataset, in steps."""
        if not isinstance(offset, int) or offset <= 0:
            raise ValueError(f"offset must be a positive int, got {offset!r}")
        self.offset = offset

    def __iter__(self):
        order = np.arange(len(self.dataset))
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.default_rng(self.seed + self.offset - 1)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                if order[i] + (self.offset - 1) * self.max_step_files < order.size:
                    yield (int(order[i]), self.offset) if self.offset > 1 else int(order[i])
            if window >= 2:
                j = (i - rnd.integers(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class DeltaBatchSampler:
    """Batches of ``batch_size`` consecutive ``sampler`` indices, every
    element of a batch at one Δ drawn from ``intervals`` by its own
    ``np.random.default_rng(seed)``: lists of ``(idx, offset, delta)``."""

    def __init__(self, sampler: InfiniteSampler, batch_size: int, intervals, seed: int = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.intervals = list(intervals)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        batch = []
        for elem in self.sampler:
            batch.append(elem)
            if len(batch) == self.batch_size:
                delta = int(self.rng.choice(self.intervals))
                yield [(*e, delta) if isinstance(e, tuple) else (e, self.sampler.offset, delta)
                       for e in batch]
                batch = []


class AttributeSubset:
    """Subset with attribute delegation to the parent dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, attr):
        return getattr(self.dataset, attr)
