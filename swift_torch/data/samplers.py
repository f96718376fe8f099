"""Index-stream samplers (deterministic generators, numpy only).

The port's own copy of the parts of ``swift_tpu/data/samplers.py`` it uses,
with the reference semantics (src/swift/data/samplers.py:9-97):

  * ``InfiniteSampler`` — infinite shuffled stream with windowed
    reshuffling (reference :26-52), one replica, single-step;
  * ``AttributeSubset`` — attribute-delegating subset (reference :90-97).
"""

from __future__ import annotations

import numpy as np


class InfiniteSampler:
    """Infinite shuffled index stream with windowed reshuffling: the JAX
    package's ``InfiniteSampler(dataset, rank=0, num_replicas=1,
    shuffle=True, seed=seed)`` (multi-replica striding and the multistep
    offset are not ported)."""

    def __init__(self, dataset, seed: int = 0, window_size: float = 0.5):
        if len(dataset) <= 0:
            raise ValueError("empty dataset")
        self.dataset = dataset
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        rnd = np.random.default_rng(self.seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            yield int(order[i])
            if window >= 2:
                j = (i - rnd.integers(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


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
