"""Weighted same-bucket batching (the port's own copy of
``pea_diffusion_tpu/data/multiplexer.py``; reference
utils/custom_multiplexer.py:21-175 + the mydemux buffer-pressure
demultiplexer).

Re-designed for a host-thread pipeline: one bounded deque per bucket; the
producer routes samples by bucket_id; the consumer picks a bucket by its
sampling probability and emits `batch_size` consecutive samples from that
bucket — so every batch is single-bucket (one set of kernel shapes per
bucket). Buffer pressure is relieved by draining the largest
bucket (the reference's `_find_next` override) instead of blocking, trading
strict weighting for liveness exactly like the reference.
"""
from __future__ import annotations

import random
from collections import deque
from typing import Dict, Iterable, Iterator, List, Sequence


class BucketBatcher:
    def __init__(
        self,
        probs: Sequence[float],
        batch_size: int,
        *,
        buffer_per_bucket: int = 256,
        max_total_buffer: int = 1000,
        seed: int = 0,
    ):
        self.probs = list(probs)
        self.batch_size = batch_size
        self.buffers: List[deque] = [deque() for _ in probs]
        self.buffer_per_bucket = buffer_per_bucket
        self.max_total_buffer = max_total_buffer
        self.rng = random.Random(seed)

    def _total(self) -> int:
        return sum(len(b) for b in self.buffers)

    def _ready(self) -> List[int]:
        return [i for i, b in enumerate(self.buffers)
                if len(b) >= self.batch_size]

    def _pick(self, ready: List[int]) -> int:
        w = [self.probs[i] for i in ready]
        return self.rng.choices(ready, weights=w, k=1)[0]

    def _pop_batch(self, i: int) -> List:
        return [self.buffers[i].popleft() for _ in range(self.batch_size)]

    def _pick_any(self) -> int:
        return self.rng.choices(range(len(self.probs)),
                                weights=self.probs, k=1)[0]

    def __call__(self, samples: Iterable[dict]) -> Iterator[List[dict]]:
        """Probability-FIRST multiplexing (custom_multiplexer.py:77-95): the
        next bucket is drawn from `probs` over ALL buckets before looking at
        fill state, and held until that bucket can serve a full batch — so
        the emitted batch distribution tracks `probs` whenever the inflow
        can sustain it (ready-set-weighted picking is arrival-biased; see
        tests/test_data.py bucket-distribution regression). Buffer pressure
        drains the largest bucket instead (mydemux._find_next semantics)."""
        target = self._pick_any()
        for s in samples:
            self.buffers[s["bucket_id"]].append(s)
            while len(self.buffers[target]) >= self.batch_size:
                yield self._pop_batch(target)
                target = self._pick_any()
            if self._total() >= self.max_total_buffer:
                # pressure: the held target isn't filling — drain the largest
                largest = max(range(len(self.buffers)),
                              key=lambda i: len(self.buffers[i]))
                if len(self.buffers[largest]) >= self.batch_size:
                    yield self._pop_batch(largest)
                else:  # pathological: drop oldest to keep liveness
                    self.buffers[largest].popleft()
                # re-draw the held target among buckets that actually have
                # samples: a nonzero-prob bucket the dataset never feeds
                # would otherwise pin `target` forever and degrade every
                # future batch to pressure-drained largest-bucket batches
                nonempty = [i for i, b in enumerate(self.buffers) if b]
                if nonempty and target not in nonempty:
                    target = self.rng.choices(
                        nonempty, weights=[self.probs[i] for i in nonempty],
                        k=1)[0]
        # drain remaining full batches at end of stream (:104-111)
        while True:
            ready = self._ready()
            if not ready:
                break
            yield self._pop_batch(self._pick(ready))
