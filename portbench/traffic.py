"""The one request generator: a traffic file's mix, drawn from the seed.

A mix is [[crops, count], ...] a block: every block of sum(count) requests
holds exactly those sizes, in an order drawn from the seed, so every seed
sends the same sizes and only their order differs. Each request takes its
crops from a pool in host memory at an offset drawn from the seed. A
sample of the requests, also drawn from the seed, keeps its outputs for the
output check: the first, every `check_every`-th from a random phase, and
the first request of the largest size.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    crops: int
    offset: int
    keep: bool


def requests(mix: list, pool: int, check_every: int, seed: int) -> Iterator[Request]:
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed, 3])))
    block = np.concatenate([np.full(int(n), int(size)) for size, n in mix])
    largest = int(block.max())
    phase = int(rng.integers(check_every))
    kept_largest, i = False, 0
    while True:
        for size in rng.permutation(block):
            size = int(size)
            keep = i == 0 or i % check_every == phase or (size == largest and not kept_largest)
            kept_largest |= keep and size == largest
            yield Request(i, size, int(rng.integers(pool - size + 1)), keep)
            i += 1
