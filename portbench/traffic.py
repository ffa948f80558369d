"""The one generator of every traffic mix: a mix file gives the client
counts of a grid, how many seed replicates each count gets, and the
simulated window; the run's seed gives each grid its own block of cell
seeds.

A mix file holds:

* ``clients``: closed-loop client counts, each crossed with every seed;
* ``seeds_per_clients``: seed replicates a client count, so a grid has
  ``len(clients) * seeds_per_clients`` cells;
* ``warmup_s``, ``duration_s``: the simulated warm-up and measured window
  of every cell;
* ``setup_warmup_s``, ``setup_duration_s``: the same for the grid that
  warms up the cell's shapes in set-up.

Every grid has the same client counts and window, so the same work: only
the seeds differ between grids and between runs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# cell seeds stay below 2**40, so seed * 1_000_003 (the cell key) fits in
# 63 bits
SEED_SPAN = 1 << 40


@dataclasses.dataclass(frozen=True)
class Grid:
    clients: Tuple[int, ...]
    seeds: Tuple[int, ...]
    warmup_s: float
    duration_s: float

    @property
    def cells(self):
        """(clients, seed) of every cell, in the entry's order."""
        return [(k, s) for k in self.clients for s in self.seeds]

    def __len__(self):
        return len(self.clients) * len(self.seeds)


def _seeds(mix: dict, run_seed: int, index: int) -> Tuple[int, ...]:
    n = int(mix["seeds_per_clients"])
    rng = np.random.default_rng([int(run_seed) % (1 << 63), index])
    base = int(rng.integers(0, SEED_SPAN - n))
    return tuple(range(base, base + n))


def grid(mix: dict, run_seed: int, index: int) -> Grid:
    """Grid ``index`` (0, 1, ...) of a run seeded ``run_seed``."""
    return Grid(tuple(int(k) for k in mix["clients"]),
                _seeds(mix, run_seed, index), float(mix["warmup_s"]),
                float(mix["duration_s"]))


def setup_grid(mix: dict, run_seed: int) -> Grid:
    """The set-up grid: the same cells' shapes, a short window."""
    return Grid(tuple(int(k) for k in mix["clients"]),
                _seeds(mix, run_seed, -1 % (1 << 32)),
                float(mix["setup_warmup_s"]), float(mix["setup_duration_s"]))
