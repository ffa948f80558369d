"""The comparison that decides ``correct``: a sample of the window's cells,
drawn from the run's seed, simulated again by the plain reference from the
same deployment file, clients and seeds, and held field by field against
what the entry returned.

Each field's gap is ``|program - reference| / max(|program|, |reference|)``
(0 when equal, NaN equal to NaN; a NaN or infinity against a number, or
an ``exhausted`` flag that differs, is a gap of 1).  The numbers compared,
each against its limit in ``limits/<cell>.json``:

* ``worst_rel_gap``: the largest gap over the sampled cells' fields;
* ``exhausted_cells``: cells of the window the entry left exhausted after
  its own retries (an answer that never came).
"""
from __future__ import annotations

import math

import numpy as np

from .reference.summary import FIELDS

SAMPLE = 1024           # cells the reference simulates again a run


def gap(p, r) -> float:
    if isinstance(p, bool) or isinstance(r, bool):
        return 0.0 if bool(p) == bool(r) else 1.0
    p, r = float(p), float(r)
    if p == r or (math.isnan(p) and math.isnan(r)):
        return 0.0
    if not (math.isfinite(p) and math.isfinite(r)):
        return 1.0
    return abs(p - r) / max(abs(p), abs(r))


def cell_gap(prog: dict, ref: dict) -> float:
    return max(gap(prog[f], ref[f]) for f in FIELDS)


def sample(n_cells: int, run_seed: int, k: int = SAMPLE):
    """Indices of the cells the reference checks, drawn from the seed."""
    rng = np.random.default_rng([int(run_seed) % (1 << 63), 0xC0DE])
    return np.sort(rng.choice(n_cells, size=min(k, n_cells), replace=False))


def judge(prog_units, ref_units, n_exhausted: int, limits: dict):
    """(correct, failed among the sampled, checks): ``checks`` maps each
    number compared to its value and limit."""
    gaps = [cell_gap(p, r) for p, r in zip(prog_units, ref_units)]
    worst = max(gaps) if gaps else 0.0
    checks = {"worst_rel_gap": {"value": worst,
                                "limit": limits["worst_rel_gap"]},
              "exhausted_cells": {"value": n_exhausted,
                                  "limit": limits["exhausted_cells"]}}
    bad = sum(g > limits["worst_rel_gap"] for g in gaps)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, bad, checks
