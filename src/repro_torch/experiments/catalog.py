"""The port's scenario catalog: the ``scale/batch/*`` family, copied from
``repro.experiments.catalog``.  Importing this module populates the
registry."""
from __future__ import annotations

from ..core.pig import PigConfig
from .registry import register
from .scenario import Scenario

# ======================================================================
# Batch-backend headroom: grids the DES cannot touch (one call per
# scenario; N up to 1025 and hundreds of seed replicates per point).
# ======================================================================
for n, r, nseeds, qseeds in ((257, 16, 128, 8), (1025, 32, 24, 4)):
    register(Scenario(
        name=f"scale/batch/N={n}/R={r}", protocol="pigpaxos", n=n,
        pig=PigConfig(n_groups=r, prc=1), backend="batch", batch_ok=True,
        clients=(60, 120), quick_clients=(60,),
        seeds=tuple(range(nseeds)), quick_seeds=tuple(range(qseeds)),
        duration=0.5, quick_duration=0.25, warmup=0.25,
        quick_skip=(n == 1025)))
# the paper-grade relay-group sweep with hundreds of replicates per R:
# 7 R values x 3 client counts x 64 seeds = 1344 cells, one call per
# scenario
for r in (1, 2, 3, 5, 8, 12, 24):
    register(Scenario(
        name=f"scale/batch/replicates/R={r}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=r, prc=1,
                      single_group_majority=(r == 1)),
        backend="batch", batch_ok=True,
        clients=(20, 60, 120), quick_clients=(60,),
        seeds=tuple(range(64)), quick_seeds=tuple(range(8)),
        duration=0.5, quick_duration=0.25, warmup=0.25))
