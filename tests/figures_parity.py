"""Shared helpers of ``test_torch_figures.py`` and
``test_torch_families.py``: the reference's and the port's
``backend_override="batch"`` runs of one registered scenario (cached per
process), and the per-cell comparison.

Both sides draw the same threefry bits, so parity is per cell.  Run op by
op (``jax.disable_jit``) the reference computes exactly the port's
arithmetic (``test_torch_figures.py`` holds the steps bit for bit); under
``jit`` XLA:CPU fuses and contracts some of the step's adds and products,
which moves a last bit now and then.  Each cell is held to ``STRICT`` --
counts within one request, latency percentiles rel 1e-5, message loads
abs 1e-6, timeline buckets within one -- or, where larger, the
reference's own envelope: the reference run again with its jitter one f32
ulp up and one down (``test_torch_vectorsim_branches.py``).

Two kinds of cell need more, and ``tolerance`` states it:

* chaotic cells, where the reference's own one-ulp move already exceeds
  ``STRICT`` (a percentile steps to another sample, a request crosses a
  window edge, and the trajectories part): there the next one-ulp
  difference is as likely to move a cell as far again, so the cell is held
  to ``CHAOTIC``, the tolerance ``test_torch_vectorsim.py`` holds the
  chaotic N=25 cells to (counts within 0.5%, percentiles rel 3%, loads abs
  1e-3), with timeline buckets within 5% of the largest bucket;
* static relays (``fig8/static/*``), where a saturated relay's long work
  chain carries XLA:CPU's contractions to the end of the run while a
  one-ulp move of the jitter (or of the costs) moves no count and a
  percentile by 1.4e-7 at most: on the quick ``fig8/static/R=1`` grid
  the reference's jit run and its own op-by-op run differ by 4.50e-5 in
  the 120-client p99 (6.2e-6 at 40 clients), and the port equals the
  op-by-op run in every count and percentile but that p99 (8.2e-7 off)
  and the 40-client mean (1.0e-7, the summation order), so latency
  percentiles there are held to ``STATIC_LAT`` = 5e-5.
"""
import dataclasses
import functools

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import torch

from repro.core import vectorsim as rvs
from repro.experiments import registry as ref_registry
from repro.experiments import runner as ref_runner
from repro_torch.experiments import registry, runner

# the CPU step loop is bound by per-operation overhead, not arithmetic:
# one intra-op thread is faster here and leaves the other test workers
# their cores
torch.set_num_threads(1)

LAT_MS = ("median_ms", "p25_ms", "p75_ms", "p99_ms")
STRICT = {"count": 1, "lat": 1e-5, "msg": 1e-6, "timeline": 1}
CHAOTIC = {"count_rel": 5e-3, "lat": 3e-2, "msg": 1e-3, "timeline_rel": 5e-2}
STATIC_LAT = 5e-5


def _moved(scenario, ulps):
    """The reference scenario's batch run with its link jitter moved by
    ``ulps`` f32 ulps (through ``build_config``, which lowers it)."""
    build = rvs.build_config

    def moved(*a, **kw):
        c = build(*a, **kw)
        j = np.float32(c.jitter)
        for _ in range(abs(ulps)):
            j = np.nextafter(j, np.float32(1.0 if ulps > 0 else 0.0))
        return dataclasses.replace(c, jitter=float(j))
    rvs.build_config = moved
    try:
        return ref_runner.run_scenarios([scenario], quick=True,
                                        ignore_quick_skip=True,
                                        backend_override="batch")
    finally:
        rvs.build_config = build


@functools.cache
def ref_art(name, ulps=0):
    """The reference's quick override run of ``name`` (its jitter moved by
    ``ulps`` f32 ulps); the suite artifact."""
    return _moved(ref_registry.get(name), ulps)


@functools.cache
def port_art(name):
    """The port's quick override run of ``name`` on the CPU."""
    return runner.run_scenarios([registry.get(name)], quick=True,
                                ignore_quick_skip=True,
                                backend_override="batch", device="cpu")


def diff(a_units, b_units):
    """Worst per-cell differences between two artifacts' units: counts
    (absolute and relative), latency percentiles (relative), message loads
    (absolute), timeline buckets (absolute and relative to the peak)."""
    d = {"count": 0, "count_rel": 0.0, "lat": 0.0, "msg": 0.0}
    assert len(a_units) == len(b_units)
    for a, b in zip(a_units, b_units):
        assert (a["clients"], a["seed"]) == (b["clients"], b["seed"])
        for k in ("count", "committed"):
            d["count"] = max(d["count"], abs(a[k] - b[k]))
            d["count_rel"] = max(d["count_rel"], abs(a[k] - b[k]) / a[k])
        d["lat"] = max([d["lat"]] + [abs(a[k] / b[k] - 1.0) for k in LAT_MS])
        ea, eb = a.get("extras", {}), b.get("extras", {})
        assert sorted(ea) == sorted(eb)
        for k in ("leader_msgs_per_op", "follower_msgs_per_op"):
            if k in ea:
                d["msg"] = max(d["msg"], abs(ea[k] - eb[k]))
        if "timeline" in ea:
            x = np.array(ea["timeline"]["counts"])
            y = np.array(eb["timeline"]["counts"])
            d["timeline"] = max(d.get("timeline", 0),
                                int(np.abs(x - y).max()))
            d["timeline_rel"] = max(d.get("timeline_rel", 0.0),
                                    float(np.abs(x - y).max() / x.max()))
    return d


def tolerance(name, want_units):
    """The cell's tolerance (see the module docstring) and its kind."""
    tol = dict(STRICT)
    for ulps in (1, -1):
        moved = ref_art(name, ulps)["scenarios"][0]["units"]
        for k, v in diff(want_units, moved).items():
            if k in tol:
                tol[k] = max(tol[k], v)
    if any(tol[k] > STRICT[k] for k in ("count", "lat")):
        return CHAOTIC, "chaotic"
    if name.startswith("fig8/static/"):
        tol["lat"] = max(tol["lat"], STATIC_LAT)
        return tol, "static"
    return tol, "damped"


def check_cell(name):
    """The port's quick override run of ``name`` against the reference's,
    per cell, within ``tolerance``; returns (worst, tolerance, kind)."""
    want = ref_art(name)["scenarios"][0]
    got = port_art(name)["scenarios"][0]
    for a, b in zip(want["units"], got["units"]):
        assert sorted(a) == sorted(b)
        assert a["exhausted"] == b["exhausted"] is False
        assert a["retry_risk"] == b["retry_risk"]
        assert b["count"] > 0
    tol, kind = tolerance(name, want["units"])
    worst = diff(want["units"], got["units"])
    bad = {k: (worst[k], tol[k]) for k in tol if worst.get(k, 0) > tol[k]}
    assert not bad, (name, kind, bad, worst)
    return worst, tol, kind
