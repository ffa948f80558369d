"""The workload shape (copied from ``repro.core.cluster.WorkloadConfig``),
with all of its fields, defaults and checks: a scenario records every
field in its spec.  The discrete-event clients (``core/cluster.py``) read
every field; the batch backend reads the payload sizes, the write or read
fraction, ``read_path``, ``arrival`` and, for EPaxos, the key distribution
(``n_keys``, ``key_dist``, ``zipf_theta``, ``conflict_rate``).
``zipf_cdf`` is the reference's key CDF (``repro.core.cluster.zipf_cdf``),
cached as the reference caches it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class WorkloadConfig:
    n_keys: int = 1000
    payload_bytes: int = 8
    write_fraction: float = 0.5   # paper: even reads/writes, both replicated
    # --- read paths -----------------------------------------------------
    # read_ratio: fraction of ops that are reads.  None (default) keeps the
    # seed behavior — ops split by ``write_fraction`` and reads go through
    # the log like writes (golden traces depend on this exact draw order).
    # When set, the op mix is read_ratio reads / (1 - read_ratio) writes
    # and clients keep a read/write latency split.
    # read_path: how reads are served —
    #   "log"    — through consensus, a slot per read (the seed behavior)
    #   "lease"  — sent to the leader, served locally while it holds a
    #              quorum lease (requires Cluster(lease=...); falls back to
    #              the log path when the lease is not held)
    #   "quorum" — client-side quorum read: probe a majority (PigPaxos: the
    #              geo-closest relay subgroup + the leader, which sits in
    #              every write quorum) for per-key commit frontiers, rinse
    #              while accepted > applied, serve the max-applied value
    read_ratio: Optional[float] = None
    read_path: str = "log"
    # --- key popularity -------------------------------------------------
    # "uniform"  — every key equally likely (the paper's YCSB-like setup)
    # "zipfian"  — YCSB-style skew: P(rank k) ∝ 1/k^theta
    # "conflict" — hot-spot model for EPaxos conflict sweeps: key 0 with
    #              probability conflict_rate, else a uniform non-zero key
    key_dist: str = "uniform"
    zipf_theta: float = 0.99
    conflict_rate: float = 0.0
    # --- arrival process ------------------------------------------------
    # "closed"  — one outstanding op per client, next op starts on reply
    # "poisson" — open loop: ops arrive at rate_hz per client regardless
    #             of replies (up to max_outstanding in flight)
    # "bursty"  — open loop, ON/OFF modulated: rate_hz*burst_factor for the
    #             first burst_on fraction of each burst_period, a reduced
    #             OFF rate the rest — the time-average stays rate_hz
    # "diurnal" — open loop, sinusoidally modulated:
    #             rate(t) = rate_hz * (1 + diurnal_amp*sin(2πt/period))
    # The modulated processes draw each inter-arrival gap from the
    # *instantaneous* rate (deterministic per seed; exact for gaps short
    # vs. the modulation period, which holds everywhere we sweep).
    arrival: str = "closed"
    rate_hz: float = 200.0
    max_outstanding: int = 64
    burst_factor: float = 8.0     # ON-phase rate multiplier
    burst_on: float = 0.1         # fraction of each period spent ON
    burst_period: float = 1.0     # seconds
    diurnal_period: float = 2.0   # seconds (compressed day)
    diurnal_amp: float = 0.8      # peak-to-mean swing, in [0, 1)
    # --- payload distribution -------------------------------------------
    # When payload_choices is set, each put draws its size from the mix
    # (weights default to uniform over the choices).
    payload_choices: Optional[tuple] = None
    payload_weights: Optional[tuple] = None
    # --- fault tolerance -------------------------------------------------
    # When set, a client that has waited this long for a reply re-sends the
    # SAME command (same client_id/seq — the leader's at-most-once session
    # dedup makes the retry safe) and keeps retrying until replied.  None
    # (the paper's setup) = wait forever; required for availability
    # scenarios, where requests sent to a crashed node are silently lost.
    request_timeout: Optional[float] = None
    # What an OPEN-LOOP client does with an ok=False reply (not-the-leader
    # bounce or an admission-control shed):
    # "retry" — re-send after 5 ms, forever (the native behavior; right
    #           for transient bounces like leader changes)
    # "drop"  — abandon the op (count it in ``rejected``, free the
    #           outstanding slot).  The open-loop overload model: a shed
    #           request costs the server ONE cheap bounce, instead of a
    #           5 ms retry storm from every capped-out client amplifying
    #           the overload it was shed to relieve.
    reject_action: str = "retry"

    def __post_init__(self):
        # scenarios are declarative data: a typo must fail loudly, not run a
        # mislabeled uniform/closed workload with green CI
        if self.key_dist not in ("uniform", "zipfian", "conflict"):
            raise ValueError(f"unknown key_dist {self.key_dist!r}")
        if self.arrival not in ("closed", "poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown arrival {self.arrival!r}")
        if self.arrival == "bursty":
            if not (0.0 < self.burst_on < 1.0):
                raise ValueError("burst_on must be in (0, 1)")
            if self.burst_factor * self.burst_on > 1.0 + 1e-12:
                raise ValueError("burst_factor * burst_on must be <= 1 "
                                 "(the OFF-phase rate would go negative)")
        if self.arrival == "diurnal" and not (0.0 <= self.diurnal_amp < 1.0):
            raise ValueError("diurnal_amp must be in [0, 1)")
        if self.reject_action not in ("retry", "drop"):
            raise ValueError(f"unknown reject_action {self.reject_action!r}")
        if self.read_ratio is not None and not (0.0 <= self.read_ratio <= 1.0):
            raise ValueError("read_ratio must be in [0, 1]")
        if self.read_path not in ("log", "lease", "quorum"):
            raise ValueError(f"unknown read_path {self.read_path!r}")
        if self.read_path == "quorum" and self.arrival != "closed":
            raise ValueError("read_path='quorum' needs closed-loop clients — "
                             "the probe/rinse state machine tracks one "
                             "outstanding read per client")


_zipf_cdf_cache: Dict[tuple, np.ndarray] = {}


def zipf_cdf(n_keys: int, theta: float) -> np.ndarray:
    """Cumulative distribution of a Zipf(theta) law over ranks 1..n_keys
    (rank 1 == key 0).  Cached: building it is O(n_keys), sampling O(log n)."""
    key = (n_keys, float(theta))
    cdf = _zipf_cdf_cache.get(key)
    if cdf is None:
        p = np.arange(1, n_keys + 1, dtype=np.float64) ** -float(theta)
        cdf = np.cumsum(p / p.sum())
        cdf[-1] = 1.0
        _zipf_cdf_cache[key] = cdf
    return cdf
