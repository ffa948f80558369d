"""Observability configuration."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ObsConfig:
    """Knobs for the observability layer, passed as ``Cluster(obs=...)``.

    ``sample_rate`` drives tracing only; the ``Tracer`` samples every
    k-th client op deterministically (k = round(1/rate)) so it never
    consumes RNG.  Tracing adds no scheduler events and mutates no
    messages, so it is safe even for golden-trace comparisons.

    ``metrics_dt`` > 0 arms the timeline sampler: a repeating scheduler
    timer that reads gauges (per-node CPU busy fraction, leader queue
    depth, in-flight slots, batch fill, shed count, commit-latency
    EWMA/p99) into ring-buffer timelines every ``metrics_dt`` seconds of
    sim time.  The timer adds K_CALL events (RNG- and message-order
    neutral, but not event-count neutral) — leave it at 0 when an
    event-count-identical run matters.
    """

    sample_rate: float = 1.0     # fraction of client ops traced (0 disables)
    metrics_dt: float = 0.0      # timeline sampling period, seconds (0 disables)
    max_spans: int = 200_000     # stop sampling new ops past this many spans
    timeline_cap: int = 4096     # ring-buffer capacity per timeline series
    perfetto_limit: int = 20_000  # max trace events kept in artifact exports

    def __post_init__(self):
        if not (0.0 <= self.sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0, 1], got {self.sample_rate}")
        if self.metrics_dt < 0.0:
            raise ValueError(f"metrics_dt must be >= 0, got {self.metrics_dt}")
        if self.max_spans <= 0 or self.timeline_cap <= 0:
            raise ValueError("max_spans and timeline_cap must be positive")

    @staticmethod
    def coerce(obs) -> "ObsConfig":
        """Accept an ObsConfig, a plain dict of kwargs, or True (defaults)."""
        if isinstance(obs, ObsConfig):
            return obs
        if obs is True:
            return ObsConfig()
        if isinstance(obs, dict):
            return ObsConfig(**obs)
        raise TypeError(f"obs must be ObsConfig, dict, or True, got {type(obs).__name__}")
