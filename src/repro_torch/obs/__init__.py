"""Observability subsystem (a copy of ``repro.obs``): per-op distributed tracing,
time-series metrics, and critical-path bottleneck attribution.

The paper's headline claims are observability claims — rotating relays keep
any single node from becoming a hotspot (Fig 8), and throughput is governed
by a leader/relay bottleneck decomposition (Eq. 1-3) — so this layer makes
*where a millisecond goes* and *which node is hot at second t* first-class
outputs of every execution path:

* :class:`Tracer` (``trace.py``) — per-op distributed tracing.  A sampled
  client op gets a trace context that rides every message of its causal
  chain (client -> leader -> relay -> follower -> ack); the engines record
  serialize / network / queue-wait / CPU-service spans per hop and the Pig
  relay layer records aggregation spans.  Purely observational: no
  scheduled events, no RNG draws, no message mutation — traces are
  bit-identical with tracing enabled (pinned by ``tests/test_torch_obs.py``
  against ``engine="ref"``), and ``net.tracer is None`` short-circuits
  every hook when disabled.
* :class:`Timelines` (``metrics.py``) — a time-series metrics registry:
  counters / gauges / ring-buffer timelines (per-node CPU busy fraction,
  leader queue depth, in-flight slots, batch fill, shed count,
  commit-latency EWMA/p99) sampled on a scheduler repeat timer
  (``Scheduler.every``).  ``Network.reset_stats`` resets the ring buffers
  at warmup, so warmup samples never pollute reported series.
* ``critpath.py`` — walks each finished span tree and decomposes commit
  latency into queue-wait / CPU-service / serialize / relay-aggregation /
  network segments with an exact sum-to-latency invariant (tested).
* ``export.py`` — Chrome/Perfetto trace-event JSON
  (``python -m repro_torch.experiments.run --trace``)
  and the ``obs`` section of ``repro-experiments/v1`` artifacts.

Enable with ``Cluster(obs=ObsConfig(sample_rate=..., metrics_dt=...))`` (a
plain dict also works).  ``sample_rate`` controls tracing only and is
event-neutral; ``metrics_dt`` > 0 arms the sampler timer, which adds
K_CALL events (still RNG- and message-order-neutral, but not
event-count-identical — keep it 0 for golden-trace comparisons).

Model boundaries (where this layer's numbers do and don't exist):

* ``engine="ref"`` has **no obs surface** — ``Cluster(obs=...)`` raises on
  the verbatim seed stack rather than silently skipping hooks.
* the batch backend (``core/vectorsim.py``) is **timelines-only**: the
  vectorized kernel emits leader-backlog series but has no per-op span
  trees or critical-path decomposition — traced runs need a DES engine.
* span trees cover **logged** operations' causal chains; leased
  leader-local reads are served without any fan-out, so their traces are
  single-node by construction (see ``docs/consistency.md`` for the read
  paths and ``docs/architecture.md`` for the full selection matrix).
"""
from .config import ObsConfig  # noqa: F401
from .critpath import CAT_PRIORITY, SEGMENTS, critical_path, decompose  # noqa: F401
from .export import obs_artifact_section, perfetto_events, write_perfetto  # noqa: F401
from .metrics import LatencyGauge, Timeline, Timelines, install_sampler  # noqa: F401
from .trace import Tracer  # noqa: F401
