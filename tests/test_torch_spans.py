"""The batch entry's spans and counters (``repro_torch.core.spans``, the
``info`` of ``simulate_scenario``) and the benchmark's readers of them,
on the CPU.

Recording changes no result, stores nothing while off, nests every span
inside its parent under one ``entry`` a grid; the chunk record reaches
``info``; each reader takes its number from the traced grid's spans
alone."""
import math
import time
import types

import pytest
import torch

from portbench import spec
from repro_torch.core import spans
from repro_torch.core import vectorsim as vs
from repro_torch.core.pig import PigConfig

torch.set_num_threads(1)

TINY = {"pigpaxos": dict(pig=PigConfig(n_groups=3), clients=(20, 60),
                         seeds=(1, 2)),
        "epaxos": dict(clients=(10, 20), seeds=(1, 2))}


def _run(protocol, info=None):
    return vs.simulate_scenario(protocol, 25, duration=0.03, warmup=0.02,
                                device="cpu", info=info, **TINY[protocol])


@pytest.fixture(scope="module")
def recorded():
    """Each tiny grid run untraced, then both inside one recording."""
    off = {p: _run(p) for p in TINY}
    with spans.recording() as rec:
        on = {p: _run(p) for p in TINY}
    return off, on, rec


@pytest.mark.parametrize("protocol", sorted(TINY))
def test_recording_changes_no_result(recorded, protocol):
    off, on, _ = recorded
    assert on[protocol] == off[protocol]


def test_spans_nest_under_one_entry_a_grid(recorded):
    _, _, rec = recorded
    assert rec.spans and {s.name for s in rec.spans} <= set(spans.NAMES)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["entry", "entry"]
    assert sorted(s.grid for s in roots) == [0, 1]
    for s in rec.spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.grid == s.grid
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    names = {s.name for s in rec.spans}
    assert {"lowering", "budget", "step_loop", "fanin_setup", "draws",
            "summary", "collect", "units"} <= names
    assert "retry" not in names
    # the CPU records no device interval
    assert rec.device == []


def test_self_time_is_the_duration_less_the_children(recorded):
    _, _, rec = recorded
    rows = {r[0]: r[1:] for r in rec.table()}
    total = sum(s.t1 - s.t0 for s in rec.spans if s.parent is None)
    assert rows["entry"][0] == 2
    assert rows["entry"][1] == pytest.approx(total)
    # the self times of every name add up to the roots' durations
    assert sum(r[2] for r in rows.values()) == pytest.approx(total)
    assert all(r[3] is None for r in rows.values())


def test_nothing_is_stored_and_no_event_built_while_off(monkeypatch):
    before = spans.last()

    def refused(*a, **k):
        raise AssertionError("built while recording is off")

    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(spans, "Recorder", refused)
    assert spans.span("draws", torch.device("cuda", 0)) is spans.span("x")
    _run("pigpaxos")
    assert spans.last() is before and spans._rec is None


def test_a_profiled_grid_records_itself():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        units = _run("epaxos")
    rec = spans.last()
    assert [s.name for s in rec.spans if s.parent is None] == ["entry"]
    assert units == _run("epaxos") and spans.last() is rec


def test_a_recording_does_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with spans.recording():
                pass


def test_device_spans_read_their_event_pairs_once_the_recording_ends(
        monkeypatch):
    class Event:
        made = []

        def __init__(self, enable_timing):
            assert enable_timing
            Event.made.append(self)

        def record(self, stream):
            self.at = 2.5 * len(Event.made)

        def elapsed_time(self, other):
            return other.at - self.at

    synced = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    dev = torch.device("cuda", 0)
    with spans.recording() as rec:
        with spans.grid():
            t = time.perf_counter()
            for _ in range(2):
                with spans.span("draws", dev):
                    pass
        # the first device span synchronized and recorded the origin
        assert rec.device == [] and synced == [dev]
        origin_t = rec._origins[dev][0]
    assert synced == [dev, dev] and len(Event.made) == 5
    assert origin_t >= t
    # the origin is event 1 (at 2.5 ms), the pairs events 2-3 and 4-5
    assert rec.device == [
        (0, "draws", pytest.approx(origin_t + 2.5e-3),
         pytest.approx(origin_t + 5e-3)),
        (0, "draws", pytest.approx(origin_t + 7.5e-3),
         pytest.approx(origin_t + 10e-3))]
    assert dict((r[0], r[4]) for r in rec.table())["draws"] == \
        pytest.approx(5.0)


@pytest.mark.parametrize("protocol", sorted(TINY))
def test_info_counts_the_chunk_and_the_draw_blocks(protocol):
    info = {}
    _run(protocol, info)
    assert info["chunks"] == 1 and info["retries"] == 0
    assert info["stack_s"] > 0
    assert 1 <= info["draw_blocks"] <= info["scan_steps"]
    assert info["fanin_launches"] == 0 and info["cells"] == 4


def test_a_too_small_budget_retries_under_retry_spans():
    cfg = vs.build_config("pigpaxos", 9, pig=PigConfig(n_groups=2))
    with spans.recording() as rec:
        out = vs.simulate_grid_sharded([cfg], [(0, 4, 0), (0, 8, 1)], 0.03,
                                       0.02, steps=64, device="cpu")
    retries = out["sharding"]["chunks"][0]["retries"]
    assert retries > 0 and not out["exhausted"].any()
    retry = [i for i, s in enumerate(rec.spans) if s.name == "retry"]
    assert len(retry) == retries
    # each retry pass runs its own lowering, step loop and collect
    for i in retry:
        kids = {s.name for s in rec.spans if s.parent == i}
        assert kids == {"lowering", "step_loop", "collect"}


# ------------------------------------------------- the benchmark's readers
def _ctx(monkeypatch, entry=(0.5, 9.5)):
    """A traced window [0, 10) s with the device busy in [0, 1) and
    [2, 9), and a recording whose grid 0 is the traced grid (grid 1 ran
    later)."""
    S = spans.Span
    rec = types.SimpleNamespace(
        spans=[S(0, "entry", None, *entry), S(0, "budget", 0, 0.5, 0.55),
               S(0, "lowering", 0, 0.55, 0.6),
               S(0, "step_loop", 0, 0.6, 8.0),
               S(0, "draws", 3, 2.0, 2.25), S(0, "draws", 3, 4.0, 4.5),
               S(0, "collect", 0, 8.0, 9.0), S(0, "units", 0, 9.0, 9.4),
               S(0, "lowering", 0, 9.4, 9.41),
               S(1, "entry", None, 20.0, 30.0),
               S(1, "units", 9, 21.0, 29.0)],
        device=[(0, "draws", 0.9, 1.2), (0, "draws", 2.0, 2.5),
                (0, "draws", 4.0, 4.25), (1, "draws", 21.0, 22.0)])
    monkeypatch.setattr(spans, "_last", rec)
    return {"window": [], "shapes": {},
            "trace": {"events": [("k", 0.0, 1.0), ("k", 2.0, 9.0)],
                      "lo": 0.0, "hi": 10.0, "window_s": 10.0,
                      "scan_steps": 2}}


# the device draws intervals hold 0.1 + 0.5 + 0.25 s of busy device time
READINGS = {"draws_device_ms_per_step": (100.0 + 500.0 + 250.0) / 2,
            "draws_host_ms_per_step": (250.0 + 500.0) / 2,
            "lowering_ms_per_grid": 50.0 + 10.0,
            "budget_ms_per_grid": 50.0,
            "units_ms_per_grid": 400.0,
            # idle [1, 2) and [9, 10); the spans cover [0.5, 9.5)
            "idle_outside_spans_share": 5.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_each_reader_reads_the_traced_grid_alone(metric, monkeypatch):
    read = spec.metric_reader(metric)
    ctx = _ctx(monkeypatch)
    assert read(ctx) == pytest.approx(READINGS[metric])
    assert math.isfinite(read(ctx))
    # a recording whose grid is not the traced one gives nothing
    assert read(_ctx(monkeypatch, entry=(10.5, 19.0))) is None
    monkeypatch.setattr(spans, "_last", None)
    assert read(ctx) is None


def test_the_readers_are_the_benchmark_s():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READINGS:
        assert entries[metric]["workloads"] == ["pig25.montecarlo"]
        assert entries[metric]["moves"] == "cells_per_s"
