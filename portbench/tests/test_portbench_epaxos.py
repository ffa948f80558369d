"""``epaxos25.montecarlo``: its readers of the port's EPaxos spans on
synthetic traces, the byte count of the per-key update, and a tiny run of
the cell as ``BENCHMARK.json`` declares it, on the CPU."""
import random
import sys
import types

import pytest

from portbench import devicespans, programspans, spec
from portbench.tests import tiny

CELL = "epaxos25.montecarlo"
BENCH = spec.load_benchmark()
NEW = ("draws_device_ms_per_step.epaxos", "keys_device_ms_per_step.epaxos",
       "keys_roofline.epaxos")


def _ctx(monkeypatch, device, scan_steps=(2,), C=393216, n=25):
    """A traced window [0, 10) s with the device busy in [0, 1) and
    [2, 9), and a recording of the port whose grid 0, with ``device``'s
    intervals, is the traced grid (grid 1 ran later)."""
    S = types.SimpleNamespace
    rec = S(spans=[S(grid=0, name="entry", t0=0.5, t1=9.5),
                   S(grid=1, name="entry", t0=20.0, t1=30.0)],
            device=device + [(1, "keys", 21.0, 22.0)])
    monkeypatch.setitem(sys.modules, programspans.MODULE,
                        S(last=lambda: rec))
    return {"config": {"n": n}, "shapes": {"C": C, "B": 1, "F": n, "G": 1},
            "window": [{"scan_steps": s} for s in scan_steps],
            "trace": {"events": [("k", 0.0, 1.0), ("k", 2.0, 9.0)],
                      "lo": 0.0, "hi": 10.0, "window_s": 10.0,
                      "scan_steps": 2}}


SPANS = [(0, "draws", 0.9, 1.2), (0, "keys", 2.0, 2.5),
         (0, "keys", 4.0, 4.25)]
KEYS_BYTES = 104_595_456      # 393,216 cells x (9 x 25 + 41) bytes


def test_keys_bytes_at_the_cell_s_size():
    read = spec.metric_reader("keys_roofline.epaxos")
    keys_bytes = read.__globals__["keys_bytes"]
    assert keys_bytes(393216, 25) == KEYS_BYTES
    assert keys_bytes(1, 1) == 9 + 41


def test_the_readers_read_the_traced_grid_s_spans(monkeypatch):
    ctx = _ctx(monkeypatch, SPANS)
    # busy device time inside the draws interval: [0.9, 1) of [0, 1)
    assert spec.metric_reader("draws_device_ms_per_step.epaxos")(ctx) == \
        pytest.approx(100.0 / 2)
    assert spec.metric_reader("keys_device_ms_per_step.epaxos")(ctx) == \
        pytest.approx((500.0 + 250.0) / 2)
    share = spec.metric_reader("keys_roofline.epaxos")(ctx)
    assert share == pytest.approx(100.0 * 2 * KEYS_BYTES / 3.35e12 / 0.75)
    assert 0.0 < share <= 100.0


def test_the_roofline_takes_the_first_pass_alone(monkeypatch):
    # a window grid of one scan step: the traced grid's second keys
    # interval belongs to a retry of fewer cells
    ctx = _ctx(monkeypatch, SPANS, scan_steps=(1, 2))
    assert spec.metric_reader("keys_roofline.epaxos")(ctx) == \
        pytest.approx(100.0 * KEYS_BYTES / 3.35e12 / 0.5)


def test_busy_inside_the_spans_is_programspans_reading(monkeypatch):
    rng = random.Random(31)
    ctx = _ctx(monkeypatch, [])
    t, events = 0.0, []
    for _ in range(2000):
        d = rng.uniform(0.0, 2e-3)
        events.append(("k", t, t + d))
        t += d + rng.choice((0.0, rng.uniform(0.0, 1e-3)))
    ivs = [(0, "keys", a, a + rng.uniform(0.0, 0.05))
           for a in sorted(rng.uniform(0.0, t) for _ in range(40))]
    S = types.SimpleNamespace
    rec = S(spans=[S(grid=0, name="entry", t0=0.0, t1=t)], device=ivs)
    monkeypatch.setitem(sys.modules, programspans.MODULE,
                        S(last=lambda: rec))
    ctx["trace"].update(events=events, hi=t, window_s=t)
    want = programspans.device_busy_ms(ctx, "keys")
    assert want > 0
    assert devicespans.busy_ms(ctx, "keys") == pytest.approx(want, rel=1e-9)
    assert devicespans.busy_ms(ctx, "keys", 41) is None


@pytest.mark.parametrize("metric", NEW)
def test_without_the_spans_the_readers_give_nothing(metric, monkeypatch):
    read = spec.metric_reader(metric)
    # a port without the keys span, as the parent's, still has draws
    ctx = _ctx(monkeypatch, SPANS[:1])
    assert (read(ctx) is None) == metric.startswith("keys_")
    monkeypatch.setitem(sys.modules, programspans.MODULE,
                        types.SimpleNamespace(last=lambda: None))
    assert read(ctx) is None
    assert read(dict(ctx, trace=None)) is None


def test_the_cell_s_entries():
    w = spec.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "epaxos-n25", "montecarlo-c10-20-40-x131072", 1)
    mix = spec.traffic(w["traffic"])
    assert len(mix["clients"]) * mix["seeds_per_clients"] == 393216
    per_layer = {m["name"]: m for m in spec.metrics_for(BENCH, CELL,
                                                        "per_layer")}
    assert set(per_layer) == {
        "scan_step_ms.epaxos", "host_cpu_ms_per_step.epaxos",
        "kernels_per_step.epaxos", "device_idle_share.epaxos",
        "fanin_rows_roofline", *NEW}
    for m in per_layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "cells_per_s"
    assert per_layer["keys_roofline.epaxos"]["unit"] == "%"


def test_a_tiny_run_of_the_declared_cell_is_correct():
    out = tiny.run(CELL)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["worst_rel_gap"]["value"] == 0.0
    assert out["checks"]["exhausted_cells"]["value"] == 0
    assert out["attempted"] == len(tiny.MIXES[CELL]["clients"]) * 2


def test_the_copy_with_the_epaxos_entries_twice_finds_the_declared_cell(
        cell_roots):
    copy = spec.load_benchmark(cell_roots[CELL])
    assert sum(w["name"] == CELL for w in copy["workloads"]) == 2
    assert spec.cell(copy, CELL) == spec.cell(BENCH, CELL)
    assert spec.config(copy, "epaxos-n25", cell_roots[CELL]) == \
        spec.config(BENCH, "epaxos-n25")


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_metric_of_the_cell(
        cuda_device):
    # the cell's traffic at 1,024 seeds a client count, so the run is short
    import math
    import time
    from portbench import harness
    mix = dict(spec.traffic(spec.cell(BENCH, CELL)["traffic"]),
               seeds_per_clients=1024)
    out = harness.run_cell(CELL, 3100000141, 1.0, True, cuda_device,
                           time.perf_counter(), mix_override=mix)
    assert out["correct"] and out["failed"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {x["name"] for x in spec.metrics_for(BENCH, CELL,
                                                          "per_layer")}
    assert all(math.isfinite(v) and v >= 0 for v in m.values()), m
    assert 0.0 < m["keys_roofline.epaxos"] <= 100.0
    assert 0.0 < m["keys_device_ms_per_step.epaxos"] < \
        m["draws_device_ms_per_step.epaxos"]
