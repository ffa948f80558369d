"""The port's chunked grid runner and the megagrid study, on the CPU.

``simulate_grid_sharded`` must equal one ``simulate_grid`` call bit for
bit (the reference's contract, ``tests/test_vectorsim.py::
test_sharded_equals_unsharded_*``), chunked, over two devices (two CPU
entries) and with exhausted cells retried inside a chunk; the study's
plan (points, seeds, buckets) must be the reference's; and a small slice
of the study must agree per point with ``repro.experiments.megagrid``.
"""
import jax  # noqa: F401  (the reference below runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core import PigConfig as RefPig
from repro.core import vectorsim as rvs
from repro.experiments import megagrid as rmg
from repro_torch.core import vectorsim as tvs
from repro_torch.core.pig import PigConfig
from repro_torch.core.workload import WorkloadConfig
from repro_torch.experiments import megagrid as tmg

torch.set_num_threads(1)


def _small_grid():
    """The reference test's grid: a PigPaxos and a Paxos config at N=9,
    two client counts, six seeds."""
    cfgs = [tvs.build_config("pigpaxos", 9, pig=PigConfig(n_groups=2,
                                                           prc=1)),
            tvs.build_config("paxos", 9)]
    grid = [(ci, k, s) for ci in range(2) for k in (4, 8) for s in range(6)]
    return cfgs, grid


def _assert_equal(want, got, what):
    for k in want:
        if k == "scan_steps":
            continue
        assert np.array_equal(want[k], got[k], equal_nan=True), (what, k)


@pytest.fixture(scope="module")
def group_grid():
    cfgs, grid = _small_grid()
    return cfgs, grid, tvs.simulate_grid(cfgs, grid, 0.1, 0.05,
                                         device="cpu")


@pytest.mark.parametrize("chunk,devices", [(64, None), (7, None),
                                           (7, ["cpu", "cpu"])])
def test_sharded_equals_unsharded(group_grid, chunk, devices):
    """One chunk, ragged chunks of 7 and chunks over two devices (each
    chunk rounded down to 6, split 3 + 3): every output field equal bit
    for bit, the retry's step budgets included."""
    cfgs, grid, want = group_grid
    got = tvs.simulate_grid_sharded(cfgs, grid, 0.1, 0.05, chunk=chunk,
                                    devices=devices, device="cpu")
    _assert_equal(want, got, chunk)
    sh = got["sharding"]
    D = 1 if devices is None else len(devices)
    assert sh["devices"] == D and sh["impl"] == "chunked"
    assert sh["kernel"] == "plain"
    assert sh["chunk"] == max(chunk - chunk % D, D)
    assert sum(m["cells"] for m in sh["chunks"]) == len(grid)
    assert all(m["wall_s"] > 0 and m["stack_s"] >= 0 for m in sh["chunks"])
    assert got["scan_steps"] == sum(m["scan_steps"] for m in sh["chunks"])


def test_sharded_epaxos_equals_unsharded():
    """The EPaxos kind through the same path (the reference's
    shard_worker case, with a conflict config beside the uniform one),
    over two devices."""
    cfgs = [tvs.build_config("epaxos", 5),
            tvs.build_config("epaxos", 5, workload=WorkloadConfig(
                key_dist="conflict", conflict_rate=0.5))]
    grid = [(ci, k, s) for ci in range(2) for k in (2, 4) for s in range(3)]
    want = tvs.simulate_grid(cfgs, grid, 0.05, 0.05, device="cpu")
    got = tvs.simulate_grid_sharded(cfgs, grid, 0.05, 0.05, chunk=5,
                                    devices=["cpu", "cpu"])
    _assert_equal(want, got, "epaxos")
    assert got["sharding"]["chunk"] == 4 and got["sharding"]["devices"] == 2


def test_sharded_exhausted_cells_retry():
    """A budget too small for every cell: each chunk retries its exhausted
    cells (padded back to a device multiple) until none is left, and the
    results equal one ``simulate_grid`` call with the same budget."""
    cfgs, _ = _small_grid()
    grid = [(0, 8, 0), (1, 8, 1), (0, 2, 2)]
    want = tvs.simulate_grid(cfgs, grid, 0.2, 0.05, steps=32, device="cpu")
    for devices in (None, ["cpu", "cpu"]):
        out = tvs.simulate_grid_sharded(cfgs, grid, 0.2, 0.05, steps=32,
                                        chunk=2, devices=devices,
                                        device="cpu")
        assert not out["exhausted"].any()
        assert (out["steps"] > 32).all()
        assert all(m["retries"] > 0 for m in out["sharding"]["chunks"])
        _assert_equal(want, out, devices)


def test_default_devices_and_kernel_flag(monkeypatch):
    cfgs, grid = _small_grid()
    with pytest.raises(ValueError, match="kernel"):
        tvs.simulate_grid_sharded(cfgs, grid, 0.1, 0.05, kernel="pallas",
                                  device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvs.simulate_grid_sharded(cfgs, grid, 0.1, 0.05)
    assert tvs.fanin_name("auto", "cpu") == "plain"
    assert tvs.fanin_name("auto", "cuda") == "seg_fanin_sm90"
    assert tvs.fanin_name("torch", "cuda") == "plain"


# ------------------------------------------------------- the study's plan
def _ref_plan(cells, axes):
    """The reference's seed allocation and buckets, as its
    ``run_megagrid`` computes them."""
    pts = rmg.build_points(axes)
    kaxis = list(axes["clients"])
    wsum = sum(p["weight"] for p in pts) * len(kaxis)
    seeds = max(1, int(np.ceil(cells / wsum)))
    for p in pts:
        p["seeds"] = max(1, int(round(seeds * p["weight"])))
    buckets = {}
    for pi, p in enumerate(pts):
        for k in kaxis:
            buckets.setdefault(rmg._bucket_key(p, k), []).append((pi, k))
    return pts, [(b, buckets[b]) for b in sorted(buckets, key=str)]


@pytest.mark.parametrize("cells,preset", [(1_000_000, "FULL_AXES"),
                                          (2 ** 18, "FULL_AXES"),
                                          (100, "SMOKE_AXES")])
def test_plan_equals_reference(cells, preset):
    """Points (names, kinds, axes, weights, seeds), every config lowered
    as the reference lowers it, and the buckets in run order: at 1M cells
    24 buckets and 1,000,112 cells."""
    axes = getattr(tmg, preset)
    assert axes == getattr(rmg, preset)
    rpts, rbk = _ref_plan(cells, axes)
    tpts, tbk = tmg.plan(cells, axes)
    assert len(tpts) == len(rpts)
    for a, b in zip(tpts, rpts):
        for k in ("name", "kind", "axes", "weight", "seeds"):
            assert a[k] == b[k], (a["name"], k)
        ca, cb = a["cfg"], b["cfg"]
        for f in ("kind", "n", "label", "costs", "majority", "jitter",
                  "static_relay", "key_mode", "n_keys", "conflict_rate"):
            assert getattr(ca, f) == getattr(cb, f), (a["name"], f)
        for f in ("members", "sizes", "thresh", "region_of",
                  "region_latency"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f))
    assert tbk == rbk
    total = sum(tpts[pi]["seeds"] for _, pairs in tbk for pi, _ in pairs)
    if cells == 1_000_000:
        assert len(tbk) == 24 and total == 1_000_112
    assert total >= cells


def test_bucket_stacking_equals_reference_at_full_size():
    """One whole EPaxos bucket and one group bucket's first chunk of the
    1M-cell study, stacked per config with the grid-wide padded shapes:
    equal to the reference's per-cell stacking."""
    tpts, tbk = tmg.plan(1_000_000)
    rpts, _ = _ref_plan(1_000_000, rmg.FULL_AXES)
    for key in (("epaxos", 9, 4, "wan3"), ("group", 24, 16, "lan")):
        (pairs,) = [p for b, p in tbk if b == key]
        pis = sorted({pi for pi, _ in pairs})
        grid = [(pis.index(pi), k, s) for pi, k in pairs
                for s in range(tpts[pi]["seeds"])][:4096]
        tc = [tpts[pi]["cfg"] for pi in pis]
        rc = [rpts[pi]["cfg"] for pi in pis]
        spec = tvs._pad_spec(tc, grid)
        assert spec == rvs._pad_spec(rc, grid)
        tb = tvs._stack_cells(tc, grid, 0.1, 0.05, pad_to=spec)[0]
        rb = rvs._stack_cells(rc, grid, 0.1, 0.05, pad_to=spec)[0]
        for k in rb:
            assert tb[k].dtype == rb[k].dtype, (key, k)
            assert np.array_equal(tb[k], rb[k]), (key, k)


# ----------------------------------------------- a small study per point
def test_smoke_study_agrees_with_reference(tmp_path):
    """``SMOKE_AXES`` at ~100 cells (both kernels, LAN and wan3, four
    buckets), the port's artifact against the reference's point by point:
    the same scenarios, specs, buckets and cells; committed counts and
    exhausted cells equal, throughput means within one request a cell.
    The points' latency means aggregate per-cell percentiles, which a
    last-bit change can step to a neighbouring sample: the cells
    themselves are held to the reference's envelope in
    ``test_bucket_cells_within_reference_envelope``."""
    kw = dict(axes=tmg.SMOKE_AXES, duration=0.1, warmup=0.05, chunk=32,
              progress=None)
    got = tmg.run_megagrid(100, device="cpu", **kw)
    want = rmg.run_megagrid(100, **kw)
    g, w = got["megagrid"], want["megagrid"]
    assert g["cells"] == w["cells"] == 104 and g["points"] == w["points"]
    assert g["exhausted"] == 0 and g["device_count"] == 1
    assert (g["backend"], g["kernel"], g["impl"]) == ("cpu", "plain",
                                                      "chunked")
    assert [b["bucket"] for b in g["buckets"]] == [
        b["bucket"] for b in w["buckets"]]
    assert [b["cells"] for b in g["buckets"]] == [
        b["cells"] for b in w["buckets"]]
    assert sorted(g["roofline"]) == sorted(w["roofline"])
    assert sorted(got) == sorted(want)
    for a, b in zip(got["scenarios"], want["scenarios"]):
        assert a["name"] == b["name"] and a["spec"] == b["spec"]
        for p, q in zip(a["points"], b["points"]):
            assert p["clients"] == q["clients"]
            assert p["committed"] == q["committed"], a["name"]
            assert p["exhausted"] == q["exhausted"] == 0
            n = p["throughput"]["n"]
            assert abs(p["throughput"]["mean"] - q["throughput"]["mean"]) \
                <= 1.0 / 0.1 / n + 1e-3, a["name"]
            for k in ("median_ms", "p99_ms"):
                assert p[k]["n"] == q[k]["n"] == n


def test_bucket_cells_within_reference_envelope():
    """A LAN group bucket of the smoke study (Paxos and PigPaxos at N = 5
    and 9, R 1-2, PRC 0-1; 4 clients x 5 seeds a point) cell by cell: the
    chunked runner against the reference's one ``simulate_grid`` call,
    counts within one, percentiles rel 1e-5, loads abs 1e-6, or the
    reference's own move with every config's jitter one, two or three f32
    ulps up or down where that is larger (at 4 clients a p99 rests on the
    top three of ~300 samples: one moved request moves it by up to 6e-4,
    and a one-ulp move alone did not reach a cell the port's last bits
    had moved; measured: port 5.8e-4, envelope 6.4e-4)."""
    import dataclasses
    tpts, tbk = tmg.plan(100, tmg.SMOKE_AXES)
    rpts, _ = _ref_plan(100, rmg.SMOKE_AXES)
    (pairs,) = [p for b, p in tbk if b == ("group", 8, 4, "lan")]
    pis = sorted({pi for pi, _ in pairs})
    grid = [(pis.index(pi), k, s) for pi, k in pairs
            for s in range(tpts[pi]["seeds"])]
    rc = [rpts[pi]["cfg"] for pi in pis]
    want = rvs.simulate_grid(rc, grid, 0.1, 0.05)
    got = tvs.simulate_grid_sharded([tpts[pi]["cfg"] for pi in pis], grid,
                                    0.1, 0.05, chunk=32, device="cpu")
    keys = (("count", 1, False), ("committed", 1, False),
            ("median_s", 1e-5, True), ("p25_s", 1e-5, True),
            ("p75_s", 1e-5, True), ("p99_s", 1e-5, True),
            ("m_leader", 1e-6, False), ("m_follower", 1e-6, False))

    def gap(x, k, rel):
        d = np.abs(np.asarray(x[k], np.float64) - want[k])
        return d / np.abs(want[k]) if rel else d
    def jitter(c, ulps):
        j = np.float32(c.jitter)
        return float(j + np.float32(ulps) * np.spacing(j))
    moved = [rvs.simulate_grid(
        [dataclasses.replace(c, jitter=jitter(c, u)) for c in rc],
        grid, 0.1, 0.05) for u in (1, -1, 2, -2, 3, -3)]
    for k, strict, rel in keys:
        tol = np.maximum(strict, np.max([gap(m, k, rel) for m in moved], 0))
        assert (gap(got, k, rel) <= tol).all(), (k, gap(got, k, rel).max())
    assert not got["exhausted"].any()


def test_cli_writes_the_artifact(tmp_path, capsys):
    path = tmp_path / "mg.json"
    assert tmg.main(["--preset", "smoke", "--cells", "30", "--chunk", "16",
                     "--device", "cpu", "--out", str(path),
                     "--duration", "0.05", "--warmup", "0.02"]) == 0
    import json
    art = json.loads(path.read_text())
    assert art["schema"] == "repro-experiments/v1"
    assert art["megagrid"]["cells"] >= 30
    assert "cells/s" in capsys.readouterr().out


def test_reference_and_port_pig_configs_agree():
    """The slices' PigPaxos lowering (PRC 0/1/2) is the reference's."""
    for r, prc in ((2, 1), (4, 0), (4, 2)):
        a = tvs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=r,
                                                           prc=prc))
        b = rvs.build_config("pigpaxos", 25, pig=RefPig(n_groups=r, prc=prc))
        assert np.array_equal(a.thresh, b.thresh) and a.costs == b.costs
