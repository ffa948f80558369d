"""The batch lowering, on the CPU: a grid lowered as its configs' rows
(once a grid) and its cells' columns (config index, clients, key), the
rows gathered to the cells on the device, against the per-cell batch
``_stack_cells`` builds (which the parity tests hold to the reference);
the step budget over the distinct (config, clients) points against the
per-cell maximum; and the bytes the lowering copies to the device.

Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.convert import cells_from_numpy
from repro_torch.core import vectorsim as vs
from repro_torch.core.network import wan_topology
from repro_torch.core.pig import PigConfig
from repro_torch.core.workload import WorkloadConfig
from repro_torch.experiments import megagrid as mg

BIG_SEED = 2**31 + 7

W3 = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]


def _configs(name):
    """A config list of each kind the lowering and the budget branch on."""
    if name == "group":
        return [vs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=3)),
                vs.build_config("paxos", 9)]
    if name == "epaxos":
        return [vs.build_config("epaxos", 25, workload=WorkloadConfig(
                    key_dist="conflict", conflict_rate=0.02)),
                vs.build_config("epaxos", 25, workload=WorkloadConfig(
                    key_dist="zipfian", n_keys=500))]
    if name == "leased-read":
        return [vs.build_config("paxos", 25, workload=WorkloadConfig(
                    read_ratio=0.9, read_path="lease")),
                vs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=3),
                                workload=WorkloadConfig(read_ratio=0.5,
                                                        read_path="lease"))]
    assert name == "wan"
    return [vs.build_config("pigpaxos", 15,
                            pig=PigConfig(n_groups=3, prc=1),
                            topo=wan_topology([5, 5, 5], W3)),
            vs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=3))]


def _grid(n_configs, clients, seeds):
    return [(ci, k, s) for ci in range(n_configs) for k in clients
            for s in seeds]


def _bucket(key, cells=2_000):
    """One bucket of the megagrid study's plan: its configs and grid."""
    pts, buckets = mg.plan(cells)
    (pairs,) = [p for b, p in buckets if b == key]
    pis = sorted({pi for pi, _ in pairs})
    grid = [(pis.index(pi), k, s) for pi, k in pairs
            for s in range(pts[pi]["seeds"])]
    return [pts[pi]["cfg"] for pi in pis], grid


def _lowered(configs, part, spec, duration, warmup, ridx=None):
    """The runner's lowering of a chunk (``part``, a grid array) on the
    CPU device: the rows shipped, the columns (or a retry's subset of
    them) gathered."""
    rows = cells_from_numpy(vs._config_rows(configs, spec, duration, warmup),
                            "cpu")
    cols = vs._cell_columns(part)
    if ridx is not None:
        cols = {k: v[ridx] for k, v in cols.items()}
    return vs._device_cells(rows, cols, "cpu")[0]


def _assert_same_cells(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


# ----------------------------------- (a) rows + columns == the stacked batch
@pytest.mark.parametrize("name", ["group", "epaxos", "wan"])
def test_one_config_grid_gathers_to_the_stacked_batch(name):
    cfg = _configs(name)[:1]
    grid = _grid(1, (20, 60, 120), (0, 3, BIG_SEED))
    spec = vs._pad_spec(cfg, grid)
    got = _lowered(cfg, vs._grid_array(grid), spec, 0.5, 0.25)
    want = cells_from_numpy(vs._stack_cells(cfg, grid, 0.5, 0.25)[0], "cpu")
    _assert_same_cells(got, want)


BUCKETS = [("group", 24, 16, "lan"), ("epaxos", 9, 4, "wan3")]


@pytest.mark.parametrize("key", BUCKETS, ids=lambda k: "-".join(map(str, k)))
@pytest.mark.parametrize("where", ["first", "ragged-last", "retry"])
def test_megagrid_chunk_gathers_to_the_stacked_batch(key, where):
    """A multi-config megagrid bucket in chunks of 64 under the whole
    bucket's padded shapes: its first chunk, its ragged last chunk (padded
    with its last cell, as the runner pads it) and a retry subset of the
    first (padded back to an even count, as for two devices)."""
    cfgs, grid = _bucket(key)
    assert len(cfgs) > 1 and len(grid) % 64
    spec = vs._pad_spec(cfgs, grid)
    size = 64
    lo = 0 if where != "ragged-last" else len(grid) - len(grid) % size
    part = vs._chunk(vs._grid_array(grid), lo, size)
    want_grid = list(grid[lo:lo + size])
    want_grid += [want_grid[-1]] * (size - len(want_grid))
    assert np.array_equal(part, np.asarray(want_grid))
    ridx = None
    if where == "retry":
        ridx = np.resize(np.array([1, 5, 17, 40, 63]), 6)
        want_grid = [want_grid[i] for i in ridx]
    got = _lowered(cfgs, part, spec, 0.1, 0.05, ridx)
    want = cells_from_numpy(
        vs._stack_cells(cfgs, want_grid, 0.1, 0.05, pad_to=spec)[0], "cpu")
    _assert_same_cells(got, want)


# ------------------------------ (b) the budget over distinct (config, k)
@pytest.mark.parametrize("name", ["group", "epaxos", "leased-read", "wan"])
def test_budget_over_distinct_points_equals_the_per_cell_maximum(name):
    cfgs = _configs(name)
    grid = _grid(len(cfgs), (4, 20, 60, 120), range(50))
    kmax, stop = 120, 0.35
    rate = max(vs._estimate_rate(cfgs[ci], k) for ci, k, _ in grid)
    want = int(rate * stop * 1.15) + kmax + 64
    assert vs._step_budget(cfgs, vs._grid_array(grid), kmax, stop) == want


def test_budget_of_the_megagrid_bucket_equals_the_per_cell_maximum():
    cfgs, grid = _bucket(("group", 24, 16, "lan"))
    kmax = vs._pad_spec(cfgs, grid)["kmax"]
    rate = max(vs._estimate_rate(cfgs[ci], k) for ci, k, _ in grid)
    assert vs._step_budget(cfgs, vs._grid_array(grid), kmax, 0.15) == \
        int(rate * 0.15 * 1.15) + kmax + 64


# ------------------------------------------ (c) the bytes the lowering ships
def _row_bytes(rows):
    """The rows' bytes as ``cells_from_numpy`` ships them (every integer
    type as int64)."""
    return sum(a.size * (8 if a.dtype.kind in "iu" else a.itemsize)
               for a in rows.values())


@pytest.mark.parametrize("protocol,clients,seeds", [
    ("epaxos", (4, 8), (0, 1)),
    ("epaxos", (6,), (0, 1, 2, BIG_SEED)),
    ("pigpaxos", (4, 8), (0, 1, 2)),
])
def test_lowered_bytes_are_the_row_and_32_a_cell(protocol, clients, seeds):
    kw = {"pig": PigConfig(n_groups=3)} if protocol == "pigpaxos" else {}
    info = {}
    units = vs.simulate_scenario(protocol, 25, clients=clients, seeds=seeds,
                                 duration=0.02, warmup=0.01, device="cpu",
                                 info=info, **kw)
    assert not any(u["exhausted"] for u in units) and info["retries"] == 0
    cfg = vs.build_config(protocol, 25, **kw)
    grid = _grid(1, clients, seeds)
    rows = vs._config_rows([cfg], vs._pad_spec([cfg], grid), 0.02, 0.01)
    cells = len(clients) * len(seeds)
    assert info["lowered_bytes"] == 32 * cells + _row_bytes(rows)
    if protocol == "epaxos":
        # the 1,000-key CDF is in the row, not in every cell
        assert info["lowered_bytes"] < 4 * 1000 * 2 + 32 * cells


def test_chunks_ship_the_rows_once():
    """A grid in three chunks over two devices: the rows go to each device
    once, every chunk ships its cells' columns alone."""
    cfgs = _configs("group")
    grid = _grid(2, (4, 8), range(5))     # 20 cells: chunks of 8, 8, 4
    out = vs.simulate_grid_sharded(cfgs, grid, 0.02, 0.01, chunk=8,
                                   devices=["cpu", "cpu"])
    rows = vs._config_rows(cfgs, vs._pad_spec(cfgs, grid), 0.02, 0.01)
    chunks = out["sharding"]["chunks"]
    assert [c["retries"] for c in chunks] == [0, 0, 0]
    assert [c["lowered_bytes"] for c in chunks] == [
        2 * _row_bytes(rows) + 32 * 8, 32 * 8, 32 * 8]
