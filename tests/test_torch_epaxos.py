"""The port's EPaxos kernel against the JAX reference, on the CPU.

Both sides draw the same threefry bits (``prng.randint`` included), so
parity is per cell.  Run op by op (``jax.disable_jit``) the reference
computes exactly the port's arithmetic: the per-step outputs are equal
bit for bit (test (b)).  Under ``jit`` XLA fuses and contracts some of
the step's adds and products, which moves a last bit now and then; the
conflict gate (``L1 < race[k]``), the dependency gate and the fan-in's
order statistic are discrete, so such a bit can move a request, and the
whole runs are held per cell to counts within one request, latency
percentiles rel 1e-5 and message loads abs 1e-6, or, where larger, the
reference's own envelope: the reference run again with its jitter one f32
ulp up and one down (as ``test_torch_vectorsim_branches.py`` does).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import WorkloadConfig as RefWorkload
from repro.core import vectorsim as rvs
from repro.core import wan_topology as ref_wan
from repro.core.network import Topology as RefTopology
from repro_torch.convert import cells_from_numpy
from repro_torch.core import vectorsim as tvs
from repro_torch.core.network import wan_topology
from repro_torch.core.workload import WorkloadConfig

torch.set_num_threads(1)

W3 = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]


def _wan_per(n):
    return [n - 2 * (n // 3), n // 3, n // 3]


def _deployment(name):
    """(n, reference kwargs, port kwargs) of one EPaxos deployment, named
    ``N=<n>/<keys>[/wan3]`` with keys uniform, c=<rate> or zipf."""
    parts = name.split("/")
    n = int(parts[0].split("=")[1])
    keys = parts[1]
    if keys == "uniform":
        wl = {}
    elif keys == "zipf":
        wl = dict(key_dist="zipfian", n_keys=200)
    else:
        wl = dict(key_dist="conflict", conflict_rate=float(keys[2:]))
    rkw = dict(workload=RefWorkload(**wl)) if wl else {}
    tkw = dict(workload=WorkloadConfig(**wl)) if wl else {}
    if parts[-1] == "wan3":
        rkw["topo"] = ref_wan(_wan_per(n), W3)
        tkw["topo"] = wan_topology(_wan_per(n), W3)
    return n, rkw, tkw


DEPLOYMENTS = ["N=5/uniform", "N=9/c=0.1", "N=25/c=0.5", "N=9/zipf",
               "N=25/zipf", "N=9/uniform/wan3", "N=25/c=0.1/wan3",
               "N=49/c=0.02"]


# ------------------------------------------------- (a) host lowering
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_build_config_and_stacked_cells_equal_reference(name):
    n, rkw, tkw = _deployment(name)
    rc = rvs.build_config("epaxos", n, **rkw)
    tc = tvs.build_config("epaxos", n, **tkw)
    for f in ("kind", "n", "static_relay", "majority", "jitter", "costs",
              "label", "key_mode", "n_keys", "conflict_rate", "read_ratio"):
        assert getattr(tc, f) == getattr(rc, f), f
    for f in ("members", "sizes", "thresh", "region_of", "region_latency",
              "key_cdf", "down", "slow"):
        a, b = getattr(tc, f), getattr(rc, f)
        assert (a is None) == (b is None), f
        assert a is None or (a.dtype == b.dtype and np.array_equal(a, b)), f
    grid = [(0, 20, 0), (0, 40, 3), (0, 2, 127)]
    assert tvs._pad_spec([tc], grid) == rvs._pad_spec([rc], grid)
    rb, rk, rkmax = rvs._stack_cells([rc], grid, 0.5, 0.25)
    tb, tk, tkmax = tvs._stack_cells([tc], grid, 0.5, 0.25)
    assert (tk, tkmax) == (rk, rkmax) == ("epaxos", 40)
    assert sorted(tb) == sorted(rb)
    for k in rb:
        assert tb[k].dtype == rb[k].dtype, k
        assert np.array_equal(tb[k], rb[k]), k
    for k in (2, 20, 40):
        assert tvs._estimate_rate(tc, k) == rvs._estimate_rate(rc, k)


def test_mixed_epaxos_grid_stacks_like_reference_and_pins_shapes():
    """Three key distributions and both topologies at one cluster size,
    stacked per config and taken by index: equal to the reference's
    per-cell stacking, and a ``pad_to`` chunk equals that slice of the
    whole grid's batch."""
    names = ["N=9/uniform", "N=9/zipf", "N=9/c=0.5", "N=9/c=0.1/wan3"]
    dep = [_deployment(x) for x in names]
    rcs = [rvs.build_config("epaxos", n, **r) for n, r, _ in dep]
    tcs = [tvs.build_config("epaxos", n, **t) for n, _, t in dep]
    grid = [(ci, k, s) for ci in range(4) for k in (4, 16) for s in (0, 5)]
    rb = rvs._stack_cells(rcs, grid, 0.2, 0.1)[0]
    tb = tvs._stack_cells(tcs, grid, 0.2, 0.1)[0]
    for k in rb:
        assert tb[k].dtype == rb[k].dtype and np.array_equal(tb[k], rb[k]), k
    assert tb["key_cdf"].shape == (16, 1000)
    spec = tvs._pad_spec(tcs, grid)
    part = tvs._stack_cells(tcs, grid[5:9], 0.2, 0.1, pad_to=spec)[0]
    for k in tb:
        assert np.array_equal(part[k], tb[k][5:9]), k


# ---------------------- (b) per-step outputs, reference run op by op
def _capture(lat, t_fin, commit_t, active, ready, loadF, loadL, cell,
             nb=0):
    return {"lat": lat, "t_fin": t_fin, "commit": commit_t,
            "active": active, "ready": ready, "loadF": loadF,
            "loadL": loadL}


@pytest.mark.parametrize("name,clients,steps", [
    ("N=9/c=0.5", 40, 25), ("N=5/zipf", 20, 20),
    ("N=9/c=0.1/wan3", 20, 20)])
def test_steps_equal_reference_run_op_by_op(monkeypatch, name, clients,
                                            steps):
    """One cell's per-step outputs (latency, finish and commit times,
    active flags) and its final clients and loads, the reference's
    ``_epaxos_cell`` run op by op against the port's, bit for bit: the same
    draws, keys, gates, fan-ins and state updates.  The hot-key case
    sends half the requests to key 0, so conflicts and the slow path come
    in the first steps."""
    n, rkw, tkw = _deployment(name)
    cfg = rvs.build_config("epaxos", n, **rkw)
    batch, kind, kmax = rvs._stack_cells([cfg], [(0, clients, 2)], 0.3,
                                         0.1)
    monkeypatch.setattr(rvs, "_summarize", _capture)
    monkeypatch.setattr(tvs, "_summarize", _capture)
    with jax.disable_jit():
        want = rvs._epaxos_cell({k: v[0] for k, v in batch.items()}, steps,
                                kmax)
    got = tvs._run_cells(cells_from_numpy(batch, "cpu"), steps, kmax, 1,
                         kind="epaxos")
    act = np.asarray(want["active"])
    assert act.all()
    for k, v in want.items():
        assert np.array_equal(got[k][0].numpy(), np.asarray(v)), k


# ------------------------------------- (c) the same state, both kernels
def test_run_cells_from_reference_state():
    """The reference's own stacked batch (conflict c=0.1 at N=9),
    carried across with ``cells_from_numpy``, through both the jitted and
    the port's ``_run_cells``: counts within one, percentiles and the mean
    rel 1e-5, loads abs 1e-6, or the reference's own move under its
    jitter one f32 ulp up or down where that is larger."""
    cfg = rvs.build_config("epaxos", 9, workload=RefWorkload(
        key_dist="conflict", conflict_rate=0.1))
    batch, kind, kmax = rvs._stack_cells([cfg], [(0, 20, 1), (0, 8, 2)],
                                         0.1, 0.05)
    steps = 1400

    def ref(b):
        return {k: np.asarray(v) for k, v in rvs._run_cells(
            b, steps, kmax, kind, 1).items()}
    want = ref(batch)
    moved = [ref(dict(batch, jitter=np.nextafter(batch["jitter"],
                                                 np.float32(to))))
             for to in (1.0, 0.0)]
    got = {k: v.numpy() for k, v in tvs._run_cells(
        cells_from_numpy(batch, "cpu"), steps, kmax, 1,
        kind="epaxos").items()}
    assert sorted(got) == sorted(want)
    assert not got["exhausted"].any() and not want["exhausted"].any()
    for k, strict, rel in (("count", 1, False), ("committed", 1, False),
                           ("median_s", 1e-5, True), ("p25_s", 1e-5, True),
                           ("p75_s", 1e-5, True), ("p99_s", 1e-5, True),
                           ("mean_s", 1e-5, True), ("m_leader", 1e-6, False),
                           ("m_follower", 1e-6, False)):
        def gap(x):
            d = np.abs(x.astype(np.float64) - want[k])
            return d / np.abs(want[k]) if rel else d
        tol = max([strict] + [gap(m[k]).max() for m in moved])
        assert gap(got[k]).max() <= tol, (k, gap(got[k]).max(), tol)


# ----------------------------------------- (d) per-cell scenario parity
LAT = ("median_ms", "p25_ms", "p75_ms", "p99_ms")
MSG = ("leader_msgs_per_op", "follower_msgs_per_op")


def _diff(a_units, b_units):
    d = {"count": 0, "lat": 0.0, "msg": 0.0}
    for a, b in zip(a_units, b_units):
        assert (a["clients"], a["seed"]) == (b["clients"], b["seed"])
        d["count"] = max(d["count"], abs(a["count"] - b["count"]),
                         abs(a["committed"] - b["committed"]))
        d["lat"] = max([d["lat"]] + [abs(a[k] / b[k] - 1.0) for k in LAT])
        d["msg"] = max([d["msg"]] + [abs(a[k] - b[k]) for k in MSG])
    return d


def _moved_jitter(rkw, n, to):
    topo = rkw.get("topo") or RefTopology(n=n)
    j = np.nextafter(np.float32(topo.jitter), np.float32(to))
    return dict(rkw, topo=dataclasses.replace(topo, jitter=float(j)))


STRICT = {"count": 1, "lat": 1e-5, "msg": 1e-6}


@pytest.mark.parametrize("name,clients", [
    ("N=5/uniform", (20,)), ("N=25/c=0.5", (40,)), ("N=9/zipf", (20,)),
    ("N=25/c=0.1/wan3", (40,))])
def test_simulate_scenario_matches_reference(name, clients):
    """``simulate_scenario`` per cell against the reference's, within
    STRICT or the reference's own one-ulp envelope where that is larger.
    Measured (the envelope printed beside the port's gap when it fails):
    the port's worst gap stays inside the reference's own move."""
    n, rkw, tkw = _deployment(name)
    kw = dict(clients=clients, seeds=(1, 2), duration=0.1, warmup=0.05)
    want = rvs.simulate_scenario("epaxos", n, **rkw, **kw)
    got = tvs.simulate_scenario("epaxos", n, device="cpu", **tkw, **kw)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        assert a["exhausted"] == b["exhausted"] is False
        assert a["retry_risk"] == b["retry_risk"]
        assert b["count"] > 0
    tol = dict(STRICT)
    for to in (1.0, 0.0):
        moved = rvs.simulate_scenario("epaxos", n,
                                      **_moved_jitter(rkw, n, to), **kw)
        for k, v in _diff(want, moved).items():
            tol[k] = max(tol[k], v)
    worst = _diff(want, got)
    assert all(worst[k] <= tol[k] for k in worst), (worst, tol)


def test_kernel_flag_and_timeline():
    """On the CPU "auto" is the plain fan-in too, so both flags agree
    exactly; ``timeline=True`` adds the completion timeline, whose counts
    are the window's completions."""
    kw = dict(clients=(10,), seeds=(0, 1), duration=0.02, warmup=0.02,
              workload=WorkloadConfig(key_dist="conflict",
                                      conflict_rate=0.5), device="cpu")
    assert (tvs.simulate_scenario("epaxos", 9, kernel="torch", **kw)
            == tvs.simulate_scenario("epaxos", 9, **kw))
    cfg = tvs.build_config("epaxos", 5)
    out = tvs.simulate_grid([cfg], [(0, 8, 0)], 0.03, 0.02, timeline=True,
                            device="cpu")
    assert out["timeline"].shape == (
        1, int(np.ceil((0.02 + 0.03 + 0.2) / 0.05)) + 1)
    assert out["timeline"].sum() >= out["count"][0] > 0
    assert out["scan_steps"] > 0


# ------------------------------------------------------- (e) boundaries
def test_reference_value_errors_keep_their_wording():
    """The batch-level EPaxos refusals, word for word (the config-level
    ones, batch_m, leased reads and fault masks, are held in
    ``test_torch_vectorsim.py``)."""
    cases = [
        (lambda m: m._stack_cells(
            [m.build_config("epaxos", 5), m.build_config("paxos", 5)],
            [(0, 4, 0), (1, 4, 0)], 0.1, 0.05)),
        (lambda m: m._stack_cells(
            [m.build_config("epaxos", 5), m.build_config("epaxos", 9)],
            [(0, 4, 0), (1, 4, 0)], 0.1, 0.05)),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(rvs)
        with pytest.raises(ValueError) as got:
            case(tvs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        rvs.simulate_grid([rvs.build_config("epaxos", 5)], [(0, 4, 0)],
                          0.1, 0.05, obs=True)
    with pytest.raises(ValueError) as got:
        tvs.simulate_grid([tvs.build_config("epaxos", 5)], [(0, 4, 0)],
                          0.1, 0.05, obs=True, device="cpu")
    assert str(got.value) == str(want.value)
