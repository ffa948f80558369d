"""The port's copy of the fault-plan lowering (``repro_torch.faults.plan``)
and of the scenario layer's batch-path checks, against the reference:
the avail plans' masks equal, every ``to_masks`` and registration error
word for word."""
import dataclasses

import numpy as np
import pytest

from repro.core import PigConfig as RefPig
from repro.core import WorkloadConfig as RefWorkload
from repro.experiments.scenario import Scenario as RefScenario
from repro.faults import plan as rplan
from repro_torch.core.pig import PigConfig
from repro_torch.core.workload import WorkloadConfig
from repro_torch.experiments import registry
from repro_torch.experiments.scenario import Scenario
from repro_torch.faults import plan as tplan


@pytest.mark.parametrize("name", ["avail/leader/N=25/batch",
                                  "avail/relay/N=25/batch"])
@pytest.mark.parametrize("quick", [True, False])
def test_avail_plans_lower_to_the_reference_masks(name, quick):
    from repro.experiments import registry as ref_registry
    (p,), (r,) = registry.select(name), ref_registry.select(name)
    rs = p.resolve(quick)
    horizon = rs.warmup + rs.duration + 0.5
    want = r.fault_plan().to_masks(r.n, horizon)
    got = p.fault_plan().to_masks(p.n, horizon)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    assert p.fault_plan().materialize(horizon) == \
        r.fault_plan().materialize(horizon)
    assert dataclasses.asdict(p.fault_plan()) == \
        dataclasses.asdict(r.fault_plan())


# events every plan below is built from (both packages take the tuples)
BAD_PLANS = [
    ("crash twice", (("crash", 3, 0.1), ("crash", 3, 0.2))),
    ("recover without crash", (("recover", 3, 0.2),)),
    ("slow factor", (("slow", 2, 0.0, float("inf"), 1e-3, 2.0),)),
    ("slow window", (("slow", 2, 0.1, 0.5, 1e-3, 1.0),)),
    ("membership", (("add_node", 25, 0.2),)),
    ("partition", (("partition", 1, 2, 0.2),)),
    ("heal", (("heal_oneway", 1, 2, 0.2),)),
    ("drop", (("drop", 3, 0.1, 0.2, 0.5),)),
    ("window budget", tuple(ev for i in range(9) for ev in (
        ("crash", 4, 0.1 * i), ("recover", 4, 0.1 * i + 0.05)))),
    ("node outside n", (("crash", 30, 0.1),)),
    ("overlapping slow", (("slow", 2, 0.0, 1.0, 1e-3, 1.0),
                          ("slow", 2, 0.5, 2.0, 1e-3, 1.0))),
]


@pytest.mark.parametrize("what,events", BAD_PLANS,
                         ids=[b[0] for b in BAD_PLANS])
def test_to_masks_errors_keep_their_wording(what, events):
    with pytest.raises(ValueError) as want:
        rplan.FaultPlan(events=events).to_masks(25, 1.0)
    with pytest.raises(ValueError) as got:
        tplan.FaultPlan(events=events).to_masks(25, 1.0)
    assert str(got.value) == str(want.value)
    assert tplan.FaultPlan(events=events).mask_expressible(1.0) is \
        rplan.FaultPlan(events=events).mask_expressible(1.0)


@pytest.mark.parametrize("ev", [("crash", 1), ("boom", 1, 0.1),
                                ("slow", 1, 0.0, 1.0, 0.0)])
def test_event_checks_keep_their_wording(ev):
    with pytest.raises(ValueError) as want:
        rplan.validate_event(ev)
    with pytest.raises(ValueError) as got:
        tplan.validate_event(ev)
    assert str(got.value) == str(want.value)


def test_plan_algebra_and_expansion_match_reference():
    def build(p):
        return (p.crash_window(1, 0.8, 1.2) + p.slow_window(2, 0.0)
                + p.crash_window(5, 2.5) + p.FaultPlan(periodic=(
                    ("crash_recover", 7, 0.4, 0.1, 0.2, 1.5),)))
    r, t = build(rplan), build(tplan)
    assert bool(t) and not tplan.FaultPlan()
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for horizon in (1.0, 2.0, 3.0):
        assert t.materialize(horizon) == r.materialize(horizon)
        want, got = r.to_masks(25, horizon), t.to_masks(25, horizon)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert tplan.jsonify_events(t.materialize(3.0)) == \
        rplan.jsonify_events(r.materialize(3.0))
    # storms expand as the reference's: the same seeded draws
    for kind in ("crash", "partition"):
        r, t = (p.storm(targets=tuple(range(1, 25)), rate_hz=6.0, t0=0.35,
                        t1=1.3, seed=11, kind=kind, max_concurrent=2)
                for p in (rplan, tplan))
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        for horizon in (1.0, 2.0):
            assert t.materialize(horizon) == r.materialize(horizon)


# registration-time checks of the batch path: (what, scenario kwargs built
# from the reference's objects and the port's); every one must raise the
# reference's ValueError
def _bad_specs(wl, p):
    lease_wl = wl(read_ratio=0.9, read_path="lease")
    return [
        ("max_batch", dict(batch={"max_batch": 0})),
        ("divisible", dict(batch={"max_batch": 4}, clients=(30,))),
        ("lease required", dict(workload=lease_wl)),
        ("lease values", dict(lease={"duration_ms": 0.0})),
        ("lease renew", dict(lease={"duration_ms": 100.0,
                                    "renew_ms": 200.0})),
        ("lease drift", dict(lease={"drift_bound": 0.5})),
        ("lease + faults", dict(workload=lease_wl, lease={},
                                faults=p.crash_window(1, 0.1, 0.2))),
        ("lease + batching", dict(workload=lease_wl, lease={},
                                  batch={"max_batch": 2}, clients=(60,))),
        ("quorum reads", dict(workload=wl(read_ratio=0.5,
                                          read_path="quorum"))),
        ("timeline", dict(collect=("timeline",))),
        ("flight", dict(collect=("flight",))),
        ("partition", dict(failures=(("partition", 1, 2, 0.1),))),
        ("bad event", dict(failures=(("crash", 1),))),
        ("node outside n", dict(faults=p.crash_window(40, 0.1, 0.2))),
        ("epaxos obs", dict(protocol="epaxos", pig=None, obs={})),
        ("epaxos lease", dict(protocol="epaxos", pig=None, lease={})),
        ("epaxos faults", dict(protocol="epaxos", pig=None,
                               faults=p.crash_window(1, 0.1, 0.2))),
    ]


SPECS = [what for what, _ in _bad_specs(RefWorkload, rplan)]


@pytest.mark.parametrize("what", SPECS)
def test_scenario_batch_checks_keep_their_wording(what):
    rkw = dict(_bad_specs(RefWorkload, rplan))[what]
    tkw = dict(_bad_specs(WorkloadConfig, tplan))[what]
    base = dict(name="x/batch", protocol="pigpaxos", n=25, backend="batch")
    with pytest.raises(ValueError) as want:
        RefScenario(**{**base, "pig": RefPig(n_groups=3), **rkw})
    with pytest.raises(ValueError) as got:
        Scenario(**{**base, "pig": PigConfig(n_groups=3), **tkw})
    assert str(got.value) == str(want.value)


def test_fault_plan_merges_legacy_failures():
    kw = dict(name="x/batch", protocol="pigpaxos", n=25, backend="batch",
              failures=(("crash", 2, 0.1), ("recover", 2, 0.3)),
              collect=("timeline",))
    r = RefScenario(faults=rplan.slow_window(3, extra_latency=1e-3),
                    pig=RefPig(n_groups=3), **kw)
    t = Scenario(faults=tplan.slow_window(3, extra_latency=1e-3),
                 pig=PigConfig(n_groups=3), **kw)
    assert t.fault_plan().materialize(t.horizon) == \
        r.fault_plan().materialize(r.horizon)
    assert Scenario(name="y/batch", protocol="paxos", n=25).fault_plan() \
        is None
    pd, rd = t.spec_dict(), r.spec_dict()
    assert {k: rd[k] for k in pd} == pd


@pytest.mark.parametrize("quick", [True, False])
def test_artifact_records_the_materialized_faults(quick):
    """A fault scenario's artifact carries the events its run applied (over
    the resolved horizon, inf as null), as the reference's does."""
    from repro.experiments import registry as ref_registry
    from repro.experiments import runner as ref_runner
    from repro_torch.experiments import runner
    for name in ("avail/leader/N=25/batch", "avail/relay/N=25/batch"):
        (p,), (r,) = registry.select(name), ref_registry.select(name)
        got = runner._scenario_artifact(p, [], quick)
        want = ref_runner._scenario_artifact(r, [], quick)
        assert got["faults"] == want["faults"] and got["faults"]
        assert got["consistency"] == want["consistency"] == "model"
