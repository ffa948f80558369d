"""The EPaxos step loop's per-key conflict tracking, traced: the ``keys``
span (``core/spans.py``) around its update of ``race`` and ``depk``, and
the ``slow_path_requests`` count in ``simulate_scenario(info=...)``, on the
CPU.

The span opens once a scan step of the EPaxos loop and never in the group
loop; while nothing records it builds nothing; recording changes no
result.  The count is checked against one the test derives from the
cells' own message counts: every request in the window sends 6 n - 4
messages over the nodes, and the slow round 4 (n - 1) more."""
import pytest
import torch

from repro_torch.core import spans
from repro_torch.core import vectorsim as vs
from repro_torch.core.pig import PigConfig
from repro_torch.core.workload import WorkloadConfig

torch.set_num_threads(1)

N = 25
ONE_KEY = WorkloadConfig(n_keys=1)
TINY = {"epaxos": dict(clients=(10, 40), seeds=(1, 2), workload=ONE_KEY),
        "pigpaxos": dict(pig=PigConfig(n_groups=3), clients=(20,),
                         seeds=(1,))}


def _run(protocol, info=None, kernel="auto", **kw):
    args = dict(TINY[protocol], **kw)
    return vs.simulate_scenario(protocol, N, duration=0.03, warmup=0.02,
                                device="cpu", kernel=kernel, info=info,
                                **args)


@pytest.fixture(scope="module")
def recorded():
    """Each tiny grid inside one recording, with its ``info``."""
    infos = {p: {} for p in TINY}
    with spans.recording() as rec:
        for p in TINY:
            _run(p, infos[p])
    return rec, infos


def test_keys_opens_once_a_scan_step_of_the_epaxos_loop(recorded):
    rec, infos = recorded
    entry = {s.grid: s for s in rec.spans if s.name == "entry"}
    assert sorted(entry) == [0, 1]
    keys = [s for s in rec.spans if s.name == "keys"]
    # grid 0 is EPaxos's, grid 1 the group loop's, which has no keys span
    assert {s.grid for s in keys} == {0}
    assert len(keys) == infos["epaxos"]["scan_steps"] > 0
    loop = [i for i, s in enumerate(rec.spans)
            if s.name == "step_loop" and s.grid == 0]
    assert len(loop) == 1 and all(s.parent == loop[0] for s in keys)
    # the CPU records no device interval
    assert rec.device == []
    assert "keys" in [r[0] for r in rec.table()]


def test_while_off_keys_builds_no_span_and_no_event(monkeypatch):
    before = spans.last()

    def refused(*a, **k):
        raise AssertionError("built while recording is off")

    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(spans, "Recorder", refused)
    assert spans.span("keys", torch.device("cuda", 0)) is spans.span("x")
    _run("epaxos")
    assert spans.last() is before and spans._rec is None


@pytest.mark.parametrize("kernel", vs.KERNELS)
def test_recording_changes_no_epaxos_result(kernel):
    info_off, info_on = {}, {}
    off = _run("epaxos", info_off, kernel)
    with spans.recording() as rec:
        on = _run("epaxos", info_on, kernel)
    assert any(s.name == "keys" for s in rec.spans)
    assert on == off
    assert info_on["slow_path_requests"] == info_off["slow_path_requests"]


def test_one_client_never_takes_the_slow_path():
    # a closed-loop client issues its next request after the previous
    # one's reply, long after every peer processed its PreAccept
    info = {}
    units = _run("epaxos", info, clients=(1,), seeds=(1, 2, 3),
                 workload=WorkloadConfig())
    assert sum(u["committed"] for u in units) > 0
    assert info["slow_path_requests"] == 0


def _slow_from_messages(u, n):
    committed = u["committed"]
    msgs = (u["leader_msgs_per_op"]
            + (n - 1) * u["follower_msgs_per_op"]) * committed
    slow = (msgs - (6 * n - 4) * committed) / (4 * (n - 1))
    assert slow == pytest.approx(round(slow), abs=1e-3)
    return round(slow)


def test_slow_path_requests_on_one_key_match_the_messages():
    info = {}
    units = _run("epaxos", info)
    want = [_slow_from_messages(u, N) for u in units]
    assert all(0 <= w <= u["committed"] for w, u in zip(want, units))
    assert sum(want) > 0
    assert info["slow_path_requests"] == sum(want)
    # no unit carries the count: the per-cell fields are the reference's
    assert all("slow_path" not in u for u in units)


def test_the_group_loop_counts_no_slow_path():
    info = {}
    _run("pigpaxos", info)
    assert info["slow_path_requests"] == 0


def test_a_retried_grid_counts_each_cell_once():
    # a budget too small for the first pass: the exhausted cells run
    # again, and their counts replace the first pass's
    cfg = vs.build_config("epaxos", 9, workload=ONE_KEY)
    grid = [(0, 8, 0), (0, 4, 1)]
    want = vs.simulate_grid([cfg], grid, 0.03, 0.02, device="cpu")
    got = vs.simulate_grid_sharded([cfg], grid, 0.03, 0.02, steps=32,
                                   chunk=2, device="cpu")
    assert got["sharding"]["chunks"][0]["retries"] > 0
    assert not got["exhausted"].any()
    assert (got["slow_path"] == want["slow_path"]).all()
    assert want["slow_path"].sum() > 0


def test_the_runner_s_run_record_carries_the_count():
    from repro_torch.experiments import registry, runner
    art = runner.run_scenarios(registry.select("conflict/N=25/c=0.5/batch"),
                               quick=True, device="cpu")
    (sa,) = art["scenarios"]
    committed = sum(u["committed"] for u in sa["units"])
    assert 0 < sa["run"]["slow_path_requests"] <= committed
