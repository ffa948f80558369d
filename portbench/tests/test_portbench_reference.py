"""The frozen plain reference against the port's entry on the CPU, at a
tiny size, for both kernels: equal in every field of every cell."""
import math

import pytest
import torch

from portbench import spec, system, traffic, yardstick
from portbench.reference import lowering, prng
from portbench.tests import tiny


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_reference_equals_the_entry_cell_for_cell(cell):
    dep = tiny.config(cell)
    mix = tiny.MIXES[cell]
    g = traffic.grid(mix, tiny.SEED, 0)
    prog = system.simulate(dep, g, "cpu", {})
    ref = spec.reference(dep).simulate(dep, g.cells, tuple(mix["clients"]),
                                       mix["warmup_s"], mix["duration_s"],
                                       "cpu")
    assert len(prog) == len(ref) == len(g)
    for p, r in zip(prog, ref):
        assert p["count"] > 0
        for f in r:
            assert _same(p[f], r[f]), (cell, p["clients"], p["seed"], f)


def test_lowering_matches_the_port_s_groups_quorums_and_budget():
    from repro_torch.core import vectorsim
    from repro_torch.core.pig import partition_followers, required_per_group
    from repro_torch.core.quorums import fast_quorum, majority
    for n, r, prc in ((25, 3, 1), (25, 5, 0), (49, 7, 2), (9, 1, 0)):
        groups = lowering._relay_groups(n, r)
        assert groups == partition_followers(list(range(1, n)), r)
        want = [min(q, len(g)) for q, g in zip(
            required_per_group(groups, n, prc, False), groups)]
        assert lowering._thresholds(groups, n, prc, False) == want
        assert lowering.majority(n) == majority(n)
        assert lowering.fast_quorum(n) == fast_quorum(n)
    for cell in tiny.CELLS:
        dep = tiny.config(cell)
        cfg = vectorsim.build_config(**system.entry_kwargs(dep))
        low = lowering.lower(dep)
        assert low["costs"] == cfg.costs
        for k in (10, 60, 120):
            assert lowering.estimate_rate(low, k) == \
                vectorsim._estimate_rate(cfg, k)


def test_draws_match_the_port_s():
    from repro_torch import prng as port
    keys = torch.tensor([[0, 7], [3, 2 ** 32 - 1], [123456, 654321]])
    idx = torch.arange(5)
    assert torch.equal(prng.fold_in(keys[:, None], idx),
                       port.fold_in(keys[:, None], idx))
    ks = prng.split(keys, 5)
    assert torch.equal(ks, port.split(keys, 5))
    for a, b in ((prng.exponential(ks, (3, 4)), port.exponential(ks, (3, 4))),
                 (prng.uniform(ks, (7,)), port.uniform(ks, (7,))),
                 (prng.randint(ks, (), 0, 25), port.randint(ks, (), 0, 25))):
        assert torch.equal(a, b)


def test_yardstick_arithmetic():
    assert yardstick.interval_union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
    # chip_smoke's byte counts of the grouped entry and the EPaxos path
    R, F, G, C = 4095 * 8, 24, 3, 4095
    assert yardstick.fanin_group_bytes(C, 8, F, G) == (
        4 * R * F + R * F + 4 * R * G + 4 * C * F + 8 * C * G + 12 * C
        + 4 * R + 4 * R * G)
    assert yardstick.fanin_epaxos_bytes(4095, 25) == 4 * (4095 * 25
                                                          + 7 * 4095)
    assert yardstick.roofline_share_pct(3.35e12, 2.0) == 50.0
    assert yardstick.roofline_share_pct(1, 0) is None
    assert yardstick.per_step_ms(1.0, 0) is None
