"""``correct`` comes out false when the timed path is broken underneath
the harness, once for each fault a cell can have, and when the control
(the reference in bfloat16) stands in the program's place.  (The
exchange between chips cannot be left out: every cell runs on one chip
and its cells are independent.)"""
import pytest
import torch

from portbench import control, system
from portbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_sound_run_is_correct(cell, cell_roots):
    out = tiny.run(cell, cell_roots[cell])
    assert out["correct"] and out["failed"] == 0, out["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, cell_roots,
                                                          monkeypatch):
    # every scan step derives its draws from step 0's state
    from repro_torch import prng
    fold_in = prng.fold_in
    monkeypatch.setattr(prng, "fold_in", lambda keys, data: fold_in(
        keys, torch.zeros_like(torch.as_tensor(data))))
    assert not tiny.run(cell, cell_roots[cell])["correct"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_half_the_grid_left_out_is_caught(cell, cell_roots, monkeypatch):
    # the entry simulates the first half of the seeds and fills the other
    # half's rows from them
    vectorsim = system.port()[0]
    entry = vectorsim.simulate_scenario

    def half(*args, seeds, **kw):
        kept = tuple(seeds[:max(1, len(seeds) // 2)])
        units = entry(*args, seeds=kept, **kw)
        out = []
        for k in kw["clients"]:
            rows = [u for u in units if u["clients"] == k]
            for i, s in enumerate(seeds):
                out.append(dict(rows[i % len(rows)], seed=s))
        return out

    monkeypatch.setattr(vectorsim, "simulate_scenario", half)
    out = tiny.run(cell, cell_roots[cell])
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, cell_roots,
                                                          monkeypatch):
    # the fan-in answers with the next order statistic: one reply more
    from repro_torch.kernels import ops, segfanin
    groups, rows = ops.seg_fanin_groups, segfanin.seg_fanin_rows
    monkeypatch.setattr(ops, "seg_fanin_groups",
                        lambda grp, gstart, sizes, kg, B, plain=False:
                        groups(grp, gstart, sizes, kg + 1, B, plain))
    monkeypatch.setattr(segfanin, "seg_fanin_rows",
                        lambda vals, coef, segid, kcap, scal, rpc:
                        rows(vals, coef, segid,
                             torch.clamp(kcap + 1, max=vals.shape[1] - 1),
                             scal, rpc))
    assert not tiny.run(cell, cell_roots[cell])["correct"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell, cell_roots):
    ok, bad, checks = control.control_reading(cell, tiny.SEED, "cpu",
                                              mix=tiny.MIXES[cell],
                                              root=cell_roots[cell])
    assert not ok and bad > 0
    assert checks["worst_rel_gap"]["value"] > checks["worst_rel_gap"][
        "limit"]
