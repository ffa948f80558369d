"""Tables 1-2 and the other ``batch_ok`` families (zipf, conflict, wan,
avail) through the port's backend override, per cell against the
reference's override run, on the CPU, quick grids, held as
``figures_parity`` states; and the quick artifacts of the cells that the
regression gate's windows name, through the unchanged gate."""
import json

import pytest

from benchmarks import regression_gate
from figures_parity import check_cell, port_art

# (cell, kind): the tables at N=5 and 25 with 20 clients, and the avail
# relay fault at N=49, are chaotic (the reference's own one-ulp move
# shifts a percentile by 1e-3 to 2e-2), as is EPaxos at c=0.02 (a
# one-ulp move flips a request between the fast and the slow path)
CELLS = [("table1/validate/R=3", "chaotic"),
         ("table2/validate/R=2", "chaotic"),
         ("zipf/pigpaxos/theta=0.99", "damped"),
         ("conflict/N=25/c=0.02", "chaotic"), ("wan/N=25", "damped"),
         ("avail/relay/N=49", "chaotic")]


@pytest.mark.parametrize("name,kind", CELLS, ids=[c[0] for c in CELLS])
def test_cell_matches_reference(name, kind):
    """Measured: table1 R=3 counts 10 of 3585, percentiles 1.0e-2; table2
    R=2 counts 4 of 4040, 1.7e-2; zipf 6.8e-6; conflict c=0.02 counts
    equal, 2.7e-2 (seed 2's p75); wan/N=25 equal; avail/relay/N=49 counts
    37 of 14064, percentiles 6.3e-3, timeline buckets 25 of 607.  Message
    loads equal everywhere; the tables' loads are Eq. 1-3's."""
    worst, tol, got_kind = check_cell(name)
    assert got_kind == kind
    if name.startswith("table"):
        u = port_art(name)["scenarios"][0]["units"][0]["extras"]
        r = int(name.rsplit("=", 1)[1])
        assert u["leader_msgs_per_op"] == 2 * r + 2


GATED = ("zipf/pigpaxos/theta=0.99", "wan/N=25")


def test_gate_windows_hold():
    """The windows of ``benchmarks/reference_bounds.json`` that name the
    cells above."""
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        bounds = json.load(f)["bounds"]
    fed = {"bounds": {n: bounds[n] for n in GATED}}
    seen = {n: port_art(n)["scenarios"][0] for n in GATED}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert sum(line.startswith("ok") for line in lines) == len(GATED)
