"""Milliseconds a scan step of the EPaxos step loop
(``core/vectorsim.py::_epaxos_cell``): the wall time of the window's
grids over their scan steps, as the entry counts them."""
from portbench import yardstick


def read(ctx):
    return yardstick.window_ms_per_step(ctx, "wall_s")
