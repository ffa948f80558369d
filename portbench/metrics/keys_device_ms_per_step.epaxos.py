"""Device milliseconds a scan step of the EPaxos step loop's per-key
conflict tracking (``core/vectorsim.py::_epaxos_cell``: ``race_new``,
``dep_new`` and the scatters into the (cells, keys) tables ``race`` and
``depk``): the device's busy time, from the profiled grid's device trace,
inside the CUDA-event intervals of the port's ``keys`` device spans,
divided by the grid's scan steps.  None against a port without them."""
from portbench import devicespans, programspans


def read(ctx):
    return programspans.per_step(ctx, devicespans.busy_ms(ctx, "keys"))
