"""Device milliseconds a scan step of the EPaxos step loop's threefry
draws (``core/vectorsim.py::_epaxos_cell``, its ``prng.py`` block a
step): the device's busy time, from the profiled grid's device trace,
inside the CUDA-event intervals the port records around each draw block
(its ``draws`` device spans, ``repro_torch/core/spans.py``), divided by
the grid's scan steps."""
from portbench import devicespans, programspans


def read(ctx):
    return programspans.per_step(ctx, devicespans.busy_ms(ctx, "draws"))
