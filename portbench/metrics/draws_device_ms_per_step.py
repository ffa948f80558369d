"""Device milliseconds a scan step of the threefry draws (``prng.py``,
each block of draws of the step loop): the device's busy time, from the
profiled grid's device trace, inside the CUDA-event intervals the port
records around each draw block (its ``draws`` device spans,
``repro_torch/core/spans.py``), divided by the grid's scan steps."""
from portbench import programspans


def read(ctx):
    return programspans.per_step(ctx,
                                 programspans.device_busy_ms(ctx, "draws"))
