"""Host milliseconds a scan step spent issuing the threefry draws: the
port's ``draws`` host spans over the profiled grid, summed and divided by
its scan steps.  Where the launch queue is full, a launch waits for room,
so this reads near the draws' device time."""
from portbench import programspans


def read(ctx):
    return programspans.per_step(ctx, programspans.host_ms(ctx, "draws"))
