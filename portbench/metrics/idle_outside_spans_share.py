"""Percent of the profiled grid's window in which the device is idle and
no span of the port is open: the device trace's idle gaps less what the
port's spans of that grid cover (both on the host's clock)."""
from portbench import programspans


def read(ctx):
    return programspans.idle_outside_pct(ctx)
