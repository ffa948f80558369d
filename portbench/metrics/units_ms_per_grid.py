"""Host milliseconds of the profiled grid's result assembly: the port's
``units`` span (``simulate_scenario``'s per-cell result dicts, built
after the results reach the host)."""
from portbench import programspans


def read(ctx):
    return programspans.host_ms(ctx, "units")
