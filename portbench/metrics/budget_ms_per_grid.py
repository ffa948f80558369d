"""Host milliseconds of the profiled grid's step budget: the port's
``budget`` span (the padded shapes, and the scan steps estimated from the
optimistic rate of every grid point), summed."""
from portbench import programspans


def read(ctx):
    return programspans.host_ms(ctx, "budget")
