"""Device kernels a scan step of the EPaxos step loop: the kernels of the
profiled grid (copies and fills left out) over its scan steps."""
from portbench import yardstick


def read(ctx):
    return yardstick.kernels_per_step(ctx)
