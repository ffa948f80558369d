"""Percent of the profiled grid's window in which no operation ran on
the device (EPaxos step loop): 1 minus the union of the device
intervals over the window."""
from portbench import yardstick


def read(ctx):
    return yardstick.idle_share_pct(ctx)
