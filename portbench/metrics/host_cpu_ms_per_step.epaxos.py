"""Host CPU milliseconds a scan step of the EPaxos step loop: the main
thread's CPU time (``time.thread_time``) over the window's grids, divided
by their scan steps.  That thread issues every operation; a launch that
finds the launch queue full spins, so where the device is behind, this
reads near the wall."""
from portbench import yardstick


def read(ctx):
    return yardstick.window_ms_per_step(ctx, "cpu_s")
