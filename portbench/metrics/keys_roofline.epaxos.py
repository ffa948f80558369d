"""The EPaxos loop's per-key conflict tracking against its roofline (the
port's ``keys`` device spans, once a scan step): the least time for the
bytes its work needs (``keys_bytes``) at the HBM peak, over the device's
busy time inside the spans' CUDA-event intervals.  Like the fan-in's
readers it takes the profiled grid's first pass (a retry runs fewer
cells): the first ``keys`` intervals, as many as the fewest scan steps any
grid of the run took.  None against a port without the spans."""
from portbench import devicespans, yardstick


def keys_bytes(C: int, n: int) -> int:
    """Bytes one scan step's per-key update needs, each read or written
    once: the peers' PreAccept arrivals and backlogs (f32) and the peer
    mask (one byte) as C x n; a cell's key (int64), its active flag (one
    byte) and six f32 values (the PreAccept cost, the commit known to all,
    the mean propagation base, the jitter, the key's ``race`` and ``depk``
    entries); and the one f32 of ``race`` and of ``depk`` it writes a
    cell.  The copies of the whole tables that an out-of-place scatter
    makes are not counted: they are not the work."""
    return C * (9 * n + 8 + 1 + 6 * 4 + 2 * 4)


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    steps = min([g["scan_steps"] for g in ctx["window"]] + [t["scan_steps"]])
    ms = devicespans.busy_ms(ctx, "keys", steps)
    if ms is None:
        return None
    return yardstick.roofline_share_pct(
        steps * keys_bytes(ctx["shapes"]["C"], int(ctx["config"]["n"])),
        1e-3 * ms)
