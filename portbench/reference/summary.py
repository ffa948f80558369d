"""What a cell reports from its per-request outputs: throughput, counts,
latency mean and percentiles, and messages per committed request.

Float sums over a cell's requests run in one fixed pairwise order, halves
added elementwise, so that a cell's result does not depend on how many
cells are simulated beside it.  Percentiles interpolate linearly between
order statistics, as numpy's default does.
"""
from __future__ import annotations

import torch

from .lowering import DRAIN_S

FIELDS = ("throughput", "count", "committed", "mean_ms", "median_ms",
          "p25_ms", "p75_ms", "p99_ms", "leader_msgs_per_op",
          "follower_msgs_per_op", "exhausted")


def row_sum(x):
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def percentile(sorted_vals, m, q):
    """The q-quantile of the first m[c] entries of each ascending row."""
    dt = sorted_vals.dtype
    n = sorted_vals.shape[1]
    mf = torch.clamp_min(m.to(dt), 1.0)
    idx = q * (mf - 1.0)
    lo = torch.clamp(torch.floor(idx).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = idx - lo.to(dt)
    lov = torch.gather(sorted_vals, 1, lo[:, None])[:, 0]
    hiv = torch.where(hi < m, torch.gather(sorted_vals, 1, hi[:, None])[:, 0],
                      lov)
    v = lov * (1.0 - frac) + hiv * frac
    return torch.where(m > 0, v, torch.nan)


def summarize(lat, t_fin, commit_t, active, ready, load_leader,
              load_followers, n_followers, stop, warmup, duration):
    """(C, requests) outputs -> per-cell numpy arrays.  ``stop``,
    ``warmup`` and ``duration`` are 0-d tensors of the working dtype."""
    dt = lat.dtype
    in_lat = active & (t_fin >= warmup) & (t_fin <= stop)
    in_commit = active & (commit_t >= warmup) & (commit_t <= stop + DRAIN_S)
    count = in_lat.sum(1)
    committed = in_commit.sum(1)
    vals = torch.sort(torch.where(in_lat, lat, torch.inf), dim=1).values
    nf = torch.clamp_min(count.to(dt), 1.0)
    comf = torch.clamp_min(committed.to(dt), 1.0)
    followers = torch.full((), float(n_followers), dtype=dt,
                           device=lat.device)
    out = {"throughput": count.to(dt) / duration, "count": count,
           "committed": committed,
           "mean_s": torch.where(count > 0,
                                 row_sum(torch.where(in_lat, lat, 0.0)) / nf,
                                 torch.nan),
           "median_s": percentile(vals, count, 0.5),
           "p25_s": percentile(vals, count, 0.25),
           "p75_s": percentile(vals, count, 0.75),
           "p99_s": percentile(vals, count, 0.99),
           "m_leader": load_leader / comf,
           "m_follower": load_followers / (followers * comf),
           "exhausted": ready.amin(1) < stop}
    return {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in out.items()}


def units(out):
    """Per-cell dicts of ``FIELDS`` (latencies in ms) from ``summarize``'s
    arrays, in the units the program reports."""
    res = []
    for i in range(len(out["count"])):
        res.append({
            "throughput": float(out["throughput"][i]),
            "count": int(out["count"][i]),
            "committed": int(out["committed"][i]),
            "mean_ms": float(out["mean_s"][i]) * 1e3,
            "median_ms": float(out["median_s"][i]) * 1e3,
            "p25_ms": float(out["p25_s"][i]) * 1e3,
            "p75_ms": float(out["p75_s"][i]) * 1e3,
            "p99_ms": float(out["p99_s"][i]) * 1e3,
            "leader_msgs_per_op": float(out["m_leader"][i]),
            "follower_msgs_per_op": float(out["m_follower"][i]),
            "exhausted": bool(out["exhausted"][i])})
    return res


def merge(dst, src, idx):
    """Write ``src``'s rows over ``dst``'s rows ``idx`` (a retry's cells)."""
    for k, v in src.items():
        dst[k][idx] = v
    return dst
