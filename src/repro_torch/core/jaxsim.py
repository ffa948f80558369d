"""Vectorized performance model of Pig/Paxos communication (port of
``repro.core.jaxsim``; the module keeps the reference's name so that a
reader finds its counterpart).  Plain functions on tensors, on an
explicit device (CUDA unless the caller passes "cpu").

1. Monte-Carlo relay rotation (``relay_load_mc``): samples relay choices
   for thousands of rounds at once and returns per-node message-load
   statistics — the amortization effect of rotation (§3.1) and M_f with
   its variance, plus the static relay hotspot that makes sqrt(N) optimal
   without rotation (§5.2).  The relay draws are the reference's threefry
   bits (``repro_torch.prng``), so the loads equal the reference's.

2. Queueing model (``latency_curve``): each node is an M/D/1 server with
   service time = CPU cost/message (§2.2).  Request latency is the sum of
   hop latencies + queue waits along the Pig path; saturation = the
   busiest node reaching utilization 1.
"""
from __future__ import annotations

import torch

from .. import prng
from ..device import resolve_device
from .analytical import epaxos_messages
from .vectorsim import _row_sum


# ---------------------------------------------------------------- Monte Carlo
def relay_load_mc(key: torch.Tensor, n: int, r: int, rounds: int,
                  rotating: bool = True, device=None) -> dict:
    """Per-node messages/round across ``rounds`` Pig rounds (leader = node
    0); ``key`` is a ``prng.PRNGKey``.

    Returns dict with 'mean' (n,), 'maxavg' (scalar: busiest node's mean
    load), 'leader' (scalar), 'follower_mean' and 'per_round' (rounds, n).
    Message accounting matches network.py: every send counts at both
    endpoints.  The loads are small integers, so their sums are exact in
    any order; the follower mean sums in one fixed order, so the card and
    the CPU agree bit for bit."""
    dev = resolve_device(device)
    f32 = torch.float32
    followers = n - 1
    sizes = torch.full((r,), followers // r, device=dev)
    sizes[:followers % r] += 1
    group_of = torch.repeat_interleave(torch.arange(r, device=dev), sizes)
    loads = torch.zeros(rounds, n, dtype=f32, device=dev)
    # leader: 2R + 2 per round (client io included)
    loads[:, 0] = 2 * r + 2
    keys = prng.split(key.to(dev), rounds)                 # (rounds, 2)
    if rotating:
        score = prng.uniform(keys, (followers,))           # (rounds, F)
    else:
        # static: the first member of each group
        score = torch.arange(followers, dtype=f32, device=dev) \
            .expand(rounds, followers)
    # relay of group g = argmin score within group (the first of equal
    # minima)
    in_grp = group_of[None, :] == torch.arange(r, device=dev)[:, None]
    masked = torch.where(in_grp, score[:, None, :], torch.inf)
    relay_idx = torch.argmin(masked, dim=2)                # (rounds, r)
    relay_load = (2.0 + 2.0 * (sizes - 1)).to(f32)         # fanout+agg + RTs
    f = torch.full((rounds, followers), 2.0, dtype=f32, device=dev) \
        .scatter(1, relay_idx, relay_load.expand(rounds, r))
    loads[:, 1:] = f
    mean = loads.sum(0) / torch.full((), float(rounds), device=dev)
    fmean = _row_sum(mean[None, 1:])[0] / torch.full(
        (), float(followers), device=dev)
    return {"mean": mean, "maxavg": mean.max(), "leader": mean[0],
            "follower_mean": fmean, "per_round": loads}


def mc_summary(n: int, r: int, rounds: int = 4096, rotating: bool = True,
               seed: int = 0, device=None) -> dict:
    out = relay_load_mc(prng.PRNGKey(seed), n, r, rounds, rotating,
                        device=device)
    return {k: v.cpu().numpy() for k, v in out.items() if k != "per_round"}


# ---------------------------------------------------------------- queueing
def _md1_wait(lam: torch.Tensor, s: float) -> torch.Tensor:
    """Mean wait in an M/D/1 queue with arrival rate lam, service time s."""
    rho = torch.clamp(lam * s, 0.0, 0.999)
    return rho * s / (2.0 * (1.0 - rho))


def latency_curve(offered, n: int, r: int, cpu_per_msg: float = 10e-6,
                  hop: float = 0.25e-3, protocol: str = "pigpaxos",
                  device=None) -> dict:
    """Mean request latency vs offered load (req/s, an f32 tensor or a
    sequence).  Returns latency (s) and per-node utilizations; latency ->
    inf past saturation."""
    dev = resolve_device(device)
    offered = torch.as_tensor(offered, dtype=torch.float32, device=dev)
    if protocol == "paxos":
        m_l = 2.0 * (n - 1) + 2.0
        m_f = 2.0
        hops = 4          # client->L, L->F, F->L, L->client
    elif protocol == "pigpaxos":
        m_l = 2.0 * r + 2.0
        m_f = 2.0 * (n - r - 1) / (n - 1) + 2.0
        hops = 6          # client->L, L->relay, relay->F, F->relay, relay->L, L->client
    else:  # epaxos (conflict-free fast path), all nodes symmetric
        m_f = epaxos_messages(n)
        m_l = m_f
        hops = 4
    visits_l, visits_f = m_l, m_f   # CPU touches per request
    lam_l = offered * m_l
    lam_f = offered * m_f
    w_l = _md1_wait(lam_l, cpu_per_msg)
    w_f = _md1_wait(lam_f, cpu_per_msg)
    # each request pays leader queueing on its leader-CPU visits and one
    # follower/relay queue per remote hop
    lat = (hops * hop + visits_l * (w_l + cpu_per_msg)
           + visits_f * (w_f + cpu_per_msg))
    rho_l = lam_l * cpu_per_msg
    sat = torch.where(rho_l >= 1.0, torch.inf, 0.0)
    return {"latency": lat + sat, "rho_leader": rho_l,
            "rho_follower": lam_f * cpu_per_msg}


def saturation_point(n: int, r: int, cpu_per_msg: float = 10e-6,
                     protocol: str = "pigpaxos") -> float:
    if protocol == "paxos":
        m = 2.0 * (n - 1) + 2.0
    elif protocol == "pigpaxos":
        m = max(2.0 * r + 2.0, 2.0 * (n - r - 1) / (n - 1) + 2.0)
    else:
        m = epaxos_messages(n)
    return 1.0 / (m * cpu_per_msg)

