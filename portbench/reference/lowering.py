"""A deployment file lowered to what the batch model's step loops read:
message costs, relay groups and their thresholds, quorum sizes, the key
model, and the scan-step budget of a grid.

Costs are linear in wire bytes (``base + per_byte * bytes``), taken at
the workload's expected wire sizes, in float64; the step loops read them
rounded once to their working precision.  Only one-region (LAN)
deployments with closed-loop clients, no faults, no batching and no
leased reads are lowered here: that is what the cells state.
"""
from __future__ import annotations

HEADER_BYTES = 24            # type tag + ballot + slot + ids
MAX_STEPS = 400_000          # cap of the exhausted-cell retry loop
DRAIN_S = 0.2                # commits counted up to stop + this
CLIENT_START = 20e-3         # first client's first request
CLIENT_STAGGER = 1e-4        # between the clients' first requests
KEY_MULT = 1_000_003         # cell key = seed * KEY_MULT + config index


def majority(n):
    return n // 2 + 1


def fast_quorum(n):
    """EPaxos's fast-path quorum, ceil(3n / 4)."""
    return (3 * n) // 4 + (1 if (3 * n) % 4 else 0)


def _wires(wl):
    """Expected wire bytes of each message role."""
    wf = float(wl["write_fraction"])
    payload = float(wl["payload_bytes"])
    cmd = 16.0 + wf * payload
    return {"req": HEADER_BYTES + cmd, "p2a": HEADER_BYTES + 16 + cmd,
            "p2b": float(HEADER_BYTES),
            "reply_cl": HEADER_BYTES + 8 + (1.0 - wf) * payload, "cmd": cmd}


def _relay_groups(n, r):
    """Followers 1..n-1 dealt round robin into r groups."""
    followers = list(range(1, n))
    r = max(1, min(r, len(followers)))
    groups = [[] for _ in range(r)]
    for i, f in enumerate(followers):
        groups[i % r].append(f)
    return groups


def _thresholds(groups, n, prc, single_group_majority):
    """Replies a relay waits for, itself included: its group size less
    PRC, raised round robin until they sum to a majority less the
    leader."""
    maj = majority(n)
    if single_group_majority and len(groups) == 1:
        return [min(len(groups[0]), maj - 1)]
    req = [max(1, len(g) - prc) for g in groups]
    i = 0
    while sum(req) < maj - 1:
        if req[i % len(req)] < len(groups[i % len(req)]):
            req[i % len(req)] += 1
        i += 1
        if i > 4 * len(req):
            break
    return [min(q, len(g)) for q, g in zip(req, groups)]


def _check(dep):
    net = dep["network"]
    if net["kind"] != "lan":
        raise ValueError(f"{dep['name']}: the reference lowers one-region "
                         f"(lan) deployments only, not {net['kind']!r}")
    if dep["clients"] != "closed":
        raise ValueError(f"{dep['name']}: closed-loop clients only")


def lower(dep):
    """The deployment dict -> a dict of float64 costs and integer layout."""
    _check(dep)
    cm, wl, net = dep["cost_model"], dep["workload"], dep["network"]
    base, pb = float(cm["base_s"]), float(cm["per_byte_s"])
    w = _wires(wl)
    n = int(dep["n"])
    out = {"n": n, "latency": float(net["oneway_latency_s"]),
           "jitter": float(net["jitter_s"]), "majority": majority(n)}
    if dep["protocol"] == "epaxos":
        if wl["key_dist"] not in ("uniform", "conflict"):
            raise ValueError(f"{dep['name']}: key_dist "
                             f"{wl['key_dist']!r} is not lowered")
        dep_cost = float(cm["epaxos_extra_per_node_s"]) * n
        broadcast = base + pb * (HEADER_BYTES + w["cmd"] + 12 + 8 * n) \
            + dep_cost
        out.update(kind="epaxos", fq=fast_quorum(n),
                   n_keys=int(wl["n_keys"]),
                   conflict_rate=(float(wl["conflict_rate"])
                                  if wl["key_dist"] == "conflict" else None),
                   costs={"c_req": base + pb * w["req"],
                          "c_pa": broadcast,
                          "c_par": base + pb * (HEADER_BYTES + 12 + 8 * n)
                          + dep_cost,
                          "c_com": broadcast,
                          "c_replycl": base + pb * w["reply_cl"],
                          "c_acc": broadcast,
                          "c_accr": base + pb * (HEADER_BYTES + 16)})
        return out
    if dep["protocol"] != "pigpaxos":
        raise ValueError(f"{dep['name']}: protocol {dep['protocol']!r} is "
                         f"not lowered")
    groups = _relay_groups(n, int(dep["relay_groups"]))
    thresh = _thresholds(groups, n, int(dep["prc"]),
                         bool(dep["single_group_majority"]))
    wrap = HEADER_BYTES + 8 + w["p2a"]
    costs = {"c_req": base + pb * w["req"], "c_fanout": base + pb * wrap,
             "c_rel": base + pb * wrap,
             "c_repl": base + pb * (HEADER_BYTES + 8 + w["p2b"]),
             "c_agg": base + pb * (HEADER_BYTES + 16),
             "c_replycl": base + pb * w["reply_cl"]}
    sizes = [len(g) for g in groups]
    # mean work a request leaves at a follower: the utilization estimate
    w_follower = (len(sizes) * (costs["c_fanout"] + costs["c_agg"])
                  + 2.0 * float(sum(s - 1 for s in sizes))
                  * (costs["c_rel"] + costs["c_repl"])) / max(n - 1, 1)
    out.update(kind="group", sizes=sizes, thresh=thresh,
               static_relay=not bool(dep["rotate_relays"]), costs=costs,
               w_follower=w_follower)
    return out


def estimate_rate(low, k):
    """An optimistic committed-requests/s bound for k clients: it sizes the
    scan-step budget (an exhausted cell retries with twice the steps)."""
    c = low["costs"]
    b, jit = low["latency"], low["jitter"]
    if low["kind"] == "epaxos":
        n = low["n"]
        per_node = 2.0 * (n - 1) * (c["c_pa"] + c["c_par"] + c["c_com"]) / n
        rt = 4 * (b + jit) + (n - 1) * c["c_pa"] + 3 * c["c_pa"]
        return min(1.0 / per_node, k / rt)
    sizes = [float(s) for s in low["sizes"]]
    ng = len(sizes)
    leader_cpu = c["c_req"] + ng * (c["c_fanout"] + c["c_agg"]) \
        + c["c_replycl"]
    fol_cpu = (ng * (c["c_fanout"] + c["c_agg"])
               + 2.0 * float(sum(s - 1 for s in sizes))
               * (c["c_rel"] + c["c_repl"]))
    fol_bound = (low["n"] - 1) / fol_cpu if fol_cpu > 0 else float("inf")
    rt = (2 * b + 2 * b + 2 * b + 6 * jit + leader_cpu + c["c_fanout"]
          + max(sizes) * (c["c_rel"] + c["c_repl"]))
    return min(1.0 / leader_cpu, fol_bound, k / rt)


def budget(low, clients, warmup, duration):
    """(requests budgeted a cell, requests a scan step, the widest client
    count) of a grid over ``clients``: the budget covers the fastest
    client count's requests in [0, stop) with 15% to spare."""
    kmax = max(clients)
    rate = max(estimate_rate(low, k) for k in clients)
    steps = int(rate * (warmup + duration) * 1.15) + kmax + 64
    breq = min(8, kmax) if low["kind"] == "group" else 1
    return min(steps, MAX_STEPS), breq, kmax


def cell_key(seed):
    """A cell's (hi, lo) key words from its seed (one deployment a grid)."""
    s = int(seed) * KEY_MULT
    return (s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF
