"""The batch model of PigPaxos on one LAN, written plainly: closed-loop
clients, a scan step pops each cell's B earliest requests, the leader
serves them as a FIFO (a Lindley recursion), each relay group gets the
fan-out through a rotating random relay, followers are fluid work
backlogs with an M/D/1 wait floor, each relay waits for its threshold of
replies (an order statistic of its group's reply arrivals) and sends an
aggregate, and the leader commits at the aggregate that completes a
majority.

Every quantity carries the cell axis C first; ``dtype`` is the working
precision of every time and cost (float32 as the deployment states; a
lower one is the comparison's control).
"""
from __future__ import annotations

import torch

from . import prng
from .grid import run
from .lowering import CLIENT_STAGGER, CLIENT_START, DRAIN_S, MAX_STEPS
from .summary import summarize

# the burst's random draws come in blocks of scan steps of at most this
# many elements
DRAW_BLOCK = 1 << 21


def _fanin(arr_back, peer_mask, B_r, lo, size, cap, vcoef, md1, c, anchor):
    """The relay of one group (slots [lo, lo + size)) answers after the
    (cap + 1)-th reply it serves: the replies sorted by arrival, the j-th
    served at max(arrival, its backlog) + its service, so the relay is
    done at the largest of the first cap + 1 of
    ``arrival + max(0, backlog + vcoef (arrival - anchor)) + md1 - j c``
    (the j c is added back by the caller).  Masked slots never count."""
    vals = torch.where(peer_mask[:, :, lo:lo + size],
                       arr_back[:, :, lo:lo + size], torch.inf)
    arr_s = torch.sort(vals, dim=2).values
    posf = torch.arange(size, device=vals.device).to(vals.dtype)
    y = arr_s + torch.clamp_min(B_r[:, :, None] + vcoef * (arr_s - anchor),
                                0.0) + md1 - posf * c
    y = torch.where(arr_s < torch.inf, y, -torch.inf)
    return y[:, :, :min(cap, size - 1) + 1].amax(2)


def _run(low, k_clients, keys, scan, breq, kmax, stop_s, warmup_s,
         duration_s, dtype, device):
    C = len(k_clients)
    f32 = dtype
    inf = torch.inf
    sizes_l = low["sizes"]
    G = len(sizes_l)
    F = low["n"] - 1
    B = breq

    def full(v):
        return torch.full((C,), v, dtype=f32, device=device)

    cs = low["costs"]
    c_req, c_fanout, c_rel, c_repl, c_agg, c_replycl = (
        full(cs[k]) for k in ("c_req", "c_fanout", "c_rel", "c_repl",
                              "c_agg", "c_replycl"))
    lat0 = full(low["latency"])
    lat0_c = lat0[:, None, None]
    c_fanout_c, c_rel_c = c_fanout[:, None, None], c_rel[:, None, None]
    c_repl_c, c_agg_c = c_repl[:, None, None], c_agg[:, None, None]
    majf = full(low["majority"])[:, None, None]
    ngf = full(G)
    stop = full(stop_s)
    warmup = full(warmup_s)
    jitter = full(low["jitter"])[:, None, None]
    w_follower = full(low["w_follower"])
    static = low["static_relay"]

    sizes = torch.tensor(sizes_l, device=device)[None].expand(C, G)
    thresh = torch.tensor(low["thresh"], device=device)[None].expand(C, G)
    starts = [sum(sizes_l[:g]) for g in range(G)]
    grp = torch.tensor([g for g, s in enumerate(sizes_l) for _ in range(s)],
                       device=device)[None].expand(C, F)
    pos = torch.tensor([j for s in sizes_l for j in range(s)],
                       device=device)[None].expand(C, F)
    gstart = torch.tensor(starts, device=device)[None].expand(C, G)
    szf = sizes.to(f32)
    grp_b = grp[:, None, :].expand(C, B, F)
    pos_b = pos[:, None, :]
    kk_r = torch.arange(G, device=device).to(f32)
    kk_b = torch.arange(B, device=device).to(f32)
    npeers = torch.clamp_min(sizes - 1, 0)
    npeers_c = npeers[:, None, :]
    acks_b = thresh.to(f32)[:, None, :].expand(C, B, G)
    T_l = c_req + ngf * (c_fanout + c_agg) + c_replycl
    kT = kk_b * T_l[:, None]
    w_peer = c_rel + c_repl
    relay_work = c_fanout[:, None] + npeers.to(f32) * w_peer[:, None] \
        + c_agg[:, None]
    relay_work_f = torch.gather(relay_work, 1, grp)
    relay_load_f = 2.0 * torch.gather(szf, 1, grp)
    caps = [max(t - 2, 0) for t in low["thresh"]]
    kgf_c = torch.tensor(caps, device=device).to(f32)[None, None, :]
    flush_at = (thresh >= 2)[:, None, :]

    kf = torch.arange(kmax, device=device).to(f32)
    ready = torch.where(torch.arange(kmax, device=device)
                        < k_clients[:, None],
                        CLIENT_START + CLIENT_STAGGER * kf, inf)
    cpuF = torch.zeros(C, F, dtype=f32, device=device)
    cpuL = torch.zeros(C, dtype=f32, device=device)
    loadF = torch.zeros(C, F, dtype=f32, device=device)
    loadL = torch.zeros(C, dtype=f32, device=device)
    dt_ewma = torch.ones(C, dtype=f32, device=device)
    t_prev = torch.zeros(C, dtype=f32, device=device)
    lat_o, tfin_o, commit_o, active_o = [], [], [], []
    key = keys[:, None, :]
    n_draw = 2 + 2 * G + 2 * F
    blk = max(1, min(scan, DRAW_BLOCK // (C * B * (n_draw + G))))

    for i in range(scan):
        j = i % blk
        if j == 0:
            idx = torch.arange(i, min(i + blk, scan), device=device)
            ks = prng.split(prng.fold_in(key, idx))
            e_blk = prng.exponential(ks[:, :, 0], (B, n_draw)).to(f32)
            u_blk = prng.uniform(ks[:, :, 1], (B, G)).to(f32)
        t0, cids = torch.sort(ready, dim=1, stable=True)
        t0, cids = t0[:, :B], cids[:, :B]
        active = t0 < stop[:, None]
        any_active = active[:, 0]
        e = e_blk[:, j] * jitter
        e_cl = e[:, :, :2]
        e_Lr = e[:, :, 2:2 + G]
        e_rL = e[:, :, 2 + G:2 + 2 * G]
        e_rp = e[:, :, 2 + 2 * G:2 + 2 * G + F]
        e_pr = e[:, :, 2 + 2 * G + F:]

        # the leader's FIFO over the burst
        aL = t0 + lat0[:, None] + e_cl[:, :, 0]
        start_b = torch.maximum(torch.cummax(aL - kT, dim=1).values + kT,
                                cpuL[:, None] + kT)
        cpuL_next = torch.maximum(
            cpuL, torch.where(active, start_b + T_l[:, None], -inf).amax(1))
        W_L = start_b - aL
        L1 = start_b + c_req[:, None]
        L1_c = L1[:, :, None]
        fan_done = L1_c + (kk_r + 1.0) * c_fanout_c
        cpuL2 = L1 + ngf[:, None] * c_fanout[:, None]

        # each group's relay: a uniform member, or the first when static
        if static:
            j_rel = torch.zeros(C, B, G, dtype=torch.int64, device=device)
        else:
            j_rel = torch.floor(u_blk[:, j] * szf[:, None, :]).long()
        j_rel = torch.minimum(torch.clamp_min(j_rel, 0), npeers_c)
        rel_idx = torch.clamp(gstart[:, None, :] + j_rel, 0, F - 1)

        # follower utilization from the leader's pacing (an EWMA)
        n_act = torch.clamp_min(active.sum(1).to(f32), 1.0)
        last_L1 = torch.where(active, L1, -inf).amax(1)
        dt_ewma = torch.where(
            any_active, 0.95 * dt_ewma + 0.05 * (last_L1 - t_prev) / n_act,
            dt_ewma)
        t_prev = torch.where(any_active, last_L1, t_prev)
        rho = torch.clamp(w_follower / torch.clamp_min(dt_ewma, 1e-9),
                          0.0, 0.95)
        md1 = rho * w_peer / (2.0 * (1.0 - rho))
        rm1_c = (rho - 1.0)[:, None, None]
        md1_c = md1[:, None, None]

        # relays receive the fan-out and pass it to their peers
        arr_rel = fan_done + lat0_c + e_Lr
        B_r = torch.gather(cpuF, 1, rel_idx.reshape(C, B * G)) \
            .reshape(C, B, G) - L1_c
        W_r = torch.clamp_min(B_r + rm1_c * (arr_rel - L1_c), 0.0) + md1_c
        h = arr_rel + W_r + c_fanout_c
        j_rel_f = torch.gather(j_rel, 2, grp_b)
        is_relay = pos_b == j_rel_f
        peer_mask = ~is_relay
        order = (pos_b - (pos_b > j_rel_f).long()).to(f32)
        send_done = torch.gather(h, 2, grp_b) + (order + 1.0) * c_rel_c
        arr_p = send_done + lat0_c + e_rp
        W_p = torch.clamp_min(cpuF[:, None, :] - L1_c
                              + rm1_c * (arr_p - L1_c), 0.0) + md1_c
        doneP = arr_p + W_p + c_rel_c + c_repl_c
        arr_back = doneP + lat0_c + e_pr

        # each relay's reply fan-in and its aggregate to the leader
        relay_free0 = h + npeers_c.to(f32) * c_rel_c
        vcoef = (rho - 1.0)[:, None, None]
        mg = torch.stack([
            _fanin(arr_back, peer_mask, B_r[:, :, g], starts[g], sizes_l[g],
                   caps[g], vcoef, md1[:, None, None], c_repl[:, None, None],
                   L1[:, :, None])
            for g in range(G)], dim=2)
        done_g = (kgf_c + 1.0) * c_repl_c + torch.maximum(relay_free0, mg)
        flush = torch.where(flush_at, done_g, relay_free0)
        agg_sent = flush + c_agg_c

        # the leader's FIFO over aggregates; commit at a majority
        arr_agg = agg_sent + lat0_c + e_rL
        arr_as, perm = torch.sort(arr_agg, dim=2, stable=True)
        cum = torch.cumsum(torch.gather(acks_b, 2, perm), dim=2)
        got = 1.0 + cum >= majf
        kstar = torch.argmax(got.to(torch.int32), dim=2, keepdim=True)
        prefL = torch.cummax(arr_as + W_L[:, :, None] - kk_r * c_agg_c,
                             dim=2).values
        doneL = (kk_r + 1.0) * c_agg_c + torch.maximum(cpuL2[:, :, None],
                                                       prefL)
        commit_done = torch.where(got.any(2),
                                  torch.gather(doneL, 2, kstar)[:, :, 0], inf)
        t_fin = commit_done + c_replycl[:, None] + lat0[:, None] \
            + e_cl[:, :, 1]

        # follower backlogs grow by the burst's work, from the first
        # active request's pacing point; each slot's work a request is a
        # constant (peer or relay), so the burst adds it once a request
        act_b = active[:, :, None]
        relay_slot = is_relay
        n_peer = (act_b & peer_mask).sum(1)
        n_work = n_peer + (act_b & relay_slot).sum(1)
        add_w = torch.zeros(C, F, dtype=f32, device=device)
        for b in range(B):
            add_w = add_w + torch.where(
                n_peer > b, w_peer[:, None],
                torch.where(n_work > b, relay_work_f, 0.0))
        anchored = torch.maximum(
            cpuF, torch.where(any_active, L1[:, 0], 0.0)[:, None])
        cpuF = torch.where(any_active[:, None], anchored + add_w, cpuF)
        cpuL = torch.where(any_active, cpuL_next, cpuL)
        ready = ready.scatter(1, cids, torch.where(active, t_fin, inf))

        # messages at each node of the requests committed in the window
        in_win = active & (commit_done >= warmup[:, None]) \
            & (commit_done <= (stop + DRAIN_S)[:, None])
        win_b = in_win[:, :, None]
        loadF = loadF + (torch.where(win_b & peer_mask, 2.0, 0.0)
                         + torch.where(win_b & relay_slot,
                                       relay_load_f[:, None], 0.0)).sum(1)
        loadL = loadL + torch.where(in_win, 2.0 * ngf[:, None] + 2.0,
                                    0.0).sum(1)

        lat_o.append(t_fin - t0)
        tfin_o.append(t_fin)
        commit_o.append(commit_done)
        active_o.append(active)

    cat = lambda xs: torch.stack(xs, 1).reshape(C, -1)
    return summarize(cat(lat_o), cat(tfin_o), cat(commit_o), cat(active_o),
                     ready, loadL, loadF.sum(1), F, stop[0], warmup[0],
                     full(duration_s)[0])


def simulate(dep, cells, grid_clients, warmup, duration, device,
             dtype=torch.float32, max_steps=MAX_STEPS):
    """Per-cell result dicts (``summary.FIELDS``) of (clients, seed) cells
    of a grid whose client counts are ``grid_clients`` (they set the step
    budget and the client axis)."""
    return run(dep, cells, grid_clients, warmup, duration, device, dtype,
               max_steps, _run)
