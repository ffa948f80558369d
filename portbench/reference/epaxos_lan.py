"""The batch model of EPaxos on one LAN, written plainly: a scan step pops
each cell's earliest client request; a random replica coordinates it,
broadcasts PreAccept and commits on the fast path after a fast quorum of
replies, or, when the previous instance of the same key is still
propagating (a conflict), after a second, Paxos-accept round to a
majority; execution waits for the previous same-key instance's commit to
be known everywhere.  Every replica's CPU is a fluid work backlog.

Keys are uniform over ``n_keys``, or, under the hot-key model, key 0
with probability ``conflict_rate`` and else uniform over the others.
``dtype`` is the working precision of every time and cost.
"""
from __future__ import annotations

import torch

from . import prng
from .grid import run
from .lowering import CLIENT_STAGGER, CLIENT_START, DRAIN_S, MAX_STEPS
from .summary import summarize

DRAW_BLOCK = 1 << 21


def _quorum_done(arr_back, backlog, c, anchor, cap):
    """The coordinator serves the replies in arrival order, each at
    max(arrival, its backlog) + c; the quorum is complete after the
    (cap + 1)-th: the largest of the first cap + 1 of
    ``arrival + max(0, backlog - (arrival - anchor) / 2) - j c`` (the
    coordinator's backlog drains at half rate meanwhile; the j c is added
    back by the caller).  Masked (+inf) replies never count."""
    n = arr_back.shape[1]
    arr_s = torch.sort(arr_back, dim=1).values
    posf = torch.arange(n, device=arr_back.device).to(arr_back.dtype)
    half = torch.full((), -0.5, dtype=arr_back.dtype, device=arr_back.device)
    zero = torch.zeros((), dtype=arr_back.dtype, device=arr_back.device)
    y = arr_s + torch.clamp_min(backlog[:, None] + half * (arr_s - anchor),
                                0.0) + zero - posf * c
    y = torch.where(arr_s < torch.inf, y, -torch.inf)
    return y[:, :min(cap, n - 1) + 1].amax(1)


def _run(low, k_clients, keys, scan, breq, kmax, stop_s, warmup_s,
         duration_s, dtype, device):
    C = len(k_clients)
    n = low["n"]
    f32 = dtype
    inf = torch.inf

    def full(v):
        return torch.full((C,), v, dtype=f32, device=device)

    cs = low["costs"]
    c_req, c_pa, c_par, c_com, c_replycl, c_acc, c_accr = (
        full(cs[k]) for k in ("c_req", "c_pa", "c_par", "c_com",
                              "c_replycl", "c_acc", "c_accr"))
    jitter = full(low["jitter"])
    jitter_c = jitter[:, None]
    c_pa_c, c_par_c, c_com_c = c_pa[:, None], c_par[:, None], c_com[:, None]
    c_acc_c, c_accr_c = c_acc[:, None], c_accr[:, None]
    acc_sum = c_acc + c_accr
    coord_base = c_req + (n - 1) * (c_pa + c_par + c_com) + c_replycl
    stop, warmup = full(stop_s), full(warmup_s)
    win_hi = stop + DRAIN_S
    n_keys = low["n_keys"]
    nkeysf = full(n_keys)
    crate = low["conflict_rate"]
    if crate is not None:
        crate_t = full(crate)
        hot_div = torch.clamp_min(1.0 - crate_t, 1e-9)
    lat = full(low["latency"])
    b_cl = b_lc = lat
    b_cp = b_pc = lat[:, None]
    # the mean one-way base from a replica to the others, summed node by
    # node in id order
    acc = torch.zeros(C, dtype=f32, device=device)
    for p in range(n):
        acc = acc + (lat if p else torch.zeros_like(lat))
    b_prop = acc / torch.full((), float(max(n - 1, 1)), dtype=f32,
                              device=device)
    ids = torch.arange(n, device=device)
    peer_of = ids[None, :] != ids[:, None]
    ord1_of = (ids[None, :] - (ids[None, :] > ids[:, None]).long()
               + 1).to(f32)
    cap1 = min(max(low["fq"] - 2, 0), n - 1)
    cap2 = min(max(low["majority"] - 2, 0), n - 1)
    kf1 = full(cap1) + 1.0
    kf2 = full(cap2) + 1.0

    kf = torch.arange(kmax, device=device).to(f32)
    ready = torch.where(torch.arange(kmax, device=device)
                        < k_clients[:, None],
                        CLIENT_START + CLIENT_STAGGER * kf, inf)
    cpu = torch.zeros(C, n, dtype=f32, device=device)
    load = torch.zeros(C, n, dtype=f32, device=device)
    race = torch.zeros(C, n_keys, dtype=f32, device=device)
    depk = torch.zeros(C, n_keys, dtype=f32, device=device)
    t0_o, tfin_o, commit_o, active_o = [], [], [], []
    key = keys[:, None, :]
    blk = max(1, min(scan, DRAW_BLOCK // (C * (2 * n + 5))))

    for i in range(scan):
        j = i % blk
        if j == 0:
            idx = torch.arange(i, min(i + blk, scan), device=device)
            ks = prng.split(prng.fold_in(key, idx), 5)
            coord_blk = prng.randint(ks[:, :, 0], (), 0, n)
            ecl_blk = prng.exponential(ks[:, :, 1], (2,)).to(f32)
            eout_blk = prng.exponential(ks[:, :, 2], (n,)).to(f32)
            eback_blk = prng.exponential(ks[:, :, 3], (n,)).to(f32)
            ukey_blk = prng.uniform(ks[:, :, 4], ()).to(f32)
        cid = torch.argmin(ready, dim=1, keepdim=True)
        t0 = torch.gather(ready, 1, cid)[:, 0]
        active = t0 < stop
        coord = coord_blk[:, j]
        coord_k = coord[:, None]
        e_cl = ecl_blk[:, j] * jitter_c
        e_out = eout_blk[:, j] * jitter_c
        e_back = eback_blk[:, j] * jitter_c
        u_key = ukey_blk[:, j]

        k = torch.floor(u_key * nkeysf).long()
        if crate is not None:
            k = torch.where(u_key < crate_t, 0,
                            1 + torch.floor((u_key - crate_t) / hot_div
                                            * (nkeysf - 1.0)).long())
        k = torch.clamp(k, 0, n_keys - 1)[:, None]

        # PreAccept to every peer; fast commit after a fast quorum
        aC = t0 + b_cl + e_cl[:, 0]
        W_C = torch.clamp_min(torch.gather(cpu, 1, coord_k)[:, 0] - t0, 0.0)
        L1 = aC + W_C + c_req
        is_peer = peer_of[coord]
        ord1 = ord1_of[coord]
        pa_done = L1[:, None] + ord1 * c_pa_c
        cpuC2 = L1 + (n - 1) * c_pa
        arr_p = pa_done + b_cp + e_out
        W_p = torch.clamp_min(cpu - t0[:, None], 0.0)
        doneP = arr_p + W_p + c_pa_c + c_par_c
        arr_back = torch.where(is_peer, doneP + b_pc + e_back, inf)
        fast_commit = kf1 * c_par + torch.maximum(
            cpuC2, _quorum_done(arr_back, W_C, c_par[:, None],
                                L1[:, None], cap1))

        # a conflict (the same key's previous PreAccept still propagates)
        # takes the accept round to a majority
        race_k = torch.gather(race, 1, k)[:, 0]
        slow = active & (L1 < race_k)
        acc_done = fast_commit[:, None] + ord1 * c_acc_c
        cpuC3 = fast_commit + (n - 1) * c_acc
        arr_p2 = acc_done + b_cp + e_out
        doneP2 = arr_p2 + W_p + c_acc_c + c_accr_c
        arr_back2 = torch.where(is_peer, doneP2 + b_pc + e_back, inf)
        slow_commit = kf2 * c_accr + torch.maximum(
            cpuC3, _quorum_done(arr_back2, W_C, c_accr[:, None],
                                L1[:, None], cap2))
        commit_done = torch.where(slow, slow_commit, fast_commit)

        # execution behind the same key's previous instance
        depk_k = torch.gather(depk, 1, k)[:, 0]
        committed_all = commit_done + (n - 1) * c_com
        exec_done = torch.maximum(committed_all, depk_k)
        t_fin = exec_done + c_replycl + b_lc + e_cl[:, 1]

        slowf = slow.to(f32)
        anchored = torch.maximum(cpu, t0[:, None])
        coord_work = coord_base + slowf * (n - 1) * acc_sum
        new_cpu = torch.where(is_peer, anchored + c_pa_c + c_par_c + c_com_c
                              + (slowf * acc_sum)[:, None], cpu)
        new_cpu = new_cpu.scatter(
            1, coord_k, (torch.gather(anchored, 1, coord_k)[:, 0]
                         + coord_work)[:, None])
        cpu = torch.where(active[:, None], new_cpu, cpu)
        ready = ready.scatter(1, cid, torch.where(active, t_fin, inf)[:, None])

        race_new = torch.where(is_peer, arr_p + W_p + c_pa_c, -inf).amax(1)
        dep_new = committed_all + b_prop + jitter
        race = race.scatter(1, k, torch.where(active, race_new,
                                              race_k)[:, None])
        depk = depk.scatter(1, k, torch.where(active, dep_new,
                                              depk_k)[:, None])

        in_win = active & (commit_done >= warmup) & (commit_done <= win_hi)
        add = torch.where(is_peer, 3.0 + 2.0 * slowf[:, None],
                          ((3.0 * n - 1.0) + 2.0 * (n - 1) * slowf)[:, None])
        load = load + torch.where(in_win[:, None], add, 0.0)

        t0_o.append(t0)
        tfin_o.append(t_fin)
        commit_o.append(commit_done)
        active_o.append(active)

    t0_s, tfin = torch.stack(t0_o, 1), torch.stack(tfin_o, 1)
    # replica 0 is reported as the "leader", the others as followers
    return summarize(tfin - t0_s, tfin, torch.stack(commit_o, 1),
                     torch.stack(active_o, 1), ready, load[:, 0],
                     load[:, 1:].sum(1), n - 1, stop[0], warmup[0],
                     full(duration_s)[0])


def simulate(dep, cells, grid_clients, warmup, duration, device,
             dtype=torch.float32, max_steps=MAX_STEPS):
    """Per-cell result dicts (``summary.FIELDS``) of (clients, seed) cells
    of a grid whose client counts are ``grid_clients``."""
    return run(dep, cells, grid_clients, warmup, duration, device, dtype,
               max_steps, _run)
