"""Artifact -> benchmark rows (port of ``repro.experiments.report``).

Maps the runner's JSON artifact onto the reference's
``name,us_per_call,derived`` CSV rows, with each family's paper-claim
summary (best-R comparison, analytical-table validation, DES <-> batch
cross-checks where both backends ran, ...): the summarizers of the 12
families the port runs.  The 16 of the discrete-event-only families
(``fig9``-``fig17``, ``openloop``, ``overload``, ``storm``, ``reconfig``,
``rolling``, ``failover``, ``lease``) are not ported.

Every summarizer degrades gracefully when ``--filter`` removed part of its
family: rows are emitted for whatever scenarios ran, and cross-scenario
summary rows are skipped when their inputs are missing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..core import analytical
from ..core.messages import CostModel
from . import runner


def csv_row(name: str, wall_s: float, calls: int, derived: str) -> str:
    us = wall_s * 1e6 / max(calls, 1)
    return f"{name},{us:.1f},{derived}"


def ms(x) -> float:
    """None (no completions in the window) -> nan, so rows degrade to
    'median=nanms' instead of a TypeError killing the whole family."""
    return float("nan") if x is None else x


def _rep(art: dict) -> Optional[dict]:
    """The representative replicate of a max-mode scenario (single-seed
    scenarios: the best-over-grid unit; multi-seed: highest-throughput)."""
    reps = art.get("replicates") or []
    if not reps:
        return None
    return max(reps, key=lambda u: u["throughput"] or 0.0)


def _wall(art: dict) -> float:
    return art["summary"]["wall_s"]


def _tput(art: dict) -> float:
    return art["summary"]["throughput"]["mean"] or 0.0


def _sat(art: dict) -> float:
    """Saturation of a curve-mode scenario: best per-point mean throughput."""
    pts = art.get("points") or []
    return max((p["throughput"]["mean"] or 0.0 for p in pts), default=0.0)


def _point_rows(art: dict, fmt) -> List[str]:
    """One row per client-grid point of a curve-mode scenario; single-seed
    points print the raw unit values (trajectory-stable), multi-seed points
    print across-seed means."""
    out = []
    units_by_clients: Dict[int, List[dict]] = {}
    for u in art["units"]:
        units_by_clients.setdefault(u["clients"], []).append(u)
    for p in art.get("points", []):
        us = units_by_clients.get(p["clients"], [])
        wall = sum(u["wall_s"] for u in us)
        count = sum(u["count"] for u in us)
        out.append(fmt(p, us, wall, count))
    return out


# ------------------------------------------------------------------ tables
def _table_rows(arts: Dict[str, dict], n: int, family: str,
                tol: float = 0.2) -> List[str]:
    rows = analytical.load_table(n)
    wall = sum(_wall(a) for a in arts.values())
    # validate the analytic table against DES-measured per-node counts for
    # every representative R that actually ran
    for name, art in arts.items():
        r = int(name.rsplit("=", 1)[1])
        rep = _rep(art)
        if rep is None or "extras" not in rep:
            continue
        ana = next(x for x in rows if x["R"] == r)
        ml = rep["extras"]["leader_msgs_per_op"]
        mf = rep["extras"]["follower_msgs_per_op"]
        assert abs(ml - ana["M_l"]) < tol, (name, ml, ana)
        assert abs(mf - ana["M_f"]) < tol, (name, mf, ana)
    return [csv_row(f"{family}/R={x['R']}", wall, 1,
                    f"M_l={x['M_l']} M_f={x['M_f']} ratio={x['ratio']}")
            for x in rows]


def _table1(arts, quick):
    return _table_rows(arts, 25, "table1")


def _table2(arts, quick):
    return _table_rows(arts, 5, "table2")


# ------------------------------------------------------------------- fig 8
def _fig8(arts, quick):
    out = []
    results = {}
    for name, art in arts.items():
        rep = _rep(art)
        if rep is None:
            continue
        if name.startswith("fig8/scale/"):
            out.append(csv_row(name, _wall(art), rep["count"],
                               f"tput={rep['throughput']:.0f}req/s "
                               f"median={ms(rep['median_ms']):.2f}ms"))
        else:
            _, label, rtag = name.split("/")
            results[(label, int(rtag[2:]))] = rep["throughput"]
            out.append(csv_row(name, _wall(art), rep["count"],
                               f"tput={rep['throughput']:.0f}req/s "
                               f"median={ms(rep['median_ms']):.2f}ms"))
    rot = {r: t for (lbl, r), t in results.items() if lbl == "rotating"}
    stat = {r: t for (lbl, r), t in results.items() if lbl == "static"}
    if rot and stat:
        out.append(csv_row(
            "fig8/summary", 0, 1,
            f"best_R_rotating={max(rot, key=rot.get)} "
            f"best_R_static={max(stat, key=stat.get)} "
            f"(paper: 1 and ~sqrt(N)=5)"))
    return out


# ----------------------------------------------------- post-paper families
def _mean_std_row(name, art):
    s = art["summary"]
    t = s["throughput"]
    rep = _rep(art)
    if rep is None:
        return None
    return csv_row(name, _wall(art), rep["count"],
                   f"tput={ms(t['mean']):.0f}req/s std={t['std'] or 0:.0f} "
                   f"seeds={t['n']} median={ms(s['median_ms']['mean']):.2f}ms")


def _zipf(arts, quick):
    out = [r for name, art in sorted(arts.items())
           if (r := _mean_std_row(name, art)) is not None]
    tp = {n: _tput(a) for n, a in arts.items() if _tput(a)}
    if len(tp) >= 2:
        spread = max(tp.values()) / max(min(tp.values()), 1)
        out.append(csv_row("zipf/summary", 0, 1,
                           f"max_over_min_tput={spread:.2f}x across theta "
                           f"(keys never route in Pig: expect ~1.0x)"))
    return out


def _wan(arts, quick):
    """WAN at N in {25,49,101}: per-size rows for both backends plus the
    DES<->batch cross-check ratio on the sizes where both ran."""
    out = [r for name, art in sorted(arts.items())
           if (r := _mean_std_row(name, art)) is not None]
    by_n: Dict[str, Dict[str, float]] = {}
    med: Dict[str, Dict[str, float]] = {}
    for name, art in arts.items():
        ntag = name.split("/")[1]
        backend = art.get("backend", "des")
        by_n.setdefault(ntag, {})[backend] = _tput(art)
        m = art["summary"]["median_ms"]["mean"]
        if m is not None:
            med.setdefault(ntag, {})[backend] = m
    for ntag, t in sorted(by_n.items()):
        if {"des", "batch"} <= set(t) and t["des"]:
            mr = (med.get(ntag, {}).get("batch", 0)
                  / max(med.get(ntag, {}).get("des", 1) or 1, 1e-9))
            out.append(csv_row(
                f"wan/{ntag}/xcheck", 0, 1,
                f"batch/des tput={t['batch'] / t['des']:.2f}x "
                f"median={mr:.2f}x (expect ~1.0x both)"))
    return out


def _scale(arts, quick):
    """Batch-backend headroom sweeps: throughput vs the Eq. 1 leader bound
    (1 / (2R+2) c) — the bound the paper's 25-node testbed could not probe."""
    out = []
    for name, art in sorted(arts.items()):
        row = _mean_std_row(name, art)
        if row is None:
            continue
        out.append(row)
        spec = art.get("spec") or {}
        r = (spec.get("pig") or {}).get("n_groups")
        if r and _tput(art):
            bound = 1.0 / (analytical.leader_messages(r) * CostModel.base)
            out.append(csv_row(
                f"{name}/vs_bound", 0, 1,
                f"tput={_tput(art):.0f} = "
                f"{_tput(art) / bound:.2f}x of Eq.1 leader bound "
                f"({bound:.0f} req/s at R={r})"))
    return out


def _conflict(arts, quick):
    """EPaxos conflict sweeps: per-point rows for both backends, the
    conflict-free-relative summary per N, and a DES<->batch xcheck ratio
    per (N, c) where both ran — the fidelity row the regression gate
    bounds to [0.90, 1.10]."""
    out = [r for name, art in sorted(arts.items())
           if (r := _mean_std_row(name, art)) is not None]
    by_n: Dict[tuple, Dict[float, float]] = {}
    for name, art in arts.items():
        parts = name.split("/")
        backend = "batch" if parts[-1] == "batch" else "des"
        ntag, ctag = parts[1], parts[2]
        by_n.setdefault((ntag, backend), {})[float(ctag.split("=")[1])] \
            = _tput(art)
    for (ntag, backend), cs in sorted(by_n.items()):
        if 0.0 in cs and max(cs) > 0.0:
            hi = cs[max(cs)]
            tag = f"{ntag}/batch" if backend == "batch" else ntag
            out.append(csv_row(f"conflict/summary/{tag}", 0, 1,
                               f"tput_at_c={max(cs)}: {hi:.0f}req/s = "
                               f"{hi / max(cs[0.0], 1):.2f}x of conflict-free"))
    for (ntag, backend), cs in sorted(by_n.items()):
        if backend != "des":
            continue
        bs = by_n.get((ntag, "batch"), {})
        for c in sorted(set(cs) & set(bs)):
            if cs[c]:
                out.append(csv_row(
                    f"conflict/{ntag}/c={c}/xcheck", 0, 1,
                    f"batch/des tput={bs[c] / cs[c]:.2f}x "
                    f"(slow-path model: expect within ~0.1 of 1.0)"))
    return out


def _batching(arts, quick):
    """Batching/pipelining family: per-cell rows, the m=8 over m=1 speedup
    per protocol (the gate requires >= 2x for paxos), and the DES<->batch
    fidelity ratio per (protocol, m) where both backends ran."""
    out = [r for name, art in sorted(arts.items())
           if (r := _mean_std_row(name, art)) is not None]
    by_m: Dict[tuple, Dict[int, float]] = {}
    for name, art in arts.items():
        parts = name.split("/")
        if parts[1] == "pipeline":
            continue
        backend = "batch" if parts[-1] == "batch" else "des"
        m = int(parts[2].split("=")[1])
        by_m.setdefault((parts[1], backend), {})[m] = _tput(art)
    for (proto, backend), ms_ in sorted(by_m.items()):
        if backend == "des" and 1 in ms_ and max(ms_) > 1 and ms_[1]:
            top = max(ms_)
            out.append(csv_row(
                f"batching/summary/{proto}", 0, 1,
                f"m={top}_over_m=1 speedup="
                f"{ms_[top] / ms_[1]:.2f}x (gate: paxos >= 2x)"))
    for (proto, backend), ms_ in sorted(by_m.items()):
        if backend != "des":
            continue
        bs = by_m.get((proto, "batch"), {})
        for m in sorted(set(ms_) & set(bs)):
            if ms_[m]:
                out.append(csv_row(
                    f"batching/{proto}/m={m}/xcheck", 0, 1,
                    f"batch/des tput={bs[m] / ms_[m]:.2f}x "
                    f"(saturated-batch model: expect within ~0.1 of 1.0)"))
    return out


# ------------------------------------------------------- fault families
def _consistency_tag(art: dict) -> str:
    """Roll the per-unit audit verdicts up to one token for the row."""
    if art.get("consistency") == "model":
        return "model"
    verdicts = {u.get("consistency") for u in art["units"]
                if "consistency" in u}
    if not verdicts:
        return "unchecked"
    return "ok" if verdicts == {"ok"} else "VIOLATION"


def _fault_window(art: dict) -> Optional[tuple]:
    """(first crash t, its recover t) from the artifact's fault timeline."""
    evs = art.get("faults") or []
    down = {}
    for ev in evs:
        if ev[0] == "crash":
            down.setdefault(ev[1], ev[2])
        elif ev[0] == "recover" and ev[1] in down:
            return (down[ev[1]], ev[2])
    return None


def _dip_depth(art: dict, rep: dict) -> Optional[float]:
    """Throughput-dip depth over the fault window, from the completion
    timeline: 1 - (rate during the window / rate before it)."""
    win = _fault_window(art)
    tl = (rep.get("extras") or {}).get("timeline")
    if win is None or tl is None:
        return None
    b = tl["bucket_s"]
    counts = tl["counts"]
    warmup = rep["warmup_s"]
    lo, hi = round(win[0] / b), round(win[1] / b)
    w0 = round(warmup / b)
    if not (w0 < lo < hi <= len(counts)):
        return None
    pre = sum(counts[w0:lo]) / max(lo - w0, 1)
    during = sum(counts[lo:hi]) / max(hi - lo, 1)
    return 1.0 - during / max(pre, 1e-9)


def _avail(arts, quick):
    """Availability family: per-scenario rows (throughput, unavailability
    window, dip depth, audit verdict) plus the DES<->batch dip cross-check
    on the names where both backends ran."""
    out = []
    dips: Dict[str, Dict[str, float]] = {}
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        ex = rep.get("extras") or {}
        dip = _dip_depth(art, rep)
        base = name[:-len("/batch")] if name.endswith("/batch") else name
        if dip is not None:
            dips.setdefault(base, {})[art.get("backend", "des")] = dip
        bits = [f"tput={rep['throughput']:.0f}req/s"]
        if "unavail_ms" in ex:
            bits.append(f"unavail={ms(ex['unavail_ms']):.0f}ms")
        if dip is not None:
            bits.append(f"dip={dip:.2f}")
        if "client_retries" in ex:
            bits.append(f"retries={ex['client_retries']}")
        bits.append(f"consistency={_consistency_tag(art)}")
        out.append(csv_row(name, _wall(art), rep["count"], " ".join(bits)))
    for base, d in sorted(dips.items()):
        if {"des", "batch"} <= set(d):
            # the <~0.1 dip-parity expectation holds for LEADER-crash plans
            # (the deferred-arrival model mirrors the outage exactly);
            # relay-crash dips come from missed fan-outs / catch-up traffic
            # / consumed PRC slack, which the mask model deliberately skips
            leader_fault = any(
                ev[0] == "crash" and ev[1] == 0
                for name, art in arts.items() if name.startswith(base)
                for ev in (art.get("faults") or []))
            note = ("expect <~0.1" if leader_fault else
                    "model boundary: DES authoritative for relay faults")
            out.append(csv_row(
                f"{base}/xcheck", 0, 1,
                f"dip des={d['des']:.2f} batch={d['batch']:.2f} "
                f"delta={abs(d['des'] - d['batch']):.3f} ({note})"))
    return out


def _gini(vals) -> float:
    """Gini coefficient of a non-negative sample (0 = perfectly even)."""
    vals = sorted(vals)
    n, s = len(vals), sum(vals)
    if n == 0 or s <= 0:
        return 0.0
    cum = sum((i + 1) * v for i, v in enumerate(vals))
    return (2.0 * cum / (n * s)) - (n + 1.0) / n


def _relay_fairness(rep: dict, n: int) -> Optional[dict]:
    """Fairness of follower busy time from the obs section's per-node CPU
    seconds: max/mean (hotspot factor) and Gini over nodes 1..n-1."""
    ob = (rep.get("extras") or {}).get("obs") or {}
    busy = ob.get("cpu_busy_s") or {}
    vals = [float(busy.get(str(i), 0.0)) for i in range(1, n)]
    if not vals or sum(vals) <= 0:
        return None
    mean = sum(vals) / len(vals)
    return {"max_over_mean": max(vals) / mean, "gini": _gini(vals)}


def _obs(arts, quick):
    """Observability family: per-scenario critical-path decomposition (the
    bottleneck attribution rows), tracer volume, batch-side leader-backlog
    series, and the relay-fairness comparison — rotating vs static relays
    on the fig8-style cells, making the paper's 'rotation spreads the relay
    load' claim (Fig. 8 discussion) an empirical number: max/mean and Gini
    of per-follower busy seconds should both be lower with rotation."""
    out = []
    fair = {}
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        ob = (rep.get("extras") or {}).get("obs") or {}
        f = _relay_fairness(rep, (art.get("spec") or {}).get("n", 0))
        if (ob.get("critical_path") or {}).get("n_ops"):
            cp = ob["critical_path"]["mean_ms"]
            seg = " ".join(f"{k}={cp[k]:.2f}" for k in
                           ("queue", "svc", "ser", "relay", "net", "wait")
                           if k in cp)
            tr = ob.get("trace") or {}
            out.append(csv_row(
                name, _wall(art), rep["count"],
                f"tput={rep['throughput']:.0f}req/s "
                f"traced={tr.get('ops_finished', 0)} "
                f"spans={tr.get('spans', 0)} critpath_ms[{seg}]"))
        elif "leader_backlog" in ob:
            lb = ob["leader_backlog"]
            qs = [v for v, c in zip(lb["mean_ms"], lb["n"]) if c]
            mean_q = sum(qs) / len(qs) if qs else 0.0
            out.append(csv_row(
                name, _wall(art), rep["count"],
                f"tput={rep['throughput']:.0f}req/s "
                f"leader_backlog_mean={mean_q:.3f}ms "
                f"peak={max(qs, default=0.0):.3f}ms buckets={len(qs)}"))
        elif f is not None:
            out.append(csv_row(
                name, _wall(art), rep["count"],
                f"tput={rep['throughput']:.0f}req/s "
                f"follower_busy max/mean={f['max_over_mean']:.2f} "
                f"gini={f['gini']:.3f}"))
        elif (row := _mean_std_row(name, art)) is not None:
            out.append(row)
        if f is not None and "/fairness/" in name:
            fair[name.rsplit("/", 1)[1]] = f
    rot, stat = fair.get("rotating"), fair.get("static")
    if rot is not None and stat is not None:
        out.append(csv_row(
            "obs/fairness/summary", 0, 1,
            f"relay busy max/mean rotating={rot['max_over_mean']:.2f} "
            f"static={stat['max_over_mean']:.2f} "
            f"gini rotating={rot['gini']:.3f} static={stat['gini']:.3f} "
            f"(paper Fig8: rotation spreads relay load -> rotating < static)"))
    return out


def _megagrid(arts, quick):
    """Megagrid family: catalog ``megagrid/slice`` scenarios (replicate
    rows) and the million-cell cross-product artifact (aggregate-only
    entries from ``experiments.megagrid``), plus a family summary naming
    the peak-throughput point."""
    out, best, cells = [], None, 0
    for name, art in sorted(arts.items()):
        row = _mean_std_row(name, art)
        if row is not None:                      # catalog slice entries
            out.append(row)
            continue
        s = art.get("summary") or {}
        t = s.get("throughput") or {}
        if t.get("mean") is None:
            continue
        cells += s.get("cells", 0)
        if best is None or t["max"] > best[1]:
            best = (name, t["max"])
        p99 = (s.get("p99_ms") or {}).get("mean")
        out.append(csv_row(
            name, 0, max(s.get("cells", 1), 1),
            f"tput={t['mean']:.0f}req/s std={t['std'] or 0:.0f} "
            f"p99={ms(p99):.2f}ms cells={s.get('cells', 0)}"))
    if best is not None:
        out.append(csv_row("megagrid/summary", 0, 1,
                           f"{cells} cells; peak point {best[0]} "
                           f"at {best[1]:.0f}req/s"))
    return out


def _rw_of(art) -> Optional[dict]:
    rep = _rep(art)
    return (rep.get("extras") or {}).get("rw") if rep else None


def _reads(arts, quick):
    """Read-path family: per-scenario rows with the read/write latency
    split and audit verdict, the leased-vs-log speedup (regression-gated
    at >= 2x), the Pig-vs-Paxos crossover across read ratios, and the
    DES<->batch fidelity ratios on the paired cells (gated [0.90, 1.10])."""
    out = []
    tp = {name: _tput(art) for name, art in arts.items()}
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        rw = _rw_of(art) or {}
        bits = [f"tput={rep['throughput']:.0f}req/s"]
        if rw:
            bits.append(f"reads={rw.get('reads', 0)} "
                        f"read_mean={ms(rw.get('read_mean_ms')):.2f}ms "
                        f"write_mean={ms(rw.get('write_mean_ms')):.2f}ms")
            if rw.get("lease_reads"):
                bits.append(f"lease_reads={rw['lease_reads']}")
        bits.append(f"consistency={_consistency_tag(art)}")
        out.append(csv_row(name, _wall(art), rep["count"], " ".join(bits)))
    # leased reads vs the log read path (the paper's only read path)
    for proto in ("paxos", "pigpaxos"):
        lease = tp.get(f"reads/{proto}/lease/r=0.9")
        log = tp.get(f"reads/{proto}/log/r=0.9")
        if lease and log:
            out.append(csv_row(
                f"reads/speedup/{proto}", 0, 1,
                f"leased/log tput={lease / log:.2f}x at r=0.9 "
                f"(gate: >= 2x — reads skip the whole commit round)"))
    # Pig-vs-Paxos crossover: Pig's relay fan-out wins on writes, but the
    # lease path serves reads at the leader in BOTH protocols, so the gap
    # must close (and invert) as the read ratio rises
    ratios = {}
    for r in ("0.0", "0.5", "0.9"):
        pig, pax = (tp.get(f"reads/pigpaxos/lease/r={r}"),
                    tp.get(f"reads/paxos/lease/r={r}"))
        if pig and pax:
            ratios[r] = pig / pax
    if len(ratios) >= 2:
        parts = " ".join(f"r={r}:{v:.2f}x" for r, v in sorted(ratios.items()))
        lo, hi = min(ratios), max(ratios)
        trend = ("crossover: Pig lead shrinks with read ratio"
                 if ratios[hi] < ratios[lo] else
                 "NO crossover (Pig lead did not shrink)")
        out.append(csv_row("reads/crossover", 0, 1,
                           f"pig/paxos tput {parts} ({trend})"))
    # DES<->batch fidelity on the paired cells
    for name in sorted(arts):
        if not name.endswith("/batch"):
            continue
        base = name[:-len("/batch")]
        if tp.get(base) and tp.get(name):
            out.append(csv_row(
                f"{base}/xcheck", 0, 1,
                f"batch/des tput={tp[name] / tp[base]:.2f}x "
                f"(leased-read model: expect within ~0.1 of 1.0)"))
    return out



SUMMARIZERS = {
    "table1": _table1, "table2": _table2, "fig8": _fig8,
    "zipf": _zipf, "conflict": _conflict, "wan": _wan, "scale": _scale,
    "batching": _batching, "avail": _avail,
    "megagrid": _megagrid, "obs": _obs, "reads": _reads,
}


def rows_for_artifact(artifact: dict,
                      families: Optional[Sequence[str]] = None) -> List[str]:
    """CSV rows for the scenario families present in ``artifact``
    (optionally restricted/ordered by ``families``)."""
    by_family: Dict[str, Dict[str, dict]] = {}
    order: List[str] = []
    for sa in artifact["scenarios"]:
        fam = sa["family"]
        if fam not in by_family:
            by_family[fam] = {}
            order.append(fam)
        by_family[fam][sa["name"]] = sa
    out = []
    for fam in (families if families is not None else order):
        if fam in by_family and fam in SUMMARIZERS:
            out.extend(SUMMARIZERS[fam](by_family[fam], artifact["quick"]))
    return out


def family_rows(families: Sequence[str], quick: bool = True,
                filter_expr: Optional[str] = None,
                artifact: Optional[dict] = None,
                backend_override: Optional[str] = None,
                device=None) -> List[str]:
    """Run the given families through the registry runner on ``device``
    (or reuse a pre-computed suite ``artifact``) and return their CSV
    rows."""
    if artifact is None:
        artifact = runner.run_families(families, quick=quick,
                                       filter_expr=filter_expr,
                                       backend_override=backend_override,
                                       device=device)
    return rows_for_artifact(artifact, families)
