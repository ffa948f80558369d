"""Artifact -> benchmark rows (port of ``repro.experiments.report``).

Maps the runner's JSON artifact onto the reference's
``name,us_per_call,derived`` CSV rows, with each family's paper-claim
summary (best-R comparison, saturation ratios, analytical-table
validation, failure-transient drop, DES <-> batch cross-checks where both
backends ran, ...): the summarizers of the 26 families the port runs.
The reference's ``failover`` and ``lease`` summarizers come with ROADMAP
item 13b; ``overload``'s gives the reference's rows for the scenarios
the port registers, those without admission control.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..core import analytical
from ..core.jaxsim import saturation_point
from ..core.messages import CostModel
from . import registry, runner


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
# ------------------------------------------------------------------- fig 9
def _fig9(arts, quick):
    out = []
    sat = {}
    for name, art in arts.items():
        proto = name.split("/")[1]
        def fmt(p, us, wall, count, proto=proto):
            return csv_row(f"fig9/{proto}/clients={p['clients']}", wall, count,
                           f"tput={ms(p['throughput']['mean']):.0f}req/s "
                           f"median={ms(p['median_ms']['mean']):.2f}ms "
                           f"p99={ms(p['p99_ms']['mean']):.2f}ms")
        out.extend(_point_rows(art, fmt))
        sat[proto] = _sat(art)
    if {"paxos", "epaxos", "pigpaxos"} <= set(sat):
        ratio = sat["pigpaxos"] / max(sat["paxos"], 1)
        model = f"{saturation_point(25, 24, protocol='paxos'):.0f}"
        out.append(csv_row(
            "fig9/summary", 0, 1,
            f"paxos={sat['paxos']:.0f} epaxos={sat['epaxos']:.0f} "
            f"pigpaxos={sat['pigpaxos']:.0f} pig/paxos={ratio:.1f}x "
            f"(paper >3x); queueing-model paxos={model}"))
    return out


# ------------------------------------------------------------------ fig 10
def _fig10(arts, quick):
    out = []
    for name, art in arts.items():
        proto = name.split("/")[1]
        def fmt(p, us, wall, count, proto=proto):
            return csv_row(f"fig10/{proto}/clients={p['clients']}", wall, count,
                           f"tput={ms(p['throughput']['mean']):.0f}req/s "
                           f"median={ms(p['median_ms']['mean']):.1f}ms")
        out.extend(_point_rows(art, fmt))
    return out


# ------------------------------------------------------------- figs 11/12
def _bar_family(arts, family, summary):
    out = []
    res = {}
    for name, art in arts.items():
        rep = _rep(art)
        if rep is None:
            continue
        res[name.split("/")[1]] = rep["throughput"]
        out.append(csv_row(name, _wall(art), rep["count"],
                           f"tput={rep['throughput']:.0f}req/s "
                           f"median={ms(rep['median_ms']):.2f}ms"))
    s = summary(res)
    if s:
        out.append(csv_row(f"{family}/summary", 0, 1, s))
    return out


def _fig11(arts, quick):
    def summary(res):
        if "pig_R1" not in res or len(res) < 4:
            return None
        return (f"R1_beats_all={res['pig_R1'] >= max(res.values()) - 1} "
                f"(paper: R=1 outperforms all at N=5)")
    return _bar_family(arts, "fig11", summary)


def _fig12(arts, quick):
    def summary(res):
        if "pig_R2" not in res or "paxos" not in res:
            return None
        gain = (res["pig_R2"] / res["paxos"] - 1) * 100
        return f"R2_gain_over_paxos={gain:.0f}% (paper: ~57%)"
    return _bar_family(arts, "fig12", summary)


# ------------------------------------------------------------------ fig 13
def _fig13(arts, quick):
    out = []
    tputs: Dict[str, Dict[int, float]] = {}
    for name, art in arts.items():
        rep = _rep(art)
        if rep is None:
            continue
        _, proto, stag = name.split("/")
        size = int(stag.split("=")[1])
        tputs.setdefault(proto, {})[size] = rep["throughput"]
        out.append(csv_row(name, _wall(art), rep["count"],
                           f"tput={rep['throughput']:.0f}req/s"))
    for proto, by_size in tputs.items():
        mx = max(by_size.values())
        for s in sorted(by_size):
            out.append(csv_row(f"fig13/{proto}/norm/payload={s}", 0, 1,
                               f"normalized={by_size[s]/mx:.3f} (paper: >0.86)"))
    if "paxos" in tputs and "pigpaxos" in tputs:
        shared = set(tputs["paxos"]) & set(tputs["pigpaxos"])
        if shared:
            r = min(tputs["pigpaxos"][s] / tputs["paxos"][s] for s in shared)
            out.append(csv_row("fig13/summary", 0, 1,
                               f"min_pig_over_paxos={r:.1f}x "
                               f"(paper: ~3x at all sizes)"))
    return out


# ------------------------------------------------------------- figs 14/15
def _iqr_row(name, art):
    rep = _rep(art)
    if rep is None:
        return None
    return csv_row(name, _wall(art), rep["count"],
                   f"median={ms(rep['median_ms']):.2f}ms "
                   f"IQR=[{ms(rep['p25_ms']):.2f},{ms(rep['p75_ms']):.2f}]ms")


def _fig14(arts, quick):
    return [r for name, art in arts.items()
            if (r := _iqr_row(name, art)) is not None]


def _fig15(arts, quick):
    out = []
    base = None
    for name, art in arts.items():
        if name == "fig15/fault_free":
            continue
        rep = _rep(art)
        if rep is None:
            continue
        out.append(csv_row(name, _wall(art), rep["count"],
                           f"median={ms(rep['median_ms']):.2f}ms "
                           f"IQR=[{ms(rep['p25_ms']):.2f},{ms(rep['p75_ms']):.2f}]ms "
                           f"tput={rep['throughput']:.0f}"))
        if name == "fig15/PRC=1/gray=1":
            base = rep["median_ms"]
    ff = arts.get("fig15/fault_free")
    rep0 = _rep(ff) if ff else None
    if rep0 is not None:
        gap = (f"; prc+gray within "
               f"{abs(ms(base) - ms(rep0['median_ms'])):.2f}ms "
               f"of fault-free" if base is not None else "")
        out.append(csv_row("fig15/fault_free", _wall(ff), rep0["count"],
                           f"median={ms(rep0['median_ms']):.2f}ms{gap}"))
    return out


# ------------------------------------------------------------------ fig 16
def _fig16(arts, quick):
    art = arts.get("fig16/group_failure")
    rep = _rep(art) if art else None
    if rep is None or "extras" not in rep:
        return []
    sc = registry.get("fig16/group_failure")
    fail_at = min(float(ev[2]) for ev in sc.fault_plan().events
                  if ev[0] == "crash")
    warmup = rep["warmup_s"]
    tl = rep["extras"]["timeline"]
    b = tl["bucket_s"]
    counts = tl["counts"]
    # round(): 0.3/0.05 is 5.999... in floats; int() would leak a warmup
    # bucket into the pre-failure window
    pre = sum(counts[round(warmup / b):round(fail_at / b)])
    post = sum(counts[round(fail_at / b):round((fail_at + 0.5) / b)])
    tput_pre = pre / (fail_at - warmup)
    tput_post = post / 0.5
    drop = (1 - tput_post / max(tput_pre, 1)) * 100
    return [csv_row("fig16/group_failure", _wall(art), rep["count"],
                    f"tput_before={tput_pre:.0f} tput_during={tput_post:.0f} "
                    f"drop={drop:.1f}% (paper: ~3%)")]


# ------------------------------------------------------------------ fig 17
def _fig17(arts, quick):
    out = []
    mats = {}
    for name, art in arts.items():
        rep = _rep(art)
        if rep is None or "extras" not in rep:
            continue
        proto = name.split("/")[1]
        m = rep["extras"]["flight_per_op"]
        mats[proto] = m
        total = sum(sum(r) for r in m)
        leader = sum(m[0]) + sum(r[0] for r in m)
        mx = max(v for r in m for v in r)
        out.append(csv_row(name, _wall(art), rep["count"],
                           f"leader_traffic_share={leader/max(total, 1e-9):.2f} "
                           f"max_cell={mx:.2f}msg/op"))
    if mats:
        os.makedirs("artifacts", exist_ok=True)
        with open("artifacts/fig17_heatmap.json", "w") as f:
            json.dump(mats, f)
        out.append(csv_row("fig17/summary", 0, 1,
                           "pigpaxos spreads load: see "
                           "artifacts/fig17_heatmap.json"))
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


def _openloop(arts, quick):
    out = []
    sat = {}
    for name, art in arts.items():
        proto = name.split("/")[1]
        rate = (art["spec"].get("workload") or {}).get("rate_hz", 0.0)
        def fmt(p, us, wall, count, proto=proto, rate=rate):
            offered = p["clients"] * rate
            return csv_row(
                f"openloop/{proto}/clients={p['clients']}", wall, count,
                f"offered={offered:.0f}req/s "
                f"achieved={ms(p['throughput']['mean']):.0f}req/s "
                f"median={ms(p['median_ms']['mean']):.2f}ms "
                f"p99={ms(p['p99_ms']['mean']):.2f}ms")
        out.extend(_point_rows(art, fmt))
        sat[proto] = _sat(art)
    if len(sat) >= 2:
        parts = " ".join(f"{p}={t:.0f}" for p, t in sorted(sat.items()))
        out.append(csv_row("openloop/summary", 0, 1,
                           f"open-loop saturation: {parts} req/s"))
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
def _ovl_points(art) -> List[dict]:
    """Per-clients aggregates of the overload extras (goodput/p99.9/shed
    live per unit, not in the runner's generic point aggregation)."""
    by_clients: Dict[int, List[dict]] = {}
    for u in art["units"]:
        by_clients.setdefault(u["clients"], []).append(u)
    pts = []
    for k, us in sorted(by_clients.items()):
        exs = [u.get("extras") or {} for u in us]
        gp = [e["goodput"] for e in exs if e.get("goodput") is not None]
        p999 = [e["p999_ms"] for e in exs if e.get("p999_ms") is not None]
        adm = [e["admission"] for e in exs if "admission" in e]
        pts.append({
            "clients": k,
            "offered": next((e["offered"] for e in exs
                             if e.get("offered") is not None), None),
            "throughput": (sum(u["throughput"] or 0 for u in us)
                           / max(len(us), 1)),
            "goodput": sum(gp) / len(gp) if gp else None,
            "p99_ms": (sum(u["p99_ms"] or 0 for u in us) / max(len(us), 1)),
            "p999_ms": sum(p999) / len(p999) if p999 else None,
            "client_shed": sum(e.get("client_shed", 0) for e in exs),
            # queue-length policies report shed_queue/shed_rate, the
            # latency-driven policy reports shed_latency — sum whatever ran
            "adm_shed": sum(a.get("shed_queue", 0) + a.get("shed_rate", 0)
                            + a.get("shed_latency", 0) for a in adm),
        })
    return pts


def _overload(arts, quick):
    """Overload family: offered vs achieved vs goodput per grid point, the
    shed counters on both sides of the admission gate, and the headline
    noadm-vs-adm comparison at the top of the load sweep (the claim the
    regression gate turns into a bound: goodput holds flat under 4x
    offered load WITH admission control and collapses without)."""
    out = []
    top: Dict[str, dict] = {}
    for name, art in sorted(arts.items()):
        pts = _ovl_points(art)
        wall = _wall(art)
        for p in pts:
            off = (f"{p['offered']:.0f}req/s" if p["offered"] is not None
                   else "n/a")
            out.append(csv_row(
                f"{name}/clients={p['clients']}", wall / max(len(pts), 1), 1,
                f"offered={off} achieved={p['throughput']:.0f}req/s "
                f"goodput={ms(p['goodput']):.0f}req/s "
                f"p99={ms(p['p99_ms']):.2f}ms p999={ms(p['p999_ms']):.2f}ms "
                f"shed_client={p['client_shed']} shed_adm={p['adm_shed']} "
                f"consistency={_consistency_tag(art)}"))
        if pts:
            top[name] = max(pts, key=lambda p: p["offered"] or 0)
    a, n = top.get("overload/paxos/adm"), top.get("overload/paxos/noadm")
    if a is not None and n is not None:
        out.append(csv_row(
            "overload/summary", 0, 1,
            f"goodput_at_4x adm={ms(a['goodput']):.0f}req/s "
            f"noadm={ms(n['goodput']):.0f}req/s "
            f"(admission holds goodput; without it the SLO collapses)"))
    la = top.get("overload/paxos/latadm")
    if la is not None and a is not None:
        out.append(csv_row(
            "overload/latadm_summary", 0, 1,
            f"goodput_at_4x latency_adm={ms(la['goodput']):.0f}req/s "
            f"queue_adm={ms(a['goodput']):.0f}req/s "
            f"shed latency_adm={la['adm_shed']} queue_adm={a['adm_shed']} "
            f"(head-to-head: SLO-driven shedding vs queue-length shedding)"))
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


def _storm(arts, quick):
    """Storm family: throughput under randomized crash-recover storms with
    the injected-event count and the audit verdict per scenario."""
    out = []
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        ex = rep.get("extras") or {}
        n_ev = len(art.get("faults") or [])
        s = art["summary"]["throughput"]
        out.append(csv_row(
            name, _wall(art), rep["count"],
            f"tput={ms(s['mean']):.0f}req/s std={s['std'] or 0:.0f} "
            f"fault_events={n_ev} "
            f"unavail={ms(ex.get('unavail_ms')):.0f}ms "
            f"retries={ex.get('client_retries', 0)} "
            f"consistency={_consistency_tag(art)}"))
    return out


def _reconfig(arts, quick):
    """Reconfiguration family: throughput under membership change, the
    membership events applied, the unavailability window, and the audit
    verdict (checked against the time-varying membership)."""
    out = []
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        ex = rep.get("extras") or {}
        cfg = [ev for ev in (art.get("faults") or [])
               if ev[0] in ("add_node", "remove_node", "replace_leader")]
        evs = " ".join(f"{ev[0]}({ev[1]})@{ev[2]:.1f}s" for ev in cfg)
        out.append(csv_row(
            name, _wall(art), rep["count"],
            f"tput={rep['throughput']:.0f}req/s events=[{evs}] "
            f"unavail={ms(ex.get('unavail_ms')):.0f}ms "
            f"retries={ex.get('client_retries', 0)} "
            f"consistency={_consistency_tag(art)}"))
    return out


def _rolling(arts, quick):
    """Rolling-upgrade family: every node restarted in sequence; reports
    the per-restart unavailability windows (mean and worst) alongside the
    restart count and the audit verdict."""
    out = []
    for name, art in sorted(arts.items()):
        rep = _rep(art)
        if rep is None:
            continue
        ex = rep.get("extras") or {}
        per = ex.get("per_fault_unavail_ms") or []
        ws = [p["unavail_ms"] for p in per if p["unavail_ms"] is not None]
        bits = [f"tput={rep['throughput']:.0f}req/s",
                f"restarts={len(per)}"]
        if ws:
            bits.append(f"unavail_per_restart_mean="
                        f"{sum(ws) / len(ws):.0f}ms")
            bits.append(f"unavail_per_restart_max={max(ws):.0f}ms")
        bits.append(f"retries={ex.get('client_retries', 0)}")
        bits.append(f"consistency={_consistency_tag(art)}")
        out.append(csv_row(name, _wall(art), rep["count"], " ".join(bits)))
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
    "table1": _table1, "table2": _table2,
    "fig8": _fig8, "fig9": _fig9, "fig10": _fig10, "fig11": _fig11,
    "fig12": _fig12, "fig13": _fig13, "fig14": _fig14, "fig15": _fig15,
    "fig16": _fig16, "fig17": _fig17,
    "zipf": _zipf, "openloop": _openloop, "conflict": _conflict,
    "wan": _wan, "scale": _scale,
    "batching": _batching, "overload": _overload,
    "avail": _avail, "storm": _storm,
    "reconfig": _reconfig, "rolling": _rolling,
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
    """Run the given families through the registry runner (the batch
    scenarios on ``device``, the discrete-event ones inline), or reuse a
    pre-computed suite ``artifact``, and return their CSV rows."""
    if artifact is None:
        artifact = runner.run_families(families, quick=quick,
                                       filter_expr=filter_expr,
                                       backend_override=backend_override,
                                       device=device)
    return rows_for_artifact(artifact, families)
