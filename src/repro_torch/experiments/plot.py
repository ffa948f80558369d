"""Artifact -> SVG plots, with zero plotting dependencies.

The runner's JSON artifact already carries everything a figure needs
(per-point aggregates for curve-mode scenarios, per-seed replicates with
latency quantiles), so this module renders the two standard views directly
as hand-built SVG — no matplotlib in the container, none required:

* ``throughput_vs_load`` — one polyline per scenario of a family, offered
  load (or client count) on x, achieved throughput on y.  For overload
  scenarios a dashed goodput line rides along, which is the whole story of
  that family: achieved stays up while goodput collapses without admission
  control.
* ``latency_cdf`` — quantile-interpolated CDF per scenario (p25/median/
  p75/p99 and, where the overload extras recorded it, p99.9).
* ``utilization_heat`` — per-node CPU-busy heat strip over virtual time,
  from the obs timelines: relay hotspots under static relays
  show up as one solid red row, rotation as an even pink wash.
* ``critpath_waterfall`` — stacked critical-path segments per traced
  scenario (queue/svc/ser/relay/net/wait mean ms per op), the
  bottleneck-attribution view.

``render_artifact`` walks a suite artifact and writes every view a
family has the data to support; ``python -m repro_torch.experiments.run
--plot DIR`` is the CLI entry point (a copy of ``repro.experiments.plot``:
the same artifact gives the same SVG bytes).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

# Okabe-Ito palette: colorblind-safe, distinct on white
_COLORS = ("#0072B2", "#D55E00", "#009E73", "#CC79A7",
           "#E69F00", "#56B4E9", "#F0E442", "#000000")

_W, _H = 720, 440
_ML, _MR, _MT, _MB = 70, 24, 34, 52        # margins: left/right/top/bottom


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v / 1000:.3g}k"
    return f"{v:.3g}"


def _ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    if hi <= lo:
        hi = lo + 1.0
    step = (hi - lo) / n
    return [lo + i * step for i in range(n + 1)]


class _Chart:
    """One x/y chart: polylines + axes + legend, emitted as SVG text."""

    def __init__(self, title: str, xlabel: str, ylabel: str):
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.series: List[tuple] = []   # (label, [(x, y)], dashed)

    def add(self, label: str, pts: Sequence[Tuple[float, float]],
            dashed: bool = False) -> None:
        pts = [(float(x), float(y)) for x, y in pts
               if x is not None and y is not None]
        if pts:
            self.series.append((label, sorted(pts), dashed))

    def _scale(self):
        xs = [x for _, pts, _ in self.series for x, _ in pts]
        ys = [y for _, pts, _ in self.series for _, y in pts]
        x0, x1 = min(xs), max(xs)
        y0, y1 = 0.0, max(ys)            # rate/fraction axes start at 0
        if x1 <= x0:
            x1 = x0 + 1.0
        if y1 <= y0:
            y1 = y0 + 1.0
        pw, ph = _W - _ML - _MR, _H - _MT - _MB

        def px(x):
            return _ML + (x - x0) / (x1 - x0) * pw

        def py(y):
            return _H - _MB - (y - y0) / (y1 - y0) * ph

        return (x0, x1, y0, y1, px, py)

    def svg(self) -> str:
        if not self.series:
            return ""
        x0, x1, y0, y1, px, py = self._scale()
        e: List[str] = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" '
            f'height="{_H}" viewBox="0 0 {_W} {_H}" '
            f'font-family="sans-serif" font-size="11">',
            f'<rect width="{_W}" height="{_H}" fill="white"/>',
            f'<text x="{_W / 2}" y="20" text-anchor="middle" '
            f'font-size="14">{self.title}</text>',
        ]
        # gridlines + tick labels
        for t in _ticks(y0, y1):
            y = py(t)
            e.append(f'<line x1="{_ML}" y1="{y:.1f}" x2="{_W - _MR}" '
                     f'y2="{y:.1f}" stroke="#ddd"/>')
            e.append(f'<text x="{_ML - 6}" y="{y + 4:.1f}" '
                     f'text-anchor="end">{_fmt(t)}</text>')
        for t in _ticks(x0, x1):
            x = px(t)
            e.append(f'<line x1="{x:.1f}" y1="{_MT}" x2="{x:.1f}" '
                     f'y2="{_H - _MB}" stroke="#eee"/>')
            e.append(f'<text x="{x:.1f}" y="{_H - _MB + 16}" '
                     f'text-anchor="middle">{_fmt(t)}</text>')
        e.append(f'<rect x="{_ML}" y="{_MT}" width="{_W - _ML - _MR}" '
                 f'height="{_H - _MT - _MB}" fill="none" stroke="#333"/>')
        e.append(f'<text x="{_W / 2}" y="{_H - 12}" text-anchor="middle">'
                 f'{self.xlabel}</text>')
        e.append(f'<text x="16" y="{_H / 2}" text-anchor="middle" '
                 f'transform="rotate(-90 16 {_H / 2})">{self.ylabel}</text>')
        # series + legend
        for i, (label, pts, dashed) in enumerate(self.series):
            color = _COLORS[i % len(_COLORS)]
            dash = ' stroke-dasharray="6 4"' if dashed else ""
            path = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in pts)
            e.append(f'<polyline points="{path}" fill="none" '
                     f'stroke="{color}" stroke-width="1.8"{dash}/>')
            for x, y in pts:
                e.append(f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" '
                         f'r="2.6" fill="{color}"/>')
            ly = _MT + 14 + 14 * i
            e.append(f'<line x1="{_ML + 8}" y1="{ly - 4}" x2="{_ML + 30}" '
                     f'y2="{ly - 4}" stroke="{color}" '
                     f'stroke-width="1.8"{dash}/>')
            e.append(f'<text x="{_ML + 34}" y="{ly}">{label}</text>')
        e.append("</svg>")
        return "\n".join(e)


def _offered(sa: dict, clients: int) -> Optional[float]:
    wl = (sa.get("spec") or {}).get("workload") or {}
    if wl.get("arrival", "closed") != "closed":
        return clients * wl.get("rate_hz", 0.0)
    return None


def _unit_goodputs(sa: dict) -> Dict[int, float]:
    """Mean goodput per client-grid point (overload extras), where present."""
    acc: Dict[int, List[float]] = {}
    for u in sa.get("units", []):
        g = (u.get("extras") or {}).get("goodput")
        if g is not None:
            acc.setdefault(u["clients"], []).append(g)
    return {k: sum(v) / len(v) for k, v in acc.items()}


def throughput_vs_load(family: str, arts: Dict[str, dict]) -> Optional[str]:
    """Achieved throughput (and goodput, when the overload extras carry it)
    vs offered load for every curve-mode scenario of ``family`` with at
    least two grid points — or one, when a sibling provides the second."""
    open_loop = any(_offered(sa, 1) is not None for sa in arts.values())
    xlabel = "offered load (req/s)" if open_loop else "clients"
    ch = _Chart(f"{family}: throughput vs load", xlabel, "req/s")
    for name, sa in sorted(arts.items()):
        pts = sa.get("points") or []
        label = name[len(family) + 1:] or name
        xy = []
        gxy = []
        goodputs = _unit_goodputs(sa)
        for p in pts:
            x = _offered(sa, p["clients"])
            x = p["clients"] if x is None else x
            xy.append((x, (p["throughput"] or {}).get("mean")))
            if p["clients"] in goodputs:
                gxy.append((x, goodputs[p["clients"]]))
        ch.add(label, xy)
        if gxy:
            ch.add(label + " (goodput)", gxy, dashed=True)
    if sum(len(pts) for _, pts, _ in ch.series) < 2:
        return None
    return ch.svg()


# latency quantiles available on every unit; p99.9 rides in the overload
# extras when collected
_QUANTS = (("p25_ms", 0.25), ("median_ms", 0.50),
           ("p75_ms", 0.75), ("p99_ms", 0.99))


def latency_cdf(family: str, arts: Dict[str, dict]) -> Optional[str]:
    """Quantile-interpolated latency CDF, one line per scenario (the
    highest-load grid point of its replicates)."""
    ch = _Chart(f"{family}: latency CDF", "latency (ms)", "P(latency <= x)")
    for name, sa in sorted(arts.items()):
        reps = sa.get("replicates") or []
        if not reps:
            continue
        u = max(reps, key=lambda r: r["clients"])
        pts = [(u[k], q) for k, q in _QUANTS if u.get(k) is not None]
        p999 = (u.get("extras") or {}).get("p999_ms")
        if p999 is not None:
            pts.append((p999, 0.999))
        if len(pts) >= 2:
            ch.add(name[len(family) + 1:] or name, pts)
    if not ch.series:
        return None
    return ch.svg()


# ------------------------------------------------------- obs views
def _obs_of(sa: dict) -> Optional[dict]:
    """The obs extras of a scenario's first unit that carries them."""
    for u in sa.get("units", []):
        ob = (u.get("extras") or {}).get("obs")
        if ob:
            return ob
    return None


def _heat_color(f: float) -> str:
    """0..1 busy fraction -> white-to-red ramp."""
    f = min(max(f, 0.0), 1.0)
    g = int(255 * (1.0 - f))
    return f"#ff{g:02x}{g:02x}"


def utilization_heat(family: str, arts: Dict[str, dict]) -> Optional[str]:
    """Per-node utilization heat strip: one row per node, time on x, cell
    color = CPU busy fraction over the sampler period — the view that makes
    a static relay hotspot (vs rotation's even spread) visible at a glance.
    Rendered from the first scenario of the family whose timelines carry
    ``busy_frac/i`` series."""
    for name, sa in sorted(arts.items()):
        ob = _obs_of(sa)
        series = ((ob or {}).get("timelines") or {}).get("series") or {}
        rows = sorted((int(k.split("/")[1]), v) for k, v in series.items()
                      if k.startswith("busy_frac/") and v["t"])
        if not rows:
            continue
        t0 = min(v["t"][0] for _, v in rows)
        t1 = max(v["t"][-1] for _, v in rows)
        if t1 <= t0:
            continue
        n = len(rows)
        rh = max(4, min(14, 360 // n))                 # row height
        h = _MT + n * rh + _MB
        e = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" '
            f'height="{h}" viewBox="0 0 {_W} {h}" '
            f'font-family="sans-serif" font-size="11">',
            f'<rect width="{_W}" height="{h}" fill="white"/>',
            f'<text x="{_W / 2}" y="20" text-anchor="middle" '
            f'font-size="14">{name}: per-node CPU busy fraction</text>',
        ]
        pw = _W - _ML - _MR
        for ri, (node, v) in enumerate(rows):
            y = _MT + ri * rh
            pts = list(zip(v["t"], v["v"]))
            for j, (t, f) in enumerate(pts):
                tn = pts[j + 1][0] if j + 1 < len(pts) else t1
                x = _ML + (t - t0) / (t1 - t0) * pw
                w = max((tn - t) / (t1 - t0) * pw, 0.5)
                e.append(f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                         f'height="{rh}" fill="{_heat_color(f)}"/>')
            if n <= 30 or node % 5 == 0:
                e.append(f'<text x="{_ML - 6}" y="{y + rh - 1}" '
                         f'text-anchor="end">{node}</text>')
        e.append(f'<rect x="{_ML}" y="{_MT}" width="{pw}" '
                 f'height="{n * rh}" fill="none" stroke="#333"/>')
        for frac in (0.0, 0.5, 1.0):
            x = _ML + frac * pw
            e.append(f'<text x="{x:.1f}" y="{_MT + n * rh + 16}" '
                     f'text-anchor="middle">'
                     f'{_fmt(t0 + frac * (t1 - t0))}s</text>')
        e.append(f'<text x="{_W / 2}" y="{h - 12}" text-anchor="middle">'
                 f'virtual time (node id on y; white=idle, red=busy)</text>')
        e.append("</svg>")
        return "\n".join(e)
    return None


# critical-path segment palette, in stack order
_SEG_ORDER = ("queue", "svc", "ser", "relay", "net", "wait")
_SEG_COLORS = {"queue": "#D55E00", "svc": "#0072B2", "ser": "#CC79A7",
               "relay": "#E69F00", "net": "#009E73", "wait": "#999999"}


def critpath_waterfall(family: str, arts: Dict[str, dict]) -> Optional[str]:
    """Critical-path waterfall: one horizontal stacked bar per traced
    scenario, segments = mean per-op milliseconds attributed to queue wait,
    CPU service, serialization, relay aggregation, network, and residual
    wait — the bottleneck-attribution picture (segments sum to the mean
    traced op latency by construction)."""
    bars = []
    for name, sa in sorted(arts.items()):
        ob = _obs_of(sa)
        cp = (ob or {}).get("critical_path") or {}
        mean = cp.get("mean_ms") or {}
        if mean and cp.get("n_ops"):
            bars.append((name[len(family) + 1:] or name, mean))
    if not bars:
        return None
    total_max = max(sum(m.get(s, 0.0) for s in _SEG_ORDER) for _, m in bars)
    if total_max <= 0:
        return None
    bh, gap = 34, 18
    h = _MT + 30 + len(bars) * (bh + gap) + _MB
    pw = _W - _ML - _MR
    e = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" '
        f'height="{h}" viewBox="0 0 {_W} {h}" '
        f'font-family="sans-serif" font-size="11">',
        f'<rect width="{_W}" height="{h}" fill="white"/>',
        f'<text x="{_W / 2}" y="20" text-anchor="middle" font-size="14">'
        f'{family}: critical-path attribution (mean ms/op)</text>',
    ]
    lx = _ML
    for s in _SEG_ORDER:
        e.append(f'<rect x="{lx}" y="{_MT + 2}" width="10" height="10" '
                 f'fill="{_SEG_COLORS[s]}"/>')
        e.append(f'<text x="{lx + 13}" y="{_MT + 11}">{s}</text>')
        lx += 24 + 7 * len(s)
    for bi, (label, mean) in enumerate(bars):
        y = _MT + 30 + bi * (bh + gap)
        e.append(f'<text x="{_ML}" y="{y - 3}">{label} '
                 f'(total {sum(mean.get(s, 0.0) for s in _SEG_ORDER):.2f}'
                 f'ms)</text>')
        x = float(_ML)
        for s in _SEG_ORDER:
            v = mean.get(s, 0.0)
            if v <= 0:
                continue
            w = v / total_max * pw
            e.append(f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                     f'height="{bh}" fill="{_SEG_COLORS[s]}" '
                     f'stroke="white" stroke-width="0.5"/>')
            if w > 34:
                e.append(f'<text x="{x + w / 2:.1f}" y="{y + bh / 2 + 4}" '
                         f'text-anchor="middle" fill="white">'
                         f'{v:.2f}</text>')
            x += w
    e.append("</svg>")
    return "\n".join(e)


def render_artifact(artifact: dict, outdir: str) -> List[str]:
    """Write throughput-vs-load, latency-CDF, utilization-heat and
    critical-path SVGs for every family in ``artifact`` that has the data;
    returns the written paths."""
    by_family: Dict[str, Dict[str, dict]] = {}
    for sa in artifact.get("scenarios", []):
        by_family.setdefault(sa["family"], {})[sa["name"]] = sa
    os.makedirs(outdir, exist_ok=True)
    written = []
    for family, arts in sorted(by_family.items()):
        for suffix, fn in (("throughput", throughput_vs_load),
                           ("latency_cdf", latency_cdf),
                           ("util_heat", utilization_heat),
                           ("critpath", critpath_waterfall)):
            svg = fn(family, arts)
            if not svg:
                continue
            path = os.path.join(outdir, f"{family}_{suffix}.svg")
            with open(path, "w") as f:
                f.write(svg)
            written.append(path)
    return written
