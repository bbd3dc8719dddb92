"""Minimal self-contained SVG line charts for the offline analysis layer.

Rebuild of the reference's L8 analysis layer (reference:
test/Correspondences_analysis.m, test/StaticTest_analysis.m,
test/PCP_SP_initpos_analysis.m — MATLAB line plots of per-frame series).
The reference hard-codes manually transcribed numbers; here the numbers are
computed by the pipeline and rendered headlessly.

Chart conventions (one system): change-over-frames => line form; categorical
color follows the series identity in a fixed validated order (never cycled);
2 px lines, >= 8 px markers with per-series shapes as secondary encoding;
recessive grid; a legend whenever there are >= 2 series; text in ink tokens,
never series color; one y-axis; native SVG <title> tooltips on markers.
"""

from __future__ import annotations

import html
from typing import Dict, List, Sequence

# Validated categorical order (light mode), assigned by identity in fixed
# order, never cycled; >6 series should be folded by the caller.
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300"]
_MARKERS = ["circle", "square", "diamond", "triangle", "cross", "circle_open"]

_SURFACE = "#ffffff"
_INK = "#1a1a19"
_INK_2 = "#6b6a63"
_GRID = "#e8e7e0"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e7:
        return str(int(v))
    return f"{v:.4g}"


def _marker_svg(shape: str, x: float, y: float, color: str, tip: str) -> str:
    t = f"<title>{html.escape(tip)}</title>"
    if shape == "square":
        return (f'<rect x="{x-4:.1f}" y="{y-4:.1f}" width="8" height="8" '
                f'fill="{color}">{t}</rect>')
    if shape == "diamond":
        return (f'<path d="M {x:.1f} {y-5:.1f} L {x+5:.1f} {y:.1f} '
                f'L {x:.1f} {y+5:.1f} L {x-5:.1f} {y:.1f} Z" '
                f'fill="{color}">{t}</path>')
    if shape == "triangle":
        return (f'<path d="M {x:.1f} {y-5:.1f} L {x+5:.1f} {y+4:.1f} '
                f'L {x-5:.1f} {y+4:.1f} Z" fill="{color}">{t}</path>')
    if shape == "cross":
        return (f'<path d="M {x-4:.1f} {y-4:.1f} L {x+4:.1f} {y+4:.1f} '
                f'M {x-4:.1f} {y+4:.1f} L {x+4:.1f} {y-4:.1f}" '
                f'stroke="{color}" stroke-width="2.5" fill="none">{t}</path>')
    if shape == "circle_open":
        return (f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="{_SURFACE}" '
                f'stroke="{color}" stroke-width="2">{t}</circle>')
    return f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="{color}">{t}</circle>'


def _ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    if hi <= lo:
        hi = lo + 1.0
    span = hi - lo
    import math

    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 2.5, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-9:
        out.append(round(t, 10))
        t += step
    return out or [lo, hi]


def save_line_chart_svg(
    path: str,
    x: Sequence[float],
    series: Dict[str, Sequence[float]],
    title: str,
    xlabel: str,
    ylabel: str,
    width: int = 720,
    height: int = 420,
) -> None:
    """Write a multi-series line chart; series order fixes color identity."""
    names = list(series.keys())
    if len(names) > len(PALETTE):
        raise ValueError(
            f"{len(names)} series > {len(PALETTE)}: fold extras before charting"
        )
    xs = [float(v) for v in x]
    all_y = [float(v) for ys in series.values() for v in ys
             if v == v and abs(v) != float("inf")]
    if not all_y or not xs:
        all_y, xs = [0.0, 1.0], xs or [0.0, 1.0]
    ylo, yhi = min(all_y + [0.0]), max(all_y)
    if yhi == ylo:
        yhi = ylo + 1.0
    yhi += (yhi - ylo) * 0.08
    xlo, xhi = min(xs), max(xs)
    if xhi == xlo:
        xhi = xlo + 1.0

    ml, mr, mt, mb = 64, 16, 44, 46
    pw, ph = width - ml - mr, height - mt - mb

    def sx(v):
        return ml + (v - xlo) / (xhi - xlo) * pw

    def sy(v):
        return mt + ph - (v - ylo) / (yhi - ylo) * ph

    e: List[str] = []
    e.append(f'<rect width="{width}" height="{height}" fill="{_SURFACE}"/>')
    e.append(
        f'<text x="{ml}" y="24" fill="{_INK}" font-size="15" '
        f'font-weight="600">{html.escape(title)}</text>'
    )
    for t in _ticks(ylo, yhi):
        yy = sy(t)
        e.append(f'<line x1="{ml}" y1="{yy:.1f}" x2="{width-mr}" y2="{yy:.1f}" '
                 f'stroke="{_GRID}" stroke-width="1"/>')
        e.append(f'<text x="{ml-8}" y="{yy+4:.1f}" fill="{_INK_2}" '
                 f'font-size="11" text-anchor="end">{_fmt(t)}</text>')
    for t in _ticks(xlo, xhi, 8):
        xx = sx(t)
        e.append(f'<text x="{xx:.1f}" y="{height-mb+18}" fill="{_INK_2}" '
                 f'font-size="11" text-anchor="middle">{_fmt(t)}</text>')
    e.append(f'<line x1="{ml}" y1="{mt+ph}" x2="{width-mr}" y2="{mt+ph}" '
             f'stroke="{_INK_2}" stroke-width="1"/>')
    e.append(f'<text x="{ml+pw/2:.0f}" y="{height-8}" fill="{_INK_2}" '
             f'font-size="12" text-anchor="middle">{html.escape(xlabel)}</text>')
    e.append(f'<text x="16" y="{mt+ph/2:.0f}" fill="{_INK_2}" font-size="12" '
             f'text-anchor="middle" transform="rotate(-90 16 {mt+ph/2:.0f})">'
             f'{html.escape(ylabel)}</text>')

    for si, name in enumerate(names):
        color = PALETTE[si]
        shape = _MARKERS[si]
        ys = [float(v) for v in series[name]]
        kept = [(sx(a), sy(b), a, b) for a, b in zip(xs, ys)
                if b == b and abs(b) != float("inf")]
        if len(kept) > 1:
            d = " ".join(f"{'M' if i == 0 else 'L'} {a:.1f} {b:.1f}"
                         for i, (a, b, _, _) in enumerate(kept))
            e.append(f'<path d="{d}" stroke="{color}" stroke-width="2" '
                     f'fill="none"/>')
        for a, b, xv, yv in kept:
            e.append(_marker_svg(shape, a, b, color,
                                 f"{name}: {xlabel}={_fmt(xv)}, {_fmt(yv)}"))

    if len(names) >= 2:  # legend: identity never by color alone (shapes too)
        lx = ml + 8
        ly = mt + 2
        for si, name in enumerate(names):
            e.append(_marker_svg(_MARKERS[si], lx + 4, ly + 5, PALETTE[si],
                                 name))
            e.append(f'<text x="{lx+14}" y="{ly+9}" fill="{_INK}" '
                     f'font-size="11">{html.escape(name)}</text>')
            lx += 18 + 7 * len(name)

    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="system-ui, sans-serif">'
        + "".join(e) + "</svg>"
    )
    with open(path, "w") as f:
        f.write(svg)
