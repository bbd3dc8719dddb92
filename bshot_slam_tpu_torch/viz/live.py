"""Live headless view of a RUNNING SLAM engine.

The reference's main program is fundamentally a visual tool: an OpenCV Viz
window redraws the world cloud, map keypoints, correspondences, and the
gold-trajectory overlay every frame (reference: test/odometry_test.cpp:
195-345).  On a headless host this module provides the same live view
without a display: every N frames it atomically rewrites

    DIR/live.svg    top-down map keypoints + trajectory (+ gold overlay)
                    with a stats panel
    DIR/live.json   machine-readable per-frame stats
    DIR/live.html   (written once) auto-refreshing wrapper — open it in any
                    browser / VS Code preview to watch the run
    DIR/live3d.html (written once) ROTATABLE 3D viewer: drag to orbit,
                    wheel to zoom — the headless answer to the reference's
                    interactive Viz3d camera (ViewerHandler.cpp:65-198);
                    polls live_points.json
    DIR/live_points.json  map / trajectory / gold / correspondence points
                    for the 3D viewer, refreshed with the SVG

Atomic replace (tmp + rename) means a watcher never reads a half-written
frame.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

_HTML = """<!doctype html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="1">
<title>bshot_slam_tpu_torch live</title></head>
<body style="margin:0;background:#111">
<a href="live3d.html" style="color:#8cf;font:13px sans-serif">3D view</a>
<img src="live.svg" style="width:100%;max-width:1100px"/>
</body></html>
"""

# Self-contained orbit-camera point viewer: drag = rotate (yaw/pitch),
# wheel = zoom, double-click = reset.  Replaces the reference's OpenCV
# Viz3d interactive camera (reference: test/odometry_test.cpp:195-345,
# src/ViewerHandler.cpp:65-198 camera math) with a headless browser page
# polling live_points.json.
_HTML3D = """<!doctype html>
<html><head><meta charset="utf-8"><title>bshot_slam_tpu_torch 3D</title></head>
<body style="margin:0;background:#0b0b12;overflow:hidden">
<canvas id="c"></canvas>
<div id="hud" style="position:fixed;top:8px;left:10px;color:#9ab;
 font:12px monospace">drag: rotate &nbsp; wheel: zoom &nbsp;
 dblclick: reset</div>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.7, pitch = 0.45, dist = 3.2, data = null, center=[0,0,0];
function resize(){ cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', resize); resize();
let drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  yaw   += (e.clientX - drag[0]) * 0.008;
  pitch += (e.clientY - drag[1]) * 0.008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  drag = [e.clientX, e.clientY]; draw();
});
cv.addEventListener('wheel', e => {
  dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault();
});
cv.addEventListener('dblclick', () => { yaw=-0.7; pitch=0.45; dist=3.2; draw(); });
function project(p, R, scale){
  const x = p[0]-center[0], y = p[1]-center[1], z = p[2]-center[2];
  const cx = R[0]*x + R[1]*y + R[2]*z;
  const cy = R[3]*x + R[4]*y + R[5]*z;
  const cz = R[6]*x + R[7]*y + R[8]*z + dist*scale;
  if (cz <= 1) return null;
  const f = 1.2 * Math.min(cv.width, cv.height);
  return [cv.width/2 + f*cx/cz, cv.height/2 - f*cy/cz, cz];
}
function draw(){
  ctx.fillStyle = '#0b0b12'; ctx.fillRect(0,0,cv.width,cv.height);
  if (!data) return;
  const cy_=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const R = [cy_, sy, 0,  -sy*sp, cy_*sp, cp,  -sy*cp, cy_*cp, -sp];
  const scale = data.scale || 1;
  function pts(arr, color, r){
    ctx.fillStyle = color;
    for (const p of arr){ const q = project(p, R, scale);
      if (q) ctx.fillRect(q[0]-r, q[1]-r, 2*r, 2*r); }
  }
  function path(arr, color, w){
    ctx.strokeStyle = color; ctx.lineWidth = w; ctx.beginPath();
    let started = false;
    for (const p of arr){ const q = project(p, R, scale);
      if (!q) { started = false; continue; }
      started ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
      started = true; }
    ctx.stroke();
  }
  pts(data.map || [], '#4f8f4f', 1);
  if (data.gold && data.gold.length) path(data.gold, '#caa94f', 1.5);
  if (data.traj && data.traj.length){
    path(data.traj, '#5fb3ff', 2);
    pts([data.traj[data.traj.length-1]], '#ff5f5f', 4);
  }
  for (const seg of (data.corr || [])){
    path(seg, '#d06fd0', 1);
  }
  ctx.fillStyle = '#9ab'; ctx.font = '12px monospace';
  ctx.fillText(JSON.stringify(data.stats || {}), 10, cv.height - 12);
}
async function tick(){
  try {
    const r = await fetch('live_points.json', {cache: 'no-store'});
    if (r.ok){
      const d = await r.json();
      data = d;
      if (d.center) center = d.center;
      draw();
    }
  } catch (e) {}
  setTimeout(tick, 1000);
}
tick();
</script></body></html>
"""


def _atomic_write(path: str, data: str) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class LiveView:
    """Periodic artifact refresh for a running SlamEngine."""

    def __init__(self, out_dir: str, every: int = 5,
                 max_map_points: int = 6000, size: int = 1000):
        self.dir = out_dir
        self.every = max(1, every)
        self.max_map_points = max_map_points
        self.size = size
        os.makedirs(out_dir, exist_ok=True)
        _atomic_write(os.path.join(out_dir, "live.html"), _HTML)
        _atomic_write(os.path.join(out_dir, "live3d.html"), _HTML3D)

    def maybe_update(self, engine, gold: Optional[np.ndarray] = None) -> bool:
        n = len(engine.records)
        if n == 0 or n % self.every:
            return False
        self.update(engine, gold)
        return True

    def update(self, engine, gold: Optional[np.ndarray] = None) -> None:
        traj = engine.trajectory
        mp = engine.state.map.positions.cpu().numpy()
        mv = engine.state.map.valid.cpu().numpy()
        pts = mp[mv]
        if len(pts) > self.max_map_points:
            idx = np.linspace(0, len(pts) - 1, self.max_map_points).astype(int)
            pts = pts[idx]
        rec = engine.records[-1]
        # Inlier correspondence segments of the newest frame (reference
        # corrviewer: odometry_test.cpp:281-345) — available when the
        # engine runs with keep_corr=True.
        corr_segs = []
        lc = getattr(engine, "last_corr", None)
        if lc is not None:
            cap = lc["map_cap"]
            for i in np.flatnonzero(lc["inlier"]):
                j = int(lc["index"][i])
                if 0 <= j < cap:
                    tgt = mp[j]
                elif lc["prev_src_world"] is not None and j >= cap:
                    k = j - cap
                    if k >= len(lc["prev_src_world"]):
                        continue
                    tgt = lc["prev_src_world"][k]
                else:
                    continue
                corr_segs.append((lc["src_world"][i], tgt))
        stats = {
            "frame": len(engine.records),
            "map_size": rec.map_size,
            "n_inliers": rec.n_inliers,
            "n_mutual": rec.n_mutual,
            "gated": rec.gated,
            "gated_total": int(sum(r.gated for r in engine.records)),
            "n_dropped": rec.n_dropped,
            "pos_mm": [round(float(v), 1) for v in rec.pose[:3, 3]],
            "keyframes": int(engine.keyframes.count),
            "loop_edges": len(getattr(engine, "loop_edges", [])),
        }
        stats["corr_drawn"] = len(corr_segs)
        _atomic_write(
            os.path.join(self.dir, "live.svg"),
            self._render_svg(traj, pts, gold, stats, corr_segs),
        )
        _atomic_write(
            os.path.join(self.dir, "live.json"), json.dumps(stats)
        )
        # 3D viewer payload (live3d.html orbits this; mm coordinates, the
        # camera normalizes by `scale`).
        every_pt = np.concatenate(
            [pts, traj] + ([gold] if gold is not None else [])
        ) if len(pts) or len(traj) else np.zeros((1, 3))
        center = every_pt.mean(axis=0)
        scale = float(max(np.abs(every_pt - center).max(), 1.0))

        def _r(a):
            return np.asarray(a, np.float64).round(0).tolist()

        _atomic_write(
            os.path.join(self.dir, "live_points.json"),
            json.dumps({
                "center": _r(center),
                "scale": scale,
                "map": _r(pts),
                "traj": _r(traj),
                "gold": _r(gold) if gold is not None else [],
                "corr": [[_r(a), _r(b)] for a, b in corr_segs],
                "stats": stats,
            }),
        )

    def _render_svg(self, traj, map_pts, gold, stats, corr_segs=()) -> str:
        S = self.size
        panel = 260  # stats panel width
        # Common top-down frame over everything drawn.
        chunks = [t[:, :2] for t in (traj, map_pts) if len(t)]
        if gold is not None and len(gold):
            chunks.append(np.asarray(gold)[:, :2])
        if not chunks:
            return "<svg xmlns='http://www.w3.org/2000/svg'/>"
        allp = np.concatenate(chunks)
        lo, hi = allp.min(0), allp.max(0)
        span = float(np.maximum(hi - lo, 1e-9).max())
        pad = 0.06 * span

        def px(p):
            q = (np.asarray(p)[:, :2] - lo + pad) / (span + 2 * pad) * S
            return q[:, 0], S - q[:, 1]

        parts = [
            f"<svg xmlns='http://www.w3.org/2000/svg' width='{S + panel}' "
            f"height='{S}' viewBox='0 0 {S + panel} {S}'>",
            f"<rect width='{S + panel}' height='{S}' fill='#181818'/>",
            f"<rect width='{S}' height='{S}' fill='#101018'/>",
        ]
        if len(map_pts):
            x, y = px(map_pts)
            dots = "".join(
                f"<circle cx='{a:.1f}' cy='{b:.1f}' r='1.2'/>"
                for a, b in zip(x, y)
            )
            parts.append(f"<g fill='#4e79a7' opacity='0.6'>{dots}</g>")
        if gold is not None and len(gold):
            x, y = px(np.asarray(gold))
            parts.append(
                "<polyline fill='none' stroke='#59a14f' stroke-width='2' "
                "stroke-dasharray='6 4' points='"
                + " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(x, y)) + "'/>"
            )
        if corr_segs:
            a = np.asarray([s[0] for s in corr_segs])
            bpts = np.asarray([s[1] for s in corr_segs])
            ax, ay = px(a)
            bx, by = px(bpts)
            lines = "".join(
                f"<line x1='{x1:.1f}' y1='{y1:.1f}' x2='{x2:.1f}' "
                f"y2='{y2:.1f}'/>"
                for x1, y1, x2, y2 in zip(ax, ay, bx, by)
            )
            parts.append(
                f"<g stroke='#f1c40f' stroke-width='0.9' "
                f"opacity='0.75'>{lines}</g>"
            )
        if len(traj):
            x, y = px(traj)
            parts.append(
                "<polyline fill='none' stroke='#e15759' stroke-width='2.5' "
                "points='"
                + " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(x, y)) + "'/>"
            )
            parts.append(
                f"<circle cx='{x[-1]:.1f}' cy='{y[-1]:.1f}' r='6' "
                f"fill='none' stroke='#f1c40f' stroke-width='2'/>"
            )
        rows = [
            f"frame      {stats['frame']}",
            f"pos mm     {stats['pos_mm']}",
            f"map        {stats['map_size']}",
            f"mutual     {stats['n_mutual']}",
            f"inliers    {stats['n_inliers']}",
            f"gated      {'YES' if stats['gated'] else 'no'}"
            f" ({stats['gated_total']} total)",
            f"dropped    {stats['n_dropped']}",
            f"keyframes  {stats['keyframes']}",
            f"loop edges {stats['loop_edges']}",
        ]
        for k, row in enumerate(rows):
            parts.append(
                f"<text x='{S + 14}' y='{34 + 24 * k}' fill='#ddd' "
                f"font-family='monospace' font-size='14'>{row}</text>"
            )
        legend = [("#e15759", "trajectory"), ("#59a14f", "gold"),
                  ("#4e79a7", "map keypoints"),
                  ("#f1c40f", "inlier correspondences")]
        for k, (c, name) in enumerate(legend):
            y0 = S - 70 + 22 * k
            parts.append(
                f"<rect x='{S + 14}' y='{y0 - 10}' width='12' height='12' "
                f"fill='{c}'/><text x='{S + 32}' y='{y0}' fill='#aaa' "
                f"font-family='monospace' font-size='13'>{name}</text>"
            )
        parts.append("</svg>")
        return "".join(parts)
