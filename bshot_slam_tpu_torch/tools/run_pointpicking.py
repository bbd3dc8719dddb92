#!/usr/bin/env python3
"""Point labeling tool of the port — `tools/run_pointpicking.py`, imports
rewritten to `bshot_slam_tpu_torch`; host-only numpy (it touches no device,
so it takes no `--cpu`), and its select lists and picker page are byte for
byte the reference tool's.  Its select lists feed
`bshot_slam_tpu_torch/tools/run_preprocess_eval.py --select`.

Headless equivalent of the reference's interactive
`pointpicking` viewer (reference: test/pointpicking.cpp + include/
ViewerHandler.h): select per-frame point subsets by 3D crop boxes and write
select-list files that the preprocessing evaluator consumes
(`run_preprocess_eval.py --select`).

The reference builds its crop cube from two mouse-drawn rectangles (top
then side view — ViewerHandler.cpp:65-198).  Two modes here:

  # headless: the crop cube specified directly
  run_pointpicking.py cap.pcap --box xmin xmax ymin ymax zmin zmax \
      [--box ...] --frames 5 --out labels.txt [--merge old_labels.txt]

  # interactive: self-contained HTML picker with the reference's 2-view
  # mouse workflow (drag a rect in the TOP view, then one in the SIDE
  # view -> crop cube; repeat for unions; download the select list)
  run_pointpicking.py cap.pcap --frames 5 --html picker.html

Each output line holds the sorted selected point indices (firing order) of
one frame, the reference's SelectedPoints format (reference:
odometry_test.cpp:147-162 loader).
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcap", nargs="?")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--n-azimuth", type=int, default=0)
    ap.add_argument("--box", nargs=6, type=float, action="append",
                    metavar=("XMIN", "XMAX", "YMIN", "YMAX", "ZMIN", "ZMAX"),
                    help="crop box in sensor-frame mm; repeatable (union)")
    ap.add_argument("--invert", action="store_true",
                    help="select points OUTSIDE the boxes (reference trim mode)")
    ap.add_argument("--merge", help="existing select-list to union with "
                    "(reference inputIDX.txt)")
    ap.add_argument("--out",
                    help="select-list output (required unless --html)")
    ap.add_argument("--html", metavar="FILE",
                    help="write a self-contained interactive 2-view picker "
                         "page instead (open in any browser)")
    args = ap.parse_args(argv)
    if not args.html and not args.out:
        ap.error("--out is required (or use --html)")
    if not args.html and not args.box:
        ap.error("--box is required in headless mode (or use --html)")

    import dataclasses

    import numpy as np

    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.io import pcap as pcap_io
    from bshot_slam_tpu_torch.io import synthetic, velodyne

    cfg = default_config()
    if args.n_azimuth:
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, n_azimuth=args.n_azimuth)
        )
    if args.synthetic:
        sweeps, _ = synthetic.render_sequence(
            args.synthetic, cfg.sensor, seed=0, n_firings=cfg.sensor.n_azimuth
        )
    else:
        if not args.pcap:
            ap.error("provide a PCAP path or --synthetic N")
        payloads, _ = pcap_io.read_udp_payloads(args.pcap)
        sweeps = velodyne.sweeps_from_payloads(payloads, cfg.sensor, skip=args.skip)
    if args.frames:
        sweeps = sweeps[: args.frames]

    def frame_xyz(sw):
        # Sensor-frame XYZ per laser, firing order
        # (reference coordinate convention, preprocess.cpp:50-52).
        d = sw.distance.astype(np.float64) * cfg.sensor.distance_scale_mm
        az = np.deg2rad(sw.azimuth_deg)
        vert_lut = np.deg2rad(np.asarray(cfg.sensor.vertical_angles_deg))
        v = vert_lut[sw.ring]
        x = d * np.cos(v) * np.sin(az)
        y = d * np.cos(v) * np.cos(az)
        z = d * np.sin(v)
        return x, y, z, d

    if args.html:
        _write_picker_html(args.html, sweeps, frame_xyz)
        print(f"interactive picker -> {args.html}")
        return 0

    merged = []
    if args.merge:
        with open(args.merge) as f:
            for line in f:
                merged.append({int(t) for t in line.split()})

    with open(args.out, "w") as f:
        for i, sw in enumerate(sweeps):
            x, y, z, d = frame_xyz(sw)
            sel = np.zeros(len(sw), bool)
            for bx in args.box:
                sel |= (
                    (x >= bx[0]) & (x <= bx[1]) & (y >= bx[2]) & (y <= bx[3])
                    & (z >= bx[4]) & (z <= bx[5])
                )
            sel &= d > 0
            if args.invert:
                sel = ~sel & (d > 0)
            idx = set(np.nonzero(sel)[0].tolist())
            if i < len(merged):
                idx |= merged[i]
            f.write(" ".join(str(j) for j in sorted(idx)) + "\n")
            print(f"frame {i}: {len(idx)} selected", file=sys.stderr)
    print(f"select lists -> {args.out}")
    return 0


_PICKER_JS = r"""
const frames = FRAMES_JSON;  // [{n, b64}] int16 cm triplets, firing order
function decode(fr) {
  const raw = atob(fr.b64);
  const buf = new Int16Array(raw.length / 2);
  for (let i = 0; i < buf.length; i++)
    buf[i] = (raw.charCodeAt(2*i) | (raw.charCodeAt(2*i+1) << 8)) << 16 >> 16;
  return buf;  // x0,y0,z0,x1,... in cm (0,0,0 = no return)
}
const pts = frames.map(decode);
let cur = 0, boxes = frames.map(() => []), pending = null;
const topC = document.getElementById('top'), sideC = document.getElementById('side');
const S = 700, RANGE = 6000; // +-60 m in cm
function toPx(v) { return (v / RANGE + 1) * S / 2; }
function fromPx(p) { return (2 * p / S - 1) * RANGE; }
function selMask(f) {
  const P = pts[f], n = frames[f].n, m = new Uint8Array(n);
  for (const b of boxes[f]) {
    for (let i = 0; i < n; i++) {
      const x = P[3*i], y = P[3*i+1], z = P[3*i+2];
      if (!x && !y && !z) continue;
      if (x >= b[0] && x <= b[1] && y >= b[2] && y <= b[3] &&
          z >= b[4] && z <= b[5]) m[i] = 1;
    }
  }
  return m;
}
function draw() {
  const P = pts[cur], n = frames[cur].n, m = selMask(cur);
  for (const [cv, ax] of [[topC, 1], [sideC, 2]]) {
    const g = cv.getContext('2d');
    g.fillStyle = '#101018'; g.fillRect(0, 0, S, S);
    for (let i = 0; i < n; i++) {
      const x = P[3*i], o = P[3*i+ax];
      if (!x && !P[3*i+1] && !P[3*i+2]) continue;
      g.fillStyle = m[i] ? '#f1c40f' : '#4e79a7';
      g.fillRect(toPx(x), S - toPx(o), 1.4, 1.4);
    }
  }
  document.getElementById('st').textContent =
    `frame ${cur + 1}/${frames.length}  boxes=${boxes[cur].length}  ` +
    `selected=${m.reduce((a, b) => a + b, 0)}` +
    (pending ? '  [now drag a rect in the SIDE view for z]' :
               '  [drag a rect in the TOP view]');
}
function rectOn(cv, done) {
  let p0 = null, live = null;
  cv.onmousedown = e => { p0 = [e.offsetX, e.offsetY]; };
  cv.onmousemove = e => {
    if (!p0) return;
    draw();
    const g = cv.getContext('2d');
    g.strokeStyle = '#e15759';
    g.strokeRect(p0[0], p0[1], e.offsetX - p0[0], e.offsetY - p0[1]);
    live = [e.offsetX, e.offsetY];
  };
  cv.onmouseup = e => {
    if (!p0) return;
    done([Math.min(p0[0], e.offsetX), Math.max(p0[0], e.offsetX)],
         [Math.min(p0[1], e.offsetY), Math.max(p0[1], e.offsetY)]);
    p0 = null; draw();
  };
}
rectOn(topC, (xs, ys) => {  // SELECT1: x/y from the top view
  pending = [fromPx(xs[0]), fromPx(xs[1]), fromPx(S - ys[1]), fromPx(S - ys[0])];
  draw();
});
rectOn(sideC, (xs, ys) => {  // SELECT2: z from the side view -> crop cube
  if (!pending) return;
  boxes[cur].push([pending[0], pending[1], pending[2], pending[3],
                   fromPx(S - ys[1]), fromPx(S - ys[0])]);
  pending = null; draw();
});
document.getElementById('undo').onclick = () => { boxes[cur].pop(); draw(); };
document.getElementById('clear').onclick = () => { boxes[cur] = []; draw(); };
document.getElementById('prev').onclick = () => { cur = Math.max(0, cur - 1); pending = null; draw(); };
document.getElementById('next').onclick = () => { cur = Math.min(frames.length - 1, cur + 1); pending = null; draw(); };
document.getElementById('copyall').onclick = () => {
  for (let f = 0; f < frames.length; f++)
    if (f !== cur) boxes[f] = boxes[cur].map(b => b.slice());
  draw();
};
document.getElementById('save').onclick = () => {
  const lines = frames.map((fr, f) => {
    const m = selMask(f), out = [];
    for (let i = 0; i < fr.n; i++) if (m[i]) out.push(i);
    return out.join(' ');
  });
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([lines.join('\n') + '\n'],
                                        {type: 'text/plain'}));
  a.download = 'select_list.txt';
  a.click();
};
draw();
"""


def _write_picker_html(path, sweeps, frame_xyz):
    """Self-contained 2-view picker (reference workflow ViewerHandler.h:20
    MODE SELECT1 -> SELECT2): points embedded as base64 int16 centimeters,
    selection and the select-list download run client-side."""
    import base64
    import json

    import numpy as np

    frames = []
    for sw in sweeps:
        x, y, z, d = frame_xyz(sw)
        q = np.stack([x, y, z], -1) / 10.0  # mm -> cm fits int16 to +-327 m
        q = np.where((d > 0)[:, None], np.clip(q, -32767, 32767), 0.0)
        frames.append({
            "n": len(sw),
            "b64": base64.b64encode(
                q.astype(np.int16).tobytes()
            ).decode("ascii"),
        })
    js = _PICKER_JS.replace("FRAMES_JSON", json.dumps(frames))
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>bshot_slam_tpu point picker</title></head>"
        "<body style='background:#181818;color:#ddd;font-family:monospace'>"
        "<h3>2-view point picker — drag TOP (x/y) then SIDE (x/z); "
        "units cm</h3>"
        "<div id='st'></div>"
        "<button id='prev'>&lt; prev</button> "
        "<button id='next'>next &gt;</button> "
        "<button id='undo'>undo box</button> "
        "<button id='clear'>clear frame</button> "
        "<button id='copyall'>copy boxes to all frames</button> "
        "<button id='save'>download select list</button><br/>"
        "<canvas id='top' width='700' height='700' "
        "style='border:1px solid #555;margin:4px'></canvas>"
        "<canvas id='side' width='700' height='700' "
        "style='border:1px solid #555;margin:4px'></canvas>"
        f"<script>{js}</script></body></html>"
    )
    with open(path, "w") as f:
        f.write(html)


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
