"""Live SLAM viewer (the port of ``mast3r_slam_tpu/viewer.py``): the map and
the trajectory over plain HTTP, from the standard library and numpy.

The SLAM process serves a small HTTP endpoint (``http.server`` on a daemon
thread: the tracking loop never waits on a client), and any browser draws
the growing point cloud and the camera path with the page's own canvas
renderer (no CDN, no websockets; a plain SSH port-forward is enough).

Endpoints:
  GET /            the viewer page
  GET /state.json  {"seq": N, ...}, the full snapshot, or {"unchanged": true}
                   when ``?since=N`` is the current sequence number

Wiring: ``runtime.viewer_port`` (0 = off; `SLAM` starts the viewer with its
state) or ``SLAM.viewer = LiveViewer(port)``. `SLAM` publishes the
trajectory and every keyframe's subsampled colored cloud on a promotion and
every ``runtime.viewer_refresh`` frames, and only then reads the device.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mast3r-slam live</title>
<style>
 body{margin:0;background:#101014;color:#cfd2da;font:13px system-ui}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 canvas{display:block}
</style></head><body>
<div id="hud">connecting…</div><canvas id="c"></canvas>
<script>
"use strict";
const cv=document.getElementById("c"),hud=document.getElementById("hud"),
      ctx=cv.getContext("2d");
let pts=new Float32Array(0),cols=new Uint8Array(0),traj=[],seq=-1,
    yaw=-0.6,pitch=-0.4,dist=4,cx=0,cy=0,cz=0,drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener("resize",resize);resize();
cv.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY,e.shiftKey]);
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  if(drag[2]){const s=dist*0.002;  // pan in view plane
    cx-=s*(dx*Math.cos(yaw)); cz-=s*(dx*Math.sin(yaw)); cy+=s*dy;}
  else {yaw+=dx*0.005;pitch+=dy*0.005;
        pitch=Math.max(-1.5,Math.min(1.5,pitch));}
  drag=[e.clientX,e.clientY,drag[2]];});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();});
function project(x,y,z,m){ // rotate about (cx,cy,cz), perspective
  x-=cx;y-=cy;z-=cz;
  let X= x*m[0]+z*m[1], Z=-x*m[1]+z*m[0];          // yaw
  let Y= y*m[2]-Z*m[3],  W= y*m[3]+Z*m[2];          // pitch
  W+=dist;
  if(W<0.05)return null;
  const f=0.9*Math.min(cv.width,cv.height)/W;
  return [cv.width/2+X*f,cv.height/2-Y*f,W];
}
function draw(){
  ctx.fillStyle="#101014";ctx.fillRect(0,0,cv.width,cv.height);
  const m=[Math.cos(yaw),Math.sin(yaw),Math.cos(pitch),Math.sin(pitch)];
  const img=ctx.getImageData(0,0,cv.width,cv.height),d=img.data,w=cv.width;
  for(let i=0;i<pts.length;i+=3){
    const p=project(pts[i],pts[i+1],pts[i+2],m);
    if(!p)continue;
    const x=p[0]|0,y=p[1]|0;
    if(x<0||y<0||x>=w||y>=cv.height)continue;
    const o=4*(y*w+x),j=i;
    d[o]=cols[j];d[o+1]=cols[j+1];d[o+2]=cols[j+2];d[o+3]=255;
  }
  ctx.putImageData(img,0,0);
  if(traj.length>1){ctx.strokeStyle="#ff5964";ctx.lineWidth=1.5;ctx.beginPath();
    let started=false;
    for(const t of traj){const p=project(t[0],t[1],t[2],m);
      if(!p){started=false;continue;}
      if(!started){ctx.moveTo(p[0],p[1]);started=true;}else ctx.lineTo(p[0],p[1]);}
    ctx.stroke();
    const last=traj[traj.length-1],p=project(last[0],last[1],last[2],m);
    if(p){ctx.fillStyle="#ffd166";ctx.beginPath();
      ctx.arc(p[0],p[1],4,0,6.3);ctx.fill();}}
  requestAnimationFrame(draw);
}
async function poll(){
  try{
    const r=await fetch("/state.json?since="+seq),s=await r.json();
    if(!s.unchanged){
      seq=s.seq;
      pts=Float32Array.from(s.points.flat());
      cols=Uint8Array.from(s.colors.flat());
      traj=s.traj;
      hud.textContent=`seq ${s.seq} · ${s.points.length} pts · `+
        `${s.traj.length} poses · ${s.n_keyframes} KFs · ${s.mode||""}`;
      if(s.traj.length&&seq<3){const t=s.traj[s.traj.length-1];
        cx=t[0];cy=t[1];cz=t[2];}
    }
  }catch(e){hud.textContent="disconnected: "+e;}
  setTimeout(poll,500);
}
poll();draw();
</script></body></html>"""


class LiveViewer:
    """Thread-safe snapshot store + HTTP server (daemon thread).

    `publish_*` are cheap host-side calls made from the SLAM loop; clients
    poll `/state.json`. Points are stored per-keyframe so eviction and
    re-fusion replace a keyframe's cloud instead of appending duplicates.
    """

    def __init__(self, port: int = 8090, max_points: int = 120_000):
        self._lock = threading.Lock()
        self._seq = 0
        self._traj: list[list[float]] = []
        self._clouds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._mode = ""
        self.max_points = max_points

        store = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr lines
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif u.path == "/state.json":
                    since = parse_qs(u.query).get("since", ["-1"])[0]
                    body = store._state_json(int(since)).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- publish

    def publish_traj(self, poses: np.ndarray, mode: str = "") -> None:
        """poses: [N, 8] Sim3 (or [N, >=3]; only translation is drawn)."""
        t = np.asarray(poses, np.float32)[:, :3]
        with self._lock:
            self._traj = np.round(t, 4).tolist()
            self._mode = mode
            self._seq += 1

    def publish_keyframe(
        self,
        kf_id: int,
        points_world: np.ndarray,
        colors: Optional[np.ndarray] = None,
        stride: int = 16,
    ) -> None:
        """Store keyframe `kf_id`'s cloud (replaces a previous publish).

        points_world: [N, 3]; colors: [N, 3] uint8 (confidence-grey if
        absent). Subsampled by `stride` to bound payloads.
        """
        p = np.asarray(points_world, np.float32).reshape(-1, 3)[::stride]
        if colors is None:
            c = np.full((len(p), 3), 200, np.uint8)
        else:
            c = np.asarray(colors).reshape(-1, 3)[::stride].astype(np.uint8)
        with self._lock:
            self._clouds[int(kf_id)] = (np.round(p, 4), c)
            self._seq += 1

    def remove_keyframe(self, kf_id: int) -> None:
        with self._lock:
            if self._clouds.pop(int(kf_id), None) is not None:
                self._seq += 1

    # --------------------------------------------------------------- serve

    def _state_json(self, since: int) -> str:
        with self._lock:
            if since == self._seq:
                return json.dumps({"seq": self._seq, "unchanged": True})
            clouds = list(self._clouds.values())
            traj = self._traj
            seq, mode = self._seq, self._mode
        if clouds:
            pts = np.concatenate([p for p, _ in clouds])
            cols = np.concatenate([c for _, c in clouds])
            if len(pts) > self.max_points:
                s = len(pts) // self.max_points + 1
                pts, cols = pts[::s], cols[::s]
        else:
            pts = np.zeros((0, 3), np.float32)
            cols = np.zeros((0, 3), np.uint8)
        return json.dumps(
            {
                "seq": seq,
                "mode": mode,
                "n_keyframes": len(clouds),
                "traj": traj,
                "points": pts.tolist(),
                "colors": cols.tolist(),
            }
        )

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
