"""Live training dashboard (``vts_tpu/utils/live.py``): the visdom-role sink
of the reference Visualizer (reference util/visualizer.py:216-221,
:343-441), dependency-free.

A stdlib ``ThreadingHTTPServer`` thread inside the training process, bound
to 127.0.0.1, serves

  * ``/``            a one-page dashboard: the loss and metric curves,
                     redrawn from ``/data.json`` every 2 s, and the latest
                     epoch's visuals;
  * ``/data.json``   the loss, metric and epoch-time history and the latest
                     image names, as JSON;
  * ``/images/<f>``  PNGs of the experiment's ``web/images`` directory (the
                     basename only; anything else is a 404).

``--display_id`` > 0 turns it on (:func:`maybe_start`), ``--display_port``
picks the port (default 8097, visdom's; 0: one the OS picks).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>vts_torch — __NAME__</title>
<style>
 body{font-family:system-ui,sans-serif;margin:16px;background:#fafafa;color:#222}
 h1{font-size:18px} h2{font-size:14px;margin:18px 0 6px}
 canvas{background:#fff;border:1px solid #ddd}
 #imgs img{max-width:256px;margin:4px;border:1px solid #ddd;vertical-align:top}
 .lg{font-size:11px;color:#555;margin:2px 0 10px}
 .lg b{font-weight:600}
</style></head><body>
<h1>vts_torch live — __NAME__</h1>
<div id="stat" class="lg">waiting for data…</div>
<h2>losses</h2><canvas id="loss" width="900" height="280"></canvas><div id="losslg" class="lg"></div>
<h2>metrics (per epoch)</h2><canvas id="met" width="900" height="280"></canvas><div id="metlg" class="lg"></div>
<h2>latest visuals</h2><div id="imgs"></div>
<script>
const COLORS=['#1b6ef3','#d93025','#188038','#f29900','#9334e6','#12848a',
              '#c5221f','#5f6368','#e8710a','#1a73e8','#7b1fa2','#33691e'];
function draw(cv,series,lg){
  const ctx=cv.getContext('2d');ctx.clearRect(0,0,cv.width,cv.height);
  const names=Object.keys(series);if(!names.length)return;
  let lo=Infinity,hi=-Infinity,n=0;
  for(const k of names){for(const v of series[k]){if(isFinite(v)){lo=Math.min(lo,v);hi=Math.max(hi,v);}}n=Math.max(n,series[k].length);}
  if(!isFinite(lo)||n<2)return; if(hi===lo){hi=lo+1;}
  const X=i=>40+(cv.width-50)*i/(n-1), Y=v=>cv.height-20-(cv.height-40)*(v-lo)/(hi-lo);
  ctx.strokeStyle='#eee';ctx.beginPath();for(let g=0;g<5;g++){const y=20+g*(cv.height-40)/4;ctx.moveTo(40,y);ctx.lineTo(cv.width-10,y);}ctx.stroke();
  ctx.fillStyle='#888';ctx.font='10px sans-serif';
  ctx.fillText(hi.toPrecision(4),2,24);ctx.fillText(lo.toPrecision(4),2,cv.height-18);
  let html='';
  names.forEach((k,i)=>{const c=COLORS[i%COLORS.length];ctx.strokeStyle=c;ctx.beginPath();
    series[k].forEach((v,j)=>{if(!isFinite(v))return;const x=X(j),y=Y(v);j?ctx.lineTo(x,y):ctx.moveTo(x,y);});
    ctx.stroke();html+='<b style="color:'+c+'">&#9632; '+k+'</b> ';});
  lg.innerHTML=html;
}
async function tick(){
  try{
    const d=await (await fetch('data.json')).json();
    document.getElementById('stat').textContent=
      'epoch '+d.epoch+' · '+d.losses.length+' loss points · '+
      (d.epoch_times.length?('last epoch '+d.epoch_times[d.epoch_times.length-1][1].toFixed(1)+' s'):'');
    const ls={};for(const r of d.losses)for(const k in r.v){(ls[k]=ls[k]||[]).push(r.v[k]);}
    draw(document.getElementById('loss'),ls,document.getElementById('losslg'));
    const ms={};for(const r of d.metrics)for(const k in r.v){(ms[k]=ms[k]||[]).push(r.v[k]);}
    draw(document.getElementById('met'),ms,document.getElementById('metlg'));
    document.getElementById('imgs').innerHTML=
      d.images.map(f=>'<a href="images/'+f+'"><img title="'+f+'" src="images/'+f+'?t='+Date.now()+'"></a>').join('');
  }catch(e){}
  setTimeout(tick,2000);
}
tick();
</script></body></html>
"""


class LiveDashboard:
    """In-process live dashboard server; the push methods are thread-safe."""

    def __init__(self, name: str, img_dir: str, port: int = 8097,
                 max_loss_points: int = 5000):
        self.name = name
        self.img_dir = img_dir
        self._lock = threading.Lock()
        self._losses: List[Dict] = []
        self._metrics: List[Dict] = []
        self._epoch_times: List = []
        self._images: List[str] = []
        self._epoch = 0
        self._max = max_loss_points
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/", "/index.html"):
                    body = _PAGE.replace("__NAME__", dash.name).encode()
                    self._send(200, "text/html", body)
                elif path == "/data.json":
                    with dash._lock:
                        body = json.dumps({
                            "epoch": dash._epoch,
                            "losses": dash._losses,
                            "metrics": dash._metrics,
                            "epoch_times": dash._epoch_times,
                            "images": dash._images,
                        }).encode()
                    self._send(200, "application/json", body)
                elif path.startswith("/images/"):
                    fname = os.path.basename(path[len("/images/"):])
                    full = os.path.join(dash.img_dir, fname)
                    if os.path.isfile(full):
                        with open(full, "rb") as f:
                            self._send(200, "image/png", f.read())
                    else:
                        self._send(404, "text/plain", b"not found")
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="vts-torch-live-dashboard", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def push_losses(self, epoch: int, iters: int,
                    losses: Dict[str, float]) -> None:
        with self._lock:
            self._epoch = max(self._epoch, epoch)
            self._losses.append(
                {"e": epoch, "i": iters,
                 "v": {k: float(v) for k, v in losses.items()}})
            if len(self._losses) > self._max:      # bound memory on long runs
                self._losses = self._losses[-self._max:]

    def push_metrics(self, epoch: int, metrics: Dict[str, float]) -> None:
        with self._lock:
            self._epoch = max(self._epoch, epoch)
            self._metrics.append(
                {"e": epoch, "v": {k: float(v) for k, v in metrics.items()}})

    def push_epoch_time(self, epoch: int, seconds: float) -> None:
        with self._lock:
            self._epoch_times.append([epoch, float(seconds)])

    def push_images(self, filenames: List[str]) -> None:
        with self._lock:
            self._images = list(filenames)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def maybe_start(opt, img_dir: str) -> Optional[LiveDashboard]:
    """The dashboard when ``--display_id`` > 0, else None; a port that cannot
    be bound prints a note and gives None, so training goes on without it."""
    if opt.display_id <= 0:
        return None
    port = opt.display_port
    try:
        dash = LiveDashboard(opt.name, img_dir, port=port)
    except OSError as e:
        print(f"[visualizer] live dashboard unavailable on :{port} ({e})")
        return None
    print(f"[visualizer] live dashboard at {dash.url}")
    return dash
