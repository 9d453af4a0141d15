"""Live training-stats dashboard for a run directory.

    python -m gantrack_tpu_torch.tools.stats_dashboard --run=<run dir> [--host=127.0.0.1] [--port=8092]

Port of ``gantrack_tpu/tools/stats_dashboard.py`` (stdlib only; ``argparse``
here, the same flags; ``tests/test_torch_tools.py`` holds the two equal).
It reads the tick keys that the port's loop and loss write as the JAX
package's do (``Progress/kimg``, ``Loss/G/loss``, ``Loss/D/loss``,
``Loss/pl_penalty``, ``Loss/r1_penalty``, ``Progress/augment``,
``Timing/sec_per_kimg``), the ``metric-*.jsonl`` rows, and the
image-to-image ``loss_log.txt`` that ``tools/train_i2i.py`` writes in the
JAX format.

The reference monitors training with visdom live plots (CycleGAN
``util/visualizer.py:plot_current_losses``) and by eyeballing
``stats.jsonl`` (StyleGAN ``training_stats``).  This serves the same
capability headlessly: a stdlib HTTP server that tails the run dir's
``stats.jsonl`` + ``metric-*.jsonl`` and renders live SVG line charts
(losses, ADA p, speed, metric trend) with stat tiles, crosshair
tooltips, a table view, and auto-refresh that holds the previous frame
while refetching.  No external JS/plotting dependency.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

_LOSS_LINE = re.compile(r"\(epoch (\d+), iters (\d+)\)(.*)")
_KV = re.compile(r"(\w+): (-?(?:[\d.]+(?:e-?\d+)?|nan|inf))")


def _finite(v):
    """Browsers reject NaN/Infinity in JSON; plot a gap (null) instead —
    a divergence must stay visible as a break in the line, not vanish."""
    import math

    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def parse_loss_log(path: str) -> dict:
    """i2i ``loss_log.txt`` ("(epoch E, iters I) k: v ...", the reference
    ``util/visualizer.py:print_current_losses`` format) → per-loss series."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            m = _LOSS_LINE.match(line.strip())
            if not m:
                continue
            iters = int(m.group(2))
            for k, v in _KV.findall(m.group(3)):
                s = out.setdefault(k, {"x": [], "y": []})
                s["x"].append(iters)
                s["y"].append(_finite(float(v)))
    return out


def read_series(run_dir: str) -> dict:
    """Parse stats.jsonl + metric-*.jsonl → plain chartable series."""
    ticks = []
    path = os.path.join(run_dir, "stats.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        ticks.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass  # torn tail line of a live writer
    kimg = [t.get("Progress/kimg", 0.0) for t in ticks]

    def col(name):
        return [_finite(t.get(name)) for t in ticks]

    # One series per RESULT KEY: multi-result metrics (pr50k3_full →
    # precision+recall, is50k → mean+std) must not interleave into one
    # zig-zag series.
    metrics = {}
    for mp in sorted(glob.glob(os.path.join(run_dir, "metric-*.jsonl"))):
        with open(mp) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for k, v in rec.get("results", {}).items():
                    snap = rec.get("snapshot_path") or ""
                    metrics.setdefault(k, []).append(
                        dict(value=_finite(v), snapshot=os.path.basename(snap)))
    return dict(
        kimg=kimg,
        loss_g=col("Loss/G/loss"), loss_d=col("Loss/D/loss"),
        pl=col("Loss/pl_penalty"), r1=col("Loss/r1_penalty"),
        augment=col("Progress/augment"),
        sec_per_kimg=col("Timing/sec_per_kimg"),
        metrics=metrics,
        extra=parse_loss_log(os.path.join(run_dir, "loss_log.txt")),
    )


_PAGE = """<!DOCTYPE html><html><head><title>gantrack stats</title><style>
.viz-root{color-scheme:light;
 --surface-1:#fcfcfb;--surface-2:#f1f0ee;--grid:#e4e3e0;
 --text-primary:#0b0b0b;--text-secondary:#52514e;
 --series-1:#2a78d6;--series-2:#eb6834;--series-3:#1baf7a}
@media (prefers-color-scheme:dark){
 :root:where(:not([data-theme="light"])) .viz-root{color-scheme:dark;
  --surface-1:#1a1a19;--surface-2:#242423;--grid:#32322f;
  --text-primary:#ffffff;--text-secondary:#c3c2b7;
  --series-1:#3987e5;--series-2:#d95926;--series-3:#199e70}}
body{margin:0}.viz-root{font-family:system-ui;background:var(--surface-1);
 color:var(--text-primary);min-height:100vh;padding:1.2em}
h1{font-size:1.05em;font-weight:600;margin:0 0 .8em}
.tiles{display:flex;gap:1em;flex-wrap:wrap;margin-bottom:1.2em}
.tile{background:var(--surface-2);border-radius:8px;padding:.7em 1.1em;min-width:8em}
.tile .l{font-size:.75em;color:var(--text-secondary)}
.tile .v{font-size:1.5em;font-weight:600;margin-top:.1em}
.grid{display:grid;grid-template-columns:repeat(auto-fit,minmax(24em,1fr));gap:1.2em}
.card{background:var(--surface-2);border-radius:8px;padding:.8em}
.card h2{font-size:.85em;font-weight:600;margin:0 0 .2em}
.legend{display:flex;gap:1em;font-size:.75em;color:var(--text-secondary);margin:.2em 0}
.legend .k{display:inline-block;width:14px;height:2px;vertical-align:middle;
 margin-right:.4em;border-radius:1px}
svg text{font:10px system-ui;fill:var(--text-secondary)}
.tip{position:fixed;pointer-events:none;background:var(--surface-1);
 border:1px solid var(--grid);border-radius:6px;padding:.45em .7em;font-size:.78em;
 display:none;z-index:9}
.tip b{font-variant-numeric:tabular-nums}
details{margin-top:1.2em;font-size:.8em}summary{color:var(--text-secondary);cursor:pointer}
table{border-collapse:collapse;margin-top:.5em}
td,th{padding:.2em .7em;border-bottom:1px solid var(--grid);
 font-variant-numeric:tabular-nums;text-align:right}
th{color:var(--text-secondary);font-weight:500}
#stale{opacity:.55}</style></head><body><div class=viz-root>
<h1>gantrack_tpu · <span id=run></span></h1>
<div class=tiles id=tiles></div><div class=grid id=charts></div>
<details><summary>table view</summary><div id=table></div></details>
<div class=tip id=tip></div><script>
const css=n=>getComputedStyle(document.querySelector('.viz-root')).getPropertyValue(n);
function fmt(v){return v==null?'–':(Math.abs(v)>=100?v.toFixed(0):
 Math.abs(v)>=1?v.toFixed(2):v.toPrecision(3));}
function ticks(lo,hi,n){const s=(hi-lo)/Math.max(n,1),m=Math.pow(10,Math.floor(Math.log10(s||1))),
 st=[1,2,5,10].map(x=>x*m).find(x=>x>=s)||m,out=[];
 for(let v=Math.ceil(lo/st)*st;v<=hi+1e-9;v+=st)out.push(v);return out;}
function chart(el,title,xs,series,xlabel){ // series: [{name,ys,color}]
 xlabel=xlabel||'kimg';
 const W=440,H=190,L=46,R=12,T=10,B=22;
 const pts=series.flatMap(s=>s.ys.filter(v=>v!=null));
 if(!xs.length||!pts.length){el.innerHTML='<h2>'+title+'</h2><div style="color:var(--text-secondary);font-size:.8em">no data yet</div>';return;}
 let lo=Math.min(...pts),hi=Math.max(...pts);if(lo===hi){lo-=1;hi+=1}
 const x0=Math.min(...xs),x1=Math.max(...xs)||1;
 const X=v=>L+(v-x0)/(x1-x0||1)*(W-L-R),Y=v=>T+(hi-v)/(hi-lo)*(H-T-B);
 let g='';ticks(lo,hi,4).forEach(v=>{g+=`<line x1=${L} x2=${W-R} y1=${Y(v)} y2=${Y(v)} stroke=${css('--grid')} stroke-width=1 />`
  +`<text x=${L-6} y=${Y(v)+3} text-anchor=end>${fmt(v)}</text>`;});
 ticks(x0,x1,5).forEach(v=>{g+=`<text x=${X(v)} y=${H-6} text-anchor=middle>${fmt(v)}</text>`;});
 series.forEach(s=>{ // null (NaN/divergence) breaks the line into segments
  let seg=[];const segs=[];
  xs.forEach((x,i)=>{if(s.ys[i]==null){if(seg.length)segs.push(seg);seg=[];}
   else seg.push(`${X(x)},${Y(s.ys[i])}`);});
  if(seg.length)segs.push(seg);
  segs.forEach(d=>{g+=`<polyline points="${d.join(' ')}" fill=none stroke=${s.color}
   stroke-width=2 stroke-linejoin=round stroke-linecap=round />`;});
  const li=s.ys.map((v,i)=>v==null?-1:i).filter(i=>i>=0).pop();
  if(li!=null&&li>=0)g+=`<circle cx=${X(xs[li])} cy=${Y(s.ys[li])} r=4 fill=${s.color}
   stroke=${css('--surface-2')} stroke-width=2 />`;});
 g+=`<line id=ch x1=0 x2=0 y1=${T} y2=${H-B} stroke=${css('--grid')} stroke-width=1 visibility=hidden />`;
 el.innerHTML='<h2>'+title+'</h2>'+(series.length>1?'<div class=legend>'+series.map(s=>
  `<span><span class=k style="background:${s.color}"></span>${s.name}</span>`).join('')+'</div>':'')
  +`<svg viewBox="0 0 ${W} ${H}" style="width:100%">${g}</svg>`;
 const svg=el.querySelector('svg'),ch=el.querySelector('#ch'),tip=document.getElementById('tip');
 svg.addEventListener('pointermove',e=>{const r=svg.getBoundingClientRect();
  const mx=(e.clientX-r.left)*W/r.width;
  let bi=0,bd=1e18;xs.forEach((x,i)=>{const d=Math.abs(X(x)-mx);if(d<bd){bd=d;bi=i}});
  ch.setAttribute('x1',X(xs[bi]));ch.setAttribute('x2',X(xs[bi]));
  ch.setAttribute('visibility','visible');
  tip.replaceChildren();const hd=document.createElement('div');
  hd.style.color=css('--text-secondary');hd.textContent=xlabel+' '+fmt(xs[bi]);
  tip.appendChild(hd);
  series.forEach(s=>{const row=document.createElement('div');
   const k=document.createElement('span');k.className='k';k.style.background=s.color;
   k.style.display='inline-block';k.style.width='14px';k.style.height='2px';
   k.style.marginRight='.4em';k.style.verticalAlign='middle';
   const b=document.createElement('b');b.textContent=fmt(s.ys[bi]);
   row.appendChild(k);row.appendChild(b);
   row.appendChild(document.createTextNode(' '+s.name));tip.appendChild(row);});
  tip.style.display='block';tip.style.left=(e.clientX+14)+'px';tip.style.top=(e.clientY+10)+'px';});
 svg.addEventListener('pointerleave',()=>{tip.style.display='none';
  ch.setAttribute('visibility','hidden');});}
function tile(l,v){return `<div class=tile><div class=l>${l}</div><div class=v>${v}</div></div>`;}
async function refresh(){
 let d;try{d=await (await fetch('/api/series')).json();}catch(e){
  document.body.id='stale';return;}
 document.body.id='';
 document.getElementById('run').textContent=d.run;
 const last=a=>a&&a.length?a[a.length-1]:null;
 let tl=tile('kimg',fmt(last(d.kimg)))+tile('sec / kimg',fmt(last(d.sec_per_kimg)))
  +tile('augment p',fmt(last(d.augment)));
 for(const[m,pts]of Object.entries(d.metrics))tl+=tile(m,fmt(last(pts).value));
 document.getElementById('tiles').innerHTML=tl;
 const C=document.getElementById('charts');C.innerHTML='';
 const card=()=>{const e=document.createElement('div');e.className='card';C.appendChild(e);return e;};
 const c1=css('--series-1'),c2=css('--series-2'),c3=css('--series-3');
 chart(card(),'loss',d.kimg,[{name:'G',ys:d.loss_g,color:c1},{name:'D',ys:d.loss_d,color:c2}]);
 chart(card(),'regularizers',d.kimg,[{name:'PL',ys:d.pl,color:c1},{name:'R1',ys:d.r1,color:c2}]);
 chart(card(),'augment p (ADA)',d.kimg,[{name:'p',ys:d.augment,color:c3}]);
 chart(card(),'sec / kimg',d.kimg,[{name:'sec/kimg',ys:d.sec_per_kimg,color:c1}]);
 for(const[m,pts]of Object.entries(d.metrics))
  chart(card(),m,pts.map((_,i)=>i),[{name:m,ys:pts.map(p=>p.value),color:c3}],'snapshot');
 for(const[k,s]of Object.entries(d.extra||{}))   // i2i loss_log.txt series
  chart(card(),k+' (iters)',s.x,[{name:k,ys:s.y,color:c1}],'iters');
 const rows=d.kimg.map((k,i)=>`<tr><td>${fmt(k)}</td><td>${fmt(d.loss_g[i])}</td>
  <td>${fmt(d.loss_d[i])}</td><td>${fmt(d.augment[i])}</td><td>${fmt(d.sec_per_kimg[i])}</td></tr>`);
 document.getElementById('table').innerHTML=
  '<table><tr><th>kimg</th><th>G loss</th><th>D loss</th><th>aug p</th><th>sec/kimg</th></tr>'
  +rows.join('')+'</table>';}
refresh();setInterval(refresh,5000);</script></div></body></html>"""


def make_handler(run_dir: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/api/series":
                data = read_series(run_dir)
                data["run"] = os.path.basename(os.path.abspath(run_dir))
                self._send(200, "application/json", json.dumps(data).encode())
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(run_dir: str, host: str, port: int) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(run_dir))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.stats_dashboard",
                                description="Serve live charts for a run's stats.jsonl / "
                                            "metric jsonls.")
    p.add_argument("--run", dest="run_dir", required=True, help="Training run directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8092)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    """Serve live charts for a run's stats.jsonl / metric jsonls."""
    opts = build_parser().parse_args(argv)
    if not os.path.isdir(opts.run_dir):
        raise SystemExit(f"not a run dir: {opts.run_dir}")
    httpd = serve(opts.run_dir, opts.host, opts.port)
    print(f"stats dashboard at http://{opts.host}:{opts.port}/  (ctrl-c to stop)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
