"""Web visualizer of a checkpoint of the port (headless: an HTTP server
and a browser page).

    python -m gantrack_tpu_torch.tools.visualizer --network=<run dir> --port=8091 \
        --cbase=16384 --cmax=512 --map-depth=2

Port of ``gantrack_tpu/tools/visualizer.py``, the same page and routes:
``/`` (the page), ``/api/info``, ``/api/layers`` (the layer table),
``/api/render?seed=&psi=&seed2=&blend=&mix_seed=&mix_cutoff=&rotate=&tx=&ty=``
and ``/api/layer?name=&seed=&psi=...`` (a channel grid of one layer's
activations), PNGs through the port's writer, the render time in the
``X-Render-Ms`` header.  The render engine maps with ψ = 1 and applies
truncation, w-space blending and style mixing between mapping and
synthesis; StyleGAN3's input transform follows the rotate/translate
sliders.  One lock serialises the renders on the device.  Seeds'
latents are the port's (``gen_images.seed_latent``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from .capture_layers import capture, channel_grid
from .gen_images import make_transform, seed_latent


class RenderEngine:
    """Mapping and synthesis of G_ema, with truncation, blending and
    mixing applied between them, and the layer view."""

    def __init__(self, G, channels: int):
        self.G = G
        self.channels = channels
        self.device = next(G.parameters()).device
        self.lock = threading.Lock()
        self.w_avg = G.mapping.w_avg.detach().cpu().numpy()
        self.input = getattr(G.synthesis, "input", None)
        self.has_transform = self.input is not None
        self._shapes: Optional[Dict[str, tuple]] = None

    def latent(self, seed: int) -> torch.Tensor:
        return seed_latent(seed, self.G.z_dim)

    def _map(self, seed: int) -> np.ndarray:
        with torch.no_grad():
            return self.G.mapping(self.latent(seed).to(self.device), None).cpu().numpy()

    def _ws(self, seed: int, psi: float, seed2: Optional[int], blend: float,
            mix_seed: Optional[int] = None, mix_cutoff: int = 0) -> np.ndarray:
        ws = self._map(seed)
        if seed2 is not None and blend > 0:
            ws = ws + (self._map(seed2) - ws) * float(blend)  # w-space lerp
        if mix_seed is not None and 0 < mix_cutoff < ws.shape[1]:
            # Style mixing: the fine layers [cutoff:] take the mixing seed's w.
            ws[:, int(mix_cutoff):] = self._map(mix_seed)[:, int(mix_cutoff):]
        return self.w_avg + (ws - self.w_avg) * float(psi)

    def _synthesis(self, ws: np.ndarray, rotate: float, tx: float, ty: float):
        """G's synthesis of ``ws`` with the input transform of the sliders
        (StyleGAN3), put back afterwards."""
        saved = None
        if self.has_transform:
            saved = self.input.transform.clone()
            m = np.linalg.inv(make_transform((tx, ty), rotate)).astype(np.float32)
            self.input.transform.copy_(torch.from_numpy(m))
        try:
            with torch.no_grad():
                return self.G.synthesis(torch.from_numpy(ws.astype(np.float32)).to(self.device),
                                        noise_mode="const")
        finally:
            if saved is not None:
                self.input.transform.copy_(saved)

    def render(self, seed: int, psi: float = 1.0, seed2: Optional[int] = None,
               blend: float = 0.0, rotate: float = 0.0, tx: float = 0.0,
               ty: float = 0.0, mix_seed: Optional[int] = None,
               mix_cutoff: int = 0) -> np.ndarray:
        """→ uint8 ``[H, W]`` (one channel; two modalities side by side) or
        ``[H, W, 3]``."""
        with self.lock:
            img = self._synthesis(self._ws(seed, psi, seed2, blend, mix_seed, mix_cutoff),
                                  rotate, tx, ty)
        img = img[0].float().permute(1, 2, 0).cpu().numpy()
        img = np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)
        if self.channels == 2:
            return np.concatenate([img[:, :, 0], img[:, :, 1]], axis=1)
        return img[:, :, 0] if self.channels == 1 else img[:, :, :3]

    def layer_activations(self, seed: int, psi: float = 1.0, rotate: float = 0.0,
                          tx: float = 0.0, ty: float = 0.0) -> Dict[str, torch.Tensor]:
        """Every 4-D activation of synthesis, NHWC, by its JAX name."""
        with self.lock:
            ws = self._ws(seed, psi, None, 0.0)
            return capture(self.G, lambda: self._synthesis(ws, rotate, tx, ty))

    def layer_shapes(self) -> Dict[str, tuple]:
        """The layer table (NHWC shapes), from one render of seed 0, kept."""
        if self._shapes is None:
            self._shapes = {k: tuple(v.shape) for k, v in self.layer_activations(0).items()}
        return self._shapes


_PAGE = """<!DOCTYPE html><html><head><title>gantrack visualizer</title><style>
body{font-family:system-ui;margin:1.2em;background:#16181d;color:#d5d9e0}
.row{display:flex;gap:2em}.panel{min-width:21em}
label{display:block;margin:.7em 0 .15em;font-size:.85em;color:#9aa3b2}
input[type=range]{width:100%}input[type=number],select{width:7em;background:#22252d;
color:#d5d9e0;border:1px solid #3a3f4b;border-radius:4px;padding:2px 6px}
img{image-rendering:pixelated;border:1px solid #3a3f4b;border-radius:6px}
#perf{margin-top:.8em;font-size:.8em;color:#9aa3b2}h1{font-size:1.1em}
</style></head><body><h1>gantrack_tpu_torch visualizer</h1><div class=row>
<div class=panel>
<label>seed <input id=seed type=number value=0></label>
<label>blend seed <input id=seed2 type=number value=1></label>
<label>blend <span id=blendv>0.00</span>
 <input id=blend type=range min=0 max=1 step=0.01 value=0></label>
<label>truncation psi <span id=psiv>1.00</span>
 <input id=psi type=range min=-1 max=2 step=0.01 value=1></label>
<label>style-mix seed <input id=mix_seed type=number value='' placeholder=off></label>
<label>mix cutoff layer <span id=mix_cutoffv>0</span>
 <input id=mix_cutoff type=range min=0 max=16 step=1 value=0></label>
<div id=xform style=display:none>
<label>rotate° <span id=rotatev>0</span>
 <input id=rotate type=range min=-180 max=180 step=1 value=0></label>
<label>translate x <span id=txv>0.00</span>
 <input id=tx type=range min=-1 max=1 step=0.01 value=0></label>
<label>translate y <span id=tyv>0.00</span>
 <input id=ty type=range min=-1 max=1 step=0.01 value=0></label></div>
<label>layer view <select id=layer><option value=''>(output)</option></select></label>
<div id=perf></div></div>
<div><img id=out width=512 height=512></div></div><script>
const ids=['seed','seed2','blend','psi','rotate','tx','ty','mix_seed','mix_cutoff'];
let timer=null;
function q(){const p=new URLSearchParams();
 ids.forEach(i=>p.set(i,document.getElementById(i).value));
 const l=document.getElementById('layer').value;
 return (l?'/api/layer?name='+encodeURIComponent(l)+'&':'/api/render?')+p;}
let lastUrl=null;
async function refresh(){const t0=performance.now();const r=await fetch(q());
 const perf=document.getElementById('perf');
 if(!r.ok){perf.textContent='error: '+await r.text();return;} // keep last frame
 const ms=r.headers.get('X-Render-Ms');const b=await r.blob();
 if(lastUrl)URL.revokeObjectURL(lastUrl);
 lastUrl=URL.createObjectURL(b);
 document.getElementById('out').src=lastUrl;
 perf.textContent=
  'render '+ms+' ms (round-trip '+(performance.now()-t0).toFixed(0)+' ms)';}
function arm(){clearTimeout(timer);timer=setTimeout(refresh,120);
 ['blend','psi','rotate','tx','ty'].forEach(i=>{const e=document.getElementById(i);
  document.getElementById(i+'v').textContent=(+e.value).toFixed(2);});
 document.getElementById('mix_cutoffv').textContent=
  document.getElementById('mix_cutoff').value;}
ids.forEach(i=>document.getElementById(i).addEventListener('input',arm));
document.getElementById('layer').addEventListener('change',arm);
fetch('/api/info').then(r=>r.json()).then(info=>{
 if(info.has_transform)document.getElementById('xform').style.display='';
 document.getElementById('mix_cutoff').max=info.num_ws;
 fetch('/api/layers').then(r=>r.json()).then(ls=>{const s=document.getElementById('layer');
  ls.layers.forEach(l=>{const o=document.createElement('option');
   o.value=l.name;o.textContent=l.name+'  '+l.shape.join('x');s.appendChild(o);});});});
refresh();</script></body></html>"""


def make_handler(engine: RenderEngine):
    from ..utils.checkpoint import encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes, ms=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if ms is not None:
                self.send_header("X-Render-Ms", f"{ms:.1f}")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            qs = {k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/api/info":
                    self._send(200, "application/json", json.dumps(dict(
                        resolution=engine.G.img_resolution, channels=engine.channels,
                        z_dim=engine.G.z_dim, num_ws=int(engine.G.num_ws),
                        has_transform=engine.has_transform)).encode())
                elif url.path == "/api/layers":
                    shapes = engine.layer_shapes()
                    self._send(200, "application/json", json.dumps(dict(
                        layers=[dict(name=k, shape=list(s[1:]))
                                for k, s in shapes.items()])).encode())
                elif url.path in ("/api/render", "/api/layer"):
                    args = dict(
                        seed=int(qs.get("seed", 0)), psi=float(qs.get("psi", 1.0)),
                        rotate=float(qs.get("rotate", 0.0)),
                        tx=float(qs.get("tx", 0.0)), ty=float(qs.get("ty", 0.0)))
                    t0 = time.perf_counter()
                    if url.path == "/api/render":
                        img = engine.render(
                            seed2=int(qs.get("seed2", 0)) if qs.get("blend") else None,
                            blend=float(qs.get("blend", 0.0)),
                            mix_seed=int(qs["mix_seed"]) if qs.get("mix_seed") else None,
                            mix_cutoff=int(qs.get("mix_cutoff", 0)), **args)
                    else:
                        acts = engine.layer_activations(**args)
                        name = qs.get("name", "")
                        if name not in acts:
                            raise KeyError(f"unknown layer {name!r}")
                        img = channel_grid(acts[name][0].float().cpu().numpy())
                    self._send(200, "image/png", encode_png(np.ascontiguousarray(img)),
                               ms=(time.perf_counter() - t0) * 1000)
                else:
                    self._send(404, "text/plain", b"not found")
            except Exception as e:  # surface errors to the page
                self._send(500, "text/plain", f"{type(e).__name__}: {e}".encode())

    return Handler


def serve(engine: RenderEngine, host: str, port: int) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(engine))


def build_parser() -> argparse.ArgumentParser:
    from .gen_images import add_network_args

    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.visualizer",
                                description="Serve the visualizer for a checkpoint.")
    add_network_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8091)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from .gen_images import load_generator, pick_device

    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    engine = RenderEngine(load_generator(opts, device), opts.channels)
    httpd = serve(engine, opts.host, opts.port)
    print(f"visualizer at http://{opts.host}:{opts.port}/  (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main(sys.argv[1:])
