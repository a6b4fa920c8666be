"""Interactive UI: the counterpart of the repository's ``cli/app.py``
(reference app.py:14-111).

    python -m hvi_cidnet_torch.cli.app [--cpu] [--no_gradio] [--host 127.0.0.1]
        [--port 7862]

A weights picker scanning ``weights/`` under the working directory (not
``weights/train/``), sliders for gamma, alpha_s and alpha_i, and optional
NIQE (+ BRISQUE) scores of the output. Two transports for one core,
``process_image``:

* **gradio**, when it is installed (it is imported only then);
* otherwise a **stdlib ``http.server``** page with the same controls
  (``make_fallback_server``): the browser POSTs the image's bytes to
  ``/enhance`` and shows the PNG of the JSON reply. A PNG body is decoded,
  and every reply encoded, by ``data/png.py``; another format goes through
  PIL, imported in the call, and without PIL the reply is the JSON error
  naming the format.

The model is base, served by ``eval.evaluator.Evaluator`` with both HVI
gates on, fp32, on the card unless ``--cpu`` is given (``DEVICE``); the
``<random init>`` entry draws the weights from a generator seeded 0, as
``cli/demo.py --random_init`` does. One evaluator is kept, under a lock
(requests run on the server's threads). The JAX app's
``enable_compilation_cache()`` has no counterpart: the port compiles no
program per shape (its kernels are built once, ``ops/_build.py``).
Imports neither jax, PIL nor cv2 at import.
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates

RANDOM_INIT = "<random init>"
DEVICE = "cuda"  # where the evaluators run; main() sets "cpu" for --cpu


def find_weights():
    files = [f for f in glob.glob("weights/**/*.*", recursive=True)
             if f.endswith((".pth", ".npz", ".safetensors")) and os.sep + "train" + os.sep not in f]
    return sorted(files) + [RANDOM_INIT]


_cache = {}
_cache_lock = threading.Lock()


def _evaluator(model_path, gamma, alpha_s, alpha_i) -> Evaluator:
    # serialized: requests run on ThreadingHTTPServer worker threads, and the
    # clear-then-insert policy (keep one Evaluator) would otherwise let one
    # thread clear another's entry between insert and read
    with _cache_lock:
        key = (model_path, gamma, alpha_s, alpha_i, DEVICE)
        if key not in _cache:
            _cache.clear()
            cfg = CIDNetConfig(variant="base")
            gates = HVIGates(gated=True, gated2=True, alpha=alpha_i, alpha_s=alpha_s)
            if model_path == RANDOM_INIT:
                weights = CIDNet(cfg, generator=torch.Generator().manual_seed(0))
            else:
                weights = model_path
            _cache[key] = Evaluator(weights, cfg, gates, gamma=gamma, device=DEVICE)
        return _cache[key]


def _rgb_u8(img) -> np.ndarray:
    """A PIL image (what gradio passes) or an array as RGB uint8 HWC: grey
    repeated, alpha dropped, as PIL's ``convert("RGB")``."""
    if hasattr(img, "convert"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] in (1, 2):
        arr = np.repeat(arr[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3], dtype=np.uint8)


def process_image(img, score, model_path, gamma, alpha_s,
                  alpha_i) -> Tuple[Optional[np.ndarray], str]:
    """The core of both transports: a uint8 HWC array (or a PIL image) in,
    (the enhanced uint8 HWC array, the info text) out."""
    if img is None:
        return None, "no image"
    ev = _evaluator(model_path, gamma, alpha_s, alpha_i)
    arr = _rgb_u8(img).astype(np.float32) / 255.0
    out = np.clip(ev.enhance(arr), 0, 1)
    out_u8 = (out * 255).astype(np.uint8)
    info = ""
    if score:
        from hvi_cidnet_torch.metrics.niqe import calculate_niqe

        info = f"NIQE: {calculate_niqe(out_u8):.4f}"
        try:
            from hvi_cidnet_torch.metrics.brisque import score as b_score

            info += f"  BRISQUE: {b_score(out_u8):.4f}"
        except FileNotFoundError:
            info += "  (BRISQUE: model file unavailable)"
    return out_u8, info


# magic bytes -> format, to name a body that only PIL could decode
_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"), (b"RIFF", "WEBP"),
            (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def decode_body(raw: bytes) -> np.ndarray:
    """An uploaded image's bytes as RGB uint8 HWC: PNG by ``data/png.py``,
    any other format by PIL (imported here)."""
    if raw[:len(png.SIGNATURE)] == png.SIGNATURE:
        return png.decode(raw, "the uploaded PNG")
    fmt = next((name for magic, name in _FORMATS if raw.startswith(magic)), "unrecognised")
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{fmt} image: only PNG is decoded without PIL, and PIL is not "
                         "installed") from None
    import io

    return _rgb_u8(Image.open(io.BytesIO(raw)))


# ---------------------------------------------------------------------------
# stdlib fallback transport
# ---------------------------------------------------------------------------

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>HVI-CIDNet (PyTorch)</title>
<style>
 body{font-family:sans-serif;max-width:900px;margin:2em auto;color:#222}
 .row{display:flex;gap:1em;align-items:center;margin:.4em 0}
 img{max-width:430px;border:1px solid #ccc}
 label{min-width:6em;display:inline-block}
 #status{color:#666}
</style></head><body>
<h2>HVI-CIDNet (PyTorch)</h2>
<div class="row"><label>image</label><input type="file" id="file" accept="image/*"></div>
<div class="row"><label>weights</label><select id="weights">__OPTIONS__</select></div>
<div class="row"><label>gamma</label><input type="range" id="gamma" min="0.1" max="5" step="0.05" value="1.0"
  oninput="gv.textContent=this.value"><span id="gv">1.0</span></div>
<div class="row"><label>alpha_s</label><input type="range" id="alpha_s" min="0" max="2" step="0.05" value="1.0"
  oninput="sv.textContent=this.value"><span id="sv">1.0</span></div>
<div class="row"><label>alpha_i</label><input type="range" id="alpha_i" min="0.1" max="2" step="0.05" value="1.0"
  oninput="iv.textContent=this.value"><span id="iv">1.0</span></div>
<div class="row"><label>score</label><input type="checkbox" id="score"> NIQE/BRISQUE of the output</div>
<div class="row"><button onclick="run()">enhance</button><span id="status"></span></div>
<div class="row"><img id="inimg"><img id="outimg"></div>
<div class="row"><span id="info"></span></div>
<script>
async function run(){
  const f = document.getElementById('file').files[0];
  if(!f){ status.textContent = 'pick an image first'; return; }
  inimg.src = URL.createObjectURL(f);
  status.textContent = 'enhancing…';
  const q = new URLSearchParams({
    gamma: gamma.value, alpha_s: alpha_s.value, alpha_i: alpha_i.value,
    weights: weights.value, score: score.checked ? '1' : '0'});
  try{
    const r = await fetch('/enhance?' + q, {method:'POST', body: f});
    const j = await r.json();
    if(j.error){ status.textContent = 'error: ' + j.error; return; }
    outimg.src = 'data:image/png;base64,' + j.image;
    info.textContent = j.info;
    status.textContent = 'done';
  }catch(e){ status.textContent = 'request failed: ' + e; }
}
</script></body></html>
"""


def make_fallback_server(host: str = "127.0.0.1", port: int = 7862):
    """ThreadingHTTPServer implementing GET / and POST /enhance.

    Returned unstarted so tests can bind port 0 and drive it from a thread.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stdout is the CLI's
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/":
                self._send(404, b"not found", "text/plain")
                return
            import html as _html

            opts = "".join(
                f'<option value="{_html.escape(w, quote=True)}">{_html.escape(w)}</option>'
                for w in find_weights()
            )
            self._send(200, _PAGE.replace("__OPTIONS__", opts).encode(), "text/html")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/enhance":
                self._send(404, b"not found", "text/plain")
                return
            try:
                q = parse_qs(url.query)
                # the weights param is client-controlled: only entries the
                # page itself offered are honored (no arbitrary-path loads)
                weights = q.get("weights", [RANDOM_INIT])[0]
                if weights not in find_weights():
                    self._send(
                        400,
                        json.dumps({"error": "unknown weights entry"}).encode(),
                        "application/json",
                    )
                    return
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                out, info = process_image(
                    decode_body(raw),
                    q.get("score", ["0"])[0] == "1",
                    weights,
                    float(q.get("gamma", ["1.0"])[0]),
                    float(q.get("alpha_s", ["1.0"])[0]),
                    float(q.get("alpha_i", ["1.0"])[0]),
                )
                body = json.dumps(
                    {"image": base64.b64encode(png.encode(out)).decode(), "info": info}
                ).encode()
                self._send(200, body, "application/json")
            except Exception as e:  # surface the failure to the page
                self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    global DEVICE
    ap = argparse.ArgumentParser(description="HVI-CIDNet interactive UI (PyTorch)")
    ap.add_argument("--port", type=int, default=7862)  # app.py:111
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--no_gradio", action="store_true",
                    help="force the stdlib fallback UI even if gradio is installed")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --cpu to serve on the CPU")
    DEVICE = "cpu" if args.cpu else "cuda"

    gr = None
    if not args.no_gradio:
        try:
            import gradio as gr
        except ImportError:
            print("gradio is not installed; serving the stdlib fallback UI instead.")
    if gr is not None:
        interface = gr.Interface(
            fn=process_image,
            inputs=[
                gr.Image(type="numpy", label="input"),
                gr.Checkbox(label="score output (NIQE/BRISQUE)"),
                gr.Dropdown(choices=find_weights(), value=find_weights()[0], label="weights"),
                gr.Slider(0.1, 5.0, value=1.0, label="gamma"),
                gr.Slider(0.0, 2.0, value=1.0, label="alpha_s"),
                gr.Slider(0.1, 2.0, value=1.0, label="alpha_i"),
            ],
            outputs=[gr.Image(type="numpy", label="enhanced"), gr.Textbox(label="score")],
            title="HVI-CIDNet (PyTorch)",
        )
        interface.launch(server_name=args.host, server_port=args.port)
        return
    server = make_fallback_server(args.host, args.port)
    print(f"serving http://{args.host}:{server.server_address[1]} on {DEVICE} (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
