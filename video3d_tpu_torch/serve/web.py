"""Browser chat UI for the serving stack of the PyTorch port (its own copy
of ``video3d_tpu/serve/web.py``, stdlib only).

The reference ships gradio web servers (llava/serve/gradio_web_server.py)
that have no 3D/video_dict support; this is the equivalent surface as a
dependency-free single-file web app on stdlib ``http.server``: one static
HTML/JS page plus JSON endpoints that speak the existing controller/worker
protocol (serve/controller.py, serve/model_worker.py) — and it DOES drive
the 3D scene-as-video path (scene id + question, streamed answer).

Run against a controller (multi-worker) or one worker directly:

    python -m video3d_tpu_torch.serve.web --controller http://localhost:21001
    python -m video3d_tpu_torch.serve.web --worker http://localhost:21002

then open http://localhost:7860/.
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>video3d chat</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;
      padding:0 1rem;background:#fafafa;color:#222}
 h1{font-size:1.2rem} .row{margin:.5rem 0}
 input,select,textarea{width:100%;box-sizing:border-box;padding:.45rem;
      border:1px solid #bbb;border-radius:6px;font:inherit}
 textarea{height:4.5rem}
 button{padding:.5rem 1.2rem;border:0;border-radius:6px;background:#2b6cb0;
      color:#fff;font:inherit;cursor:pointer} button:disabled{opacity:.5}
 #log{white-space:pre-wrap;background:#fff;border:1px solid #ddd;
      border-radius:6px;padding:.8rem;min-height:6rem;margin-top:1rem}
 .q{color:#2b6cb0;font-weight:600} .err{color:#b02b2b}
 label{font-size:.85rem;color:#555}
</style></head><body>
<h1>video3d &mdash; 3D scene chat</h1>
<div class="row"><label>model</label><select id="model"></select></div>
<div class="row"><label>scene (video id, e.g. scannet/scene0000_00) &mdash;
 leave empty for 2D image chat</label>
 <input id="video" placeholder="scannet/scene0000_00"></div>
<div class="row"><label>images (2D multi-image chat; ignored when a scene
 is set)</label>
 <input type="file" id="imgfiles" multiple accept="image/*">
 <div id="previews"></div></div>
<div class="row"><label>question</label>
 <textarea id="prompt" placeholder="Where is the brown chair?"></textarea></div>
<div class="row"><button id="ask">Ask</button>
 <button id="reset">New chat</button></div>
<div id="log"></div>
<script>
const log = document.getElementById('log');
// multi-turn: the full history rides each request as `conversations`
// (the worker re-prompts the engine with it); scene change resets it.
// Resets are ignored while a request streams — the completion handler
// would otherwise push the old answer into the freshly reset history.
let history = [], busy = false, images = [];
function resetChat(){ if (busy) return; history = []; log.innerHTML = ''; }
document.getElementById('reset').onclick = resetChat;
document.getElementById('video').onchange = resetChat;
// image selection: read files as data URLs (previews + the base64
// payload the worker's {"images": [b64...]} wire field expects);
// changing the selection starts a fresh chat
document.getElementById('imgfiles').onchange = async (ev) => {
  if (busy) { ev.target.value = ''; return; }  // mid-stream: ignore
  resetChat();
  images = [];
  const pv = document.getElementById('previews');
  pv.innerHTML = '';
  for (const f of ev.target.files){
    const url = await new Promise((res, rej) => {
      const r = new FileReader();
      r.onload = () => res(r.result); r.onerror = rej;
      r.readAsDataURL(f);
    });
    images.push(url);
    const im = document.createElement('img');
    im.src = url; im.style.maxHeight = '72px'; im.style.margin = '2px';
    pv.appendChild(im);
  }
};
async function loadModels(){
  const r = await fetch('models'); const d = await r.json();
  const sel = document.getElementById('model');
  sel.innerHTML = '';
  for (const m of d.models){
    const o = document.createElement('option'); o.value = o.textContent = m;
    sel.appendChild(o);
  }
}
loadModels();
document.getElementById('ask').onclick = async () => {
  const btn = document.getElementById('ask'); btn.disabled = true;
  busy = true;
  const q = document.getElementById('prompt').value;
  const qdiv = document.createElement('div');
  qdiv.className = 'q'; qdiv.textContent = 'Q: ' + q;
  log.appendChild(qdiv);
  const adiv = document.createElement('div'); log.appendChild(adiv);
  history.push({from: 'human', value: q});
  let answer = '', failed = false;
  try {
    const scene = document.getElementById('video').value;
    const body = {
      model: document.getElementById('model').value,
      conversations: history.concat([{from: 'gpt', value: null}])};
    if (scene) body.video = scene;
    else if (images.length)
      // strip the data-URL header: the wire field carries raw base64
      body.images = images.map(u => u.split(',', 2)[1]);
    const resp = await fetch('chat', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    const reader = resp.body.getReader();
    const dec = new TextDecoder(); let buf = '';
    while (true){
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n')) >= 0){
        const line = buf.slice(0, i); buf = buf.slice(i + 1);
        if (!line.trim()) continue;
        const d = JSON.parse(line);
        if (d.error_code) { adiv.className = 'err'; failed = true;
          adiv.textContent = 'error: ' + (d.error || 'unknown'); }
        else { answer = d.text; adiv.textContent = 'A: ' + answer; }
      }
    }
  } catch (e){ adiv.className = 'err'; failed = true;
    adiv.textContent = 'error: ' + e; }
  if (failed) history.pop(); else history.push({from: 'gpt', value: answer});
  busy = false;
  btn.disabled = false;
};
</script></body></html>
"""


def _post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class WebUI:
    """Controller-or-worker backend resolution for the web handlers."""

    def __init__(self, controller_addr: Optional[str] = None,
                 worker_addr: Optional[str] = None,
                 model_name: str = "video3d"):
        assert controller_addr or worker_addr, \
            "need --controller or --worker"
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name

    def models(self) -> list:
        if self.controller_addr:
            try:
                return _post_json(self.controller_addr + "/list_models",
                                  {})["models"]
            except Exception:  # noqa: BLE001 — controller down
                return []
        return [self.model_name]

    def resolve_worker(self, model: str) -> str:
        if self.controller_addr:
            return _post_json(self.controller_addr + "/get_worker_address",
                              {"model": model})["address"]
        return self.worker_addr

    def stream_chat(self, request: dict):
        """Yield cumulative-answer dicts from the worker's \\0-separated
        stream (model_worker.py /worker_generate_stream wire format)."""
        addr = self.resolve_worker(request.get("model", self.model_name))
        if not addr:
            yield {"text": "", "error": "no worker for model",
                   "error_code": 1}
            return
        payload = {
            "video": request.get("video", ""),
            "stream_chunk": int(request.get("stream_chunk", 8)),
        }
        if request.get("conversations"):      # multi-turn history
            payload["conversations"] = request["conversations"]
        else:
            payload["prompt"] = request.get("prompt", "")
        if request.get("images") and not request.get("video"):
            # 2D multi-image chat: the worker's images path does not
            # stream — one /worker_generate round trip, one NDJSON line
            payload.pop("stream_chunk", None)
            payload.pop("video", None)
            payload["images"] = request["images"]
            try:
                yield _post_json(addr + "/worker_generate", payload,
                                 timeout=600)
            except Exception as e:  # noqa: BLE001 — worker down/4xx
                yield {"text": "", "error": str(e), "error_code": 1}
            return
        req = urllib.request.Request(
            addr + "/worker_generate_stream",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            buf = b""
            while True:
                # read1: return bytes as they arrive (read(n) would block
                # for the full n and defeat streaming)
                chunk = r.read1(4096)
                if not chunk:
                    break
                buf += chunk
                while b"\0" in buf:
                    piece, buf = buf.split(b"\0", 1)
                    if piece:
                        yield json.loads(piece)
            if buf:
                yield json.loads(buf)


class _WebHandler(BaseHTTPRequestHandler):
    ui: WebUI = None

    def log_message(self, *args):  # quiet
        pass

    def _send(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(_PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/models":
            self._send(json.dumps({"models": self.ui.models()}).encode(),
                       "application/json")
        else:
            self._send(b"not found", "text/plain", 404)

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, OSError):
            self._send(b'{"error": "malformed request body"}',
                       "application/json", 400)
            return
        if self.path == "/chat":
            # NDJSON stream: one cumulative-answer object per line
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            try:
                for payload in self.ui.stream_chat(data):
                    self.wfile.write(json.dumps(payload).encode() + b"\n")
                    self.wfile.flush()
            except (ConnectionError, BrokenPipeError):
                pass                 # browser cancelled the fetch mid-stream
            except Exception as e:  # noqa: BLE001 — surface to the browser
                try:
                    self.wfile.write(json.dumps(
                        {"text": "", "error": str(e),
                         "error_code": 1}).encode() + b"\n")
                except OSError:
                    pass             # socket already gone
        else:
            self._send(b"not found", "text/plain", 404)


def serve_web(controller_addr: Optional[str] = None,
              worker_addr: Optional[str] = None,
              model_name: str = "video3d",
              host: str = "127.0.0.1", port: int = 7860,
              background: bool = False):
    ui = WebUI(controller_addr, worker_addr, model_name)
    handler = type("Handler", (_WebHandler,), {"ui": ui})
    server = ThreadingHTTPServer((host, port), handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return ui, server
    print(f"web ui on http://{host}:{port}/")
    server.serve_forever()


def main():
    parser = argparse.ArgumentParser("video3d_tpu_torch web ui")
    parser.add_argument("--controller", default=None,
                        help="controller address (multi-worker)")
    parser.add_argument("--worker", default=None,
                        help="single worker address (bypass controller)")
    parser.add_argument("--model-name", default="video3d")
    # localhost by default: the UI is unauthenticated — pass --host 0.0.0.0
    # deliberately to expose it beyond this machine
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    args = parser.parse_args()
    serve_web(args.controller, args.worker, args.model_name,
              host=args.host, port=args.port)


if __name__ == "__main__":
    main()
