"""Serving controller of the PyTorch port: worker registry with heartbeat
expiry + dispatch (the port's own copy of ``video3d_tpu/serve/controller.py``,
stdlib and numpy only).

Re-implements the reference controller's API surface
(llava/serve/controller.py:57-298 — register_worker,
receive_heart_beat, refresh_all_workers, list_models, get_worker_address
with lottery/shortest-queue dispatch, worker_api_generate proxy) on the
Python stdlib HTTP server, so serving needs no FastAPI/uvicorn. Unlike the
reference serve stack, workers here run the full 3D pipeline (video_dict
support) — see model_worker.py.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from video3d_tpu_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION


@dataclass
class WorkerInfo:
    model_names: list
    speed: float
    queue_length: int
    last_heart_beat: float = field(default_factory=time.time)


def _post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


class Controller:
    """``dispatch_method``:

    * ``lottery`` / ``shortest_queue`` — the reference's two policies
      (controller.py:156-228).
    * ``scene_affinity`` (beyond reference) — route same-scene requests to
      the worker that served the scene last. Workers LRU-cache per-scene
      state (tower features + prefix KV, eval/drivers.py InferenceEngine);
      a prefix hit admits at a fraction of a cold prefill's cost (PERF.md
      §5, the batcher's admissions), so affinity beats pure queue
      balancing unless the sticky worker's backlog exceeds the shortest
      queue by more than ``affinity_max_backlog`` speed-normalized
      requests (queue_length/speed, the same units the shortest-queue
      candidate is chosen by; = raw requests on a homogeneous fleet) —
      then the
      scene re-sticks to the worker actually chosen. Requests without a
      scene (or whose sticky worker died) fall back to shortest_queue.
    """

    def __init__(self, dispatch_method: str = "shortest_queue",
                 affinity_max_backlog: int = 8,
                 affinity_scenes: int = 4096):
        assert dispatch_method in ("lottery", "shortest_queue",
                                   "scene_affinity")
        self.dispatch_method = dispatch_method
        self.affinity_max_backlog = affinity_max_backlog
        self.affinity_scenes = affinity_scenes
        self._scene_worker: "OrderedDict[tuple, str]" = OrderedDict()
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    # ---- registry (controller.py:77-154) ----

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict] = None) -> bool:
        status = worker_status or {"model_names": [], "speed": 1, "queue_length": 0}
        with self.lock:
            self.workers[worker_name] = WorkerInfo(
                model_names=status["model_names"], speed=status["speed"],
                queue_length=status["queue_length"])
        return True

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self.lock:
            info = self.workers.get(worker_name)
            if info is None:
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def remove_stale_workers(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            stale = [n for n, info in self.workers.items()
                     if info.last_heart_beat < expire]
            for n in stale:
                del self.workers[n]

    def refresh_all_workers(self) -> None:
        with self.lock:
            names = list(self.workers.items())
        for name, info in names:
            try:
                status = _post_json(name + "/worker_get_status", {})
                self.register_worker(name, True, status)
            except Exception:
                with self.lock:
                    self.workers.pop(name, None)

    def list_models(self) -> list:
        with self.lock:
            names = set()
            for info in self.workers.values():
                names.update(info.model_names)
            return sorted(names)

    # ---- dispatch (controller.py:156-228) ----

    def get_worker_address(self, model_name: str,
                           scene: Optional[str] = None) -> str:
        self.remove_stale_workers()
        with self.lock:
            candidates = [(n, i) for n, i in self.workers.items()
                          if model_name in i.model_names]
            if not candidates:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([i.speed for _, i in candidates], np.float64)
                speeds = speeds / speeds.sum()
                idx = int(np.random.choice(len(candidates), p=speeds))
                return candidates[idx][0]
            # shortest_queue, speed-normalized
            qlens = [i.queue_length / max(i.speed, 1e-6) for _, i in candidates]
            idx = int(np.argmin(qlens))
            if self.dispatch_method == "scene_affinity" and scene:
                key = (model_name, scene)
                sticky = self._scene_worker.get(key)
                by_name = dict(candidates)
                # the premium is measured in the same speed-normalized units
                # the shortest-queue candidate was chosen by (queue/speed);
                # comparing raw queue_length would mismeasure it on
                # heterogeneous-speed fleets (a fast sticky worker's raw
                # backlog overstates its actual wait)
                if sticky in by_name and (
                        by_name[sticky].queue_length
                        / max(by_name[sticky].speed, 1e-6)
                        - qlens[idx]
                        <= self.affinity_max_backlog):
                    # the sticky worker holds this scene's feature/prefix
                    # caches: a warm admission costs a fraction of a cold
                    # prefill, worth a bounded queue premium
                    self._scene_worker.move_to_end(key)
                    by_name[sticky].queue_length += 1
                    return sticky
                # new scene / dead or overloaded sticky worker: rebalance
                # and stick the scene to the worker that will now warm it
                self._scene_worker[key] = candidates[idx][0]
                self._scene_worker.move_to_end(key)
                while len(self._scene_worker) > self.affinity_scenes:
                    self._scene_worker.popitem(last=False)
            candidates[idx][1].queue_length += 1
            return candidates[idx][0]


class _ControllerHandler(BaseHTTPRequestHandler):
    controller: Controller = None

    def log_message(self, *args):  # quiet
        pass

    def _reply(self, payload: dict, code: int = 200):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        c = self.controller
        if self.path == "/register_worker":
            ok = c.register_worker(data["worker_name"],
                                   data.get("check_heart_beat", True),
                                   data.get("worker_status"))
            self._reply({"exist": ok})
        elif self.path == "/receive_heart_beat":
            exist = c.receive_heart_beat(data["worker_name"], data["queue_length"])
            self._reply({"exist": exist})
        elif self.path == "/refresh_all_workers":
            c.refresh_all_workers()
            self._reply({})
        elif self.path == "/list_models":
            self._reply({"models": c.list_models()})
        elif self.path == "/get_worker_address":
            self._reply({"address": c.get_worker_address(
                data["model"], scene=data.get("video"))})
        elif self.path in ("/worker_generate", "/worker_ground"):
            addr = c.get_worker_address(data.get("model", ""),
                                        scene=data.get("video"))
            if not addr:
                self._reply({"error": "no worker", "error_code": 2}, 503)
                return
            self._reply(_post_json(addr + self.path, data, timeout=600))
        else:
            self._reply({"error": f"unknown path {self.path}"}, 404)


def serve_controller(host: str = "127.0.0.1", port: int = 21001,
                     dispatch_method: str = "shortest_queue",
                     background: bool = False,
                     affinity_max_backlog: int = 8):
    controller = Controller(dispatch_method,
                            affinity_max_backlog=affinity_max_backlog)
    handler = type("Handler", (_ControllerHandler,), {"controller": controller})
    server = ThreadingHTTPServer((host, port), handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return controller, server
    server.serve_forever()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--dispatch-method", default="shortest_queue",
                        choices=("lottery", "shortest_queue",
                                 "scene_affinity"))
    parser.add_argument("--affinity-max-backlog", type=int, default=8,
                        help="scene_affinity: max extra queued requests "
                             "the sticky (cache-warm) worker may carry "
                             "over the shortest queue before the scene "
                             "rebalances")
    args = parser.parse_args()
    serve_controller(args.host, args.port, args.dispatch_method,
                     affinity_max_backlog=args.affinity_max_backlog)
