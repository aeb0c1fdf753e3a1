"""Serving model worker of the PyTorch port: one InferenceEngine on the card
behind HTTP (counterpart of ``video3d_tpu/serve/model_worker.py``).

API surface of the reference worker (llava/serve/model_worker.py:44-230:
register with the controller, heartbeat thread, /worker_get_status,
/worker_generate), but requests carry a scene id and run the full 3D
pipeline (frames, voxel-id world PE, prefill, decode).

Request schema (POST /worker_generate):
  {"video": "scannet/scene0000_00", "prompt": "<image>\\nwhere is ...",
   "max_new_tokens": 512}
or a ``conversations`` history instead of ``prompt``, or, for plain 2D
multi-image chat (the reference gradio_multi_image contract: base64 images,
one per '<image>' placeholder, missing placeholders prepended):
  {"prompt": "<image>\\n<image>\\nwhat changed?", "images": [b64png, ...]}
Response: {"text": ..., "inference_time": seconds, "error_code": 0}

Also: /worker_generate_stream (``\\0``-separated cumulative-text JSON),
/worker_ground, the OpenAI routes /v1/chat/completions (SSE with
``"stream": true``) and /v1/models, and the metrics (POST /worker_metrics,
GET /metrics in the Prometheus text format).

Requests that reach the engine directly (no batcher, or a batcher's bypass:
per-request sampling, adapters, 2D images, stops and budget cuts) run one
at a time (``ModelWorker._direct``): the engine writes its decode state in
place and every prefill allocates a cache, so concurrent threads would
stack them. A stream takes that semaphore around each of its chunks and
releases it before the chunk goes to the client, so a client that stops
reading holds its own cache but blocks nobody. Each open stream holds its
prefilled cache (bucket + max_new_tokens positions) between chunks, so at
most ``ModelWorker.MAX_OPEN_STREAMS`` are open at once; one more is
refused.

Launch: ``python -m video3d_tpu_torch.serve.model_worker --model-path DIR
[--load-format dummy]`` (see :func:`main`).
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from video3d_tpu_torch.constants import WORKER_HEART_BEAT_INTERVAL
from video3d_tpu_torch.serve.controller import _post_json


class ModelWorker:
    # open engine streams at once, each holding its cache between chunks
    MAX_OPEN_STREAMS = 4

    def __init__(self, engine, model_name: str,
                 controller_addr: Optional[str] = None,
                 worker_addr: Optional[str] = None,
                 heartbeat: bool = True,
                 batcher=None,
                 adapters: Optional[dict] = None):
        self.engine = engine
        self.batcher = batcher     # ContinuousBatcher: concurrent requests
        self.model_name = model_name
        # multi-LoRA serving (vLLM --lora-modules): name -> InferenceEngine
        # whose params share the base engine's frozen tensors (lazy
        # LoraAdapted leaves over a quantized base), each with its own
        # scene / prefix caches (cached features and KV depend on the
        # adapter). Requests pick one by the wire "model" field; the
        # controller routes by the advertised model_names.
        self.adapters = dict(adapters or {})
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:8]
        self.queue_length = 0
        # observability counters (GET /metrics, POST /worker_metrics)
        self.n_requests = 0
        self.n_errors = 0
        self.inference_seconds = 0.0
        self.lock = threading.Lock()
        # device work that reaches an engine directly runs one request (one
        # stream chunk) at a time, and at most MAX_OPEN_STREAMS engine
        # streams hold a cache at once (module docstring)
        self._direct = threading.Semaphore(1)
        self._streams = threading.BoundedSemaphore(self.MAX_OPEN_STREAMS)
        self._hb_stop = threading.Event()
        if controller_addr and worker_addr:
            self.register()
            if heartbeat:
                t = threading.Thread(target=self._heartbeat_loop, daemon=True)
                t.start()

    def status(self) -> dict:
        return {"model_names": [self.model_name, *sorted(self.adapters)],
                "speed": 1, "queue_length": self.queue_length}

    def _engine_for(self, request: dict):
        """``(engine, is_adapter)`` of the request's ``model`` field: absent
        or the base name -> the base engine; an unknown name raises,
        listing what this worker serves."""
        name = request.get("model")
        if name is None or name == self.model_name:
            return self.engine, False
        if name in self.adapters:
            return self.adapters[name], True
        raise ValueError(
            f"unknown model {name!r}; this worker serves "
            f"{[self.model_name, *sorted(self.adapters)]}")

    def metrics(self) -> dict:
        """Flat scrape of the serving stack: worker counters, the engine's
        cache hit counts (scene features, prefix KV) and, with continuous
        batching, slot occupancy, page-pool headroom and prefix-page
        sharing. Served as JSON (POST /worker_metrics) and Prometheus text
        (GET /metrics)."""
        eng = self.engine
        m = {
            "queue_length": self.queue_length,
            "requests_total": self.n_requests,
            "errors_total": self.n_errors,
            "inference_seconds_total": round(self.inference_seconds, 3),
            "adapters_served": len(self.adapters),
            "scene_cache_hits_total": eng.scene_cache_stats[0],
            "scene_cache_misses_total": eng.scene_cache_stats[1],
            "prefix_cache_hits_total": eng.prefix_cache_stats[0],
            "prefix_cache_misses_total": eng.prefix_cache_stats[1],
            "speculative_accepted_total": eng.spec_stats[0],
            "speculative_offered_total": eng.spec_stats[1],
        }
        b = self.batcher
        # a RoutedBatcher fans out to .pools; sum over them
        pools = list(getattr(b, "pools", [b])) if b is not None else []
        if pools:
            m["slots"] = sum(p.num_slots for p in pools)
            m["slots_in_use"] = sum(sum(r is not None for r in p.slots)
                                    for p in pools)
            m["speculative_batching"] = int(any(p.spec for p in pools))
            if any(p.chunk_prefill for p in pools):
                m["admissions_chunking"] = sum(
                    int(p._job is not None) for p in pools)
                m["admissions_chunk_queued"] = sum(
                    len(p._chunkq) for p in pools)
            paged = [p for p in pools if p.paged]
            if paged:
                m["pages"] = sum(p.total_pages - 1 for p in paged)
                m["pages_free"] = sum(p._alloc.available for p in paged)
                m["admissions_deferred"] = sum(len(p._deferred)
                                               for p in paged)
                m["prefix_shared_admits_total"] = sum(
                    p.prefix_share_stats[0] for p in paged)
                m["prefix_shared_scenes"] = sum(len(p._shared)
                                                for p in paged)
        return m

    def register(self) -> None:
        _post_json(self.controller_addr + "/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                ok = _post_json(self.controller_addr + "/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length,
                })
                if not ok.get("exist"):
                    self.register()
            except Exception:  # noqa: BLE001 — controller down: retry later
                pass

    @staticmethod
    def _record(request: dict) -> dict:
        """Wire request -> engine record: a single-turn ``prompt`` or a
        multi-turn ``conversations`` history (human / gpt turns, the
        trailing gpt turn None or absent; the reference cli.py's
        conversation loop as a stateless wire field)."""
        convs = request.get("conversations")
        if convs:
            convs = [dict(c) for c in convs]
            if convs[-1].get("value"):
                convs.append({"from": "gpt", "value": None})
        else:
            convs = [{"from": "human", "value": request["prompt"]},
                     {"from": "gpt", "value": None}]
        return {"video": request.get("video", ""), "conversations": convs}

    def _sampling(self, request: dict):
        """Per-request sampling overrides (reference worker parity,
        llava/serve/model_worker.py:140-167): (overrides for
        ``generate_answer_stream``, whether they differ from the engine's
        defaults). temperature / top_p are put on a 0.05 grid, top_k is
        exact. The JAX package compiles a decode graph per combination and
        refuses a ninth; here overrides decode eagerly and capture nothing
        (eval/drivers.py), so every combination is admitted."""
        ecfg = self.engine.ecfg
        out = {}
        for k, cast in (("temperature", float), ("top_p", float),
                        ("top_k", int)):
            v = request.get(k)
            if v is None:
                continue
            v = cast(v)
            if cast is float:
                v = round(round(v / 0.05) * 0.05, 2)
            if v != cast(getattr(ecfg, k)):
                out[k] = v
        return out, bool(out)

    @staticmethod
    def _apply_stop(text: str, stop) -> str:
        """Truncate at the first stop sequence (a string or a list): the
        text-level form of the reference's KeywordsStoppingCriteria
        (mm_utils.py; the worker passes params['stop'])."""
        if not stop:
            return text
        for s in ([stop] if isinstance(stop, str) else stop):
            if s:
                i = text.find(s)
                if i >= 0:
                    text = text[:i]
        return text

    def _serialized(self, gen):
        """Yield from ``gen`` with each step (its prefill, then each chunk)
        under ``_direct``, released before the item is handed on."""
        try:
            while True:
                with self._direct:
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                yield item
        finally:
            gen.close()

    def generate(self, request: dict) -> dict:
        with self.lock:
            self.queue_length += 1
        try:
            record = self._record(request)
            # the batcher's slots run the BASE engine's params; adapter
            # requests take the direct routes below
            eng, is_adapter = self._engine_for(request)
            ecfg = eng.ecfg
            mnt = request.get("max_new_tokens")
            # clamp to the engine budget (the batcher clamps only to its
            # rows' room, which can exceed the configured budget)
            mnt = None if mnt is None else min(int(mnt),
                                               ecfg.max_new_tokens)
            sampling, differs = self._sampling(request)
            stop = request.get("stop")
            t0 = time.time()
            kw = {} if mnt is None else {"max_new_tokens": mnt}
            if request.get("images"):
                # plain 2D multi-image chat (no scene id): decode the base64
                # payloads, splice each at its own <image> sentinel. The
                # whole conversation is re-templated each round (the
                # reference gradio_multi_image server) and the request's
                # budget / sampling ride the host-chunked decode.
                from PIL import Image as PILImage

                pil = [PILImage.open(io.BytesIO(base64.b64decode(s)))
                       .convert("RGB") for s in request["images"]]
                prompt = request.get("prompt")
                convs = None if prompt else record["conversations"]
                with self._direct:
                    text = eng.generate_answer_images(
                        prompt, pil, conversations=convs,
                        max_new_tokens=mnt, **sampling)
            elif self.batcher is not None and not differs and not is_adapter:
                if stop:
                    # stop early through the stream instead of decoding the
                    # whole budget past the stop sequence; cancel releases
                    # the slot at the next boundary
                    handle = self.batcher.submit(record, **kw)
                    text = ""
                    try:
                        for t in handle.text_stream(
                                self.engine._decode_text):
                            text = self._apply_stop(t, stop)
                            if text != t:
                                break
                    finally:
                        handle.cancel()
                else:
                    text = self.batcher.generate(record, **kw)
            elif differs or stop or (
                    mnt is not None and mnt < ecfg.max_new_tokens):
                # per-request budget / sampling / stop: the engine's
                # host-chunked stream (a batched pool decodes every slot
                # with one sampling configuration); an adapter without
                # them takes its engine's captured decode below
                with self._direct:
                    text = ""
                    stream = eng.generate_answer_stream(
                        record, max_new_tokens=mnt, **sampling)
                    try:
                        for t in stream:
                            text = self._apply_stop(t, stop)
                            if text != t:
                                break
                    finally:
                        stream.close()
            else:
                with self._direct:
                    text = eng.generate_answer(record)
            text = self._apply_stop(text, stop)
            dt = time.time() - t0
            with self.lock:
                self.inference_seconds += dt
            return {"text": text, "inference_time": dt, "error_code": 0}
        except Exception as e:  # noqa: BLE001 — reported in the reply
            with self.lock:
                self.n_errors += 1
            return {"text": "", "error": str(e), "error_code": 1}
        finally:
            with self.lock:
                self.queue_length -= 1
                self.n_requests += 1

    def ground(self, request: dict) -> dict:
        """3D visual grounding over HTTP (the reference serve stack cannot
        ground): ``{"video", "query"}`` -> scores over the scene's object
        proposals (and the trailing no-object score, the reference eval
        layout), the proposal boxes (xyzwhd) and the argmax box (None when
        the no-object score wins). Rides the scene-prefix KV and
        object-feature caches when they are on."""
        with self.lock:
            self.queue_length += 1
        try:
            eng, _ = self._engine_for(request)
            if eng.ecfg.ground_token_id is None:
                return {"error": "engine has no ground token (set "
                        "EngineConfig.ground_token_id)", "error_code": 1}
            record = {
                "video": request["video"],
                "conversations": [
                    {"from": "human", "value": request["query"]},
                    {"from": "gpt", "value": "<ground>"},
                ],
            }
            t0 = time.time()
            with self._direct:
                scores, objects = eng.ground(record)
            dt = time.time() - t0
            with self.lock:
                self.inference_seconds += dt
            scores = [float(s) for s in scores]
            i = max(range(len(scores)), key=scores.__getitem__)
            best = (None if i >= len(objects)
                    else [float(x) for x in objects[i]])
            return {"scores": scores,
                    "objects": [[float(x) for x in o] for o in objects],
                    "best_box": best, "inference_time": dt,
                    "error_code": 0}
        except Exception as e:  # noqa: BLE001 — reported in the reply
            with self.lock:
                self.n_errors += 1
            return {"error": str(e), "error_code": 1}
        finally:
            with self.lock:
                self.queue_length -= 1
                self.n_requests += 1

    def _openai_record(self, request: dict):
        """OpenAI ``messages`` -> native wire request: ``(wire_request,
        None)`` or ``(None, (error_payload, status))``.

        Content may be null (assistant tool-call turns) or a content-part
        list with non-dict junk: parsed liberally. A ``{"type":
        "video_id"}`` part (or a top-level ``"video"``) selects the scene;
        the <image> splice token goes into turn 0 when no turn carries one.
        ``{"type": "image_url"}`` parts with ``data:`` base64 URLs take the
        2D multi-image route (wire ``images``)."""
        video = request.get("video", "")
        images = []
        convs = []
        for msg in request.get("messages", []):
            if not isinstance(msg, dict):
                continue
            role = msg.get("role")
            if role not in ("user", "assistant"):
                continue
            content = msg.get("content") or ""
            if not isinstance(content, str):    # OpenAI content-part list
                texts = []
                for part in content:
                    if not isinstance(part, dict):
                        continue
                    if part.get("type") == "text":
                        texts.append(str(part.get("text", "")))
                    elif part.get("type") == "video_id":
                        video = part.get("video_id", video)
                    elif part.get("type") == "image_url":
                        url = part.get("image_url")
                        if isinstance(url, dict):
                            url = url.get("url", "")
                        url = url or ""
                        if role != "user":
                            continue    # images ride only on user turns
                        if not (url.startswith("data:") and "," in url):
                            return None, ({"error": {
                                "message": "image_url must be a data: URI "
                                           "(base64 inline); remote http(s) "
                                           "fetch is not supported",
                                "type": "invalid_request_error",
                                "param": "messages", "code": None}}, 400)
                        images.append(url.split(",", 1)[1])
                content = "\n".join(texts)
            if role == "assistant" and not content:
                continue        # tool-call / empty turns carry no text
            convs.append({"from": "human" if role == "user" else "gpt",
                          "value": content})
        if not convs:
            return None, ({"error": {"message": "no user/assistant message",
                                     "type": "invalid_request_error",
                                     "param": "messages", "code": None}},
                          400)
        # standard OpenAI clients don't know the <image> splice token;
        # with a scene attached, it goes into turn 0
        if video and all("<image>" not in c["value"] for c in convs):
            convs[0]["value"] = f"<image>\n{convs[0]['value']}"
        wire = {"video": video, "conversations": convs}
        if images:
            if video:
                return None, ({"error": {
                    "message": "a request carries either a 3D scene "
                               "(video_id) or 2D images, not both",
                    "type": "invalid_request_error", "param": "messages",
                    "code": None}}, 400)
            if request.get("stream"):
                return None, ({"error": {
                    "message": "streaming is not supported for 2D "
                               "multi-image requests",
                    "type": "invalid_request_error", "param": "stream",
                    "code": None}}, 400)
            wire["images"] = images
        name = request.get("model")
        if name is not None:
            if name != self.model_name and name not in self.adapters:
                return None, ({"error": {
                    "message": f"model {name!r} not found; serving "
                               f"{[self.model_name, *sorted(self.adapters)]}",
                    "type": "invalid_request_error", "param": "model",
                    "code": "model_not_found"}}, 404)
            wire["model"] = name
        mnt = request.get("max_tokens",
                          request.get("max_completion_tokens"))
        if mnt is not None:
            try:
                wire["max_new_tokens"] = int(mnt)
            except (TypeError, ValueError):
                return None, ({"error": {
                    "message": "max_tokens must be an integer",
                    "type": "invalid_request_error",
                    "param": "max_tokens", "code": None}}, 400)
        for k in ("temperature", "top_p", "stop"):
            if request.get(k) is not None:
                wire[k] = request[k]
        return wire, None

    def openai_stream(self, request: dict):
        """SSE events for ``"stream": true``: chat.completion.chunk objects
        carrying content deltas (the native stream yields cumulative text),
        a role-priming first chunk and a finish_reason terminator."""
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        created = int(time.time())
        model = request.get("model", self.model_name)

        def chunk(delta, finish=None):
            return {"id": rid, "object": "chat.completion.chunk",
                    "created": created, "model": model,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]}

        yield chunk({"role": "assistant", "content": ""})
        # deltas are append-only, but a stop sequence can make the
        # cumulative text shrink at a chunk boundary (a partial stop suffix
        # was already streamed): hold back maxlen(stop) - 1 characters from
        # intermediate deltas; the tail flushes at the end
        stop = request.get("stop")
        hold = 0
        if stop:
            ss = [stop] if isinstance(stop, str) else stop
            hold = max((len(s) for s in ss if s), default=1) - 1
        prev = ""
        final = ""
        inner = self.generate_stream(request)
        try:
            for payload in inner:
                if payload["error_code"]:
                    yield {"error": {"message": payload.get(
                        "error", "generation failed"),
                        "type": "server_error", "param": None,
                        "code": None}}
                    return
                final = payload["text"]
                safe = final[:len(final) - hold] if hold else final
                if len(safe) > len(prev) and safe.startswith(prev):
                    yield chunk({"content": safe[len(prev):]})
                    prev = safe
        finally:
            inner.close()       # propagate cancellation on client hangup
        if len(final) > len(prev) and final.startswith(prev):
            yield chunk({"content": final[len(prev):]})
        yield chunk({}, finish="stop")

    def chat_completions(self, request: dict):
        """OpenAI-compatible /v1/chat/completions (non-streaming): the scene
        id rides a top-level ``"video"`` or a ``{"type": "video_id"}``
        content part; the whole user / assistant history is forwarded as a
        multi-turn conversation; system messages are dropped (the ChatML
        template carries its own). Returns ``(payload, http_status)``:
        errors use the OpenAI error envelope with a non-2xx status."""
        wire, err = self._openai_record(request)
        if err is not None:
            return err
        out = self.generate(wire)
        if out["error_code"]:
            return {"error": {"message": out.get("error", "generation "
                                                 "failed"),
                              "type": "server_error", "param": None,
                              "code": None}}, 500
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": request.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out["text"]},
                "finish_reason": "stop",
            }],
        }, 200

    def generate_stream(self, request: dict):
        """Yield cumulative-text chunks (the reference worker's
        generate_stream contract, serve/model_worker.py:108-166: one JSON
        object per chunk, ``\\0``-separated on the wire)."""
        with self.lock:
            self.queue_length += 1
        t0 = time.time()
        try:
            record = self._record(request)
            eng, is_adapter = self._engine_for(request)
            chunk = int(request.get("stream_chunk", 16))
            mnt = request.get("max_new_tokens")
            mnt = None if mnt is None else min(
                int(mnt), eng.ecfg.max_new_tokens)
            sampling, differs = self._sampling(request)
            stop = request.get("stop")
            handle = None
            held = False
            if self.batcher is not None and not differs and not is_adapter:
                handle = self.batcher.submit(
                    record, **({} if mnt is None
                               else {"max_new_tokens": mnt}))
                stream = handle.text_stream(self.engine._decode_text)
            else:
                # sampling overrides and adapters bypass the batcher (its
                # slots decode the base params with one sampling setting);
                # the stream's cache lives until it ends
                if not self._streams.acquire(blocking=False):
                    raise RuntimeError(
                        f"{self.MAX_OPEN_STREAMS} streams are open on this "
                        "worker's engine; retry when one has ended")
                held = True
                stream = self._serialized(eng.generate_answer_stream(
                    record, chunk=chunk, max_new_tokens=mnt, **sampling))
            try:
                for text in stream:
                    cut = self._apply_stop(text, stop)
                    yield {"text": cut, "error_code": 0}
                    if cut != text:
                        break        # stop sequence hit: end the stream
            finally:
                # a client gone mid-stream (the handler close()s this
                # generator on a broken pipe): release the batcher slot, or
                # end the engine's stream and free its cache
                if handle is not None:
                    handle.cancel()
                else:
                    stream.close()
                if held:
                    self._streams.release()
        except Exception as e:  # noqa: BLE001 — reported in the stream
            with self.lock:
                self.n_errors += 1
            yield {"text": "", "error": str(e), "error_code": 1}
        finally:
            with self.lock:
                self.queue_length -= 1
                self.n_requests += 1
                self.inference_seconds += time.time() - t0


def _prometheus(metrics: dict, model: str) -> str:
    """A flat metrics dict in the Prometheus exposition format (text/plain,
    line-based; no client library needed)."""
    lines = []
    for k, v in metrics.items():
        name = f"video3d_{k}"
        kind = "counter" if k.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f'{name}{{model="{model}"}} {v}')
    return "\n".join(lines) + "\n"


class _WorkerHandler(BaseHTTPRequestHandler):
    worker: ModelWorker = None

    def log_message(self, *args):
        pass

    def _reply(self, payload: dict, code: int = 200):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            body = _prometheus(self.worker.metrics(),
                               self.worker.model_name).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/models":
            # OpenAI model discovery: the base model and every adapter
            created = int(time.time())
            self._reply({"object": "list", "data": [
                {"id": name, "object": "model", "created": created,
                 "owned_by": "video3d_tpu_torch"}
                for name in (self.worker.model_name,
                             *sorted(self.worker.adapters))]})
        else:
            self._reply({"error": f"unknown path {self.path}"}, 404)

    def _send_stream(self, gen, ctype: str, frame) -> None:
        """Write ``frame(item)`` for each item of ``gen`` as it comes; a
        client hangup closes ``gen`` (which cancels its request)."""
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        if ctype == "text/event-stream":
            self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for item in gen:
                self.wfile.write(frame(item))
                self.wfile.flush()
            if ctype == "text/event-stream":
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass            # client hung up; close() cancels below
        finally:
            gen.close()

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
        except Exception as e:  # noqa: BLE001 — malformed body/headers
            self._reply({"error": f"bad request: {e}"}, 400)
            return
        if self.path == "/v1/chat/completions" and data.get("stream"):
            # OpenAI streaming: SSE chat.completion.chunk events
            wire, err = self.worker._openai_record(data)
            if err is not None:
                self._reply(err[0], err[1])
                return
            wire["model"] = data.get("model", self.worker.model_name)
            self._send_stream(self.worker.openai_stream(wire),
                              "text/event-stream",
                              lambda ev: b"data: " + json.dumps(ev).encode()
                              + b"\n\n")
            return
        if self.path == "/worker_generate_stream":
            # reference wire format: JSON chunks separated by b"\0"; errors
            # ride the chunks (generate_stream catches them)
            self._send_stream(self.worker.generate_stream(data),
                              "application/octet-stream",
                              lambda p: json.dumps(p).encode() + b"\0")
            return
        try:
            if self.path == "/worker_get_status":
                self._reply(self.worker.status())
            elif self.path == "/worker_metrics":
                self._reply(self.worker.metrics())
            elif self.path == "/worker_generate":
                self._reply(self.worker.generate(data))
            elif self.path == "/worker_ground":
                self._reply(self.worker.ground(data))
            elif self.path == "/v1/chat/completions":
                payload, status = self.worker.chat_completions(data)
                self._reply(payload, status)
            else:
                self._reply({"error": f"unknown path {self.path}"}, 404)
        except Exception as e:  # noqa: BLE001 — never drop the connection
            self._reply({"error": str(e)}, 500)


def serve_worker(engine, model_name: str, host: str = "127.0.0.1",
                 port: int = 21002, controller_addr: Optional[str] = None,
                 background: bool = False, heartbeat: bool = True,
                 num_slots: int = 0, paged: bool = False,
                 page_size: int = 128, total_pages: Optional[int] = None,
                 chunked_prefill: int = 0, adapters: Optional[dict] = None):
    """Serve ``engine`` (and ``adapters``, name -> engine) over HTTP.
    ``num_slots > 0`` turns on continuous batching: concurrent requests
    share one S-slot decode loop (``serve/batcher.py``) instead of running
    one at a time through the engine; ``paged`` switches its cache to the
    page pool of ``total_pages`` pages of ``page_size`` tokens;
    ``chunked_prefill`` (tokens) bounds the decode stall of cold admissions
    (0: atomic admissions). With ``background`` returns (worker, server)
    and serves on a daemon thread."""
    batcher = None
    if num_slots > 0:
        from video3d_tpu_torch.serve.batcher import ContinuousBatcher

        batcher = ContinuousBatcher(engine, num_slots=num_slots,
                                    paged=paged, page_size=page_size,
                                    total_pages=total_pages,
                                    chunked_prefill=chunked_prefill)
    worker_addr = f"http://{host}:{port}"
    worker = ModelWorker(engine, model_name, controller_addr, worker_addr,
                         heartbeat=heartbeat, batcher=batcher,
                         adapters=adapters)
    handler = type("Handler", (_WorkerHandler,), {"worker": worker})
    server = ThreadingHTTPServer((host, port), handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return worker, server
    server.serve_forever()


def build_parser():
    """The launcher's flags (the reference's worker launch surface plus
    continuous batching, caches and adapters)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m video3d_tpu_torch.serve.model_worker")
    parser.add_argument("--model-path", required=True,
                        help="directory of the tokenizer (read through "
                             "transformers' AutoTokenizer)")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--controller-address", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; "
                             "without one the launcher raises)")
    parser.add_argument("--video-folder", default="data")
    parser.add_argument("--embodiedscan-folder", default="data/embodiedscan")
    parser.add_argument("--metadata-folder", default="data/metadata")
    parser.add_argument("--max-frame-num", type=int, default=32)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--num-slots", type=int, default=0,
                        help="continuous batching slots (0 = sequential)")
    parser.add_argument("--kv-cache-dtype", default="bfloat16",
                        choices=("bfloat16", "int8", "int4"))
    parser.add_argument("--load-in-8bit", action="store_true",
                        help="int8 LLM projections and lm_head")
    parser.add_argument("--load-in-4bit", action="store_true",
                        help="int4 LLM projections and lm_head")
    parser.add_argument("--w8a8", action="store_true",
                        help="int8 weights and int8 activations (implies "
                             "--load-in-8bit; ignored under --load-in-4bit)")
    parser.add_argument("--load-format", choices=("auto", "dummy"),
                        default="auto",
                        help="'auto': the checkpoint in --model-path "
                             "(config.json + *.safetensors); 'dummy': "
                             "ModelConfig()'s weights drawn on the device "
                             "from seed 0 (vLLM load_format=dummy)")
    parser.add_argument("--lora-modules", nargs="+", default=None,
                        metavar="NAME=RUN_DIR/model",
                        help="serve LoRA / QLoRA adapters beside the base "
                             "(vLLM --lora-modules): each NAME=PATH is a "
                             "Trainer export (the run's model directory, "
                             "lora.json beside it); requests pick one by "
                             "the 'model' field; QLoRA adapters need the "
                             "matching --load-in-8bit/4bit so all share one "
                             "quantized base")
    parser.add_argument("--spec-draft-layers", type=int, default=0)
    parser.add_argument("--scene-cache", type=int, default=8,
                        help="scene-level vision-feature LRU (0 disables)")
    parser.add_argument("--prefix-cache", type=int, default=4,
                        help="scene-prefix KV LRU: later questions on a "
                             "scene prefill only their suffix (0 disables)")
    parser.add_argument("--paged-kv", action="store_true",
                        help="paged KV pool instead of dense cache rows")
    parser.add_argument("--page-size", type=int, default=128)
    parser.add_argument("--chunked-prefill", type=int, default=0,
                        help="tokens per admission prefill chunk (bounds "
                             "the decode stall of cold admissions; "
                             "0 = atomic)")
    parser.add_argument("--total-pages", type=int, default=0,
                        help="page pool size (0 = dense-equivalent)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (not ported above 1, "
                             "ROADMAP A12)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel replicas (not ported above 1, "
                             "ROADMAP A12)")
    return parser


def _load_tokenizer(model_path: str):
    """The tokenizer saved in the directory ``model_path``, through
    transformers (imported here only: the port needs it for nothing else),
    from local files only: the launcher never downloads."""
    if not os.path.isdir(model_path):
        raise SystemExit(f"--model-path {model_path!r} is not a directory "
                         "holding a tokenizer")
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise SystemExit(
            "the worker loads its tokenizer from --model-path through the "
            "transformers package, which is not installed") from None
    return AutoTokenizer.from_pretrained(model_path, local_files_only=True)


def check_ported(args) -> None:
    """Raise NotImplementedError for a launch the port has not got:
    ``--tp`` / ``--dp`` above 1 (A12)."""
    if args.tp > 1 or args.dp > 1:
        raise NotImplementedError(
            "--tp / --dp above 1: multi-GPU serving is not ported "
            "(ROADMAP A12)")


def weight_bits(args):
    """(bits, act) of the launch flags, as JAX's launcher reads them:
    ``--w8a8`` means bits 8 with int8 activations, except under
    ``--load-in-4bit``."""
    bits = (4 if args.load_in_4bit
            else 8 if args.load_in_8bit or args.w8a8 else 16)
    return bits, "int8" if args.w8a8 and bits != 4 else "none"


def build_worker_engines(args, tokenizer, cfg=None):
    """(base engine, adapters) of parsed launcher ``args``: the weights of
    the checkpoint in ``--model-path`` (``--load-format auto``, through
    ``builder.load_pretrained_model``) or ``cfg`` (default
    ``ModelConfig()``) drawn on the device from seed 0 (``dummy``), bf16
    on the card (f32 on the CPU), quantized per ``--load-in-8bit/4bit``
    and ``--w8a8`` (:func:`weight_bits`), and an engine per
    ``--lora-modules`` entry over the same base."""
    import torch

    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.data.video_processor import VideoProcessor
    from video3d_tpu_torch.eval.drivers import EngineConfig, InferenceEngine
    from video3d_tpu_torch.params import init_model, resolve_device

    check_ported(args)
    bits, act = weight_bits(args)
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if args.load_format == "auto":
        from video3d_tpu_torch.models.builder import load_pretrained_model
        from video3d_tpu_torch.models.quant import quantize_tree

        _, params, cfg, _ = load_pretrained_model(
            args.model_path, dtype=dtype, load_tokenizer=False, device=dev)
        if bits != 16:
            params = quantize_tree(params, bits=bits, act=act)
    else:
        cfg = cfg or ModelConfig()
        params = init_model(cfg, dev,
                            torch.Generator(device=dev).manual_seed(0), dtype,
                            bits=bits, act=act)
    vp = VideoProcessor(DataConfig(video_folder=args.video_folder,
                                   annotation_dir=args.embodiedscan_folder,
                                   metadata_dir=args.metadata_folder,
                                   frames_upbound=args.max_frame_num))
    ecfg = EngineConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        max_frames=args.max_frame_num,
        kv_cache_dtype=args.kv_cache_dtype,
        speculative_draft_layers=args.spec_draft_layers,
        scene_cache_scenes=args.scene_cache,
        prefix_cache_scenes=args.prefix_cache)
    engine = InferenceEngine(params, cfg, tokenizer, vp, engine_cfg=ecfg,
                             device=dev)
    adapters = {}
    for spec in args.lora_modules or ():
        # NAME=<run>/model: over a quantized base the adapters stay lazy
        # (LoraAdapted, apply_lora), so N adapters cost the base + N x
        # (A, B); a bf16 base gets a merged copy of every adapted weight
        from video3d_tpu_torch.train.lora import (apply_lora,
                                                  load_lora_export,
                                                  merge_lora_into_params)

        aname, _, apath = spec.partition("=")
        if not (aname and apath):
            raise ValueError(f"--lora-modules entry {spec!r}: expected "
                             "NAME=PATH")
        lora, lcfg, lbits = load_lora_export(apath, params)
        if lbits != bits:
            raise ValueError(
                f"adapter {aname!r} was trained against a {lbits}-bit base "
                f"(lora.json) but the worker loads {bits}-bit weights; pass "
                "the matching --load-in-8bit/4bit")
        if bits == 16:
            print(f"[worker] adapter {aname!r} over a bf16 base holds a "
                  "merged copy of every adapted weight; quantize the base "
                  "(--load-in-8bit) to share it")
            aparams = merge_lora_into_params(params, lora, lcfg)
        else:
            aparams = apply_lora(params, lora, lcfg)
        adapters[aname] = InferenceEngine(aparams, cfg, tokenizer, vp,
                                          engine_cfg=ecfg, device=dev)
    return engine, adapters


def main(argv=None) -> None:
    """``python -m video3d_tpu_torch.serve.model_worker --model-path DIR
    [--load-format dummy] [--load-in-8bit | --w8a8] [--num-slots 8
    --paged-kv]
    [--lora-modules NAME=RUN/model ...]``: build the engine on the card and
    serve it (with ``--controller-address``, registered there)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_ported(args)
    engine, adapters = build_worker_engines(args,
                                            _load_tokenizer(args.model_path))
    name = args.model_name or args.model_path.rstrip("/").split("/")[-1]
    serve_worker(engine, name, host=args.host, port=args.port,
                 controller_addr=args.controller_address,
                 num_slots=args.num_slots, paged=args.paged_kv,
                 page_size=args.page_size,
                 total_pages=args.total_pages or None,
                 chunked_prefill=args.chunked_prefill, adapters=adapters)


if __name__ == "__main__":
    main()
