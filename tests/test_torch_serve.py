"""The port's serving stack against the JAX package's, over real HTTP in one
process on free ports: both packages' controller and worker serve the same
tiny float32 weights (the port's through ``from_jax_params``) on the same
synthetic scene, one FakeTokenizer shared by every engine. Every route
gives the JAX stack's answer: /worker_generate (prompt, history, budget
cuts, stops), the ``\\0``-separated stream, the OpenAI route with and
without SSE, /worker_ground, 2D images (wire ``images`` and OpenAI
``image_url`` parts), an adapter by name, the controller's proxy routes
and dispatch, the CLI, manual registration and the web UI. Also: the
port's batcher worker and ``RoutedBatcher`` against the sequential
engine, concurrent requests on the sequential worker, and the launcher
(``--help``, what it refuses, the engines it builds)."""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.serve import controller as jctl
from video3d_tpu.serve import model_worker as jmw
from video3d_tpu.serve import router as jrouter
from video3d_tpu.serve import web as jweb
from video3d_tpu.train import lora as jlora
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.serve import cli as tcli
from video3d_tpu_torch.serve import controller as tctl
from video3d_tpu_torch.serve import model_worker as tmw
from video3d_tpu_torch.serve import register_worker as treg
from video3d_tpu_torch.serve import router as trouter
from video3d_tpu_torch.serve import web as tweb

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
MAX_NEW = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "video3d-tiny"


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, payload, timeout=300):
    return jctl._post_json(url, payload, timeout=timeout)


def _raw(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _ecfg(mod, tok, **kw):
    return mod.EngineConfig(max_new_tokens=MAX_NEW,
                            eos_token_id=tok.eos_token_id, max_frames=2,
                            buckets=(256,), stop_str="",
                            ground_token_id=tok.vocab["<ground>"],
                            max_objects=8, **kw)


class Stacks:
    """Both packages' engines, controllers and workers on free ports."""

    def __init__(self, root):
        self.info = make_fake_scene(root, n_frames=2)
        self.data_cfg = DataConfig(
            video_folder=root,
            annotation_dir=os.path.join(root, "embodiedscan"),
            metadata_dir=os.path.join(root, "metadata"), frames_upbound=2)
        self.tok = FakeTokenizer()
        self.jparams = jlv.init_model(jax.random.PRNGKey(0), CFG)
        self.tparams = self.port_params(self.jparams)
        self.jeng = self.jax_engine(self.jparams)
        self.teng = self.torch_engine(self.tparams)
        self.servers = []
        self.jc, self.jw = self.serve(jctl, jmw, self.jeng)
        self.tc, self.tw = self.serve(tctl, tmw, self.teng)

    @staticmethod
    def port_params(jparams):
        return from_jax_params(jax.tree.map(np.asarray, jparams), TCFG,
                               device="cpu")

    def jax_engine(self, params, **kw):
        return jdrv.InferenceEngine(
            params, CFG, self.tok, VideoProcessor(self.data_cfg),
            SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
            _ecfg(jdrv, self.tok, **kw), device_geometry=True)

    def torch_engine(self, params, **kw):
        return tdrv.InferenceEngine(
            params, TCFG, self.tok,
            TVideoProcessor(port_config(self.data_cfg)),
            TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
            _ecfg(tdrv, self.tok, **kw), device="cpu")

    def serve(self, ctl, mw, engine, **kw):
        """(controller address, worker address) of a new stack."""
        cport, wport = free_port(), free_port()
        controller, cserver = ctl.serve_controller(port=cport,
                                                   background=True)
        caddr = f"http://127.0.0.1:{cport}"
        self.controllers = {**getattr(self, "controllers", {}),
                            caddr: controller}
        worker, wserver = mw.serve_worker(engine, MODEL, port=wport,
                                          controller_addr=caddr,
                                          background=True, heartbeat=False,
                                          **kw)
        self.servers += [cserver, wserver]
        self.workers = getattr(self, "workers", []) + [worker]
        return caddr, f"http://127.0.0.1:{wport}"

    def both(self, path, payload, **kw):
        """(JAX reply, port reply) of one request to both workers."""
        return (_post(self.jw + path, payload, **kw),
                _post(self.tw + path, payload, **kw))

    def close(self):
        for w in self.workers:
            if w.batcher is not None:
                w.batcher.shutdown()
        for s in self.servers:
            s.shutdown()
            s.server_close()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    s = Stacks(str(tmp_path_factory.mktemp("data")))
    yield s
    s.close()


def _history(turns: int):
    convs = [{"from": "human", "value": "<image>\nwhat is in the room"},
             {"from": "gpt", "value": "a chair"},
             {"from": "human", "value": "what color is it"},
             {"from": "gpt", "value": "brown"},
             {"from": "human", "value": "where is the lamp"}]
    return convs[:turns]


def _generate_payloads(video):
    base = {"video": video, "prompt": "<image>\nwhat is in the room"}
    return [base,
            {"video": video, "conversations": _history(3)},
            {"video": video, "conversations": _history(5)},
            {**base, "max_new_tokens": 2},
            {**base, "temperature": 0.0},
            {**base, "stop": "zzz-never"}]


def test_generate_routes_match_jax(stacks):
    for payload in _generate_payloads(stacks.info["sample_idx"]):
        j, t = stacks.both("/worker_generate", payload)
        assert j["error_code"] == 0 and t["error_code"] == 0, (j, t)
        assert t["text"] == j["text"], payload
    # a stop sequence inside the answer cuts both at its first occurrence
    base = _generate_payloads(stacks.info["sample_idx"])[0]
    full = _post(stacks.tw + "/worker_generate", base)["text"]
    words = full.split()
    if len(words) >= 2:
        for stop in (words[1], ["zzz-never", words[1]]):
            j, t = stacks.both("/worker_generate", {**base, "stop": stop})
            assert t["text"] == j["text"] == full[:full.find(words[1])]


def test_concurrent_requests_on_the_sequential_worker(stacks):
    """Threads on the worker without a batcher: each answer equals the one
    the engine gives alone (the direct route runs one request at a time)."""
    payloads = _generate_payloads(stacks.info["sample_idx"])[:3]
    want = [_post(stacks.tw + "/worker_generate", p)["text"]
            for p in payloads]
    out = [None] * 9

    def hit(i):
        out[i] = _post(stacks.tw + "/worker_generate", payloads[i % 3])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(9)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert [o["text"] for o in out] == [want[i % 3] for i in range(9)]
    m = _post(stacks.tw + "/worker_metrics", {})
    assert m["queue_length"] == 0 and m["errors_total"] == 0


def _stream_chunks(addr, payload):
    _, raw = _raw(addr + "/worker_generate_stream", payload)
    return [json.loads(c) for c in raw.split(b"\0") if c]


@pytest.mark.parametrize("chunk", [2, 4])
def test_stream_matches_jax(stacks, chunk):
    for payload in _generate_payloads(stacks.info["sample_idx"])[:4]:
        payload = {**payload, "stream_chunk": chunk}
        j = _stream_chunks(stacks.jw, payload)
        t = _stream_chunks(stacks.tw, payload)
        assert t == j and t and all(c["error_code"] == 0 for c in t)
        final = _post(stacks.tw + "/worker_generate",
                      {k: v for k, v in payload.items()
                       if k != "stream_chunk"})
        assert t[-1]["text"] == final["text"]


def _sse(addr, payload):
    ctype, raw = _raw(addr + "/v1/chat/completions", payload)
    assert ctype.startswith("text/event-stream")
    events = [e[len("data: "):] for e in raw.decode().split("\n\n")
              if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    return ([c["choices"][0]["delta"] for c in chunks],
            [c["choices"][0]["finish_reason"] for c in chunks])


def _openai_payloads(video):
    return [
        {"model": MODEL, "messages": [
            {"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": [
                {"type": "video_id", "video_id": video},
                {"type": "text", "text": "what is in the room"}]}]},
        {"video": video, "messages": [
            {"role": "user", "content": "what is in the room"},
            {"role": "assistant", "content": "a chair"},
            {"role": "user", "content": "what color is it"}]},
        {"video": video, "max_tokens": 2, "messages": [
            {"role": "user", "content": "what is in the room"}]},
    ]


def test_openai_routes_match_jax(stacks):
    video = stacks.info["sample_idx"]
    native = _post(stacks.tw + "/worker_generate",
                   {"video": video, "prompt": "<image>\nwhat is in the room"})
    for i, payload in enumerate(_openai_payloads(video)):
        j, t = stacks.both("/v1/chat/completions", payload)
        assert t["object"] == "chat.completion"
        assert t["choices"] == j["choices"]
        if i == 0:
            assert t["choices"][0]["message"]["content"] == native["text"]
        jd, td = (_sse(stacks.jw, {**payload, "stream": True}),
                  _sse(stacks.tw, {**payload, "stream": True}))
        assert td == jd
        text = "".join(d.get("content", "") for d in td[0])
        assert text == t["choices"][0]["message"]["content"]
    for payload in ({"messages": [{"role": "system", "content": "hi"}]},
                    {"model": "nope", "messages": [{"role": "user",
                                                    "content": "q"}]}):
        codes = []
        for addr in (stacks.jw, stacks.tw):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(addr + "/v1/chat/completions", payload)
            codes.append((e.value.code, json.loads(e.value.read())))
        assert codes[1] == codes[0]


def test_ground_matches_jax(stacks):
    payload = {"video": stacks.info["sample_idx"],
               "query": "the brown chair"}
    j, t = stacks.both("/worker_ground", payload)
    assert j["error_code"] == 0 and t["error_code"] == 0, (j, t)
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-5,
                               atol=1e-5)
    assert t["objects"] == j["objects"]
    assert int(np.argmax(t["scores"])) == int(np.argmax(j["scores"]))
    assert t["best_box"] == j["best_box"]
    # through the controllers' proxy routes
    jc = _post(stacks.jc + "/worker_ground", {**payload, "model": MODEL})
    tc = _post(stacks.tc + "/worker_ground", {**payload, "model": MODEL})
    assert tc["scores"] == t["scores"] and jc["scores"] == j["scores"]


def _pil(seed, size=(56, 40)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                        np.uint8))


def _b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_images_match_jax(stacks):
    imgs = [_b64(_pil(0)), _b64(_pil(1, (64, 48)))]
    payloads = [
        {"prompt": "<image>\n<image>\nwhat changed?", "images": imgs},
        {"prompt": "compare", "images": imgs[:1]},
        {"conversations": [{"from": "human", "value": "what is this"},
                           {"from": "gpt", "value": "a pattern"},
                           {"from": "human", "value": "and this"}],
         "images": imgs},
        {"prompt": "compare", "images": imgs, "max_new_tokens": 3},
    ]
    for payload in payloads:
        j, t = stacks.both("/worker_generate", payload)
        assert j["error_code"] == 0 and t["error_code"] == 0, (j, t)
        assert t["text"] == j["text"]
    want = _post(stacks.tw + "/worker_generate", payloads[0])["text"]
    oa = {"messages": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64," + imgs[0]}},
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64," + imgs[1]}},
        {"type": "text", "text": "<image>\n<image>\nwhat changed?"}]}]}
    j, t = stacks.both("/v1/chat/completions", oa)
    assert t["choices"] == j["choices"]
    assert t["choices"][0]["message"]["content"] == want


def test_sampled_requests_match_the_port_engine(stacks):
    """Sampled answers cannot match JAX's PRNG: a request's overrides give
    the port engine's own answer under those settings, and top_k = 1
    gives the greedy answer."""
    video = stacks.info["sample_idx"]
    base = {"video": video, "prompt": "<image>\nwhat is in the room"}
    greedy = _post(stacks.tw + "/worker_generate", base)["text"]
    sampled = stacks.torch_engine(stacks.tparams, temperature=1.5,
                                  top_k=20)
    want = sampled.generate_answer(tmw.ModelWorker._record(base))
    out = _post(stacks.tw + "/worker_generate",
                {**base, "temperature": 1.5, "top_k": 20})
    assert out["error_code"] == 0 and out["text"] == want
    chunks = _stream_chunks(stacks.tw, {**base, "temperature": 1.5,
                                        "top_k": 20, "stream_chunk": 2})
    assert chunks[-1]["text"] == want
    one = _post(stacks.tw + "/worker_generate",
                {**base, "temperature": 1.5, "top_k": 1})
    assert one["text"] == greedy


def test_metrics_match_jax(stacks):
    stacks.both("/worker_generate",
                _generate_payloads(stacks.info["sample_idx"])[0])
    j, t = stacks.both("/worker_metrics", {})
    assert set(t) == set(j)
    assert t["errors_total"] == 0 and t["requests_total"] >= 1
    for addr in (stacks.jw, stacks.tw):
        with urllib.request.urlopen(addr + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert "# TYPE video3d_requests_total counter" in text
        assert f'video3d_queue_length{{model="{MODEL}"}} 0' in text
    with urllib.request.urlopen(stacks.tw + "/v1/models", timeout=30) as r:
        assert [m["id"] for m in json.loads(r.read())["data"]] == [MODEL]


def test_controller_routes_match_jax(stacks):
    video = stacks.info["sample_idx"]
    for c, w in ((stacks.jc, stacks.jw), (stacks.tc, stacks.tw)):
        assert _post(c + "/list_models", {})["models"] == [MODEL]
        assert _post(c + "/get_worker_address",
                     {"model": MODEL})["address"] == w
        assert _post(c + "/get_worker_address",
                     {"model": "nope"})["address"] == ""
    payload = {"model": MODEL, "video": video,
               "prompt": "<image>\nwhat is in the room"}
    j = _post(stacks.jc + "/worker_generate", payload)
    t = _post(stacks.tc + "/worker_generate", payload)
    assert t["error_code"] == 0 and t["text"] == j["text"]
    for c in (stacks.jc, stacks.tc):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(c + "/worker_generate", {**payload, "model": "nope"})
        assert e.value.code == 503


def test_cli_and_register_worker(stacks, capsys):
    video = stacks.info["sample_idx"]
    rc = tcli.main(["--controller", stacks.tc, "--model", MODEL,
                    "--video", video, "--max-new-tokens", "3",
                    "--message", "what is in the room"])
    out = capsys.readouterr().out
    want = _post(stacks.tw + "/worker_generate", {
        "video": video, "max_new_tokens": 3,
        "conversations": [{"from": "human",
                           "value": "<image>\nwhat is in the room"},
                          {"from": "gpt", "value": None}]})["text"]
    assert rc == 0 and MODEL in out and stacks.tw in out
    assert out.rstrip("\n").split("\n")[-1] == want
    with pytest.raises(SystemExit):
        tcli.main(["--controller", stacks.tc])     # no --video / --image
    # a controller restart, then manual registration with --refresh
    controller = stacks.controllers[stacks.tc]
    with controller.lock:
        controller.workers.clear()
    assert _post(stacks.tc + "/list_models", {})["models"] == []
    rc = treg.main(["--controller-address", stacks.tc, "--worker-name",
                    stacks.tw, "--check-heart-beat", "--refresh"])
    assert rc == 0
    assert _post(stacks.tc + "/list_models", {})["models"] == [MODEL]
    assert _post(stacks.tc + "/get_worker_address",
                 {"model": MODEL})["address"] == stacks.tw


def _web_lines(addr, payload):
    _, raw = _raw(addr + "/chat", payload)
    return [json.loads(line) for line in raw.splitlines() if line.strip()]


def test_web_ui_matches_jax(stacks):
    uis = []
    for web, c in ((jweb, stacks.jc), (tweb, stacks.tc)):
        port = free_port()
        _, server = web.serve_web(controller_addr=c, port=port,
                                  background=True)
        stacks.servers.append(server)
        uis.append(f"http://127.0.0.1:{port}")
    page = urllib.request.urlopen(uis[1] + "/", timeout=30).read()
    assert b"fetch('models')" in page and b"imgfiles" in page
    for u in uis:
        assert json.loads(urllib.request.urlopen(
            u + "/models", timeout=30).read())["models"] == [MODEL]
    video = stacks.info["sample_idx"]
    payloads = [
        {"model": MODEL, "video": video,
         "prompt": "<image>\nwhat is in the room", "stream_chunk": 2},
        {"model": MODEL, "video": video, "stream_chunk": 2,
         "conversations": _history(3) + [{"from": "gpt", "value": None}]},
        {"model": MODEL, "images": [_b64(_pil(2))],
         "conversations": [{"from": "human", "value": "what is this"},
                           {"from": "gpt", "value": None}]},
        {"model": "nope", "video": video, "prompt": "hi"},
    ]
    for payload in payloads:
        j, t = _web_lines(uis[0], payload), _web_lines(uis[1], payload)
        if payload["model"] == "nope":
            assert t[-1]["error_code"] == j[-1]["error_code"] == 1
            continue
        for line in j + t:
            line.pop("inference_time", None)
        assert t == j and t[-1]["error_code"] == 0


def _dispatch_sequence(mod, method, seed):
    """Picks of a controller under one sequence of registrations,
    heart-beats and requests."""
    np.random.seed(seed)
    c = mod.Controller(method, affinity_max_backlog=2, affinity_scenes=3)
    for i, speed in enumerate((1, 2, 1)):
        c.register_worker(f"http://w{i}", True,
                          {"model_names": ["m", "m-lora"] if i else ["m"],
                           "speed": speed, "queue_length": 0})
    picks = []
    for step in range(40):
        if step % 7 == 3:
            c.receive_heart_beat(f"http://w{step % 3}", step % 5)
        if step == 20:
            with c.lock:
                del c.workers["http://w1"]
        if step == 25:
            c.register_worker("http://w1", True,
                              {"model_names": ["m"], "speed": 3,
                               "queue_length": 4})
        model = "m-lora" if step % 9 == 4 else "m"
        scene = None if step % 6 == 5 else f"s{step % 4}"
        picks.append(c.get_worker_address(model, scene=scene))
    picks.append(c.get_worker_address("nope"))
    return picks, c.list_models(), sorted(
        (n, i.queue_length) for n, i in c.workers.items())


@pytest.mark.parametrize("method", ["scene_affinity", "shortest_queue",
                                    "lottery"])
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_dispatch_matches_jax(method, seed):
    assert _dispatch_sequence(tctl, method, seed) == \
        _dispatch_sequence(jctl, method, seed)


def test_router_footprints_and_answers(stacks):
    """``RoutedBatcher``'s footprints equal the JAX router's (the engine's
    multi-turn ``_tokenize_prompt``), and its answers the sequential
    engine's."""
    video = stacks.info["sample_idx"]
    recs = [tmw.ModelWorker._record(p)
            for p in _generate_payloads(video)[:3]]
    jr = object.__new__(jrouter.RoutedBatcher)
    jr.engine = stacks.jeng
    router = trouter.RoutedBatcher(stacks.teng, pools=((300, 1), (400, 2)))
    try:
        for rec in recs:
            assert router._footprint(rec) == jr._footprint(rec)
        out = [router.submit(r) for r in recs]
        texts = [h.result(stacks.teng._decode_text, timeout=300)
                 for h in out]
        assert texts == [stacks.teng.generate_answer(r) for r in recs]
        assert list(router.generate_stream(recs[0]))[-1] == texts[0]
        too_long = trouter.RoutedBatcher.__new__(trouter.RoutedBatcher)
        too_long.engine, too_long.limits = stacks.teng, [8]
        too_long.pools = router.pools[:1]
        with pytest.raises(ValueError, match="exceeds the largest pool"):
            too_long.generate(recs[0])
    finally:
        router.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_worker_matches_sequential(stacks, paged):
    """serve_worker(num_slots=2): concurrent requests through the shared
    decode loop give the sequential engine's (and so JAX's) answers; a
    client that hangs up mid-stream gives its slot back."""
    video = stacks.info["sample_idx"]
    payloads = _generate_payloads(video)[:3]
    want = [_post(stacks.jw + "/worker_generate", p)["text"]
            for p in payloads]
    _, addr = stacks.serve(tctl, tmw, stacks.teng, num_slots=2,
                           paged=paged, page_size=16)
    out = [None] * 6

    def hit(i):
        out[i] = _post(addr + "/worker_generate", payloads[i % 3])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert [o["text"] for o in out] == [want[i % 3] for i in range(6)]
    # a client that reads one chunk and hangs up
    req = urllib.request.Request(
        addr + "/worker_generate_stream",
        data=json.dumps({**payloads[0], "stream_chunk": 1}).encode(),
        headers={"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=300)
    r.read1(16)
    r.close()
    # a sampling override takes the direct route
    sampled = _post(addr + "/worker_generate",
                    {**payloads[0], "temperature": 1.5, "top_k": 1})
    assert sampled["text"] == want[0]
    m = None
    for _ in range(100):
        m = _post(addr + "/worker_metrics", {})
        if m["slots_in_use"] == 0 and m["queue_length"] == 0:
            break
        threading.Event().wait(0.1)
    assert m["slots"] == 2 and m["slots_in_use"] == 0
    assert m["requests_total"] == 8 and m["errors_total"] == 0
    if paged:
        assert m["pages_free"] == m["pages"]


def _adapter_tree(base, seed):
    tr = jlora.init_lora_trainable(jax.random.PRNGKey(seed), base,
                                   jlora.LoraConfig(r=4, alpha=64))
    rng = np.random.default_rng(seed + 100)

    def fill(path, x):
        if jax.tree_util.keystr(path).endswith("['B']"):
            return jax.numpy.asarray(0.5 * rng.normal(size=x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, tr)


def test_adapters_by_name_match_jax(stacks):
    """Multi-LoRA serving: an int8 base and two adapters kept lazy over
    it; the ``model`` field picks the adapter on every route, /v1/models
    lists them all, an unknown name is a 404."""
    base = jquant.quantize_tree(stacks.jparams, bits=8)
    lcfg = jlora.LoraConfig(r=4, alpha=64)
    adapted = {name: jlora.apply_lora(base, _adapter_tree(base, 10 + i),
                                      lcfg)
               for i, name in enumerate(("tuned-a", "tuned-b"))}
    j_ad = {n: stacks.jax_engine(p) for n, p in adapted.items()}
    t_ad = {n: stacks.torch_engine(stacks.port_params(p))
            for n, p in adapted.items()}
    _, jw = stacks.serve(jctl, jmw, stacks.jax_engine(base), adapters=j_ad)
    _, tw = stacks.serve(tctl, tmw,
                         stacks.torch_engine(stacks.port_params(base)),
                         adapters=t_ad)
    with urllib.request.urlopen(tw + "/v1/models", timeout=30) as r:
        assert [m["id"] for m in json.loads(r.read())["data"]] == \
            [MODEL, "tuned-a", "tuned-b"]
    video = stacks.info["sample_idx"]
    texts = []
    for name in (None, "tuned-a", "tuned-b"):
        payload = {"video": video, "prompt": "<image>\nwhat is in the room"}
        if name:
            payload["model"] = name
        j, t = _post(jw + "/worker_generate", payload), \
            _post(tw + "/worker_generate", payload)
        assert t["error_code"] == 0 and t["text"] == j["text"]
        texts.append(t["text"])
        oa = {"video": video, "messages": [{"role": "user",
                                            "content": "what is in the room"}]}
        if name:
            oa["model"] = name
        j, t = _post(jw + "/v1/chat/completions", oa), \
            _post(tw + "/v1/chat/completions", oa)
        assert t["choices"] == j["choices"]
        assert t["model"] == (name or MODEL)
    assert len(set(texts)) == 3
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(tw + "/v1/chat/completions",
              {"model": "missing", "video": video,
               "messages": [{"role": "user", "content": "x"}]})
    assert e.value.code == 404
    assert json.loads(e.value.read())["error"]["code"] == "model_not_found"
    out = _post(tw + "/worker_generate", {"video": video, "prompt": "q",
                                          "model": "missing"})
    assert out["error_code"] == 1 and "unknown model" in out["error"]


def test_launcher_help_and_refusals():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "video3d_tpu_torch.serve.model_worker",
         "--help"], capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO)
    assert out.returncode == 0
    for flag in ("--num-slots", "--spec-draft-layers", "--load-format",
                 "--load-in-8bit", "--load-in-4bit", "--kv-cache-dtype",
                 "--scene-cache", "--prefix-cache", "--paged-kv",
                 "--chunked-prefill", "--lora-modules", "--device"):
        assert flag in out.stdout
    for argv, item in ((["--tp", "2"], "A12"), (["--dp", "2"], "A12")):
        with pytest.raises(NotImplementedError, match=item):
            tmw.main(["--model-path", "unused"] + argv)
    # --w8a8 is bits 8 with int8 activations, except under --load-in-4bit
    # (JAX's launcher); --load-format auto reads the checkpoint directory
    parser = tmw.build_parser()
    for argv, want in (([], (16, "none")), (["--w8a8"], (8, "int8")),
                       (["--w8a8", "--load-in-4bit"], (4, "none")),
                       (["--load-in-8bit"], (8, "none"))):
        args = parser.parse_args(["--model-path", "unused"] + argv)
        assert tmw.weight_bits(args) == want
    assert "load_pretrained_model" in tmw.build_worker_engines.__doc__


def test_launcher_builds_engines_on_the_cpu(tmp_path, monkeypatch):
    """``build_worker_engines`` at the tiny config on the CPU (the launcher
    builds ``ModelConfig()`` on the card): the engine settings from the
    flags, and main()'s hand-off to serve_worker."""
    from video3d_tpu_torch.config import ModelConfig as TModelConfig

    tok = FakeTokenizer()
    args = tmw.build_parser().parse_args([
        "--model-path", str(tmp_path), "--load-format", "dummy",
        "--device", "cpu", "--load-in-8bit", "--kv-cache-dtype", "int8",
        "--max-new-tokens", "5", "--max-frame-num", "3", "--prefix-cache",
        "2", "--scene-cache", "0", "--spec-draft-layers", "1"])
    engine, adapters = tmw.build_worker_engines(args, tok,
                                                TModelConfig.tiny())
    e = engine.ecfg
    assert (e.max_new_tokens, e.max_frames, e.kv_cache_dtype,
            e.prefix_cache_scenes, e.scene_cache_scenes,
            e.speculative_draft_layers, e.eos_token_id) == \
        (5, 3, "int8", 2, 0, 1, tok.eos_token_id)
    assert engine.device == torch.device("cpu") and adapters == {}
    assert isinstance(engine.params["llm"]["lm_head"], dict)
    seen = {}
    monkeypatch.setattr(tmw, "_load_tokenizer", lambda path: tok)
    monkeypatch.setattr(tmw, "build_worker_engines",
                        lambda a, t: (engine, {"x": engine}))
    monkeypatch.setattr(tmw, "serve_worker",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    tmw.main(["--model-path", str(tmp_path / "ckpt-name"),
              "--load-format", "dummy", "--num-slots", "4", "--paged-kv",
              "--total-pages", "64", "--chunked-prefill", "128"])
    assert seen["args"] == (engine, "ckpt-name")
    assert {k: seen["kw"][k] for k in ("num_slots", "paged", "total_pages",
                                       "chunked_prefill")} == \
        {"num_slots": 4, "paged": True, "total_pages": 64,
         "chunked_prefill": 128}
    assert seen["kw"]["adapters"] == {"x": engine}
