"""The port's worker helpers called directly beside the JAX package's, on
the same inputs (no engine, no sockets): ``_record``, ``_sampling`` with
its 0.05 grid, ``_apply_stop``,
``_openai_record`` with every error envelope, ``openai_stream``'s stop
hold-back, ``status``, ``_engine_for``, ``metrics`` over stand-in
batchers and ``_prometheus``. Outputs must be equal. Then the port's own
limits, over stand-in engines: the cap on open engine streams, and the
route an adapter request takes."""

from types import SimpleNamespace

import pytest

from video3d_tpu.serve import model_worker as jmw
from video3d_tpu_torch.serve import model_worker as tmw

PACKAGES = (jmw, tmw)


def _bare(mod, **attrs):
    w = object.__new__(mod.ModelWorker)     # the helpers touch no state
    w.model_name = "m"
    w.adapters = {}
    for k, v in attrs.items():
        setattr(w, k, v)
    return w


def _both(fn):
    """fn(module) for the JAX package and the port."""
    return [fn(m) for m in PACKAGES]


RECORDS = [
    {"video": "v", "prompt": "<image>\nq"},
    {"prompt": "q"},
    {"video": "v", "conversations": [{"from": "human", "value": "q"},
                                     {"from": "gpt", "value": "a"},
                                     {"from": "human", "value": "q2"}]},
    {"video": "v", "conversations": [{"from": "human", "value": "q"},
                                     {"from": "gpt", "value": None}]},
    {"video": "v", "conversations": [{"from": "human", "value": "q"},
                                     {"from": "gpt"}]},
    {"video": "v", "conversations": [], "prompt": "fallback"},
]


@pytest.mark.parametrize("request_", RECORDS)
def test_record_matches_jax(request_):
    j, t = _both(lambda m: m.ModelWorker._record(dict(request_)))
    assert t == j


STOPS = [("hello world", None), ("hello world", ""), ("hello world", []),
         ("hello world", "wor"), ("hello world", ["zz", "o w"]),
         ("hello", ["", "zz"]), ("abcabc", ["c", "b"]), ("", "x"),
         ("a##b##", "##")]


@pytest.mark.parametrize("text,stop", STOPS)
def test_apply_stop_matches_jax(text, stop):
    j, t = _both(lambda m: m.ModelWorker._apply_stop(text, stop))
    assert t == j


def _sampling_worker(mod, **ecfg):
    e = dict(temperature=0.0, top_p=1.0, top_k=0, max_new_tokens=8)
    e.update(ecfg)
    w = _bare(mod, engine=SimpleNamespace(ecfg=SimpleNamespace(**e)))
    if mod is jmw:
        w._sampling_combos = set()
    return w


SAMPLING_SEQ = [{"temperature": 0.0}, {"temperature": 0.70001},
                {"temperature": 0.70004}, {"top_p": 0.93, "top_k": 5},
                {"top_k": "7"}, {"temperature": "0.2", "top_p": None},
                {"temperature": 0.1}, {"temperature": 0.3},
                {"temperature": 0.4}, {"temperature": 0.5},
                {"temperature": 0.6}, {"temperature": 0.9},
                {"temperature": 0.1}, {"temperature": 0.025}]


@pytest.mark.parametrize("ecfg", [{}, {"temperature": 0.7, "top_k": 5}])
def test_sampling_sequence_matches_jax(ecfg):
    """The same request sequence through both workers: the overrides and
    the grid equal JAX's at every request. JAX compiles a decode graph per
    combination and refuses a ninth; the port captures none and admits
    every one, so it is held to JAX's worker with the cap lifted."""
    def run(w):
        seq = []
        for req in SAMPLING_SEQ:
            try:
                seq.append(w._sampling(dict(req)))
            except ValueError as e:
                seq.append(("refused", "sampling configurations" in str(e)))
        return seq

    capped = run(_sampling_worker(jmw, **ecfg))
    assert ("refused", True) in capped      # the sequence passes JAX's cap
    lifted = _sampling_worker(jmw, **ecfg)
    lifted._MAX_SAMPLING_COMBOS = len(SAMPLING_SEQ)
    want = run(lifted)
    assert ("refused", True) not in want
    assert run(_sampling_worker(tmw, **ecfg)) == want


OPENAI_REQUESTS = [
    {"video": "scannet/scene0000_00", "max_tokens": 7, "temperature": 0.5,
     "stop": ["\n"], "messages": [
         {"role": "system", "content": "ignored"},
         {"role": "user", "content": "what is in the room"},
         {"role": "assistant", "content": "a chair"},
         {"role": "user", "content": [{"type": "text",
                                       "text": "what color"}]}]},
    {"messages": [{"role": "user", "content": [
        {"type": "video_id", "video_id": "scannet/scene0001_00"},
        {"type": "text", "text": "<image>\nlook"}]}]},
    {"messages": [{"role": "user", "content": "hi"}],
     "max_completion_tokens": "3", "top_p": 0.9},
    {"video": "v", "messages": [
        "junk", {"role": "user", "content": None},
        {"role": "assistant", "content": None},
        {"role": "user", "content": ["junk-part",
                                     {"type": "text", "text": "q"}]}]},
    {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,"
                                                   "QUJD"}},
        {"type": "image_url", "image_url": "data:image/png;base64,REVG"},
        {"type": "text", "text": "compare"}]},
        {"role": "assistant", "content": [
            {"type": "image_url",
             "image_url": {"url": "data:image/png;base64,WFla"}},
            {"type": "text", "text": "ok"}]}]},
    {"model": "m", "messages": [{"role": "user", "content": "q"}]},
    {"model": "tuned", "messages": [{"role": "user", "content": "q"}]},
    # error envelopes: every one of them
    {"messages": [{"role": "system", "content": "hi"},
                  {"role": "assistant", "content": None}]},
    {"messages": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "https://example.com/a.png"}}]}]},
    {"video": "v", "messages": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64,QUJD"}}]}]},
    {"stream": True, "messages": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64,QUJD"}}]}]},
    {"model": "nope", "messages": [{"role": "user", "content": "q"}]},
    {"max_tokens": "abc", "messages": [{"role": "user", "content": "hi"}]},
]


@pytest.mark.parametrize("i", range(len(OPENAI_REQUESTS)))
def test_openai_record_matches_jax(i):
    req = OPENAI_REQUESTS[i]
    j, t = _both(lambda m: _bare(m, adapters={"tuned": None})
                 ._openai_record(dict(req)))
    assert t == j
    if t[0] is None:                   # an OpenAI error envelope
        payload, status = t[1]
        assert status in (400, 404)
        assert set(payload["error"]) == {"message", "type", "param", "code"}


STREAMS = [(["hello ", "hello wor##", "hello wor"], {"stop": "##x"}),
           (["a", "ab", "abc"], {}),
           (["x", "xy##", "xy"], {"stop": ["zz", "##"]}),
           (["", "", "ok"], {"stop": "k"})]


@pytest.mark.parametrize("texts,extra", STREAMS)
def test_openai_stream_holdback_matches_jax(texts, extra):
    def run(mod):
        w = _bare(mod)

        def fake_stream(request):
            for t in texts:
                yield {"text": t, "error_code": 0}

        w.generate_stream = fake_stream
        events = list(w.openai_stream({"model": "m", **extra}))
        return ([e["choices"][0]["delta"] for e in events],
                [e["choices"][0]["finish_reason"] for e in events])

    j, t = _both(run)
    assert t == j


def test_openai_stream_error_matches_jax():
    def run(mod):
        w = _bare(mod)

        def fake_stream(request):
            yield {"text": "a", "error_code": 0}
            yield {"text": "", "error": "boom", "error_code": 1}

        w.generate_stream = fake_stream
        return [e.get("error", e.get("choices", [{}])[0].get("delta"))
                for e in w.openai_stream({"model": "m"})]

    j, t = _both(run)
    assert t == j


def _stand_in_pool(paged: bool, chunked: bool):
    return SimpleNamespace(
        num_slots=4, slots=[None, object(), None, object()], spec=False,
        chunk_prefill=512 if chunked else 0, _job=object() if chunked
        else None, _chunkq=[1, 2], paged=paged, total_pages=33,
        _alloc=SimpleNamespace(available=20), _deferred=[1],
        prefix_share_stats=[5, 2], _shared={"s": 1})


@pytest.mark.parametrize("pools", [None, "one", "routed"])
def test_status_engine_for_metrics_and_prometheus_match_jax(pools):
    engine = SimpleNamespace(scene_cache_stats=[1, 2],
                             prefix_cache_stats=[3, 4], spec_stats=[5, 6])
    if pools == "one":
        batcher = _stand_in_pool(True, True)
    elif pools == "routed":
        batcher = SimpleNamespace(pools=[_stand_in_pool(True, False),
                                         _stand_in_pool(False, True)])
    else:
        batcher = None

    def run(mod):
        w = _bare(mod, engine=engine, batcher=batcher, queue_length=2,
                  n_requests=9, n_errors=1, inference_seconds=1.23456,
                  adapters={"b-tuned": "B", "a-tuned": "A"})
        with pytest.raises(ValueError, match="unknown model"):
            w._engine_for({"model": "nope"})
        picks = [w._engine_for(r) for r in ({}, {"model": "m"},
                                            {"model": "a-tuned"})]
        m = w.metrics()
        return w.status(), picks, m, mod._prometheus(m, "m")

    j, t = _both(run)
    assert t == j


def _stand_in_engine(answer: str, streamed: str, closed: list):
    """An engine whose captured route answers ``answer`` and whose stream
    yields growing prefixes of ``streamed``, recording each stream's end."""
    def stream(record, chunk=16, max_new_tokens=None, **sampling):
        try:
            for i in range(len(streamed)):
                yield streamed[:i + 1]
        finally:
            closed.append(record["conversations"][0]["value"])

    return SimpleNamespace(
        ecfg=SimpleNamespace(temperature=0.0, top_p=1.0, top_k=0,
                             max_new_tokens=8),
        generate_answer=lambda record: answer,
        generate_answer_stream=stream)


def test_open_engine_streams_are_capped(monkeypatch):
    """Each open engine stream holds its cache between chunks: past
    ``MAX_OPEN_STREAMS`` open at once a stream is refused, and one that
    ends (its client hung up) makes room again."""
    closed: list = []
    monkeypatch.setattr(tmw.ModelWorker, "MAX_OPEN_STREAMS", 2)
    w = tmw.ModelWorker(_stand_in_engine("a", "abcdef", closed), "m")
    a, b = (w.generate_stream({"prompt": p}) for p in ("qa", "qb"))
    assert next(a) == {"text": "a", "error_code": 0}
    assert next(b)["error_code"] == 0
    c = w.generate_stream({"prompt": "qc"})
    out = next(c)
    assert out["error_code"] == 1 and "2 streams are open" in out["error"]
    c.close()
    a.close()                      # the client of a hung up
    assert closed == ["qa"]
    d = w.generate_stream({"prompt": "qd"})
    assert [o["text"] for o in d] == ["a", "ab", "abc", "abcd", "abcde",
                                      "abcdef"]
    b.close()
    assert closed == ["qa", "qd", "qb"]
    assert w.n_errors == 1 and w.n_requests == 4 and w.queue_length == 0


@pytest.mark.parametrize("extra,route", [
    ({}, "captured"), ({"max_new_tokens": 8}, "captured"),
    ({"temperature": 0.5}, "stream"), ({"max_new_tokens": 3}, "stream"),
    ({"stop": "zz"}, "stream")])
def test_adapter_route(extra, route):
    """An adapter request without a sampling override, a budget cut or a
    stop takes its engine's ``generate_answer`` (the captured decode on
    the card); with one, the engine's host-chunked stream."""
    closed: list = []
    base = _stand_in_engine("base", "base", closed)
    tuned = _stand_in_engine("captured", "stream", closed)
    w = tmw.ModelWorker(base, "m", adapters={"tuned": tuned})
    out = w.generate({"model": "tuned", "prompt": "q", **extra})
    assert out["error_code"] == 0 and out["text"] == route
    assert w.generate({"prompt": "q"})["text"] == "base"
