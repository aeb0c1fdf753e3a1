"""The port's decode loops in chunks (``models/generate.py``) and the host
side of their captured form (``models/decode_graph.py``), on the CPU with
the tiny f32 config: the chunked ``generate_from_state`` against the
per-step loop and JAX's, the in-place decode chunks, the graph key, the
launch accounting of replays (a stand-in graph) and the buffers reserved
before a capture. The captured form itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import ModelConfig as JModelConfig
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.kernels.decode_attention import decode_plan
from video3d_tpu_torch.models import decode_graph as dg
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.models.quant import Int4Weight, quantize_weight
from video3d_tpu_torch.params import _convert

from port_configs import port_config

torch.set_num_threads(1)

JCFG = JModelConfig.tiny()
TCFG = port_config(JCFG)
EOS = 73
NEW = 19            # not a multiple of CHUNK
CHUNK = 4
CACHE = 48


@pytest.fixture(scope="module")
def models():
    """The tiny LLM's weights, its EOS column of the head scaled up so rows
    emit EOS after a few steps (each at its own step)."""
    tree = jax.tree.map(np.asarray,
                        jqwen.init_qwen2(jax.random.PRNGKey(4), JCFG.llm))
    head = tree["lm_head"].copy()
    head[:, EOS] *= 5.0
    tree["lm_head"] = head
    return {"llm": jax.tree.map(jnp.asarray, tree)}, \
        {"llm": _convert(tree, "cpu", None)}


def _state(B: int, seed: int = 0):
    """The same prefilled-looking dense state for JAX and the port: random
    K/V below each row's position, random next logits."""
    rng = np.random.default_rng(seed)
    llm = JCFG.llm
    width = llm.num_key_value_heads * llm.head_dim
    shape = (llm.num_hidden_layers, B, CACHE, width)
    pos = rng.integers(5, 20, size=B)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    for b, p in enumerate(pos):
        k[:, b, p:] = 0
        v[:, b, p:] = 0
    logits = rng.standard_normal((B, llm.vocab_size)).astype(np.float32)
    # the port's copies, made before JAX sees (and may donate) the arrays
    k0, v0, logits0, pos0 = k.copy(), v.copy(), logits.copy(), pos.copy()
    jstate = jgen.DecodeState(
        jnp.asarray(logits), jqwen.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos, jnp.int32), jnp.zeros((B,), bool),
        jnp.zeros((), jnp.int32))

    def port():
        return tgen.DecodeState(
            torch.from_numpy(logits0.copy()),
            tqwen.KVCache(torch.from_numpy(k0.copy()),
                          torch.from_numpy(v0.copy())),
            torch.from_numpy(pos0.copy()), torch.zeros(B, dtype=torch.bool),
            torch.zeros((), dtype=torch.long))
    return jstate, port


def _count_forwards(monkeypatch):
    calls = []
    real = tqwen.qwen2_forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tqwen, "qwen2_forward", counted)
    return calls


@pytest.mark.parametrize("B", [1, 3])
def test_chunked_generate_matches_per_step_loop_and_jax(models, B,
                                                        monkeypatch):
    """Chunks of 4 over 11 new tokens: the same tokens and lengths as the
    per-step loop (chunk 1) and JAX's while_loop, rows done at their own
    steps; the chunked loop stops after the chunk in which the last row
    finished."""
    jp, tp = models
    jstate, port = _state(B)
    want = jgen.generate_from_state(jp, JCFG, jstate, max_new_tokens=NEW,
                                    eos_token_id=EOS)
    calls = _count_forwards(monkeypatch)
    step = tgen.generate_from_state(tp, TCFG, port(), NEW, EOS, chunk=1,
                                    capture=False)
    per_step = len(calls)
    calls.clear()
    got = tgen.generate_from_state(tp, TCFG, port(), NEW, EOS, chunk=CHUNK,
                                   capture=False)
    for res in (step, got):
        np.testing.assert_array_equal(res.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(res.lengths.numpy(),
                                      np.asarray(want.lengths))
    lengths = got.lengths.tolist()
    last = max(lengths)
    assert last < NEW, lengths          # the EOS bias ends every row
    if B > 1:
        assert len(set(lengths)) == B, lengths
    assert per_step == last + 1
    assert len(calls) == min(-(-(last + 1) // CHUNK) * CHUNK, NEW)


def test_generate_rejects_capture_on_the_cpu(models):
    _, tp = models
    _, port = _state(1)
    with pytest.raises(ValueError, match="CUDA"):
        tgen.generate_from_state(tp, TCFG, port(), NEW, EOS, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        tgen.decode_chunk(tp, TCFG, port(), 2, EOS, capture=True)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_chunks_update_the_state_in_place(models, layout):
    """decode_chunk / paged_decode_chunk return the state they were given,
    every tensor written in place (data_ptr equal), with JAX's tokens and
    JAX's next logits, positions or lengths and done flags."""
    jp, tp = models
    B, chunk = 3, 5
    jstate, port = _state(B, seed=1)
    if layout == "dense":
        st = port()
        ptrs = [t.data_ptr() for t in dg.state_tensors(st)]
        new, toks = tgen.decode_chunk(tp, TCFG, st, chunk, EOS,
                                      capture=False)
        jnew, jtoks = jgen.decode_chunk(jp, JCFG, jstate, chunk=chunk,
                                        eos_token_id=EOS)
        pairs = ((new.pos, jnew.pos),)
    else:
        page, maxp = 8, CACHE // 8
        pos = np.asarray(jstate.pos)
        jpaged = jgen.empty_paged_state(JCFG, B, 1 + B * maxp, page, maxp,
                                        cache_dtype=jnp.float32)
        tpaged = tgen.empty_paged_state(TCFG, B, 1 + B * maxp, page, maxp,
                                        torch.float32)
        jc, tc = jpaged.cache, tpaged.cache
        dense = port().cache
        for s in range(B):
            row = np.arange(1 + s * maxp, 1 + (s + 1) * maxp, dtype=np.int32)
            sub = tqwen.KVCache(dense.k[:, s:s + 1], dense.v[:, s:s + 1])
            from video3d_tpu_torch.models import paged_kv as tpk
            tpk.transplant_dense(tc, sub, s, torch.from_numpy(row), maxp,
                                 int(pos[s]))
            jsub = jqwen.KVCache(jstate.cache.k[:, s:s + 1],
                                 jstate.cache.v[:, s:s + 1])
            from video3d_tpu.models import paged_kv as jpk
            jc = jpk.transplant_dense(jc, jsub, s, jnp.asarray(row), maxp,
                                      int(pos[s]))
        logits = port().next_logits
        st = tpaged._replace(next_logits=logits,
                             done=torch.zeros(B, dtype=torch.bool))
        # a copy: jnp.asarray may share the tensor's memory, which the
        # port's in-place chunk below overwrites
        jst = jpaged._replace(cache=jc,
                              next_logits=jnp.asarray(logits.numpy().copy()),
                              done=jnp.zeros((B,), bool))
        ptrs = [t.data_ptr() for t in dg.state_tensors(st)]
        new, toks = tgen.paged_decode_chunk(tp, TCFG, st, chunk, EOS,
                                            capture=False)
        jnew, jtoks = jgen.paged_decode_chunk(jp, JCFG, jst, chunk=chunk,
                                              eos_token_id=EOS)
        pairs = ((new.cache.lens, jnew.cache.lens),)
    assert new is st
    assert [t.data_ptr() for t in dg.state_tensors(new)] == ptrs
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(new.done.numpy(), np.asarray(jnew.done))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(new.next_logits.numpy(),
                               np.asarray(jnew.next_logits), rtol=0,
                               atol=1e-5)


def test_graph_key_fields(models):
    """Each field of the key tells graphs apart; a repeat call gives the
    same key."""
    _, tp = models
    _, port = _state(2)
    st = port()
    key = dg.graph_key("dense", tp, st, 8, EOS)
    assert dg.graph_key("dense", tp, st, 8, EOS) == key
    int8_llm = dict(tp["llm"], lm_head=quantize_weight(tp["llm"]["lm_head"]))
    paged = tgen.empty_paged_state(TCFG, 2, 9, 8, 4, torch.float32)
    variants = {
        "kind": dg.graph_key("generate", tp, st, 8, EOS),
        "slots": dg.graph_key("dense", tp, _state(3)[1](), 8, EOS),
        "chunk": dg.graph_key("dense", tp, st, 4, EOS),
        "cache_form": dg.graph_key("dense", tp, st._replace(
            cache=tqwen.KVCache.zeros(TCFG.llm, 2, CACHE, torch.bfloat16)),
            8, EOS),
        "layout": dg.graph_key("dense", tp, paged, 8, EOS),
        "weight_form": dg.graph_key("dense", {"llm": int8_llm}, st, 8, EOS),
        "cache_shape": dg.graph_key("dense", tp, st._replace(
            cache=tqwen.KVCache.zeros(TCFG.llm, 2, CACHE + 8,
                                      torch.float32)), 8, EOS),
        "storage": dg.graph_key("dense", tp, st._replace(
            pos=st.pos.clone()), 8, EOS),
        "eos": dg.graph_key("dense", tp, st, 8, EOS + 1)}
    for field, other in variants.items():
        assert other != key, field
        diff = [f for f in dg.GraphKey._fields
                if getattr(other, f) != getattr(key, f)]
        assert field in diff, (field, diff)
    assert key.cache_form == "float32" and key.layout == "dense"
    assert variants["cache_form"].cache_form == "bf16"
    assert variants["weight_form"].weight_form == "int8"


def _fake_graphs():
    """A holder whose graphs are stand-ins for ``CudaGraph``: a capture
    runs the body with every tensor of the holder's entries put back
    afterwards (a capture records, it changes nothing), a replay runs the
    recorded body again (the device work of a replay) without counting
    launches."""
    holder = None

    class FakeGraph:
        def __init__(self, stream):
            assert stream is None
            self.body = None
            self.replays = 0

        def capture(self, body):
            tensors = []
            for e in holder._entries.values():
                tensors += dg.state_tensors(e.state) if e.state else []
                tensors += list(e.toks.values())
                tensors += [e.lengths] if e.lengths is not None else []
            saved = [t.clone() for t in tensors]
            body()
            for t, v in zip(tensors, saved):
                t.copy_(v)
            self.body = body

        def replay(self):
            self.replays += 1
            with _build.capturing_launches():
                self.body()

    holder = dg.DecodeGraphs("cpu", graph_type=FakeGraph)
    return holder


def _capture_on_the_cpu(monkeypatch):
    monkeypatch.setattr(dg, "resolve_capture",
                        lambda capture, device, graphs: capture is not False
                        and graphs is not None)


def test_replays_add_the_captured_launches_once_each():
    """The warm-up's launches count once, the capture's not at all, and
    each replay adds the launches the capture recorded."""
    holder = _fake_graphs()
    entry = dg.Entry(None, None)
    runs = []

    def body():
        runs.append(1)
        _build.count_launch("paged_attention")
        _build.count_launch("paged_attention")
        _build.count_launch("int8_matmul")

    before = dict(_build.LAUNCHES)
    holder.run(entry, 2, body, lambda: (0, 0))    # warm-up and capture
    assert len(runs) == 2 and holder.captures == 1
    replay = entry.graphs[2]
    assert replay.launches == {"paged_attention": 2, "int8_matmul": 1}
    for _ in range(3):
        holder.run(entry, 2, body, lambda: (0, 0))
    assert holder.replays == 3 and replay.graph.replays == 3
    assert len(runs) == 5
    delta = {k: _build.LAUNCHES[k] - before[k] for k in before
             if _build.LAUNCHES[k] != before[k]}
    assert delta == {"paged_attention": 8, "int8_matmul": 4}


def test_replays_keep_the_buffers_they_were_captured_with():
    """A graph keeps the split buffers its stream had at its capture: a
    later warm-up that grows them (a larger batch's key) replaces them for
    the launches that follow, and the earlier graph still holds the old
    ones, so nothing it reads is freed."""
    holder = _fake_graphs()
    holder.stream_id = 0x5EED0
    small, large = dg.Entry(None, None), dg.Entry(None, None)
    try:
        holder.run(small, 2, lambda: None, lambda: (64, 4096))
        old = _launch.held("cpu", holder.stream_id)
        assert len(old) == 2
        assert small.graphs[2].buffers == old
        holder.run(large, 2, lambda: None, lambda: (100_000, 1 << 24))
        new = _launch.held("cpu", holder.stream_id)
        assert all(a is not b for a, b in zip(old, new))
        assert all(a is b for a, b in zip(small.graphs[2].buffers, old))
        assert large.graphs[2].buffers == new
        assert new[0].numel() >= 100_000 and new[1].numel() >= 1 << 22
    finally:
        _launch._counters.pop(("cpu", 0x5EED0), None)
        _launch._workspaces.pop(("cpu", 0x5EED0), None)


def test_capture_needs_a_holder():
    """By default a loop runs captured only on the card and with a holder
    to keep its graphs; asked for without one, or off the card, it
    raises."""
    holder = _fake_graphs()
    assert dg.resolve_capture(None, "cuda", holder)
    assert not dg.resolve_capture(None, "cuda", None)
    assert not dg.resolve_capture(None, "cpu", holder)
    assert not dg.resolve_capture(False, "cuda", holder)
    assert dg.resolve_capture(True, "cuda:0", holder)
    with pytest.raises(ValueError, match="holder"):
        dg.resolve_capture(True, "cuda", None)
    with pytest.raises(ValueError, match="CUDA"):
        dg.resolve_capture(True, "cpu", holder)


def test_holder_keeps_max_entries_and_counts_keys(models):
    """generate_from_state's entries, one per shape: the holder keeps the
    MAX_ENTRIES most recent, counts every key asked for and each eviction,
    and the bytes its own states hold."""
    _, tp = models
    holder = _fake_graphs()
    n = dg.MAX_ENTRIES + 1
    for B in range(1, n + 1):
        holder.bind(tp, _state(B)[1](), EOS)
    holder.bind(tp, _state(n)[1](), EOS)              # a hit
    stats = holder.stats()
    assert stats["keys"] == n and stats["entries"] == dg.MAX_ENTRIES
    assert stats["evictions"] == 1
    want = sum(t.numel() * t.element_size()
               for e in holder._entries.values()
               for t in dg.state_tensors(e.state))
    assert stats["held_state_bytes"] == want > 0
    assert min(k.slots for k in holder._entries) == 2


def test_captured_generate_host_logic_with_a_stand_in_graph(models,
                                                            monkeypatch):
    """The captured loop's host side on the CPU, graphs replaced by a
    stand-in that reruns the recorded chunk: tokens and lengths equal the
    uncaptured loop's; one graph per chunk length (4 and the remainder 3,
    no row ending: EOS -1); a second call with another state of the same
    shapes is copied into the held state and only replays, and leaves the
    caller's state alone; then rows that end stop the loop early."""
    jp, tp = models
    _capture_on_the_cpu(monkeypatch)
    holder = _fake_graphs()
    for seed, captures, eos in ((2, 2, -1), (3, 2, -1), (0, 4, EOS)):
        _, port = _state(3, seed)
        want = tgen.generate_from_state(tp, TCFG, port(), 2 * CHUNK + 3,
                                        eos, chunk=CHUNK, capture=False)
        st = port()
        pos = st.pos.clone()
        got = tgen.generate_from_state(tp, TCFG, st, 2 * CHUNK + 3, eos,
                                       chunk=CHUNK, graphs=holder)
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.lengths, want.lengths)
        assert holder.captures == captures
    assert holder.replays > 0
    assert torch.equal(st.pos, pos)      # copied into the held state
    assert len(holder._entries) == 2     # one per EOS id


def test_decode_chunk_host_logic_with_a_stand_in_graph(models, monkeypatch):
    """The batcher's captured chunk on the CPU with the stand-in graph: the
    graph adopts the state's own tensors, replays on them after an
    in-place admission, and equals the uncaptured chunk."""
    _, tp = models
    _capture_on_the_cpu(monkeypatch)
    holder = _fake_graphs()
    _, port = _state(2, seed=5)
    st, ref = port(), port()
    for i in range(3):
        if i == 2:                          # an admission between chunks
            for s in (st, ref):
                s.pos[1] = 3
                s.done[1] = False
        st, toks = tgen.decode_chunk(tp, TCFG, st, 3, EOS, graphs=holder)
        ref, want = tgen.decode_chunk(tp, TCFG, ref, 3, EOS, capture=False)
        assert torch.equal(toks, want)
        for a, b in zip(dg.state_tensors(st), dg.state_tensors(ref)):
            assert torch.equal(a, b)
    assert holder.captures == 1 and holder.replays == 2


def _meta_params(bits: int):
    """Qwen2-7B's decode weights (shapes only, on ``meta``) in the int8 or
    int4 form."""
    m = torch.device("meta")
    shapes = {"wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
              "wo": (3584, 3584), "w_gate": (3584, 18944),
              "w_up": (3584, 18944), "w_down": (18944, 3584),
              "lm_head": (3584, 152064)}

    def w(name):
        i, o = shapes[name]
        if bits == 8:
            return {"q": torch.empty(i, o, dtype=torch.int8, device=m),
                    "scale": torch.empty(1, o, device=m)}
        ip, op = -(-i // 512) * 512, -(-o // 2048) * 2048
        return Int4Weight(torch.empty(ip // 2, op, dtype=torch.int8,
                                      device=m),
                          torch.empty(ip // 512, op, device=m), (i, o), 512)
    layer = {"attn": {n: w(n) for n in ("wq", "wk", "wv", "wo")},
             "mlp": {n: w(n) for n in ("w_gate", "w_up", "w_down")}}
    return {"llm": {"layers": [layer], "lm_head": w("lm_head")}}


@pytest.mark.parametrize("bits,rows", [(8, 1), (8, 8), (4, 1), (4, 8)])
def test_step_buffers_are_the_largest_plans(bits, rows):
    """step_buffers at Qwen2-7B's shapes: the largest counters and
    workspace of B3's plan and of every weight-streaming plan the step
    launches (the one-row int8 head through B4's matvec)."""
    from video3d_tpu_torch.config import ModelConfig

    params = _meta_params(bits)
    sms, cap = 132, 8704
    want_c = decode_plan(rows, 4, cap, sms).counters
    want_w = decode_plan(rows, 4, cap, sms).workspace_bytes
    llm = params["llm"]
    for w in (*llm["layers"][0]["attn"].values(),
              *llm["layers"][0]["mlp"].values(), llm["lm_head"]):
        if bits == 4:
            p = qm.stream_plan(rows, 2 * w.q4.shape[0], w.q4.shape[1], sms, 4)
        elif rows == 1 and w["q"].shape[1] >= 32768:
            p = qm.matvec_plan(*w["q"].shape, sms)
        else:
            p = qm.stream_plan(rows, *w["q"].shape, sms, 8)
        if p.workspace_bytes:
            want_c = max(want_c, p.tiles * qm.STREAM_PAIRS)
            want_w = max(want_w, p.workspace_bytes)
    got = dg.step_buffers(params, ModelConfig(), rows, cap, sms)
    assert got == (want_c, want_w)
    assert got[1] > decode_plan(rows, 4, cap, sms).workspace_bytes


def test_reserve_sizes_the_buffers_and_growth_during_capture_raises(
        monkeypatch):
    stream = 0x5EED
    try:
        _launch.reserve("cpu", stream, 300, 4096 * 4)
        counters = _launch.arrival_counters("cpu", stream, 300)
        ws = _launch.workspace("cpu", stream, 4096 * 4)
        assert counters.numel() >= 300 and ws.numel() >= 4096
        assert bool((counters == 0).all())
        monkeypatch.setattr(_launch, "_capturing", lambda: True)
        assert _launch.arrival_counters("cpu", stream, 300) is counters
        assert _launch.workspace("cpu", stream, 1024) is ws
        with pytest.raises(RuntimeError, match="reserve"):
            _launch.arrival_counters("cpu", stream, counters.numel() + 1)
        with pytest.raises(RuntimeError, match="reserve"):
            _launch.workspace("cpu", stream, ws.numel() * 4 + 4)
        assert _launch.arrival_counters("cpu", stream, 300) is counters
    finally:
        _launch._counters.pop(("cpu", stream), None)
        _launch._workspaces.pop(("cpu", stream), None)
