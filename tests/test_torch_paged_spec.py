"""Paged KV cache with speculative decoding in the port, on the CPU:

* the multi-token paged block (``qwen2_forward`` over the pools with L > 1,
  the speculative verify) equals the dense cache's per-row block over the
  same values, f32 / int8 / int4, within 1e-5, and ``lens`` advances by L;
* ``paged_attention_multi`` equals JAX's on the same numpy pools (f32,
  int8, JAX's ``jnp.int4`` against the port's packed bytes) within 1e-5;
* dead slots write only the scratch page and keep their length;
* the speculative continuous batcher, dense and paged (bf16 and int8
  pools, shared scene-prefix pages through the self-draft prefix path),
  answers as the sequential plain engine and returns every page;
* an admission that finds too few pages waits until one finishes."""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.kernels import paged_attention as jpa
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.kernels import paged_attention as tpa
from video3d_tpu_torch.models import paged_kv as tpk
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert, from_jax_params
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config
from test_torch_paged_kv import (CFG as LCFG, DTYPES, FORMS, HD, KV, H,
                                 TCFG as LTCFG, _jax, _pools, _port, _tables,
                                 t)

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)


def _layer_params():
    return _convert(jax.tree.map(np.asarray, jqwen.init_qwen2(
        jax.random.PRNGKey(2), LCFG)), "cpu", None)


@pytest.mark.parametrize("form", FORMS)
def test_block_matches_dense(form):
    """Three slots prefilled densely (lengths 20, 13, 7), their rows copied
    into shuffled pool pages; a 4-token block per slot at its own offset
    through the dense per-row path and through the pools: hidden states
    within 1e-5 (f32 model; the caches hold the same values), ``lens``
    advanced by 4, and the pools hold the dense rows' values."""
    rng = np.random.default_rng(9)
    params = _layer_params()
    S, L0, K1, PAGE = 3, 20, 4, 16
    D = LCFG.hidden_size
    dt = DTYPES[form][1]
    dense = tqwen.KVCache.zeros(LTCFG, S, 2 * PAGE, dtype=dt)
    lens0 = torch.tensor([20, 13, 7])
    x0 = t(rng.standard_normal((S, L0, D)).astype(np.float32))
    pos = torch.arange(L0)[None].expand(S, L0)
    tqwen.qwen2_forward(params, LTCFG, x0, pos[..., None].expand(S, L0, 3),
                        kv_cache=dense, cache_positions=pos, kv_len=lens0,
                        prefill=True)
    pool = tpk.PagedKVCache.zeros(LTCFG, 1 + S * 2, PAGE, S, 2, dtype=dt)
    pages = rng.permutation(np.arange(1, 1 + S * 2)).reshape(S, 2)
    for s in range(S):
        sub = tqwen.KVCache(*(None if a is None else a[:, s:s + 1]
                              for a in dense))
        tpk.transplant_dense(pool, sub, s, t(pages[s].astype(np.int32)), 2,
                             int(lens0[s]))
    bpos = lens0[:, None] + torch.arange(K1)
    x = t(rng.standard_normal((S, K1, D)).astype(np.float32))
    p3 = bpos[..., None].expand(S, K1, 3)
    hd = tqwen.qwen2_forward(params, LTCFG, x, p3, kv_cache=dense,
                             cache_positions=bpos, kv_len=lens0 + K1)
    hp = tqwen.qwen2_forward(params, LTCFG, x, p3, paged_cache=pool)
    np.testing.assert_allclose(hp.numpy(), hd.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(pool.lens, (lens0 + K1).int())
    for s in range(S):
        n = int(lens0[s]) + K1
        for name in ("k", "v"):
            rows = getattr(pool, name)[:, torch.from_numpy(pages[s])] \
                .reshape(LCFG.num_hidden_layers, -1,
                         getattr(pool, name).shape[-1])[:, :n]
            assert torch.equal(rows, getattr(dense, name)[:, s, :n])


@pytest.mark.parametrize("form", FORMS)
def test_paged_attention_multi_matches_jax(form):
    """Layer 1 of stacked pools, shuffled tables with ragged lengths and an
    empty slot, 3 queries per slot at positions lens - 3 .. lens - 1 (the
    empty slot's are negative: every key masked, as in JAX): the port's
    gather equals JAX's ``paged_attention_multi`` within 1e-5."""
    rng = np.random.default_rng(4)
    B, NL, layer, L = 4, 2, 1, 3
    table, lens, P = _tables(rng, "shuffled", B)
    k, v, ks, vs = _pools(rng, NL, P, form)
    q = rng.standard_normal((B, L, H, HD)).astype(np.float32)
    qpos = lens[:, None] - L + np.arange(L)[None]
    got = tpa.paged_attention_multi(
        t(q), _port(k, form), _port(v, form), t(table), t(qpos), layer,
        None if ks is None else t(ks), None if vs is None else t(vs))
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks[layer]),
                                        v_scale=jnp.asarray(vs[layer]))
    want = jpa.paged_attention_multi(
        jnp.asarray(q), _jax(k[layer], form), _jax(v[layer], form),
        jnp.asarray(table), jnp.asarray(qpos), kv_heads=KV, **scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dead_slots_write_only_scratch():
    """A 3-token block with slot 1 dead: slot 0's lens goes 4 -> 7, slot
    1's stays 7, slot 1's pages stay zero and the scratch page 0 took its
    writes."""
    params = _layer_params()
    S, K1 = 2, 3
    pool = tpk.PagedKVCache.zeros(LTCFG, 5, 16, S, 2, dtype=torch.float32)
    pool.page_table.copy_(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    pool.lens.copy_(torch.tensor([4, 7], dtype=torch.int32))
    bpos = pool.lens.long()[:, None] + torch.arange(K1)
    x = torch.randn(S, K1, LCFG.hidden_size,
                    generator=torch.Generator().manual_seed(1))
    tqwen.qwen2_forward(params, LTCFG, x, bpos[..., None].expand(S, K1, 3),
                        paged_cache=pool,
                        paged_active=torch.tensor([True, False]))
    assert pool.lens.tolist() == [7, 7]
    assert not pool.k[:, 3:5].any() and not pool.v[:, 3:5].any()
    assert pool.k[:, 0, 0].any()
    assert pool.k[:, 1, 4:7].any()


# ---------------------------------------------------------------------------
# the speculative continuous batcher
# ---------------------------------------------------------------------------

QUESTIONS = ("what color is the chair", "how many tables are there",
             "where is the lamp")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=3)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    return info, data_cfg, from_jax_params(jax.tree.map(np.asarray, params),
                                           TCFG, device="cpu")


def _engine(scene, **kw):
    _, data_cfg, tparams = scene
    tok = FakeTokenizer()
    return tdrv.InferenceEngine(
        tparams, TCFG, tok, TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        tdrv.EngineConfig(max_new_tokens=6, eos_token_id=tok.eos_token_id,
                          max_frames=3, buckets=(256,), stop_str="",
                          suffix_buckets=(32, 64), **kw), device="cpu")


def _record(info, question):
    return {"video": info["sample_idx"],
            "conversations": [{"from": "human",
                               "value": f"<image>\n{question}"},
                              {"from": "gpt", "value": None}]}


def _wait(pred, seconds=60):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


SPEC_MODES = {
    "dense": dict(batcher=dict(paged=False), engine={}),
    "paged": dict(batcher=dict(paged=True, page_size=128), engine={}),
    "paged_int8": dict(batcher=dict(paged=True, page_size=128),
                       engine=dict(kv_cache_dtype="int8")),
    "paged_shared_prefix": dict(batcher=dict(paged=True, page_size=8),
                                engine=dict(prefix_cache_scenes=1)),
}


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_spec_batcher_matches_sequential(scene, mode):
    """Three requests through two speculative slots (a 1-layer self-draft,
    K=2, chunks of 2 rounds) answer as the plain engine one at a time
    (the same cache form). Paged: every page is back after the last
    request. With the prefix cache on, the first request stores the
    prefix and the others seed both caches from it and share its pages."""
    info = scene[0]
    m = SPEC_MODES[mode]
    plain = _engine(scene, **m["engine"])
    records = [_record(info, q) for q in QUESTIONS]
    want = [plain.generate_answer(r) for r in records]
    eng = _engine(scene, speculative_draft_layers=1, speculative_k=2,
                  **m["engine"])
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, **m["batcher"])
    try:
        assert b.spec and b.chunk_prefill == 0
        if mode == "paged_shared_prefix":
            got = [b.submit(records[0]).result(eng._decode_text,
                                               timeout=300)]
            handles = [b.submit(r) for r in records[1:]]
        else:
            got, handles = [], [b.submit(r) for r in records]
        got += [h.result(eng._decode_text, timeout=300) for h in handles]
        assert got == want
        if b.paged:
            assert _wait(lambda: all(s is None for s in b.slots))
            held = sum(len(sh["pages"]) for sh in b._shared.values())
            assert b._alloc.available + held == b.total_pages - 1
            assert all(p is None for p in b._slot_pages)
        if mode == "paged_shared_prefix":
            assert eng.prefix_cache_stats == [2, 1]
            assert b.prefix_share_stats == [2, 1]
    finally:
        b.shutdown()


def test_deferred_admission_under_page_pressure(scene):
    """A pool of one request's pages (bucket 256 + 6 new + chunk 2 + K+2
    at pages of 128: 3 pages, the pool 1 + 3) defers the second admission
    until the first finishes; both answers are right."""
    info = scene[0]
    plain = _engine(scene)
    records = [_record(info, q) for q in QUESTIONS[:2]]
    want = [plain.generate_answer(r) for r in records]
    eng = _engine(scene, speculative_draft_layers=1, speculative_k=2)
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=128, total_pages=4)
    try:
        assert b.max_pages == 3
        handles = [b.submit(r) for r in records]
        got = [h.result(eng._decode_text, timeout=300) for h in handles]
    finally:
        b.shutdown()
    assert got == want


def test_batcher_demotes_on_low_acceptance(scene):
    """``speculative_min_acceptance`` 0.99 with a 1-layer self-draft: after
    20 K offered drafts the batcher demotes itself to plain decoding at an
    idle boundary, with a new state; later answers are still the plain
    engine's."""
    info = scene[0]
    plain = _engine(scene)
    records = [_record(info, q) for q in QUESTIONS * 4]
    want = [plain.generate_answer(r) for r in records]
    eng = _engine(scene, speculative_draft_layers=1, speculative_k=2,
                  speculative_min_acceptance=0.99)
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=4)
    try:
        state0 = b.state
        got = []
        for r in records:
            got.append(b.submit(r).result(eng._decode_text, timeout=300))
            if not b.spec:
                break
        assert b._spec_demote
        got += [b.submit(r).result(eng._decode_text, timeout=300)
                for r in records[len(got):]]
        assert not b.spec and b.state is not state0
        assert got == want
    finally:
        b.shutdown()
