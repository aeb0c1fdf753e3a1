"""Speculative decoding of the port (``models/speculative.py`` and the
engine's speculative paths) against the JAX package on the CPU, at
``ModelConfig.tiny()`` in float32:

* greedy ``generate_speculative`` with a perfect draft (every layer) and a
  bad one (one layer), at K in {1, 3, 5}, B=2 with unequal prompts: tokens
  and lengths equal JAX's ``generate_speculative`` and ``generate_greedy``
  and the port's ``generate_greedy`` exactly;
* a separate draft model, a truncated draft vocabulary, top_k = 1
  sampling and an int8 KV cache all stay greedy-exact;
* ``accept_truncate`` and ``spec_decode_chunk``'s greedy emissions and
  kept masks equal JAX's;
* ``rejection_sample_block``'s law (V=5, K=2, 200k rows, atol 0.01, as
  JAX's ``test_block_marginals_match_target``) and the p == q case;
* sampled rounds are a function of (seed, round, row): the one-shot loop
  and the chunked slot loop draw the same tokens, inside the warped
  support, within the budget;
* the engine's speculative answers equal the JAX engine's (full prefill,
  the self-draft scene-prefix path, an attached draft), and the
  min-acceptance guard demotes to plain decoding;
* a slot running past the end of its cache row writes at the row's end
  instead of failing.

Exact token equality holds in f32 here because the verify block's logits
and a one-token step's logits agree to rounding and the tiny model's
random logits have no near-ties at that scale."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.constants import IMAGE_TOKEN_INDEX
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import speculative as jspec
from video3d_tpu.models.splice import build_splice_plan
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.models import speculative as tspec
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
EOS = 7
N_NEW = 12
LAYERS = CFG.llm.num_hidden_layers


def _batches(ids_list, max_len, seed=0):
    rng = np.random.default_rng(seed)
    B, V, S = len(ids_list), 2, CFG.vision.image_size
    g = -(-CFG.vision.num_patches_per_side // CFG.spatial_pool_stride)
    images = rng.normal(size=(B, V, 3, S, S)).astype(np.float32)
    coords = rng.uniform(0, 50, size=(B, V, g, g, 3)).astype(np.float32)
    plan = build_splice_plan(ids_list, None, [V] * B,
                             tokens_per_frame=CFG.tokens_per_frame,
                             max_len=max_len, grid_side=g)
    jb = jlv.Batch(
        images=jnp.asarray(images), patch_coords=jnp.asarray(coords),
        text_ids=jnp.asarray(plan.text_ids), kind=jnp.asarray(plan.kind),
        vision_index=jnp.asarray(plan.vision_index),
        labels=jnp.asarray(plan.labels),
        position_ids=jnp.asarray(plan.position_ids),
        mrope_position_ids=jnp.asarray(plan.mrope_position_ids),
        seq_len=jnp.asarray(plan.seq_len))

    def t(a):
        return torch.from_numpy(np.asarray(a)).long()

    tb = tlv.Batch(images=torch.from_numpy(images),
                   patch_coords=torch.from_numpy(coords),
                   text_ids=t(plan.text_ids), kind=t(plan.kind),
                   vision_index=t(plan.vision_index),
                   position_ids=t(plan.position_ids), seq_len=t(plan.seq_len))
    return jb, tb


@pytest.fixture(scope="module")
def setup():
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu")
    T = CFG.tokens_per_frame
    jb, tb = _batches([[3, 4, IMAGE_TOKEN_INDEX, 5, 6],
                       [9, IMAGE_TOKEN_INDEX, 11, 12, 13, 14, 15]],
                      8 + 2 * T + 6)
    want = np.asarray(jgen.generate_greedy(
        params, CFG, jb, max_new_tokens=N_NEW, eos_token_id=EOS,
        cache_dtype=jnp.float32).tokens)
    return params, tparams, jb, tb, want


def _port_spec(tparams, tb, k, K, cache=torch.float32, draft_vocab=0,
               **kw):
    return tspec.generate_speculative(
        tparams, tspec.self_draft_params(tparams, k, draft_vocab), TCFG,
        tspec.self_draft_config(TCFG.llm, k), tb, num_draft_tokens=K,
        max_new_tokens=N_NEW, eos_token_id=EOS, cache_dtype=cache, **kw)


@pytest.mark.parametrize("k", [LAYERS, 1], ids=["perfect", "bad"])
@pytest.mark.parametrize("K", [1, 3, 5])
def test_greedy_matches_jax_and_vanilla(setup, k, K):
    """Greedy speculation emits the target's greedy ids: the port's tokens
    and lengths equal JAX's ``generate_speculative``, JAX's and the port's
    ``generate_greedy``, exactly. A perfect draft accepts everything (at
    most ceil(N/(K+1)) + 2 target forwards); a bad one needs at most one
    forward per token."""
    params, tparams, jb, tb, want = setup
    jres = jspec.generate_speculative(
        params, jspec.self_draft_params(params, k), CFG,
        jspec.self_draft_config(CFG.llm, k), jb, num_draft_tokens=K,
        max_new_tokens=N_NEW, eos_token_id=EOS, cache_dtype=jnp.float32)
    res = _port_spec(tparams, tb, k, K)
    vanilla = tgen.generate_greedy(tparams, TCFG, tb, N_NEW, EOS,
                                   cache_dtype=torch.float32)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    np.testing.assert_array_equal(res.tokens.numpy(), vanilla.tokens.numpy())
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(jres.lengths))
    assert res.target_forwards == int(jres.target_forwards)
    assert res.accepted_drafts == int(jres.accepted_drafts)
    assert res.offered_drafts == int(jres.offered_drafts)
    if k == LAYERS:
        assert res.target_forwards <= 1 + -(-N_NEW // (K + 1)) + 1
        assert res.accepted_drafts == res.offered_drafts
    assert res.target_forwards <= N_NEW + 1


@pytest.mark.parametrize("variant", ["separate_draft", "draft_vocab",
                                     "top_k_1", "top_k_1_draft_vocab"])
def test_variants_stay_greedy_exact(setup, variant):
    """A standalone draft (other weights), a draft head cut to 8 tokens,
    and sampling at top_k = 1 (the warped laws collapse to the argmax)
    all give the greedy ids."""
    params, tparams, jb, tb, want = setup
    if variant == "separate_draft":
        draft = jlv.init_model(jax.random.PRNGKey(1), CFG)
        tdraft = from_jax_params(jax.tree.map(np.asarray, draft), TCFG,
                                 device="cpu")["llm"]
        res = tspec.generate_speculative(
            tparams, tdraft, TCFG, TCFG.llm, tb, num_draft_tokens=3,
            max_new_tokens=N_NEW, eos_token_id=EOS,
            cache_dtype=torch.float32)
    else:
        vocab = 8 if "draft_vocab" in variant else 0
        kw = dict(temperature=0.7, top_k=1, seed=5) \
            if "top_k" in variant else {}
        res = _port_spec(tparams, tb, 1, 3, draft_vocab=vocab, **kw)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_int8_cache_matches_vanilla_int8():
    """Over an int8 cache the verify block attends the quantized cache
    through the folded path: the ids equal the port's vanilla int8 decode
    and JAX's speculative int8 decode."""
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu")
    jb, tb = _batches([[3, 4, IMAGE_TOKEN_INDEX, 5]],
                      6 + 2 * CFG.tokens_per_frame + 4)
    jres = jspec.generate_speculative(
        params, jspec.self_draft_params(params, 1), CFG,
        jspec.self_draft_config(CFG.llm, 1), jb, num_draft_tokens=3,
        max_new_tokens=8, eos_token_id=EOS, cache_dtype=jnp.int8)
    res = tspec.generate_speculative(
        tparams, tspec.self_draft_params(tparams, 1), TCFG,
        tspec.self_draft_config(TCFG.llm, 1), tb, num_draft_tokens=3,
        max_new_tokens=8, eos_token_id=EOS, cache_dtype=torch.int8)
    vanilla = tgen.generate_greedy(tparams, TCFG, tb, 8, EOS,
                                   cache_dtype=torch.int8)
    np.testing.assert_array_equal(res.tokens.numpy(), vanilla.tokens.numpy())
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))


def test_accept_truncate_matches_jax():
    """Random emissions, acceptance counts, done rows and EOS placements:
    keep, is_eos and idx equal JAX's."""
    rng = np.random.default_rng(3)
    B, K = 64, 4
    emit = rng.integers(0, 6, (B, K + 1))
    a = rng.integers(0, K + 1, B)
    done = rng.random(B) < 0.2
    want = jspec.accept_truncate(jnp.asarray(emit), jnp.asarray(a),
                                 jnp.asarray(done), 3, K)
    got = tspec.accept_truncate(torch.from_numpy(emit), torch.from_numpy(a),
                                torch.from_numpy(done), 3, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.broadcast_to(g.numpy(), w.shape),
                                      np.asarray(w))


def test_spec_decode_chunk_matches_jax(setup):
    """The batcher's slot loop, greedy: spec_start on each row, both rows
    grafted into a 3-slot state (slot 1 left empty), two chunks of 3
    rounds: ``emit`` and ``keep`` equal JAX's ``spec_decode_chunk`` on the
    same slots, and so do cur, pos and done."""
    params, tparams, jb, tb, _ = setup
    k, K, mcl = 1, 3, 64
    jd, jc = jspec.self_draft_params(params, k), \
        jspec.self_draft_config(CFG.llm, k)
    td, tc = tspec.self_draft_params(tparams, k), \
        tspec.self_draft_config(TCFG.llm, k)
    jslots = jspec.empty_spec_slots(CFG, jc, 3, mcl, cache_dtype=jnp.float32)
    tslots = tspec.empty_spec_slots(TCFG, tc, 3, mcl,
                                    cache_dtype=torch.float32)
    for row, slot in ((0, 0), (1, 2)):
        jsub, _ = jspec.spec_start(
            params, jd, CFG, jc, jax.tree.map(lambda x: x[row:row + 1], jb),
            max_cache_len=mcl, cache_dtype=jnp.float32)
        jslots = jspec.insert_spec_slot(jslots, jnp.asarray(slot), jsub)
        tsub, _ = tspec.spec_start(
            tparams, td, TCFG, tc,
            tlv.Batch(*(None if x is None else x[row:row + 1] for x in tb)),
            mcl, torch.float32)
        tslots = tspec.insert_spec_slot(tslots, slot, tsub)
    for _ in range(2):
        jslots, jemit, jkeep = jspec.spec_decode_chunk(
            params, jd, CFG, jc, jslots, iters=3, num_draft_tokens=K,
            eos_token_id=EOS)
        tslots, temit, tkeep = tspec.spec_decode_chunk(
            tparams, td, TCFG, tc, tslots, iters=3, num_draft_tokens=K,
            eos_token_id=EOS)
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(
            np.where(tkeep.numpy(), temit.numpy(), -1),
            np.where(np.asarray(jkeep), np.asarray(jemit), -1))
        for name in ("cur", "pos", "done"):
            np.testing.assert_array_equal(
                getattr(tslots, name).numpy()[[0, 2]],
                np.asarray(getattr(jslots, name))[[0, 2]], err_msg=name)


def test_rejection_sampling_law():
    """The speculative-sampling theorem by Monte-Carlo over 200k rows (one
    row per draw: the draws hash the row): the first emission follows
    t_probs[0], the second, given the first draft accepted, t_probs[1]
    (the test's distributions do not depend on the prefix), atol 0.01 as
    JAX's test. With q == p every draft is accepted and the bonus
    follows t_probs[K]."""
    V, K, N = 5, 2, 200_000
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.ones(V), size=(1, K)).astype(np.float32)
    t = rng.dirichlet(np.ones(V), size=(1, K + 1)).astype(np.float32)
    d = np.stack([rng.choice(V, size=N, p=q[0, i] / q[0, i].sum())
                  for i in range(K)], 1)
    qt = torch.from_numpy(q).expand(N, K, V)
    tt = torch.from_numpy(t).expand(N, K + 1, V)
    emit, a = tspec.rejection_sample_block(
        torch.from_numpy(d), qt, tt, seed=1,
        step=torch.tensor(3, dtype=torch.long))
    emit, a = emit.numpy(), a.numpy()
    np.testing.assert_allclose(np.bincount(emit[:, 0], minlength=V) / N,
                               t[0, 0], atol=0.01)
    sel = a >= 1
    np.testing.assert_allclose(
        np.bincount(emit[sel, 1], minlength=V) / sel.sum(), t[0, 1],
        atol=0.01)
    # p == q: the acceptance probability is 1 everywhere
    same = torch.from_numpy(np.concatenate([q, t[:, -1:]], 1)) \
        .expand(N, K + 1, V)
    emit, a = tspec.rejection_sample_block(
        torch.from_numpy(d), qt, same, seed=2,
        step=torch.tensor(0, dtype=torch.long))
    assert (a.numpy() == K).all()
    np.testing.assert_array_equal(emit[:, :K].numpy(), d)
    np.testing.assert_allclose(
        np.bincount(emit[:, K].numpy(), minlength=V) / N, t[0, -1],
        atol=0.01)


def test_sampled_rounds_draw_alike(setup):
    """Sampled speculation (temperature 0.9, top-p 0.9) is a function of
    (seed, round, row): the one-shot loop of row 0 and its chunked slot
    loop (spec_start, chunks of 2 rounds) emit the same tokens; every token
    lies inside its position's warped target support (a teacher-forced
    recompute over the emitted ids); lengths stay within the budget."""
    _, tparams, _, tb, _ = setup
    kw = dict(temperature=0.9, top_p=0.9, top_k=0, seed=11)
    k, K = 1, 3
    one = tlv.Batch(*(None if x is None else x[:1] for x in tb))
    res = _port_spec(tparams, one, k, K, **kw)
    n = int(res.lengths[0])
    assert 0 < n <= N_NEW
    td, tc = tspec.self_draft_params(tparams, k), \
        tspec.self_draft_config(TCFG.llm, k)
    sub, first = tspec.spec_start(tparams, td, TCFG, tc, one, 64,
                                  torch.float32, **kw)
    got = [int(first[0])]
    while len(got) < N_NEW and not bool(sub.done[0]):
        sub, emit, keep = tspec.spec_decode_chunk(
            tparams, td, TCFG, tc, sub, iters=2, num_draft_tokens=K,
            eos_token_id=EOS, **kw)
        got += emit[0][keep[0]].tolist()
    got = got[:N_NEW]
    assert got[:n] == res.tokens[0, :n].tolist()
    # teacher-forced support check: feed the emitted ids one at a time
    state = tgen.start_decode(tparams, TCFG, one, 64,
                              cache_dtype=torch.float32)
    logits = state.next_logits
    for i, tok in enumerate(res.tokens[0, :n].tolist()):
        warped = tgen.warp_logits(logits, kw["temperature"], kw["top_p"])
        assert torch.isfinite(warped[0, tok]), i
        pos = state.pos + i
        with torch.inference_mode():
            h = tgen.qwen2.qwen2_forward(
                tparams["llm"], TCFG.llm,
                tgen.qwen2.embed_tokens(tparams["llm"],
                                        torch.tensor([[tok]])),
                tgen._decode_position_ids(pos[:, None]),
                kv_cache=state.cache, cache_positions=pos[:, None],
                kv_len=pos + 1)
            logits = tgen.qwen2.lm_head(tparams["llm"], h)[:, 0]


# ---------------------------------------------------------------------------
# the engine
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
    return info, data_cfg, params, from_jax_params(
        jax.tree.map(np.asarray, params), TCFG, device="cpu")


def _ecfg(module, tok, **kw):
    return module.EngineConfig(
        max_new_tokens=6, eos_token_id=tok.eos_token_id, max_frames=3,
        buckets=(256,), stop_str="", suffix_buckets=(32, 64), **kw)


def _engines(scene, **kw):
    info, data_cfg, params, tparams = scene
    tok, jtok = FakeTokenizer(), FakeTokenizer()
    eng = tdrv.InferenceEngine(
        tparams, TCFG, tok, TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, tok, **kw), device="cpu")
    jeng = jdrv.InferenceEngine(
        params, CFG, jtok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, jtok, **kw), device_geometry=True)
    return eng, jeng


def _record(info, question, i=0):
    return {"id": f"q{i}", "video": info["sample_idx"],
            "conversations": [{"from": "human",
                               "value": f"<image>\n{question}"},
                              {"from": "gpt", "value": "x"}],
            "metadata": {"dataset": "scanqa"}}


@pytest.mark.parametrize("mode", ["full", "prefix", "attached_draft"])
def test_engine_answers_match_jax(scene, mode):
    """``generate_answer`` with speculation on answers as the JAX engine
    and as the port's plain engine: a 1-layer self-draft over full
    prefills; the self-draft through the scene-prefix cache (a miss that
    stores the prefix, then hits whose suffix prefill seeds both caches;
    ``prefix_cache_stats`` as JAX's); a separate draft attached with
    ``set_draft_model``."""
    info = scene[0]
    kw = dict(speculative_draft_layers=1, speculative_k=3)
    if mode == "prefix":
        kw["prefix_cache_scenes"] = 1
    if mode == "attached_draft":
        kw = dict(speculative_k=2)
    eng, jeng = _engines(scene, **kw)
    plain, _ = _engines(scene)
    if mode == "attached_draft":
        draft = jlv.init_model(jax.random.PRNGKey(1), CFG)
        jeng.set_draft_model(draft["llm"], CFG.llm)
        eng.set_draft_model(from_jax_params(jax.tree.map(np.asarray, draft),
                                            TCFG, device="cpu")["llm"],
                            TCFG.llm)
    recs = [_record(info, q, i) for i, q in enumerate(QUESTIONS)]
    want = [jeng.generate_answer(r) for r in recs]
    got = [eng.generate_answer(r) for r in recs]
    assert got == want
    assert got == [plain.generate_answer(r) for r in recs]
    assert eng.prefix_cache_stats == jeng.prefix_cache_stats
    assert eng.spec_stats[1] > 0
    if mode == "prefix":
        assert eng.prefix_cache_stats == [2, 1]


def test_run_generative_spec_prefix_matches_jax(scene, tmp_path):
    """``run_generative`` at batch size 1 with a self-draft and the prefix
    cache on goes through the speculative prefix path: the same jsonl
    answers as the JAX driver."""
    import json

    info = scene[0]
    kw = dict(speculative_draft_layers=2, speculative_k=2,
              prefix_cache_scenes=1)
    eng, jeng = _engines(scene, **kw)
    recs = [_record(info, q, i) for i, q in enumerate(QUESTIONS)]
    for e in (eng, jeng):
        for r in recs:
            e._tokenize_prompt(r)
    tdrv.run_generative(eng, recs, str(tmp_path / "t.jsonl"))
    jdrv.run_generative(jeng, recs, str(tmp_path / "j.jsonl"))

    def answers(name):
        with open(tmp_path / name) as f:
            return {r["sample_id"]: r["pred_response"]
                    for r in map(json.loads, f)}

    assert answers("t.jsonl") == answers("j.jsonl")
    assert eng.prefix_cache_stats == [2, 1]


def test_min_acceptance_demotes(scene):
    """A one-layer self-draft that is rarely right, under a
    ``speculative_min_acceptance`` of 0.99: after enough offered drafts
    the guard turns speculation off, later answers take the plain path
    (no new offered drafts), and every answer is the plain engine's."""
    info = scene[0]
    eng, _ = _engines(scene, speculative_draft_layers=1, speculative_k=4,
                      speculative_min_acceptance=0.99)
    plain, _ = _engines(scene)
    recs = [_record(info, q, i) for i, q in enumerate(QUESTIONS * 2)]
    want = [plain.generate_answer(r) for r in recs]
    got = []
    for r in recs:
        got.append(eng.generate_answer(r))
        if eng._spec_disabled:
            break
    assert eng._spec_disabled
    offered = eng.spec_stats[1]
    got += [eng.generate_answer(r) for r in recs[len(got):]]
    assert eng.spec_stats[1] == offered
    assert got == want


def test_self_draft_shares_tensors(scene):
    """The self-draft's layers are the target's own tensors and the cut
    head is a view of the target's."""
    eng, _ = _engines(scene, speculative_draft_layers=1,
                      speculative_draft_vocab=8)
    dp, dc = eng._self_draft()
    assert dp["layers"][0] is eng.params["llm"]["layers"][0]
    assert dp["lm_head"].shape[1] == 8
    assert dp["lm_head"].data_ptr() == eng.params["llm"]["lm_head"].data_ptr()
    assert dc.num_hidden_layers == 1
    assert tspec._shares_layers(eng.params, dp)


def test_rows_past_their_cache_row(setup):
    """A slot that decodes past the end of its cache row (a batcher slot
    past its budget inside a chunk) writes its blocks at the row's last
    K+1 slots instead of failing (JAX drops such writes): 8 rounds over
    rows of max seq_len + 8 slots run, the positions pass the row's end,
    and the rounds that fit emit what the same rounds over long rows
    emit."""
    _, tparams, _, tb, _ = setup
    k, K, rounds = 1, 3, 8
    td, tc = tspec.self_draft_params(tparams, k), \
        tspec.self_draft_config(TCFG.llm, k)
    short = int(tb.seq_len.max()) + 8
    runs = {}
    for mcl in (short, 64):
        slots = tspec.empty_spec_slots(TCFG, tc, 2, mcl,
                                       cache_dtype=torch.float32)
        for row in range(2):
            sub, _ = tspec.spec_start(
                tparams, td, TCFG, tc,
                tlv.Batch(*(None if x is None else x[row:row + 1]
                            for x in tb)), mcl, torch.float32)
            tspec.insert_spec_slot(slots, row, sub)
        slots, emit, keep = tspec.spec_decode_chunk(
            tparams, td, TCFG, tc, slots, iters=rounds, num_draft_tokens=K,
            eos_token_id=-1)
        runs[mcl] = (slots.pos.clone(), torch.where(keep, emit, -1))
    assert (runs[short][0] > short - (K + 1)).all()
    fits = 2           # rounds of at most K+1 tokens from seq_len <= short-8
    assert torch.equal(runs[short][1][:, :fits], runs[64][1][:, :fits])
