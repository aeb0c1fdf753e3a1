"""Sampling in the port's decode loops (``models/generate.py``) against the
JAX package's on the CPU:

* ``warp_logits`` against JAX's (temperature, top-k with tied logits,
  top-p at an exact boundary and inside a tie, all combined): the same
  -inf mask and the kept values within 1e-6;
* ``temperature=0`` is the argmax (first maximum);
* a seeded draw follows the softmax of the warped logits: 40000 rows of
  the same logits drawn at one step, and one row over 4000 steps, pass a
  chi-square test at p = 1e-4 against the warped probabilities (the draw
  is a fixed function of seed, step and row, so the verdict is fixed too),
  and no draw falls outside the warped support;
* the draw depends on the seed and the step and on nothing else: a
  sampled ``generate_from_state`` in chunks of 8 gives the per-step loop's
  tokens (chunk 1), and so do two decode chunks of 3 against one of 6;
  every sampled token lies inside its step's warped support;
* a greedy and a sampled decode never share a captured graph's key;
* the engine at ``temperature=0`` (top-p / top-k set, inert) gives the
  JAX engine's tokens.

Torch and JAX draw different streams (Gumbel-max over a counter hash
against ``jax.random.categorical``), so sampled tokens are held to the
warped distribution, never to JAX's tokens."""

import os

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import decode_graph as dg
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert, from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
EOS = 73
CACHE = 64
P_VALUE = 1e-4


def _warp_pair(logits, temperature, top_p, top_k):
    want = np.asarray(jgen.warp_logits(jnp.asarray(logits), temperature,
                                       top_p, top_k))
    got = tgen.warp_logits(torch.from_numpy(logits), temperature, top_p,
                           top_k).numpy()
    return got, want


def _exact_boundary():
    """Logits whose softmax is [1/2, 1/4, 1/8, 1/8] exactly in float32 (the
    logits are log2 multiples, the largest 0): at top_p 0.75 the
    cumulative sum equals top_p at the second token."""
    return np.log(np.asarray([[4.0, 2.0, 1.0, 1.0]], np.float32)) \
        .astype(np.float32) - np.float32(np.log(4.0))


CASES = {
    "temperature": dict(temperature=0.7, top_p=1.0, top_k=0),
    "top_k_ties": dict(temperature=1.0, top_p=1.0, top_k=3),
    "top_p_boundary": dict(temperature=1.0, top_p=0.75, top_k=0),
    "top_p_in_tie": dict(temperature=1.0, top_p=0.5, top_k=0),
    "combined": dict(temperature=0.7, top_p=0.9, top_k=50),
}


def _case_logits(name):
    rng = np.random.default_rng(len(name))
    if name == "top_p_boundary":
        return _exact_boundary()
    logits = rng.normal(size=(3, 200)).astype(np.float32) * 2
    if name == "top_k_ties":
        # the 3rd and 4th largest logits of row 0 tie: both stay
        order = np.argsort(-logits[0])
        logits[0, order[3]] = logits[0, order[2]]
    if name == "top_p_in_tie":
        # row 0's top-p cutoff lands inside a run of equal logits: all stay
        logits[0] = 0.0
        logits[0, :2] = 3.0
    return logits


@pytest.mark.parametrize("name", list(CASES))
def test_warp_logits_match_jax(name):
    logits = _case_logits(name)
    got, want = _warp_pair(logits, **CASES[name])
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = ~np.isneginf(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)
    if name == "top_k_ties":
        assert kept[0].sum() == 4 and (kept[1:].sum(1) == 3).all()
    if name == "top_p_boundary":
        assert kept.tolist() == [[True, True, False, False]]
    if name == "top_p_in_tie":
        assert kept[0].sum() == 200


def test_temperature_zero_is_the_argmax():
    logits = torch.from_numpy(_case_logits("temperature"))
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1      # first maximum
    got = tgen.sample_token(logits, tgen.Sampling(0.0, 0.5, 3, seed=9),
                            torch.tensor(5))
    assert got.tolist() == torch.argmax(logits, -1).tolist()
    assert int(got[1]) == 7


def _chi_square(counts, probs):
    """p-value of the counts against the probabilities (the support only)."""
    return stats.chisquare(counts, probs / probs.sum() * counts.sum()).pvalue


def test_seeded_draws_follow_the_warped_softmax():
    s = tgen.Sampling(temperature=0.8, top_p=0.9, top_k=6, seed=3)
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 16)).astype(np.float32))
    warped = tgen.warp_logits(logits, s.temperature, s.top_p, s.top_k)[0]
    support = torch.isfinite(warped)
    probs = torch.softmax(warped, -1)[support].numpy().astype(np.float64)
    assert 2 <= int(support.sum()) <= 6
    # many rows at one step, then one row over many steps
    rows = tgen.sample_token(logits.expand(40000, -1), s, torch.tensor(11))
    steps = torch.stack([tgen.sample_token(logits, s, torch.tensor(i))[0]
                         for i in range(4000)])
    for draws in (rows, steps):
        assert bool(support[draws].all())
        counts = torch.bincount(draws, minlength=16)[support].numpy()
        assert _chi_square(counts, probs) > P_VALUE
    # another seed draws another stream
    other = tgen.sample_token(logits.expand(40000, -1), s._replace(seed=4),
                              torch.tensor(11))
    assert not torch.equal(other, rows)


def test_gumbel_noise_is_finite_at_every_hash_extreme():
    """The uniforms never round to 0 or 1 in float32: the noise stays
    finite for the smallest and largest hashes and those next to them (an
    infinite noise on a masked token would win the argmax)."""
    top = (1 << 32) - 1
    bits = torch.tensor([0, 1, 511, 512, top - 512, top - 511, top - 1, top],
                        dtype=torch.long)
    g = tgen.gumbel_from_bits(bits)
    assert bool(torch.isfinite(g).all())
    assert (g[1:] >= g[:-1]).all()          # monotone in the hash


@pytest.fixture(scope="module")
def model():
    """The tiny LLM's weights (an EOS column scaled up, so rows end)."""
    tree = jax.tree.map(np.asarray,
                        jqwen.init_qwen2(jax.random.PRNGKey(4), CFG.llm))
    tree["lm_head"] = tree["lm_head"].copy()
    tree["lm_head"][:, EOS] *= 3.0
    return {"llm": _convert(tree, "cpu", None)}


def _state(B: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    llm = TCFG.llm
    width = llm.num_key_value_heads * llm.head_dim
    shape = (llm.num_hidden_layers, B, CACHE, width)
    pos = rng.integers(5, 20, size=B)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    logits = rng.standard_normal((B, llm.vocab_size)).astype(np.float32)
    return tgen.DecodeState(
        torch.from_numpy(logits), tqwen.KVCache(torch.from_numpy(k),
                                                torch.from_numpy(v)),
        torch.from_numpy(pos), torch.zeros(B, dtype=torch.bool),
        torch.zeros((), dtype=torch.long))


SAMPLED = dict(temperature=0.9, top_p=0.95, top_k=40, seed=5)


def test_sampled_generate_is_chunk_invariant(model):
    """chunk=8 and chunk=1 draw the same tokens for one seed; a decode chunk
    of 6 equals two of 3; every token lies in its step's warped support."""
    new = 20
    per_step = tgen.generate_from_state(model, TCFG, _state(3), new, EOS,
                                        chunk=1, capture=False, **SAMPLED)
    chunked = tgen.generate_from_state(model, TCFG, _state(3), new, EOS,
                                       chunk=8, capture=False, **SAMPLED)
    assert torch.equal(per_step.tokens, chunked.tokens)
    assert torch.equal(per_step.lengths, chunked.lengths)
    greedy = tgen.generate_from_state(model, TCFG, _state(3), new, EOS,
                                      chunk=8, capture=False)
    assert not torch.equal(greedy.tokens, chunked.tokens)

    one, two = _state(2, 1), _state(2, 1)
    _, six = tgen.decode_chunk(model, TCFG, one, 6, EOS, capture=False,
                               **SAMPLED)
    _, a = tgen.decode_chunk(model, TCFG, two, 3, EOS, capture=False,
                             **SAMPLED)
    _, b = tgen.decode_chunk(model, TCFG, two, 3, EOS, capture=False,
                             **SAMPLED)
    assert torch.equal(six, torch.cat([a, b], 1))
    assert int(one.step) == int(two.step) == 6

    # the support: step by step, each draw inside the warp of its logits
    st = _state(3, 2)
    s = tgen.Sampling(**SAMPLED)
    for _ in range(10):
        warped = tgen.warp_logits(st.next_logits, s.temperature, s.top_p,
                                  s.top_k)
        done = st.done.clone()
        _, tok = tgen.decode_chunk(model, TCFG, st, 1, EOS, capture=False,
                                   **SAMPLED)
        live = ~done
        assert bool(torch.isfinite(
            warped[live, tok[live, 0]]).all())


def test_greedy_and_sampled_keys_differ(model):
    st = _state(2)
    greedy = dg.graph_key("dense", model, st, 8, EOS,
                          tgen.Sampling(0.0, 0.9, 5).key())
    assert greedy == dg.graph_key("dense", model, st, 8, EOS)
    sampled = dg.graph_key("dense", model, st, 8, EOS,
                           tgen.Sampling(**SAMPLED).key())
    assert sampled != greedy and sampled.warp == (0.9, 0.95, 40, 5)
    assert dg.graph_key("dense", model, st, 8, EOS, tgen.Sampling(
        **dict(SAMPLED, seed=6)).key()) != sampled


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    info = make_fake_scene(root, n_frames=3)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    tok = FakeTokenizer()
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    kw = dict(max_new_tokens=6, eos_token_id=tok.eos_token_id, max_frames=3,
              buckets=(256,), stop_str="", temperature=0.0, top_p=0.9,
              top_k=5)
    jeng = jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        jdrv.EngineConfig(**kw), device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        tdrv.EngineConfig(**kw), device="cpu")
    return info, jeng, teng


def test_engine_at_temperature_zero_gives_jax_tokens(engines):
    info, jeng, teng = engines
    assert teng.ecfg.sampling() == {"temperature": 0.0, "top_p": 0.9,
                                    "top_k": 5}
    for i in range(2):
        q = {"id": f"q{i}", "video": info["sample_idx"],
             "conversations": [{"from": "human",
                                "value": f"<image>\nwhat is near chair {i}"},
                               {"from": "gpt", "value": None}]}
        want = jeng._generate(*jeng._prepare_generation(q))
        got = teng._generate(*teng._prepare_generation(q))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
