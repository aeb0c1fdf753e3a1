"""Gemma's head width 256 on the serving paths, on the CPU: B7 (the decode
template's hd-256 instantiation over the pools, ``csrc/decode_sm90.cuh``)
and B5 (``csrc/shared_prefix_hd256.cu``) at hd 256
(``kernels/attention_hd256.py``).

* Their plain twins against JAX's ``paged_decode_attention`` and
  ``flash_attention_shared_prefix``, Pallas kernels run in interpret mode
  (hd 256 takes JAX's kernels, as any ``hd % 128 == 0`` does).
* Their plans (every position or key in one CTA, the shapes alone
  decide) and the captured decode step's reservation of the paged plan's
  workspace and counters.
* The launch glue with a stand-in library (the plan, the page table or the
  prefix and suffix pointers and the stream's workspace handed to the C
  entries, only the output allocated, nothing of kv_len or the suffix
  lengths read on the host).
* The kernels' algorithms written out in plain torch (B7's positions
  through the page table, split as B3's and merged in two levels; B5's
  row tiles folded b-major, the prefix's tiles split, the last split's
  suffix tiles and the merge in split order) against the twins.
* ``check_card_path`` for the card (no card needed): the paged,
  shared-prefix and quantized-cache paths take 256; training and ALiBi on
  pages are refused with a ValueError before any work.
* A tiny hd-256 Gemma (hidden 512, 2 query heads of 256 on 1 kv head, 2
  layers) in f32: the paged batcher (plain, shared prefix pages, a chunked
  admission, speculative), the HTTP worker over a paged batcher and the
  scene-grouped batched answers at batch 4 give the JAX engine's token
  ids (the worker: its texts).
"""

import dataclasses
import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels import flash_attention as jfa
from video3d_tpu.kernels import paged_attention as jpa
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention_hd256 as h256
from video3d_tpu_torch.kernels import decode_attention as tda
from video3d_tpu_torch.kernels import flash_attention as tfa
from video3d_tpu_torch.kernels import paged_attention as tpa
from video3d_tpu_torch.models import builder as tb
from video3d_tpu_torch.models import decode_graph as dg
from video3d_tpu_torch.params import CARD_HEAD_DIMS, check_card_path
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from family_configs import (data_config, engines, jax_params, model_config,
                            question)
from fixtures import make_fake_scene
from port_configs import port_config
from test_torch_hd256_host import (_count_allocations, _no_host_reads,
                                   emulate_decode, emulate_shared_prefix)

torch.set_num_threads(1)

HD = h256.HEAD_DIM
H100_SMS = 132
F32_ATOL, BF16_ATOL = 1e-5, 2e-2
DTYPES = {"f32": (np.float32, torch.float32, F32_ATOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_ATOL)}


def t(a):
    return torch.from_numpy(np.array(a))


def _port(a, dtype):
    """numpy f32 values as a port tensor of ``dtype``."""
    return t(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a, dtype)


def _np(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).float())


# ---------------------------------------------------------------------------
# B7's twin at hd 256 against JAX's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

NL, LAYER = 2, 1
# (KV, G, page, maxp, kv_len, aliased): a page of 128 and an odd one,
# ragged lengths with 1, pages shared by every slot or private and shuffled
PAGED_CASES = [(1, 8, 128, 3, [1, 300, 129], True),
               (2, 2, 128, 3, [256, 1, 77], False),
               (1, 2, 24, 4, [1, 50, 96], True),
               (2, 8, 24, 4, [71, 24, 1], False)]


def _paged_case(rng, KV, G, page, maxp, lens, aliased):
    """q (B, 1, H, 256), stacked (NL, P, page, KV * 256) pools, table (B,
    maxp), lengths: aliased, every slot's first two pages are pool pages 1
    and 2; else each slot holds shuffled pages of its own."""
    B = len(lens)
    if aliased:
        P = 3 + B * (maxp - 2)
        table = np.array([[1, 2] + list(range(3 + b * (maxp - 2),
                                              3 + (b + 1) * (maxp - 2)))
                          for b in range(B)])
    else:
        P = 1 + B * maxp
        table = rng.permutation(P - 1)[:B * maxp].reshape(B, maxp) + 1
    k = rng.standard_normal((NL, P, page, KV * HD)).astype(np.float32)
    v = rng.standard_normal((NL, P, page, KV * HD)).astype(np.float32)
    q = rng.standard_normal((B, 1, KV * G, HD)).astype(np.float32)
    return (q, k, v, table.astype(np.int32), np.asarray(lens, np.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("KV,G,page,maxp,lens,aliased", PAGED_CASES)
def test_paged_twin_matches_jax_kernel(dtype, KV, G, page, maxp, lens,
                                       aliased):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v, table, kv_len = _paged_case(np.random.default_rng(page + KV),
                                         KV, G, page, maxp, lens, aliased)
    before = dict(_build.LAUNCHES)
    got = tpa.paged_decode_attention(
        _port(q, tdt), _port(k, tdt), _port(v, tdt), t(table), t(kv_len),
        LAYER, KV)
    assert _build.LAUNCHES == before         # the CPU runs the twin
    assert got.dtype == tdt and got.shape == q.shape
    assert h256.paged_hd256_plain is tpa.paged_attention_plain
    want = jpa.paged_decode_attention(
        _jax(q, jdt), _jax(k, jdt), _jax(v, jdt), jnp.asarray(table),
        jnp.asarray(kv_len), layer=LAYER, kv_heads=KV, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# B5's twin at hd 256 against JAX's fused Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

# (B, L, KV, G, P, suffix_lens): prefixes that end mid-tile, ragged suffixes
PREFIX_CASES = [(2, 64, 1, 4, 100, [64, 30]),
                (3, 64, 2, 2, 70, [1, 64, 17])]


def _prefix_case(rng, B, L, KV, G, P):
    q = rng.standard_normal((B, L, KV * G, HD)).astype(np.float32)
    pk = rng.standard_normal((P, KV, HD)).astype(np.float32)
    pv = rng.standard_normal((P, KV, HD)).astype(np.float32)
    sk = rng.standard_normal((B, L, KV, HD)).astype(np.float32)
    sv = rng.standard_normal((B, L, KV, HD)).astype(np.float32)
    return q, pk, pv, sk, sv


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,L,KV,G,P,slens", PREFIX_CASES)
def test_shared_prefix_twin_matches_jax_kernel(dtype, B, L, KV, G, P,
                                               slens):
    """Rows below suffix_lens (the others are undefined by contract)."""
    jdt, tdt, atol = DTYPES[dtype]
    arrays = _prefix_case(np.random.default_rng(P), B, L, KV, G, P)
    lens = np.asarray(slens, np.int32)
    before = dict(_build.LAUNCHES)
    got = tfa.flash_attention_shared_prefix(
        *(_port(a, tdt) for a in arrays), t(lens))
    assert _build.LAUNCHES == before
    assert h256.shared_prefix_hd256_plain is \
        tfa.mha_shared_prefix_reference
    want = np.asarray(jfa.flash_attention_shared_prefix(
        *(_jax(a, jdt) for a in arrays), jnp.asarray(lens), interpret=True),
        np.float32)
    got = _np(got)
    for b, n in enumerate(slens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# (B, H, KV, maxp, page) of the paged form's calls: chip_smoke.py phase 3's
# serving shape and phase 19's batcher (8 slots, pages of 128), small cases
PAGED_PLANS = [(8, 8, 1, 56, 128), (8, 8, 1, 60, 128), (3, 8, 2, 3, 128),
               (4, 4, 1, 4, 24), (1, 8, 1, 1, 7)]
# (B, L, H, KV, P) of the shared-prefix form's: phase 3's B=8 suffix batch
# and phase 19's, tile edges
PREFIX_PLANS = [(8, 64, 8, 1, 6716), (8, 64, 8, 1, 6748), (3, 64, 8, 2, 70),
                (2, 20, 4, 2, 100), (1, 5, 8, 1, 64), (2, 64, 4, 1, 0)]


@pytest.mark.parametrize("B,H,KV,maxp,page", PAGED_PLANS)
def test_paged_plan_covers_every_position_once(B, H, KV, maxp, page):
    """B7 at hd 256 plans as B3: sms // KV CTAs per kv head over maxp *
    page positions a slot, every position of full slots in exactly one
    CTA, two hd-256 slices of workspace per CTA."""
    cap = maxp * page
    plan = tda.decode_plan(B, KV, cap, H100_SMS, HD)
    assert plan.splits == min(H100_SMS // KV, B * cap)
    assert plan.workspace_bytes == 2 * plan.ctas * tda.part_floats(HD) * 4
    seen = set()
    for _, b, s0, s1 in plan.segments([cap] * B):
        for pos in range(s0, s1):
            assert (b, pos) not in seen
            seen.add((b, pos))
    assert len(seen) == B * cap


@pytest.mark.parametrize("B,L,H,KV,P", PREFIX_PLANS)
def test_shared_prefix_plan_covers_every_key_once(B, L, H, KV, P):
    """The prefix's keys: its SP_KEYS-key tiles each in one split (the
    suffix walks with the last split), the split count the chunk kernels'
    cost model gives the row tiles of the B L H / KV rows folded b-major
    per kv head."""
    plan = h256.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    assert plan.groups == KV * -(-B * L * (H // KV) // h256.SP_ROWS)
    assert plan.splits == tfa.chunk_plan(plan.groups, -(-P // h256.SP_KEYS),
                                         H100_SMS).splits
    keys = [k for s in range(plan.splits) for t in plan.tiles(s)
            for k in range(t * h256.SP_KEYS, (t + 1) * h256.SP_KEYS)]
    assert keys[:P] == list(range(P)) and len(keys) < P + h256.SP_KEYS


def test_plans_depend_on_shapes_alone():
    """No kv_len, page table or suffix length reaches a plan: the same
    shapes give the same plan. At Gemma-2B's heads, phase 3's paged step
    (8 slots of 56 pages of 128) takes all 132 SMs for its one kv head,
    and B5's B=8 suffix batch over a 6716-token prefix (4096 folded rows:
    32 row tiles) splits the prefix's 105 key tiles four ways (128
    CTAs)."""
    a = tda.decode_plan(8, 1, 56 * 128, H100_SMS, HD)
    assert a is tda.decode_plan(8, 1, 56 * 128, H100_SMS, HD)
    assert (a.splits, a.counters) == (132, 8 * (1 + tda.MAX_GROUPS))
    b = h256.shared_prefix_plan(8, 64, 8, 1, 6716, H100_SMS)
    assert b is h256.shared_prefix_plan(8, 64, 8, 1, 6716, H100_SMS)
    assert (b.groups, b.key_tiles, b.splits, b.ctas) == (32, 105, 4, 128)


@pytest.mark.parametrize("slots,maxp", [(8, 56), (8, 60), (1, 3)])
def test_step_buffers_reserve_the_paged_plan(slots, maxp):
    """A captured paged step of Gemma-2B reserves B7's hd-256 plan's
    workspace and arrival counters over maxp * page positions, so the
    replayed launches find them at their sizes (a capture must not
    allocate)."""
    cfg = tb.model_config_from_hf({
        "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
        "intermediate_size": 16384, "num_hidden_layers": 18,
        "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
        "hidden_activation": "gelu_pytorch_tanh"})
    dense = torch.zeros(1)                  # dense weights plan nothing
    params = {"llm": {"layers": [{"attn": {"wq": dense}, "mlp": {}}],
                      "lm_head": dense}}
    page = 128
    counters, nbytes = dg.step_buffers(params, cfg, slots, maxp * page,
                                       H100_SMS)
    plan = tda.decode_plan(slots, 1, maxp * page, H100_SMS, HD)
    assert plan.splits > 1 and nbytes >= plan.workspace_bytes > 0
    assert counters >= plan.counters


# ---------------------------------------------------------------------------
# the launch glue
# ---------------------------------------------------------------------------

class _Library:
    """Records each C call of the two entries; returns success."""

    def __init__(self):
        self.calls = []

    def v3d_paged_attention_hd256(self, *args):
        self.calls.append(args)
        return 0

    def v3d_shared_prefix_attention_hd256(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("maxp,page", [(3, 128), (60, 128)])
def test_paged_launch_hands_the_table_and_plan_to_the_c_entry(maxp, page,
                                                             monkeypatch):
    B, H, KV, P = 2, 8, 1, 2 * maxp + 1
    q = torch.zeros(B, 1, H, HD, dtype=torch.bfloat16)
    pools = torch.zeros(NL, P, page, KV * HD, dtype=torch.bfloat16)
    vpools = torch.zeros_like(pools)
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, maxp)
    kv_len = torch.tensor([maxp * page, 5], dtype=torch.int32)
    lib, stream = _Library(), 700 + maxp
    plan = tda.decode_plan(B, KV, maxp * page, H100_SMS, HD)
    name = h256.NAMES["paged"]
    before = _build.LAUNCHES[name]
    out = tpa._launch_paged(lib, stream, H100_SMS, "", q, pools, vpools,
                            table, kv_len, LAYER, KV, None, None)
    assert _build.LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (args,) = lib.calls
    assert len(args) == len(_build._SIGNATURES["v3d_paged_attention_hd256"])
    assert args[:6] == (q.data_ptr(), pools.data_ptr(), vpools.data_ptr(),
                        table.data_ptr(), kv_len.data_ptr(), out.data_ptr())
    ws, ws_bytes, counters = args[6:9]
    assert ws and counters and ws_bytes >= plan.workspace_bytes
    assert args[9:] == (LAYER, B, P, page, maxp, H, KV, plan.splits,
                        pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    tpa._launch_paged(lib, stream, H100_SMS, "", q, pools, vpools, table,
                      kv_len, LAYER, KV, None, None)
    assert made == ["empty_like"]                 # the output alone
    assert lib.calls[1][6:9] == (ws, ws_bytes, counters)  # the stream's


@pytest.mark.parametrize("B,L,P", [(8, 64, 6716), (1, 5, 64)])
def test_shared_prefix_launch_hands_the_pointers_and_plan_to_the_c_entry(
        B, L, P, monkeypatch):
    H, KV = 8, 1
    q = torch.zeros(B, L, H, HD, dtype=torch.bfloat16)
    pk = torch.zeros(P, KV, HD, dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    sk = torch.zeros(B, L, KV, HD, dtype=torch.bfloat16)
    sv = torch.zeros_like(sk)
    lib, stream = _Library(), 800 + B
    plan = h256.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    name = h256.NAMES["shared_prefix"]
    before = _build.LAUNCHES[name]
    out = h256._launch_shared_prefix(lib, stream, H100_SMS, q, pk, pv, sk,
                                     sv)
    assert _build.LAUNCHES[name] == before + 1
    (args,) = lib.calls
    assert len(args) == len(
        _build._SIGNATURES["v3d_shared_prefix_attention_hd256"])
    assert args[:6] == (q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                        sk.data_ptr(), sv.data_ptr(), out.data_ptr())
    assert args[6:12] == (B, L, P, H, KV, pytest.approx(HD ** -0.5))
    ws, ws_bytes, counters = args[12:15]
    if plan.splits == 1:
        assert (ws, ws_bytes, counters) == (0, 0, 0)
    else:
        assert ws and counters and ws_bytes >= plan.workspace_bytes
    assert args[15:] == (plan.splits, stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_shared_prefix(lib, stream, H100_SMS, q, pk, pv, sk, sv)
    assert made == ["empty_like"]
    assert lib.calls[1][12:15] == (ws, ws_bytes, counters)


# ---------------------------------------------------------------------------
# the kernels' algorithms, in plain torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("page,maxp,lens", [(24, 4, [1, 50, 0, 96]),
                                            (128, 2, [129, 3, 256, 7])])
def test_paged_algorithm_matches_the_twin(sms, page, maxp, lens):
    """B7 at hd 256 (the decode template over the pools): positions
    through each slot's page table (aliased first page, shuffled rest), a
    kv_len 0 slot (zeros), slots cut over several CTAs (sms=132: a row's
    slices merged in groups) and few (sms=4)."""
    rng = np.random.default_rng(page)
    B, KV, G = len(lens), 2, 2
    P = 2 + B * (maxp - 1)
    own = rng.permutation(np.arange(2, P)).reshape(B, maxp - 1)
    table = torch.from_numpy(np.concatenate(
        [np.ones((B, 1), np.int64), own], 1).astype(np.int32))
    k = torch.randn(NL, P, page, KV * HD, generator=torch.Generator()
                    .manual_seed(1))
    v = 0.5 * torch.randn(NL, P, page, KV * HD,
                          generator=torch.Generator().manual_seed(2))
    q = 3.0 * torch.randn(B, 1, KV * G, HD,
                          generator=torch.Generator().manual_seed(3))
    kv_len = torch.tensor(lens)

    def rows(b, g, s):
        pid, r = int(table[b, s // page]), s % page
        cols = slice(g * HD, (g + 1) * HD)
        return k[LAYER, pid, r, cols], v[LAYER, pid, r, cols]

    got = emulate_decode(q, maxp * page, KV, lens, rows, sms)
    ref = h256.paged_hd256_plain(q, k, v, table, kv_len, LAYER, KV)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,L,P,slens,sms", [
    (2, 20, 100, [20, 7], 132), (2, 20, 100, [20, 7], 4),
    (3, 64, 64, [1, 64, 33], 132), (2, 70, 0, [70, 5], 132),
    (2, 100, 30, [100, 41], 32), (2, 20, 1000, [20, 7], 132),
    (3, 20, 300, [20, 3, 11], 132), (3, 70, 650, [70, 0, 64], 32)])
def test_shared_prefix_algorithm_matches_the_twin(B, L, P, slens, sms):
    """B5's row tiles of 128 rows folded b-major (a tile spanning batch
    rows), the prefix's 64-key tiles (a partial last one masked; none at
    P=0) in one split or many (P=1000: 16 splits of one tile; P=300: 5),
    the last split's suffix tiles of each batch row its rows touch (two
    tiles at L=70; P=650: 4 splits), the merge in split order; rows below
    suffix_lens."""
    KV, G = 2, 2
    gen = torch.Generator().manual_seed(P + L)
    q = 3.0 * torch.randn(B, L, KV * G, HD, generator=gen)
    pk = torch.randn(P, KV, HD, generator=gen)
    pv = 0.5 * torch.randn(P, KV, HD, generator=gen)
    sk = torch.randn(B, L, KV, HD, generator=gen)
    sv = 0.5 * torch.randn(B, L, KV, HD, generator=gen)
    got = emulate_shared_prefix(q, P, KV, lambda g, s: (pk[s, g], pv[s, g]),
                                (sk, sv), sms)
    ref = h256.shared_prefix_hd256_plain(q, pk, pv, sk, sv,
                                         torch.tensor(slens))
    for b, n in enumerate(slens):
        torch.testing.assert_close(got[b, :n], ref[b, :n], rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# what the card takes at hd 256, and what it refuses before any work
# ---------------------------------------------------------------------------

def test_card_paths_at_hd256():
    """``check_card_path`` on a CUDA device (no card needed): the answer,
    paged, shared-prefix, quantized-cache and training paths take head_dim
    256 (training: B2 with the logsumexp and B6 at hd 256); ALiBi on pages
    raises whatever the width."""
    cfg = port_config(model_config("gemma_hd256"))
    assert cfg.llm.head_dim == 256
    for path in ("answer", "paged", "shared_prefix", "quantized_cache",
                 "training"):
        assert CARD_HEAD_DIMS[path] == (128, 256)
        check_card_path(cfg, "cuda", path)
    check_card_path(cfg, "cpu", "training")          # the CPU runs it
    mpt = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, position_embedding="alibi"))
    with pytest.raises(ValueError, match="ALiBi"):
        check_card_path(mpt, "cuda", "paged")


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    """Two scenes, the hd-256 Gemma's JAX tree and its data config."""
    root = str(tmp_path_factory.mktemp("gemma256"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=2,
                             extend=(i > 0)) for i in range(2)]
    cfg = model_config("gemma_hd256")
    return infos, cfg, jax_params(cfg, seed=3), data_config(root)


def test_training_at_hd256_refused_on_the_card(gemma):
    """The Trainer on the card takes head_dim 256 now (B2 with the
    logsumexp and B6 have hd-256 forms); a head width with no training
    form (64: eight heads of 64 over the same hidden size) is still
    refused with a ValueError before any work (no card needed: the check
    runs before anything touches the device)."""
    from video3d_tpu_torch.train.optim import OptimConfig
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    _, cfg, params, data_cfg = gemma
    _, teng = engines(cfg, params, data_cfg)
    check_card_path(teng.cfg, "cuda", "training")
    narrow = dataclasses.replace(teng.cfg, llm=dataclasses.replace(
        teng.cfg.llm, head_dim=64, num_attention_heads=8))
    with pytest.raises(ValueError, match="head_dim 64 has no training"):
        Trainer(narrow, teng.params, None, None, OptimConfig(),
                TrainingConfig(), device="cuda")


# ---------------------------------------------------------------------------
# the tiny hd-256 Gemma through the serving paths, against the JAX engine
# ---------------------------------------------------------------------------

TEXTS = ("what color is the chair", "how many tables are there",
         "where is the lamp", "is the door open")
PAGE = 8          # small pages, so the tiny scene prefix spans full pages
EOS = 101


def _ids(toks) -> list:
    ids = [int(x) for x in toks]
    return ids[:ids.index(EOS)] if EOS in ids else ids


def _recording(engine):
    """Record the ids of every answer the engine decodes, in order."""
    seen = []
    decode = engine._decode_text

    def wrapped(toks):
        seen.append(_ids(toks))
        return decode(toks)
    engine._decode_text = wrapped
    return seen


@pytest.fixture(scope="module")
def records(gemma):
    """Four questions on scene A, then two on scene B."""
    infos = gemma[0]
    return [question(infos[0], t, i) for i, t in enumerate(TEXTS)] + \
        [question(infos[1], t, 4 + i) for i, t in enumerate(TEXTS[:2])]


@pytest.fixture(scope="module")
def jax_answers(gemma, records):
    """The JAX engine's answers (texts and ids), one at a time, with the
    scene-prefix cache on; every question tokenized first."""
    _, cfg, params, data_cfg = gemma
    jeng, _ = engines(cfg, params, data_cfg, prefix_cache_scenes=2)
    for r in records:
        jeng._tokenize_prompt(r)
    seen = _recording(jeng)
    texts = [jeng.generate_answer(r) for r in records]
    return texts, seen


BATCHER_MODES = {
    "paged": dict(batcher={}, engine={}),
    "paged_shared": dict(batcher={}, engine=dict(prefix_cache_scenes=2)),
    "paged_chunked": dict(batcher=dict(chunked_prefill=64),
                          engine=dict(prefix_cache_scenes=2)),
    "paged_spec": dict(batcher={}, engine=dict(prefix_cache_scenes=2,
                                               speculative_draft_layers=1,
                                               speculative_k=2)),
}


@pytest.mark.parametrize("mode", list(BATCHER_MODES))
def test_paged_batcher_matches_jax(gemma, records, jax_answers, mode):
    """Six requests over two scenes through two paged slots: each scene's
    first request admitted alone (its miss stores the prefix; chunked
    mode runs it through the job pipeline), then the rest at once, so the
    hits alias their scene's prefix pages. Every answer's ids and text are
    the JAX engine's; every private page comes back."""
    _, cfg, params, data_cfg = gemma
    m = BATCHER_MODES[mode]
    _, eng = engines(cfg, params, data_cfg, **m["engine"])
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE, **m["batcher"])
    try:
        assert b.spec == (mode == "paged_spec")
        handles, texts = {}, {}
        for i in (0, 4):                 # each scene's miss, alone
            handles[i] = b.submit(records[i])
            texts[i] = handles[i].result(eng._decode_text, timeout=600)
        for i in (1, 2, 3, 5):
            handles[i] = b.submit(records[i])
        for i in (1, 2, 3, 5):
            texts[i] = handles[i].result(eng._decode_text, timeout=600)
        order = range(len(records))
        want_texts, want_ids = jax_answers
        assert [_ids(handles[i].tokens) for i in order] == want_ids
        assert [texts[i] for i in order] == want_texts
        end = time.time() + 60
        while time.time() < end and any(s is not None for s in b.slots):
            time.sleep(0.02)
        held = sum(len(sh["pages"]) for sh in b._shared.values())
        assert b._alloc.available + held == b.total_pages - 1
        if mode != "paged":
            assert b.prefix_share_stats[0] >= 2      # hits shared pages
    finally:
        b.shutdown()


def test_batched_prefix_answers_match_jax(gemma, records):
    """The scene-grouped batched answers at batch 4: the first question
    misses and stores the prefix; the B=4 chunk then takes the suffix
    batch over it (``prepare_answers_batch_prefix`` returns a prefix
    batch, not None); the ids equal the JAX engine's batched answers."""
    _, cfg, params, data_cfg = gemma
    jeng, teng = engines(cfg, params, data_cfg, prefix_cache_scenes=2)
    qs = records[:4]
    for e in (jeng, teng):
        for r in qs:
            e._tokenize_prompt(r)
    jseen, tseen = _recording(jeng), _recording(teng)
    want = [jeng.generate_answer(qs[0])]
    got = [teng.generate_answer(qs[0])]
    prep = teng.prepare_answers_batch_prefix(qs)
    assert prep is not None and prep["mode"] == "prefix_batch"
    assert prep["batch"].text_ids.shape[0] == 4
    got += teng.answers_from_prefix_batch(prep)
    want += jeng.generate_answers_batch_prefix(qs)
    assert teng.prefix_cache_stats == [4, 1]
    assert tseen == jseen
    assert got == want


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_paged_worker_serves_the_hd256_gemma(gemma, records, jax_answers):
    """The HTTP worker with a paged batcher (``--paged-kv``): concurrent
    requests over both scenes answer as the JAX engine."""
    from video3d_tpu_torch.serve import model_worker as tmw

    _, cfg, params, data_cfg = gemma
    _, eng = engines(cfg, params, data_cfg, prefix_cache_scenes=2)
    for r in records:
        eng._tokenize_prompt(r)
    port = _free_port()
    worker, server = tmw.serve_worker(eng, "gemma256", port=port,
                                      background=True, heartbeat=False,
                                      num_slots=2, paged=True,
                                      page_size=PAGE)
    try:
        assert worker.batcher.paged

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/worker_generate",
                data=json.dumps(records[i]).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                out[i] = json.loads(r.read())

        out = [None] * len(records)
        post(0)                            # the miss stores the prefix
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(1, len(records))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert [o["error_code"] for o in out] == [0] * len(records)
        assert [o["text"] for o in out] == jax_answers[0]
    finally:
        worker.batcher.shutdown()
        server.shutdown()
        server.server_close()
