"""Paged KV cache of the port against the JAX package, on the CPU: B7's
plain version against the Pallas kernel in interpret mode and the gather
oracle (shuffled tables, ragged lengths, a kv_len == 0 slot, aliased
tables whose live pages outnumber the pool), the pool writes
(``append_layer_kv``, ``transplant_dense``, ``scatter_shared_prefix``,
``write_prefill``) bit for bit, ``PageAllocator``, the paged
``decoder_layer`` branch, and ``qwen2_forward`` over a paged cache against
the dense decode of the same tokens; each over bf16 (or f32), int8 and int4
pools (JAX's ``jnp.int4`` pools against the port's packed uint8 ones, read
back unpacked)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig
from video3d_tpu.kernels import paged_attention as jpa
from video3d_tpu.models import paged_kv as jpk
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import paged_attention as tpa
from video3d_tpu_torch.models import paged_kv as tpk
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert

from port_configs import port_config

torch.set_num_threads(1)

CFG = LLMConfig.tiny()
TCFG = port_config(CFG)
H, KV, HD = 4, 2, 128
PAGE, MAXP = 16, 4
FORMS = ["bf16", "int8", "int4"]
QMAX = {"int8": 127.0, "int4": 7.0}
#: cache dtypes of JAX and of the port per form
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8),
          "int4": (jnp.int4, tqwen.KV_INT4)}


def t(a):
    return torch.from_numpy(np.array(a))


def _port(a, form):
    """Pool values for the port: int4 packed two per uint8 byte."""
    return tqwen.pack_kv_int4(t(a)) if form == "int4" else t(a)


def _jax(a, form):
    return jnp.asarray(a, jnp.int4) if form == "int4" else jnp.asarray(a)


def _pools(rng, NL, P, form):
    """Stacked flat (NL, P, page, KV*hd) pools: f32, or int8 / int4 values
    (as int8) with (NL, P, KV, 1, page) f32 scales."""
    shape = (NL, P, PAGE, KV, HD)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if form == "bf16":
        return k.reshape(NL, P, PAGE, KV * HD), \
            v.reshape(NL, P, PAGE, KV * HD), None, None
    qmax = QMAX[form]
    out = []
    for x in (k, v):
        s = np.abs(x).max(axis=-1, keepdims=True) / qmax + 1e-8
        q = np.clip(np.round(x / s), -qmax, qmax).astype(np.int8)
        out.append((q.reshape(NL, P, PAGE, KV * HD),
                    s.transpose(0, 1, 3, 4, 2).astype(np.float32)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _tables(rng, case, B):
    """(table, lens, P): shuffled private pages with ragged lengths and a
    len-0 slot, or two aliased prefix pages per slot with live (slot, page)
    pairs (16) outnumbering the pool (11), as prefix sharing makes them."""
    if case == "shuffled":
        P = 1 + B * MAXP
        table = np.stack([rng.permutation(P - 1)[:MAXP] + 1
                          for _ in range(B)])
        lens = [1, PAGE + 7, 0, MAXP * PAGE]
    else:
        P = 1 + 2 + B * 2
        table = np.zeros((B, MAXP), np.int64)
        for b in range(B):
            table[b] = [1, 2, 3 + 2 * b, 4 + 2 * b]
        lens = [MAXP * PAGE, MAXP * PAGE, MAXP * PAGE, 3 * PAGE + 5]
    return table.astype(np.int32), np.asarray(lens, np.int32), P


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", ["shuffled", "aliased"])
def test_paged_plain_matches_jax_kernel_and_oracle(case, form):
    """Layer 1 of stacked pools. f32 pools: the plain version equals the
    Pallas kernel in interpret mode and the oracle within 1e-5. int8 and
    int4 pools: it equals the f32 oracle within 1e-5 relative; the Pallas
    kernel's quantized form rounds the query block and p to bf16 before
    its dots (paged_attention.py:84-90), so against it the bound is
    bf16's."""
    rng = np.random.default_rng(3)
    B, NL, layer = 4, 2, 1
    table, lens, P = _tables(rng, case, B)
    k, v, ks, vs = _pools(rng, NL, P, form)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    before = dict(_build.LAUNCHES)
    got = tpa.paged_decode_attention(
        t(q), _port(k, form), _port(v, form), t(table), t(lens), layer, KV,
        None if ks is None else t(ks), None if vs is None else t(vs)).numpy()
    assert _build.LAUNCHES == before
    jscale = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs))
    kern = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), _jax(k, form), _jax(v, form), jnp.asarray(table),
        jnp.asarray(lens), layer=layer, kv_heads=KV, interpret=True,
        **jscale))
    lscale = {} if ks is None else dict(k_scale=jnp.asarray(ks[layer]),
                                        v_scale=jnp.asarray(vs[layer]))
    oracle = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), _jax(k[layer], form), _jax(v[layer], form),
        jnp.asarray(table), jnp.asarray(lens), kv_heads=KV, **lscale))
    live = lens > 0
    assert np.all(got[~live] == 0) and np.all(kern[~live] == 0)
    if form != "bf16":
        np.testing.assert_allclose(got[live], oracle[live], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got, kern, rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(got[live], oracle[live], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)


def test_paged_plain_masks_stale_pages():
    """Positions past kv_len contribute exactly 0: the same call with the
    unread tail of every page overwritten (finite garbage) is bit for bit
    the same."""
    rng = np.random.default_rng(4)
    table, lens, P = _tables(rng, "shuffled", 4)
    k, v, _, _ = _pools(rng, 1, P, "bf16")
    q = t(rng.standard_normal((4, 1, H, HD)).astype(np.float32))
    got = tpa.paged_attention_plain(q, t(k), t(v), t(table), t(lens), 0, KV)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lens):
        for s in range(n, MAXP * PAGE):
            pg, off = table[b, s // PAGE], s % PAGE
            if not any(table[c, u // PAGE] == pg and u % PAGE == off
                       for c in range(4) for u in range(lens[c])):
                k2[0, pg, off] = 1e4
                v2[0, pg, off] = -1e4
    again = tpa.paged_attention_plain(q, t(k2), t(v2), t(table), t(lens), 0,
                                      KV)
    assert torch.equal(got, again)


def _caches(form, P=9, S=3, maxp=4):
    jdt, tdt = DTYPES[form]
    return (jpk.PagedKVCache.zeros(CFG, P, PAGE, S, maxp, dtype=jdt),
            tpk.PagedKVCache.zeros(TCFG, P, PAGE, S, maxp, dtype=tdt))


def _np(a) -> np.ndarray:
    """A JAX array or a port tensor as numpy: bf16 as f32, JAX int4 and the
    port's packed int4 as int8 values."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint8:
            a = tqwen.unpack_kv_int4(a)
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    if a.dtype in (jnp.bfloat16, jnp.int4):
        a = a.astype(jnp.float32 if a.dtype == jnp.bfloat16 else jnp.int8)
    return np.asarray(a)


def _same(jcache, tcache):
    for name in ("k", "v", "k_scale", "v_scale", "page_table", "lens"):
        want, got = getattr(jcache, name), getattr(tcache, name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


def _values(rng, shape, form):
    """+-32 integers for quantized caches (their scales, max / qmax, and
    the quantized values are then the same in both frameworks), bf16-exact
    normals otherwise."""
    if form != "bf16":
        return rng.integers(-32, 33, shape).astype(np.float32)
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("form", FORMS)
def test_pool_writes_bit_identical_to_jax(form):
    """write_prefill, transplant_dense (with and without skip_pages),
    scatter_shared_prefix, append_positions + append_layer_kv with a dead
    slot and advance_lens: pools (int4 read back unpacked), scales, tables
    and lengths equal JAX's bit for bit; the int4 copies carry the packed
    bytes verbatim."""
    rng = np.random.default_rng(6)
    NL, C = CFG.num_hidden_layers, CFG.num_key_value_heads * CFG.head_dim
    KVc, hd = CFG.num_key_value_heads, CFG.head_dim
    jc, tc = _caches(form)
    # slot 0: a two-page prefill written layer by layer
    jc = jpk.set_slot_pages(jc, 0, [5, 2])
    tpk.set_slot_pages(tc, 0, [5, 2])
    for layer in range(NL):
        kseq = _values(rng, (2 * PAGE, KVc, hd), form)
        vseq = _values(rng, (2 * PAGE, KVc, hd), form)
        jc = jpk.write_prefill(jc, layer, jnp.asarray(kseq),
                               jnp.asarray(vseq), 0)
        tpk.write_prefill(tc, layer, t(kseq), t(vseq), 0)
    _same(jc, tc)
    # a B=1 dense cache of 3 pages, and a scene prefix of 2 full pages
    jd = jqwen.KVCache.zeros(CFG, 1, 3 * PAGE, dtype=DTYPES[form][0])
    td = tqwen.KVCache.zeros(TCFG, 1, 3 * PAGE, dtype=DTYPES[form][1])
    for layer in range(NL):
        x = _values(rng, (1, 3 * PAGE, KVc, hd), form)
        y = _values(rng, (1, 3 * PAGE, KVc, hd), form)
        jk, jv = jnp.asarray(x), jnp.asarray(y)
        if form != "bf16":
            kq, kscale = jqwen._quantize_kv(jk, DTYPES[form][0])
            vq, vscale = jqwen._quantize_kv(jv, DTYPES[form][0])
            jd = jqwen.KVCache(
                jd.k.at[layer].set(kq.reshape(1, -1, C)),
                jd.v.at[layer].set(vq.reshape(1, -1, C)),
                jd.k_scale.at[layer].set(kscale),
                jd.v_scale.at[layer].set(vscale))
        else:
            jd = jqwen.KVCache(
                jd.k.at[layer].set(jk.reshape(1, -1, C).astype(jnp.bfloat16)),
                jd.v.at[layer].set(jv.reshape(1, -1, C).astype(jnp.bfloat16)))
    for dst, src in zip(td, jd):
        if dst is not None:
            dst.copy_(_port(_np(src), form) if dst.dtype == torch.uint8
                      else t(_np(src)))
    row = np.asarray([7, 1, 3, 0], np.int32)
    jc = jpk.transplant_dense(jc, jd, 1, jnp.asarray(row), 3, 40)
    tpk.transplant_dense(tc, td, 1, t(row), 3, 40)
    _same(jc, tc)
    jc = jpk.scatter_shared_prefix(jc, jd, jnp.asarray([4, 6]), 2)
    tpk.scatter_shared_prefix(tc, td, [4, 6], 2)
    row = np.asarray([4, 6, 8, 0], np.int32)
    jc = jpk.transplant_dense(jc, jd, 2, jnp.asarray(row), 3, 35,
                              skip_pages=2)
    tpk.transplant_dense(tc, td, 2, t(row), 3, 35, skip_pages=2)
    _same(jc, tc)
    # one decode step: slot 1 dead (its token goes to page 0, offset 0)
    active = np.asarray([True, False, True])
    jpids, joff = jpk.append_positions(jc, jnp.asarray(active))
    tpids, toff = tpk.append_positions(tc, t(active))
    np.testing.assert_array_equal(tpids.numpy(), np.asarray(jpids))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    for layer in range(NL):
        kn = _values(rng, (3, KVc, hd), form)
        vn = _values(rng, (3, KVc, hd), form)
        pools = jpk.append_layer_kv(
            (jc.k, jc.v, jc.k_scale, jc.v_scale), jnp.asarray(kn),
            jnp.asarray(vn), jpids, joff, layer=layer)
        jc = jc._replace(k=pools[0], v=pools[1], k_scale=pools[2],
                         v_scale=pools[3])
        tpk.append_layer_kv(tc, layer, t(kn), t(vn), tpids, toff)
    jc = jpk.advance_lens(jc, jnp.asarray(active))
    tpk.advance_lens(tc, t(active))
    _same(jc, tc)


def test_page_allocator_matches_jax():
    """Same ids in the same order, page 0 never handed out, the same
    errors on exhaustion and on bad ids."""
    ja, ta = jpk.PageAllocator(6), tpk.PageAllocator(6)
    assert ta.available == ja.available == 5
    assert ta.alloc(3) == ja.alloc(3) == [1, 2, 3]
    ta.free([2])
    ja.free([2])
    assert ta.alloc(3) == ja.alloc(3)
    assert ta.available == ja.available == 0
    with pytest.raises(MemoryError, match="exhausted"):
        ta.alloc(1)
    for bad in ([0], [6]):
        with pytest.raises(ValueError, match="bad page id"):
            ta.free(bad)
    assert tpk.pages_needed(33, 16) == jpk.pages_needed(33, 16) == 3


def test_int4_pools_shapes_and_dtypes():
    """PagedKVCache.zeros(KV_INT4): uint8 pools of half JAX's int4 row
    width, f32 (layers, P, KV, 1, page) scale pools, the table and lengths
    as JAX's; a dtype the pools do not take raises."""
    jc, tc = _caches("int4", P=4, S=2, maxp=2)
    for name in ("k", "v"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert got.dtype == torch.uint8 and want.dtype == jnp.int4
        assert tuple(got.shape) == want.shape[:-1] + (want.shape[-1] // 2,)
    for name in ("k_scale", "v_scale", "page_table", "lens"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tc.page_size == PAGE and tc.num_pages == 4
    with pytest.raises(ValueError, match="paged cache"):
        tpk.PagedKVCache.zeros(TCFG, 4, PAGE, 2, 2, dtype=torch.int16)


def _paged_layer_case(form):
    """JAX and port ``decoder_layer`` (layer 1, one token per slot) over
    the same stacked pools with a dead slot: +-32 inputs at rotary angle 0
    keep K/V bit-identical across the frameworks."""
    layer, S, P = 1, 3, 9
    jp = jqwen.init_qwen2(jax.random.PRNGKey(5), CFG)
    tl = _convert(jax.tree.map(np.asarray, jp["layers"][layer]), "cpu", None)
    rng = np.random.default_rng(8)
    jc, tc = _caches(form, P=P, S=S)
    for slot, (pages, n) in enumerate((([3, 1], 20), ([2, 4], 9),
                                       ([5, 6, 7], 40))):
        jc = jpk.set_slot_pages(jc, slot, pages)
        tpk.set_slot_pages(tc, slot, pages)
        jc = jc._replace(lens=jc.lens.at[slot].set(n))
        tc.lens[slot] = n
    for layer_i in range(CFG.num_hidden_layers):
        for name in ("k", "v"):
            x = _values(rng, (P, PAGE, KV, CFG.head_dim), form)
            if form != "bf16":
                q, s = jpk._quantize_kv(jnp.asarray(x), DTYPES[form][0])
                jc = jc._replace(**{
                    name: getattr(jc, name).at[layer_i].set(
                        q.reshape(P, PAGE, -1)),
                    f"{name}_scale": getattr(jc, f"{name}_scale")
                    .at[layer_i].set(s.transpose(0, 2, 3, 1))})
            else:
                jc = jc._replace(**{name: getattr(jc, name).at[layer_i].set(
                    jnp.asarray(x.reshape(P, PAGE, -1), jnp.bfloat16))})
    for name in ("k", "v", "k_scale", "v_scale"):
        dst = getattr(tc, name)
        if dst is not None:
            src = _np(getattr(jc, name))
            dst.copy_(_port(src, form) if dst.dtype == torch.uint8
                      else t(src))
    active = np.asarray([True, False, True])
    x = rng.choice([-32.0, 32.0], size=(S, 1, CFG.hidden_size)).astype(
        np.float32)
    pos3 = np.zeros((S, 1, 3), np.int64)
    jpids, joff = jpk.append_positions(jc, jnp.asarray(active))
    jlens = jc.lens + jnp.asarray(active, jnp.int32)
    jcos, jsin = jqwen.compute_mrope_cos_sin(jnp.asarray(pos3), CFG)
    jout, jpools = jqwen.decoder_layer(
        jp["layers"][layer], jnp.asarray(x), jcos, jsin, CFG,
        paged=((jc.k, jc.v, jc.k_scale, jc.v_scale), jc.page_table, jpids,
               joff, jlens), layer_idx=layer)
    tpids, toff = tpk.append_positions(tc, t(active))
    tcos, tsin = tqwen.compute_mrope_cos_sin(t(pos3), TCFG)
    tout = tqwen.decoder_layer(
        tl, t(x), tcos, tsin, TCFG, layer,
        paged=(tc, tpids, toff, tc.lens + t(active).int()))
    return np.asarray(jout), jpools, tout.numpy(), tc, active


@pytest.mark.parametrize("form", FORMS)
def test_decoder_layer_paged_matches_jax(form):
    """The single-token paged branch: the token's K/V (and int8 / int4
    scales) land in the stacked pools bit for bit as in JAX (int4 read back
    unpacked), and the layer output of the live slots agrees within 1e-4
    (the pools' rounding is the same in both; the attention reads them in
    f32)."""
    jout, jpools, tout, tc, active = _paged_layer_case(form)
    np.testing.assert_allclose(tout[active], jout[active], rtol=0,
                               atol=1e-4)
    for got, want in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), jpools):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(_np(got), _np(want))


def test_paged_multi_token_raises():
    """A multi-token paged block (the speculative verify), which raised
    before it was ported, runs: each slot's 2 tokens land at (table[s,
    lens // page], lens % page) per token, bit for bit JAX's
    ``append_positions_multi`` coordinates, the hidden states are finite
    and ``lens`` advances by 2 (tests/test_torch_paged_spec.py holds the
    block against the dense path)."""
    params = _convert(jax.tree.map(np.asarray, jqwen.init_qwen2(
        jax.random.PRNGKey(2), CFG)), "cpu", None)
    jc, tc = _caches("bf16")
    table = np.asarray([[3, 1, 2, 4], [5, 6, 7, 8], [2, 3, 4, 5]], np.int32)
    lens = np.asarray([PAGE - 1, 3, 2 * PAGE - 1], np.int32)
    tc.page_table.copy_(t(table))
    tc.lens.copy_(t(lens))
    jc = jc._replace(page_table=jnp.asarray(table), lens=jnp.asarray(lens))
    want = jpk.append_positions_multi(jc, 2)
    got = tpk.append_positions_multi(tc, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = torch.randn(3, 2, CFG.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    pos3 = (t(lens).long()[:, None] + torch.arange(2))[..., None] \
        .expand(3, 2, 3)
    h = tqwen.qwen2_forward(params, TCFG, x, pos3, paged_cache=tc)
    assert torch.isfinite(h).all()
    assert tc.lens.tolist() == (lens + 2).tolist()


@pytest.mark.parametrize("form", FORMS)
def test_forward_paged_matches_dense_decode(form):
    """Three slots prefilled into a dense cache, their rows transplanted
    into shuffled pool pages, then three decode steps of the same tokens
    through ``qwen2_forward`` over the dense cache and over the pools (slot
    1 dead in the last step): the live slots' hidden states agree within
    1e-5 (f32 model, the cache values are the same), the pools hold the
    dense rows' values, and lens advanced by the active mask only."""
    rng = np.random.default_rng(9)
    params = _convert(jax.tree.map(np.asarray, jqwen.init_qwen2(
        jax.random.PRNGKey(2), CFG)), "cpu", None)
    S, L0, steps = 3, 20, 3
    D = CFG.hidden_size
    dt = DTYPES[form][1]
    dense = tqwen.KVCache.zeros(TCFG, S, L0 + steps + 9, dtype=dt)
    lens0 = torch.tensor([20, 13, 7])
    x0 = t(rng.standard_normal((S, L0, D)).astype(np.float32))
    pos = torch.arange(L0)[None].expand(S, L0)
    tqwen.qwen2_forward(params, TCFG, x0, pos[..., None].expand(S, L0, 3),
                        kv_cache=dense, cache_positions=pos, kv_len=lens0,
                        prefill=True)
    pool = tpk.PagedKVCache.zeros(TCFG, 1 + S * 2, PAGE, S, 2, dtype=dt)
    pages = rng.permutation(np.arange(1, 1 + S * 2)).reshape(S, 2)
    for s in range(S):
        sub = tqwen.KVCache(*(None if a is None else a[:, s:s + 1]
                              for a in dense))
        tpk.transplant_dense(pool, sub, s, t(pages[s].astype(np.int32)), 2,
                             int(lens0[s]))
    pos = lens0.clone()
    for step in range(steps):
        active = torch.tensor([True, step < steps - 1, True])
        x = t(rng.standard_normal((S, 1, D)).astype(np.float32))
        p3 = pos[:, None, None].expand(S, 1, 3)
        hd = tqwen.qwen2_forward(params, TCFG, x, p3, kv_cache=dense,
                                 cache_positions=pos[:, None],
                                 kv_len=pos + 1)
        hp = tqwen.qwen2_forward(params, TCFG, x, p3, paged_cache=pool,
                                 paged_active=active)
        np.testing.assert_allclose(hp[active].numpy(), hd[active].numpy(),
                                   rtol=0, atol=1e-5)
        pos = pos + active.long()
        assert torch.equal(pool.lens, pos.int())
    for s in range(S):
        n = int(pos[s])
        for name in ("k", "v"):
            rows = getattr(pool, name)[:, torch.from_numpy(pages[s])] \
                .reshape(CFG.num_hidden_layers, -1, getattr(pool, name)
                         .shape[-1])[:, :n]
            assert torch.equal(rows, getattr(dense, name)[:, s, :n])
