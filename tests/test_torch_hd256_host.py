"""Host logic of the head-width-256 attention kernels
(``csrc/attention_hd256.cu``, ``csrc/flash_attention_hd256.cu``,
``csrc/flash_attention_bwd_hd256.cu``, B3's hd-256 instantiation of
``csrc/decode_sm90.cuh``, ``kernels/attention_hd256.py``) on the CPU: the
plans (``hd256_plan``: row tiles of 64 folded query rows, splits of whole
64-key tiles that cover every key slot once, from the shapes and the SM
count alone; ``decode_plan`` at head width 256: every live position in one
CTA, a row's slices in at most MAX_GROUPS groups; ``bwd_hd256_plan``:
B6's split of each group's query heads), the launch glue with a stand-in
library (the pointers, shapes and plan handed to the C entry, the stream's
workspace where the keys split, nothing but the output allocated on a
second call, no value of the lengths read on the host), and the kernels'
algorithms written out in plain torch against the plain twins: the WMMA
kernel's (each CTA's rows, positions and key range, the online softmax
over 64-key tiles in base 2, the empty partials of splits past a row's
keys and the merge) for B2 folded, the decode template's at 256
(:func:`emulate_decode`) for B3, and the prefill kernel's
(:func:`emulate_prefill`)."""

import math
from collections import Counter

import pytest
import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import attention_hd256 as h256
from video3d_tpu_torch.kernels import decode_attention as da

torch.set_num_threads(1)

H100_SMS = 132
HD = h256.HEAD_DIM
FWD_ROWS = 128     # the prefill kernel's query rows per CTA (csrc kBq), 64
FWD_KEYS = 64      # a consumer; keys per K / V tile (kBk)
LOG2E = math.log2(math.e)
# (B, L, H, KV, S) of every hd-256 call chip_smoke.py makes: phase 3's
# rows and edge cases (the training forms' too), phase 19's Gemma-2B miss
# (prefill), hit (folded) and decode, and the speculative verify shape
SMOKE_SHAPES = [(1, 8192, 8, 1, 8192), (2, 300, 8, 2, 300),
                (3, 65, 8, 1, 65), (1, 64, 8, 1, 8224), (2, 64, 8, 2, 8224),
                (1, 1, 8, 1, 8704), (4, 1, 8, 2, 8704), (4, 1, 8, 1, 8704),
                (1, 6748, 8, 1, 6748), (1, 64, 8, 1, 6812),
                (1, 1, 8, 1, 6780), (8, 5, 8, 1, 6812),
                (1, 129, 8, 1, 129), (4, 130, 8, 4, 130),
                (2, 200, 2, 2, 200)]


@pytest.mark.parametrize("B,L,H,KV,S", SMOKE_SHAPES)
def test_plan_covers_every_key_once(B, L, H, KV, S):
    plan = h256.hd256_plan(B, L, H, KV, S, H100_SMS)
    assert plan.rows == L * (H // KV) and plan.bkv == B * KV
    assert (plan.row_tiles - 1) * h256.ROWS < plan.rows \
        <= plan.row_tiles * h256.ROWS
    assert plan.split_keys % h256.KEYS == 0
    # every key slot in exactly one split, no split empty by capacity
    assert (plan.splits - 1) * plan.split_keys < S \
        <= plan.splits * plan.split_keys
    groups = plan.bkv * plan.row_tiles
    if groups >= H100_SMS:
        assert plan.splits == 1
    else:
        assert plan.ctas <= max(H100_SMS, groups)
    assert plan.workspace_bytes == (0 if plan.splits == 1 else
                                    plan.bkv * plan.rows * plan.splits
                                    * h256.PART_FLOATS * 4)


# (B, L, H, KV, causal) of B6's calls in chip_smoke.py (phase 3's main
# case and edges, phase 7b's Gemma-2B records) and the cuda tests
BWD_SHAPES = [(1, 8192, 8, 1, True), (1, 129, 8, 1, True),
              (4, 130, 8, 4, True), (2, 200, 2, 2, True),
              (2, 200, 8, 2, False), (1, 4096, 8, 1, True),
              (2, 300, 8, 1, True), (1, 8192, 28, 4, True)]


@pytest.mark.parametrize("B,L,H,KV,causal", BWD_SHAPES)
def test_bwd_plan_splits_each_group_evenly(B, L, H, KV, causal):
    """Every query head of a group in exactly one split; the fewest splits
    whose longest walk fits the SMs' even share, else one head a CTA."""
    plan = h256.bwd_hd256_plan(B, L, H, KV, causal, H100_SMS)
    G = H // KV
    assert G % plan.splits == 0 and plan.splits * plan.heads == G
    assert plan.key_tiles == -(-L // h256.BWD_KEYS) and plan.bkv == B * KV
    assert plan.ctas == plan.key_tiles * B * KV * plan.splits
    q_tiles = -(-L // h256.BWD_ROWS)
    assert plan.longest == q_tiles * plan.heads
    walk = sum(q_tiles - j if causal else q_tiles
               for j in range(plan.key_tiles))
    assert plan.share == pytest.approx(B * H * walk / H100_SMS)
    assert plan.longest <= plan.share or plan.splits == G
    fewer = [s for s in range(1, plan.splits) if G % s == 0]
    assert all(q_tiles * G // s > plan.share for s in fewer)
    assert plan.partial_shape(B, L, KV) == (plan.splits, B, L, KV, HD)


def test_bwd_plan_of_gemma_2b():
    """Gemma-2B's training record (8 heads on one kv head, L = 8192): the
    group splits in four, so key tile 0 walks 2 x 128 query tiles against
    an even share of ~500; the plan is a pure function of its arguments."""
    plan = h256.bwd_hd256_plan(1, 8192, 8, 1, True, H100_SMS)
    assert (plan.splits, plan.heads, plan.longest) == (4, 2, 256)
    assert plan.ctas == 128 * 4
    assert plan is h256.bwd_hd256_plan(1, 8192, 8, 1, True, H100_SMS)


def test_plan_depends_on_shapes_alone():
    """The decode form's grid never reads kv_len (it stays on the device):
    the same shapes give the same plan; the Gemma-2B decode step (one kv
    head) takes all 132 SMs, each CTA with two workspace slots of 8 (m, l)
    pairs and 8 x 256 f32 of O, and a row's counter and its MAX_GROUPS
    group counters (132 slices merge in 11 groups of 12). At
    the same shape a one-query WMMA launch (``hd256_plan``) splits its 136
    key tiles over the card in one wave (68 CTAs of two)."""
    a = da.decode_plan(1, 1, 8704, H100_SMS, 256)
    assert a is da.decode_plan(1, 1, 8704, H100_SMS, 256)
    assert (a.splits, a.head_dim, a.counters) == (132, 256,
                                                  1 + da.MAX_GROUPS)
    assert da.group_size(132) == 12
    assert a.workspace_bytes == 2 * a.splits * (2 * 8 + 8 * 256) * 4
    assert da.decode_plan(1, 4, 8704, H100_SMS).splits == 33
    b = h256.hd256_plan(1, 1, 8, 1, 8704, H100_SMS)
    assert (b.splits, b.split_keys, b.row_tiles) == (68, 128, 1)


# (KV, capacity, kv_len) of B3 hd256's calls in chip_smoke.py and the cuda
# tests: Gemma-2B's row, four rows on two kv heads, fewer live positions
# than CTAs with a kv_len 0 row, a full row, a 32k row beside short ones,
# eight equal rows (phase 19's batched decode), rows at a block's edges
DECODE_SHAPES = [(1, 8704, [6812]), (2, 8704, [8704, 6812, 300, 4097]),
                 (1, 8704, [7, 0, 9, 3]), (1, 8704, [8704]),
                 (1, 32768, [32768, 5, 100, 0]), (1, 8704, [6812] * 8),
                 (1, 64, [1, 15, 16, 17]), (4, 8704, [6812])]


@pytest.mark.parametrize("kv_heads,cap,lens", DECODE_SHAPES)
def test_decode_plan_at_hd256_covers_every_position_once(kv_heads, cap,
                                                         lens):
    """At head width 256 the plan's CTAs (one per SM, as at 128) cover
    every live position of every row once, each within one position of
    the mean; the workspace holds two hd-256 slices per CTA; a row's
    slices fall into at most MAX_GROUPS groups of ``group_size``, in
    order, each group's slices consecutive."""
    B = len(lens)
    plan = da.decode_plan(B, kv_heads, cap, H100_SMS, 256)
    assert plan.splits == min(H100_SMS // kv_heads, B * cap)
    assert plan.workspace_bytes == 2 * plan.ctas * da.part_floats(256) * 4
    for ctas in plan.slices(lens):
        if ctas:
            gs = da.group_size(len(ctas))
            assert -(-len(ctas) // gs) <= da.MAX_GROUPS
            assert gs == len(ctas) or len(ctas) > da.TREE_MIN
    live = plan.lens(lens)
    seen = Counter()
    per_cta = Counter()
    for cta, b, s0, s1 in plan.segments(lens):
        per_cta[cta] += s1 - s0
        seen.update((b, s) for s in range(s0, s1))
    assert seen == Counter({(b, s): 1 for b, n in enumerate(live)
                            for s in range(n)})
    mean = sum(live) / plan.splits
    assert all(abs(per_cta[c] - mean) <= 1 for c in range(plan.splits))


class _Library:
    """Records each C call; returns success."""

    def __init__(self):
        self.calls = []

    def v3d_attention_hd256(self, *args):
        self.calls.append(args)
        return 0

    def v3d_decode_attention_hd256(self, *args):
        self.calls.append(args)
        return 0


def _no_host_reads(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("a tensor value was read on the host")
    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)


def _count_allocations(monkeypatch):
    made = []
    for fn in ("empty", "empty_like", "zeros", "zeros_like", "ones", "full",
               "tensor"):
        orig = getattr(torch, fn)

        def wrapped(*a, _orig=orig, _fn=fn, **k):
            made.append(_fn)
            return _orig(*a, **k)
        monkeypatch.setattr(torch, fn, wrapped)
    monkeypatch.setattr(_launch, "_allocate", lambda *a: pytest.fail(
        "a buffer was allocated on the second call"))
    return made


def _check_decode_launch(q, k, v, lens, KV, lib, stream, monkeypatch):
    """B3 at hd 256 through ``decode_attention._launch_decode``: the
    hd-256 entry gets the decode template's arguments, the plan of
    ``decode_plan`` at head width 256 and the stream's workspace and
    counters; a second call allocates only its output and reads nothing of
    kv_len on the host."""
    B, _, H, _ = q.shape
    k_all, v_all = k[None], v[None]
    S = k.shape[1]
    plan = da.decode_plan(B, KV, S, H100_SMS, 256)
    name = h256.NAMES["decode"]
    before = _build.LAUNCHES[name]
    out = da._launch_decode(lib, stream, H100_SMS, "", q, k_all, v_all, lens,
                            0, KV, None, None)
    assert _build.LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (args,) = lib.calls
    assert len(args) == len(_build._SIGNATURES["v3d_decode_attention_hd256"])
    assert args[:5] == (q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                        lens.data_ptr(), out.data_ptr())
    ws, ws_bytes, counters = args[5:8]
    assert ws and counters and ws_bytes >= plan.workspace_bytes
    assert args[8:] == (0, B, S, H, KV, plan.splits,
                        pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    da._launch_decode(lib, stream, H100_SMS, "", q, k_all, v_all, lens, 0,
                      KV, None, None)
    assert made == ["empty_like"]                 # the output alone
    assert lib.calls[1][5:8] == (ws, ws_bytes, counters)


@pytest.mark.parametrize("form,L,S,q_off", [("folded", 64, 900, [700, 100]),
                                            ("decode", 1, 900, None)])
def test_launch_hands_the_plan_to_the_c_entry(form, L, S, q_off,
                                              monkeypatch):
    """The folded form's WMMA entry, and B3's decode-template entry at hd
    256 (:func:`_check_decode_launch`)."""
    B, H, KV = 2, 8, 2
    q = torch.zeros(B, L, H, HD, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV * HD, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    lens = torch.tensor([S, S // 2], dtype=torch.int32)
    offs = None if q_off is None else torch.tensor(q_off, dtype=torch.int32)
    lib, stream = _Library(), 400 + L
    if form == "decode":
        _check_decode_launch(q, k, v, lens, KV, lib, stream, monkeypatch)
        return
    plan = h256.hd256_plan(B, L, H, KV, S, H100_SMS)
    name = h256.NAMES[form]
    before = _build.LAUNCHES[name]
    out = h256._launch_form(lib, stream, H100_SMS, form, q, k, v, lens, offs,
                            KV)
    assert _build.LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (args,) = lib.calls
    assert len(args) == len(_build._SIGNATURES["v3d_attention_hd256"])
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lens.data_ptr())
    assert args[4] == (0 if offs is None else offs.data_ptr())
    assert args[5] == out.data_ptr()
    ws = args[6]
    assert (ws == 0) == (plan.splits == 1)
    assert args[7:] == (h256.MODES[form], B, L, S, H, KV, plan.splits,
                        plan.split_keys, pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_form(lib, stream, H100_SMS, form, q, k, v, lens, offs, KV)
    assert made == ["empty_like"]                 # the output alone
    assert lib.calls[1][6] == ws                  # the stream's workspace


def emulate_rows(q, S: int, KV: int, pos0_of, lim_of, key_rows,
                 sms: int = H100_SMS):
    """The kernel's algorithm in f32 torch for q (B, L, H, 256) over a key
    axis of S slots: per (batch row, kv head), row tile and split of
    ``hd256_plan``, the tile's folded rows (row f: query f // G of head
    g G + f % G), their positions (``pos0_of(b)`` + f // G) and the row's
    key limit (``lim_of(b)``), the key range [k_begin, k_end), each 64-key
    tile's K / V rows from ``key_rows(b, g, s)`` (None: a key no row
    attends, loaded as zeros and masked; a quantized cache's rows come as
    (k, v, k_scale, v_scale), the rows as the tile load converts them and
    the key's two scales), the online softmax over 64-key tiles in base 2
    (a quantized key's scale on its score column, its value scale on p,
    l summed over the unscaled p), then the one split's normalised output
    or the merge of every split's (O, m, l), empty partials skipped."""
    B, L, H, hd = q.shape
    G = H // KV
    plan = h256.hd256_plan(B, L, H, KV, S, sms)
    scale = hd ** -0.5 * math.log2(math.e)
    out = torch.zeros(B, L, H, hd)
    for b in range(B):
        pos0, lim = pos0_of(b), lim_of(b)
        for g in range(KV):
            parts = {}
            for t in range(plan.row_tiles):
                f0 = t * h256.ROWS
                fs = list(range(f0, min(f0 + h256.ROWS, plan.rows)))
                pos = torch.tensor([pos0 + f // G for f in fs])
                qt = q[b, [f // G for f in fs],
                       [g * G + f % G for f in fs]].float()     # (R, hd)
                for sp in range(plan.splits):
                    kb = sp * plan.split_keys
                    ke = min(kb + plan.split_keys, lim,
                             pos0 + fs[-1] // G + 1)
                    m = torch.full((len(fs),), -math.inf)
                    lsum = torch.zeros(len(fs))
                    o = torch.zeros(len(fs), hd)
                    for kt in range(kb, ke, h256.KEYS):
                        keys = torch.arange(kt, kt + h256.KEYS)
                        kk = torch.zeros(h256.KEYS, hd)
                        vv = torch.zeros(h256.KEYS, hd)
                        ksc = torch.ones(h256.KEYS)
                        vsc = torch.ones(h256.KEYS)
                        live = torch.zeros(h256.KEYS, dtype=torch.bool)
                        for r in range(h256.KEYS):
                            rows = key_rows(b, g, kt + r) \
                                if kt + r < ke else None
                            if rows is not None:
                                kk[r], vv[r] = rows[:2]
                                if len(rows) == 4:
                                    ksc[r], vsc[r] = rows[2:]
                                live[r] = True
                        x = (qt @ kk.T) * (ksc * scale)[None]
                        ok = (keys[None] <= pos[:, None]) \
                            & (keys[None] < lim) & live[None]
                        x = torch.where(ok, x, -math.inf)
                        m_new = torch.maximum(m, x.max(1).values)
                        dead = m_new == -math.inf
                        p = torch.where(dead[:, None], 0.0,
                                        torch.exp2(x - m_new[:, None]))
                        alpha = torch.where(dead, 1.0, torch.exp2(m - m_new))
                        o = o * alpha[:, None] + (p * vsc[None]) @ vv
                        lsum = lsum * alpha + p.sum(1)
                        m = m_new
                    for i, f in enumerate(fs):
                        parts.setdefault(f, []).append((m[i], lsum[i], o[i]))
            for f, ps in parts.items():
                mx = max((pm for pm, pl, _ in ps if pl > 0),
                         default=-math.inf)
                acc, tot = torch.zeros(hd), 0.0
                for pm, pl, po in ps:
                    if pl > 0:
                        w = 2.0 ** (pm - mx)
                        acc, tot = acc + w * po, tot + w * pl
                out[b, f // G, g * G + f % G] = acc / tot if tot > 0 else 0.0
    return out


def emulate_prefill(q, k, v, lens, causal=True):
    """The forward kernel's algorithm in f32 torch: per (batch row, head,
    128-row query tile), each consumer's 64 rows over the 64-key tiles
    they can see (the CTA's count, causal: up to min(length, tile end);
    one fewer where the consumer's own rows end a tile earlier), masked
    scores at -inf, the online softmax in base 2 (a row that has seen no
    allowed key keeps p = 0), O / max(l, 1e-30), and lse = m ln 2 +
    log(max(l, 1e-30)) with m = -1e30 where no key was allowed. Keys past
    L read as zeros (TMA's fill) and are masked. Returns (out, lse)."""
    B, L, H, hd = q.shape
    G = H // k.shape[2]
    scale = hd ** -0.5 * LOG2E
    out, lse = torch.zeros(B, L, H, hd), torch.zeros(B, H, L)
    kp = torch.zeros(B, L + FWD_ROWS, k.shape[2], hd)
    vp = torch.zeros_like(kp)
    kp[:, :L], vp[:, :L] = k, v
    for b in range(B):
        n = min(max(int(lens[b]), 0), L)
        for h in range(H):
            for q0 in range(0, L, FWD_ROWS):
                end = min(n, q0 + FWD_ROWS) if causal else n
                n_tiles = -(-end // FWD_KEYS) if end > 0 else 0
                for first in (q0, q0 + FWD_ROWS // 2):
                    if first >= L:
                        continue
                    rows = torch.arange(first, min(first + 64, L))
                    mine = min(n, first + 64) if causal else n
                    n_mine = min(n_tiles, -(-mine // FWD_KEYS))
                    qt = q[b, rows, h].float()
                    m = torch.full((len(rows),), -math.inf)
                    lsum = torch.zeros(len(rows))
                    o = torch.zeros(len(rows), hd)
                    for it in range(n_mine):
                        keys = torch.arange(it * FWD_KEYS,
                                            (it + 1) * FWD_KEYS)
                        kk, vv = kp[b, keys, h // G], vp[b, keys, h // G]
                        x = (qt @ kk.T) * scale
                        ok = (keys[None] < n) & (
                            (keys[None] <= rows[:, None]) | (not causal))
                        x = torch.where(ok, x, -math.inf)
                        m_new = torch.maximum(m, x.max(1).values)
                        u = torch.where(m_new == -math.inf, 0.0, m_new)
                        alpha = torch.exp2(m - u)
                        p = torch.exp2(x - u[:, None])
                        lsum = lsum * alpha + p.sum(1)
                        o = o * alpha[:, None] + p @ vv
                        m = m_new
                    d = lsum.clamp(min=1e-30)
                    out[b, rows, h] = o / d[:, None]
                    lse[b, h, rows] = torch.where(
                        m == -math.inf, torch.tensor(-1e30),
                        m * math.log(2)) + torch.log(d)
    return out, lse


def _emulate(q, k, v, lens, q_off, mode, sms=H100_SMS):
    """:func:`emulate_rows` of the dense forms over (B, S, KV, 256) keys:
    key s of row b is row s of its K and V, a row at position q_off[b]
    (folded, mode 1) or lens[b] - 1 (decode, mode 2) plus its query index,
    keys valid below lens[b]."""
    S, KV = k.shape[1], k.shape[2]
    pos0 = {1: lambda b: int(q_off[b]), 2: lambda b: int(lens[b]) - 1}[mode]
    return emulate_rows(q, S, KV, pos0,
                        lambda b: min(max(int(lens[b]), 0), S),
                        lambda b, g, s: (k[b, s, g].float(),
                                         v[b, s, g].float()), sms)


def _inputs(seed, B, L, S, H, KV):
    g = torch.Generator().manual_seed(seed)
    q = 3.0 * torch.randn(B, L, H, HD, generator=g)
    k = torch.randn(B, S, KV, HD, generator=g)
    v = 0.5 * torch.randn(B, S, KV, HD, generator=g)
    return q, k, v


@pytest.mark.parametrize("B,L,H,KV,lengths", [(2, 150, 4, 2, [150, 70]),
                                              (3, 65, 8, 8, [1, 64, 65])])
def test_algorithm_matches_the_prefill_twin(B, L, H, KV, lengths):
    """The prefill kernel's algorithm (:func:`emulate_prefill`): causal,
    groups of 2 and 1, lengths at a 64-key tile's edges."""
    q, k, v = _inputs(1, B, L, L, H, KV)
    lens = torch.tensor(lengths)
    got, _ = emulate_prefill(q, k, v, lens)
    ref = h256.prefill_hd256_plain(q, k, v, lens)
    for b, n in enumerate(lens.tolist()):
        torch.testing.assert_close(got[b, :n], ref[b, :n], rtol=0,
                                   atol=1e-5)


def test_algorithm_matches_the_folded_twin():
    """Rows at their own offsets over a cache of 300 slots, split over
    keys, a row whose later splits hold none of its keys."""
    B, L, H, KV, S = 2, 20, 4, 2, 300
    q, k, v = _inputs(2, B, L, S, H, KV)
    offs, lens = torch.tensor([250, 30]), torch.tensor([270, 50])
    got = _emulate(q, k, v, lens, offs, 1)
    k_all = k.reshape(1, B, S, KV * HD)
    v_all = v.reshape(1, B, S, KV * HD)
    ref = h256.folded_hd256_plain(q, k_all, v_all, lens, offs, 0, KV)
    for b, n in enumerate((lens - offs).tolist()):
        torch.testing.assert_close(got[b, :n], ref[b, :n], rtol=0,
                                   atol=1e-5)


DECODE_BLOCK = 16   # positions of a unit's block (csrc kBlock)
DECODE_UNITS = 4    # units of a CTA at hd 256: warp pairs (csrc units<256>)


def emulate_decode(q, S: int, KV: int, lens, key_rows,
                   sms: int = H100_SMS):
    """B3 at hd 256's algorithm (``csrc/decode_sm90.cuh`` at kHd 256) in
    f32 torch, q (B, 1, H, 256): per kv head g, the CTAs of
    ``decode_plan(B, KV, S, sms, 256)`` take their segments of the rows'
    live positions laid end to end (``DecodePlan.segments``); a CTA's walk
    is cut into blocks of 16 positions per segment, dealt round-robin to
    its 4 units (a pair of warps, each with half of the 256 channels,
    whose sums are exchanged, so a unit's score is the whole dot), each
    unit's online softmax in base 2 over a segment; at a segment's end the
    units merge in unit order, a row that one CTA holds is normalised, a
    slice is kept; the slices of a row merge in CTA order
    (``DecodePlan.slices``), in groups of ``group_size`` consecutive ones
    and then the groups' partials in order; a kv_len 0 row is zeros.
    ``key_rows(b, g, s)``: (k, v) of position s, or (k, v, k_scale,
    v_scale) of a
    quantized cache (the key scale on the score, the value scale on p, l
    over the unscaled p)."""
    B, _, H, hd = q.shape
    G = H // KV
    plan = da.decode_plan(B, KV, S, sms, hd)
    scale = hd ** -0.5 * LOG2E
    out = torch.zeros(B, 1, H, hd)
    live = plan.lens(lens)
    for g in range(KV):
        qg = q[:, 0, g * G:(g + 1) * G].float()               # (B, G, hd)
        slices = {}
        by_cta = {}
        for cta, b, s0, s1 in plan.segments(lens):
            by_cta.setdefault(cta, []).append((b, s0, s1))
        for cta, segs in by_cta.items():
            block = 0                        # the CTA's block count so far
            for b, s0, s1 in segs:
                units = [(torch.full((G,), -math.inf), torch.zeros(G),
                          torch.zeros(G, hd)) for _ in range(DECODE_UNITS)]
                for p0 in range(s0, s1, DECODE_BLOCK):
                    m, lsum, o = units[block % DECODE_UNITS]
                    rows = [key_rows(b, g, s)
                            for s in range(p0, min(p0 + DECODE_BLOCK, s1))]
                    kk = torch.stack([r[0] for r in rows]).float()
                    vv = torch.stack([r[1] for r in rows]).float()
                    ksc = torch.tensor([float(r[2]) if len(r) == 4 else 1.0
                                        for r in rows])
                    vsc = torch.tensor([float(r[3]) if len(r) == 4 else 1.0
                                        for r in rows])
                    x = (qg[b] @ kk.T) * (ksc * scale)[None]    # (G, n)
                    m_new = torch.maximum(m, x.max(1).values)
                    p = torch.exp2(x - m_new[:, None])
                    alpha = torch.exp2(m - m_new)
                    units[block % DECODE_UNITS] = (
                        m_new, lsum * alpha + p.sum(1),
                        o * alpha[:, None] + (p * vsc[None]) @ vv)
                    block += 1
                mx = torch.stack([u[0] for u in units]).max(0).values
                lsum, o = torch.zeros(G), torch.zeros(G, hd)
                for um, ul, uo in units:
                    w = torch.exp2(um - mx)
                    lsum, o = lsum + w * ul, o + w[:, None] * uo
                if s1 - s0 == live[b]:
                    out[b, 0, g * G:(g + 1) * G] = o / lsum[:, None]
                else:
                    slices[(b, cta)] = (mx, lsum, o)
        for b, ctas in enumerate(plan.slices(lens)):
            if not ctas:
                continue
            parts = [slices[(b, c)] for c in ctas]
            gs = da.group_size(len(parts))
            groups = [_merge_parts(parts[i:i + gs])
                      for i in range(0, len(parts), gs)]
            _, lsum, o = _merge_parts(groups)
            out[b, 0, g * G:(g + 1) * G] = o / lsum[:, None]
    return out


def _merge_parts(parts):
    """(m, l, O) parts merged in order onto their max: one (m, l, O)."""
    mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
    lsum, o = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for pm, pl, po in parts:
        w = torch.exp2(pm - mx)
        lsum, o = lsum + w * pl, o + w[:, None] * po
    return mx, lsum, o


def test_algorithm_matches_the_decode_twin():
    """One token per row at kv_len - 1: rows cut into slices over the
    plan's CTAs and a kv_len 0 row (zeros); then fewer live positions than
    CTAs (some CTAs' ranges empty, a row's slices those of its positions'
    CTAs), on two kv heads of groups of 2."""
    for seed, (B, H, KV, S, lengths) in enumerate(
            [(4, 8, 1, 700, [700, 5, 0, 129]), (3, 4, 2, 40, [7, 0, 20])]):
        q, k, v = _inputs(3 + seed, B, 1, S, H, KV)
        lens = torch.tensor(lengths)
        got = emulate_decode(q, S, KV, lengths,
                             lambda b, g, s: (k[b, s, g], v[b, s, g]))
        k_all = k.reshape(1, B, S, KV * HD)
        v_all = v.reshape(1, B, S, KV * HD)
        ref = h256.decode_hd256_plain(q, k_all, v_all, lens, 0, KV)
        live = [b for b, n in enumerate(lengths) if n]
        torch.testing.assert_close(got[live], ref[live], rtol=0, atol=1e-5)
        assert all(bool((got[b] == 0).all())
                   for b, n in enumerate(lengths) if n == 0)


def emulate_shared_prefix(q, P: int, KV: int, prefix_rows, suffix,
                          sms: int = H100_SMS):
    """B5 at hd 256's algorithm (``csrc/shared_prefix_hd256.cu``) in f32
    torch, q (B, L, H, 256): per kv head g and row tile of
    ``shared_prefix_plan`` (SP_ROWS rows of the B L G rows folded b-major:
    row f is query (f % LG) // G of batch row f // LG, head g G + f % G),
    each split walks its prefix tiles of SP_KEYS keys (keys past P masked)
    and the last split then the suffix tiles of every batch row its rows
    touch (a row allows key j of its own batch row's suffix when j <= its
    query index), with the online softmax in base 2; the splits' (O, m, l)
    merge in split order, a split with no allowed key weighing 0.
    ``prefix_rows(g, s)``: (k, v) of prefix key s, or (k, v, k_scale,
    v_scale) of a quantized prefix; ``suffix``: the (B, L, KV, 256) bf16
    suffix keys and values (sk, sv), at scale 1."""
    B, L, H, hd = q.shape
    G = H // KV
    LG = L * G
    R = B * LG
    plan = h256.shared_prefix_plan(B, L, H, KV, P, sms)
    scale = hd ** -0.5 * LOG2E
    sk, sv = suffix
    out = torch.zeros(B, L, H, hd)
    for g in range(KV):
        for q0 in range(0, R, h256.SP_ROWS):
            fs = torch.arange(q0, min(q0 + h256.SP_ROWS, R))
            bs, rs = fs // LG, (fs % LG) // G
            heads = g * G + fs % G
            qt = q[bs, rs, heads].float()                   # (n, hd)
            tiles = []
            for split in range(plan.splits):
                walk = [("p", t * h256.SP_KEYS, None)
                        for t in plan.tiles(split)]
                if split == plan.splits - 1:
                    for b in range(int(bs[0]), int(bs[-1]) + 1):
                        r_hi = int(rs[bs == b].max())
                        walk += [("s", j, b) for j in
                                 range(0, r_hi + 1, h256.SP_KEYS)]
                tiles.append(walk)
            parts = []
            for walk in tiles:
                m = torch.full((len(fs),), -math.inf)
                lsum = torch.zeros(len(fs))
                o = torch.zeros(len(fs), hd)
                for kind, k0, b in walk:
                    keys = torch.arange(k0, k0 + h256.SP_KEYS)
                    kk = torch.zeros(h256.SP_KEYS, hd)
                    vv = torch.zeros(h256.SP_KEYS, hd)
                    ksc = torch.ones(h256.SP_KEYS)
                    vsc = torch.ones(h256.SP_KEYS)
                    if kind == "p":
                        ok = (keys < P)[None].expand(len(fs), -1)
                        for i, s in enumerate(keys.tolist()):
                            if s < P:
                                rows = prefix_rows(g, s)
                                kk[i], vv[i] = rows[0], rows[1]
                                if len(rows) == 4:
                                    ksc[i], vsc[i] = rows[2], rows[3]
                    else:
                        n = min(h256.SP_KEYS, L - k0)
                        kk[:n] = sk[b, k0:k0 + n, g].float()
                        vv[:n] = sv[b, k0:k0 + n, g].float()
                        ok = (bs[:, None] == b) & (keys[None] <= rs[:, None])
                    x = (qt @ kk.T) * (ksc * scale)[None]
                    x = torch.where(ok, x, -math.inf)
                    m_new = torch.maximum(m, x.max(1).values)
                    u = torch.where(m_new == -math.inf, 0.0, m_new)
                    p = torch.exp2(x - u[:, None])
                    alpha = torch.exp2(m - u)
                    lsum = lsum * alpha + p.sum(1)
                    o = o * alpha[:, None] + (p * vsc[None]) @ vv
                    m = m_new
                parts.append((m, lsum, o))
            mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
            den, acc = torch.zeros(len(fs)), torch.zeros(len(fs), hd)
            for pm, pl, po in parts:
                w = torch.where(pm == -math.inf, 0.0, torch.exp2(pm - mx))
                den, acc = den + w * pl, acc + w[:, None] * po
            out[bs, rs, heads] = acc / den.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("B,L,H,KV,P", [(8, 64, 8, 1, 6716),
                                        (3, 64, 8, 1, 1000),
                                        (1, 64, 8, 1, 101), (1, 5, 8, 1, 64),
                                        (2, 40, 4, 2, 300), (4, 17, 8, 1, 0),
                                        (8, 64, 8, 2, 6716)])
def test_shared_prefix_plan_splits_every_prefix_tile_once(B, L, H, KV, P):
    """B5 at hd 256: a row tile of SP_ROWS folded rows per group (kv head
    x row tiles of the B L G rows), every prefix tile of SP_KEYS keys in
    exactly one split, no split without one where the prefix splits, one
    split where the groups fill the card; a split launch's workspace holds
    one partial per CTA, and the plan reads the shapes alone."""
    plan = h256.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    assert plan is h256.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    assert plan.groups == KV * -(-B * L * (H // KV) // h256.SP_ROWS)
    assert plan.key_tiles == -(-P // h256.SP_KEYS)
    tiles = [t for s in range(plan.splits) for t in plan.tiles(s)]
    assert tiles == list(range(plan.key_tiles))
    if plan.splits > 1:
        assert all(len(plan.tiles(s)) for s in range(plan.splits))
        assert plan.workspace_bytes == \
            plan.ctas * (h256.SP_ROWS * HD + 2 * h256.SP_ROWS) * 4
    else:
        assert plan.workspace_bytes == 0
    if plan.groups >= H100_SMS:
        assert plan.splits == 1
    assert plan.ctas <= max(H100_SMS, plan.groups)
