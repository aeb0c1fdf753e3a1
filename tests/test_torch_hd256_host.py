"""Host logic of the head-width-256 attention kernels
(``csrc/attention_hd256.cu``, ``csrc/flash_attention_hd256.cu``,
``csrc/flash_attention_bwd_hd256.cu``, ``kernels/attention_hd256.py``) on
the CPU: the plans (``hd256_plan``: row tiles of 64 folded query rows,
splits of whole 64-key tiles that cover every key slot once, from the
shapes and the SM count alone; ``bwd_hd256_plan``: B6's split of each
group's query heads), the launch glue with a stand-in library (the
pointers, shapes and plan handed to the C entry, the stream's workspace
where the keys split, nothing but the output allocated on a second call,
no value of the lengths read on the host), and the kernels' algorithms
written out in plain torch against the plain twins: the WMMA kernel's
(each CTA's rows, positions and key range, the online softmax over 64-key
tiles in base 2, the empty partials of splits past a row's keys and the
merge) for B2 folded and B3, and the prefill kernel's
(:func:`emulate_prefill`)."""

import math

import pytest
import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import attention_hd256 as h256

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
    the same shapes give the same plan, and the Gemma-2B decode step
    splits its 136 key tiles over the card in one wave (68 CTAs of two)."""
    a = h256.hd256_plan(1, 1, 8, 1, 8704, H100_SMS)
    assert a is h256.hd256_plan(1, 1, 8, 1, 8704, H100_SMS)
    assert (a.splits, a.split_keys, a.row_tiles) == (68, 128, 1)


class _Library:
    """Records each C call; returns success."""

    def __init__(self):
        self.calls = []

    def v3d_attention_hd256(self, *args):
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


@pytest.mark.parametrize("form,L,S,q_off", [("folded", 64, 900, [700, 100]),
                                            ("decode", 1, 900, None)])
def test_launch_hands_the_plan_to_the_c_entry(form, L, S, q_off,
                                              monkeypatch):
    B, H, KV = 2, 8, 2
    q = torch.zeros(B, L, H, HD, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV * HD, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    lens = torch.tensor([S, S // 2], dtype=torch.int32)
    offs = None if q_off is None else torch.tensor(q_off, dtype=torch.int32)
    lib, stream = _Library(), 400 + L
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


def test_algorithm_matches_the_decode_twin():
    """One token per row at kv_len - 1, fewer live positions than CTAs in
    some rows, and a kv_len 0 row, which reads zeros."""
    B, H, KV, S = 4, 8, 1, 700
    q, k, v = _inputs(3, B, 1, S, H, KV)
    lens = torch.tensor([700, 5, 0, 129])
    got = _emulate(q, k, v, lens, None, 2)
    k_all = k.reshape(1, B, S, KV * HD)
    v_all = v.reshape(1, B, S, KV * HD)
    ref = h256.decode_hd256_plain(q, k_all, v_all, lens, 0, KV)
    live = [0, 1, 3]
    torch.testing.assert_close(got[live], ref[live], rtol=0, atol=1e-5)
    assert bool((got[2] == 0).all())
