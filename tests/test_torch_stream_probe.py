"""Kernel B9's plain versions (``video3d_tpu_torch/kernels/stream_probe.py``)
against the JAX package's HBM stream probes, on the CPU at tiny shapes.

The probes are closures inside each script's ``main()`` and cannot be
imported, so each test rebuilds its ``pallas_call`` here from the kernel
body at the cited line, run with ``interpret=True``:
``scripts/bench/kv_probe.py:42`` (B9a), ``scripts/bench/int8_matvec.py:55``
(B9b), ``scripts/bench/stream_probe.py:73`` (B9c, strided and ``--contig``)
and ``:113`` (B9d, ``--split-same``). Rows must be equal; the checksums
(the port's addition) are held against numpy's wrapping sums of each
block's 4-byte words. The wrappers' checks and their launch counts close
the file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import stream_probe as sp

torch.set_num_threads(1)

S, KV, HD, BS = 256, 2, 128, 64
IN, OUT, BO = 64, 1024, 256


def _t(value, n=1):
    return np.full((1, n), value, np.float32)


def _int8(seed, shape):
    return np.random.default_rng(seed).integers(
        -127, 128, size=shape).astype(np.int8)


def _np_sums(blocks):
    """(nblk, ...) arrays -> (nblk,) uint32 wrapping sums of 4-byte words."""
    words = np.ascontiguousarray(blocks).view(np.uint32)
    s = words.reshape(words.shape[0], -1).astype(np.uint64).sum(1)
    return (s & 0xFFFFFFFF).astype(np.uint32)


def _u32(t):
    return t.numpy().view(np.uint32)


def _jax_kv(k, v, t, bs):
    """kv_probe.py:42-65, interpret mode."""
    nj = k.shape[0] // bs

    def kernel(k_ref, v_ref, t_ref, o_ref):
        row = (t_ref[...]
               + k_ref[0, 0, :].astype(jnp.float32)[None]
               + v_ref[0, 0, :].astype(jnp.float32)[None])
        o_ref[...] = jnp.broadcast_to(row, o_ref.shape)

    spec = pl.BlockSpec((bs, KV, HD), lambda j: (j, 0, 0))
    return np.asarray(pl.pallas_call(
        kernel, grid=(nj,),
        in_specs=[spec, spec, pl.BlockSpec((1, HD), lambda j: (0, 0))],
        out_specs=pl.BlockSpec((8, HD), lambda j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((nj * 8, HD), jnp.float32),
        interpret=True)(jnp.asarray(k), jnp.asarray(v), jnp.asarray(t)))


def _jax_one(q, t, bo):
    """int8_matvec.py:55-68, interpret mode (int8 or bf16 weight)."""
    def probe_kernel(q_ref, t_ref, o_ref):
        o_ref[...] = q_ref[0, :].astype(jnp.float32)[None] + t_ref[...]

    n, m = q.shape
    return np.asarray(pl.pallas_call(
        probe_kernel, grid=(m // bo,),
        in_specs=[pl.BlockSpec((n, bo), lambda i: (0, i)),
                  pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, bo), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, m), jnp.float32),
        interpret=True)(q, jnp.asarray(t)))


def _jax_multi(qs, t, bo, contig):
    """stream_probe.py:73-98, interpret mode."""
    K = len(qs)
    G = OUT // bo

    def probe_kernel(*refs):
        t_ref = refs[K]
        o_ref = refs[K + 1]
        acc = t_ref[...]
        for r in refs[:K]:
            blk = r[0] if contig else r[...]
            acc = acc + blk[0, :].astype(jnp.float32)[None]
        o_ref[...] = acc

    w_spec = (pl.BlockSpec((1, IN, bo), lambda i: (i, 0, 0)) if contig
              else pl.BlockSpec((IN, bo), lambda i: (0, i)))
    return np.asarray(pl.pallas_call(
        probe_kernel, grid=(G,),
        in_specs=[w_spec for _ in range(K)]
        + [pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, bo), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, OUT), jnp.float32),
        interpret=True)(*[jnp.asarray(q) for q in qs], jnp.asarray(t)))


def _jax_split(q, t, bo, K):
    """stream_probe.py:113-135, interpret mode."""
    Gk = OUT // bo // K

    def probe_kernel(*refs):
        t_ref = refs[K]
        acc = t_ref[...]
        outs = refs[K + 1:]
        for r, o_ref in zip(refs[:K], outs):
            o_ref[...] = acc + r[0, :].astype(jnp.float32)[None]

    def in_map(off):
        return lambda i: (0, i + off)

    ys = pl.pallas_call(
        probe_kernel, grid=(Gk,),
        in_specs=[pl.BlockSpec((IN, bo), in_map(j * Gk)) for j in range(K)]
        + [pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((1, bo), lambda i: (0, i))
                   for _ in range(K)],
        out_shape=[jax.ShapeDtypeStruct((1, OUT // K), jnp.float32)
                   for _ in range(K)],
        interpret=True)(*([jnp.asarray(q)] * K), jnp.asarray(t))
    return np.concatenate([np.asarray(y) for y in ys], 0)


@pytest.mark.parametrize("tval", [0.0, 3e-6, -2.5])
def test_kv_probe_plain_matches_pallas(tval):
    k, v = _int8(0, (S, KV, HD)), _int8(1, (S, KV, HD))
    t = np.linspace(tval, tval + 1.0, HD, dtype=np.float32)[None]
    out, sums = sp.kv_probe(torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(t), BS)
    np.testing.assert_array_equal(out.numpy(), _jax_kv(k, v, t, BS))
    nj = S // BS
    for i, x in enumerate((k, v)):
        np.testing.assert_array_equal(_u32(sums[i]),
                                      _np_sums(x.reshape(nj, -1)))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("tval", [0.0, 7e-6])
def test_matvec_probe_plain_matches_pallas(dtype, tval):
    q8 = _int8(2, (IN, OUT))
    jq = jnp.asarray(q8).astype(getattr(jnp, dtype))
    tq = torch.from_numpy(q8).to(getattr(torch, dtype))
    t = _t(tval)
    out, sums = sp.matvec_probe(tq, torch.from_numpy(t), BO)
    np.testing.assert_array_equal(out.numpy(), _jax_one(jq, t, BO))
    raw = tq.view(torch.int16).numpy() if dtype == "bfloat16" else q8
    blocks = raw.reshape(IN, OUT // BO, BO).transpose(1, 0, 2)
    np.testing.assert_array_equal(_u32(sums[0]), _np_sums(blocks))


@pytest.mark.parametrize("contig", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_stream_probe_plain_matches_pallas(K, contig):
    q8s = [_int8(10 + k, (IN, OUT)) for k in range(K)]
    t = _t(1e-6 * K)
    tiles = [q.reshape(IN, OUT // BO, BO).transpose(1, 0, 2) for q in q8s]
    jin = tiles if contig else q8s
    qs = [torch.from_numpy(q) for q in q8s]
    if contig:
        qs = [sp.tile_contig(q, BO) for q in qs]
        np.testing.assert_array_equal(qs[0].numpy(), tiles[0])
    out, sums = sp.stream_probe(qs, torch.from_numpy(t), BO, contig=contig)
    np.testing.assert_array_equal(out.numpy(),
                                  _jax_multi(jin, t, BO, contig))
    for k in range(K):
        np.testing.assert_array_equal(_u32(sums[k]), _np_sums(tiles[k]))


@pytest.mark.parametrize("K", [1, 2, 4])
def test_split_probe_plain_matches_pallas(K):
    q8 = _int8(20, (IN, OUT))
    t = _t(-4e-6)
    out, sums = sp.split_probe(torch.from_numpy(q8), torch.from_numpy(t),
                               BO, K)
    np.testing.assert_array_equal(out.numpy(), _jax_split(q8, t, BO, K))
    blocks = q8.reshape(IN, OUT // BO, BO).transpose(1, 0, 2)
    np.testing.assert_array_equal(_u32(sums).reshape(-1), _np_sums(blocks))


def test_controls_differ_from_the_plain_versions():
    """The checks chip_smoke.py makes must be able to fail: a checksum that
    skips each block's last row, and B9d read one block late."""
    q = torch.from_numpy(_int8(30, (IN, OUT)))
    t = torch.zeros(1, 1)
    _, good = sp.matvec_probe_plain(q, t, BO)
    _, bad = sp.matvec_probe_plain(q, t, BO, skip_last_row=True)
    assert bool((good != bad).all())
    out, _ = sp.split_probe_plain(q, t, BO, 2)
    shifted, _ = sp.split_probe_plain(q, t, BO, 2, shift=1)
    assert not torch.equal(out, shifted)
    k = torch.from_numpy(_int8(31, (S, KV, HD)))
    _, good = sp.kv_probe_plain(k, k, torch.zeros(HD), BS)
    _, bad = sp.kv_probe_plain(k, k, torch.zeros(HD), BS, skip_last_row=True)
    assert bool((good != bad).all())


@pytest.mark.parametrize("form", ["kv", "matvec_int8", "matvec_bf16",
                                  "strided", "contig", "split"])
def test_probe_cli_checks_catch_every_control(form):
    """``bench/probes.py`` with ``check=True``, as chip_smoke.py phase 3
    runs it, at tiny shapes on the CPU: rows and checksums equal the plain
    version, and every control differs from the kernel's result."""
    from video3d_tpu_torch.bench import probes

    cpu = torch.device("cpu")
    shape = (IN, OUT)
    run = {"kv": lambda: probes.probe_kv(cpu, bss=(BS, 2 * BS), seq=S,
                                         check=True),
           "matvec_int8": lambda: probes.probe_matvec(
               cpu, bo=BO, shape=shape, check=True),
           "matvec_bf16": lambda: probes.probe_matvec(
               cpu, "bfloat16", bo=BO, shape=shape, check=True),
           "strided": lambda: probes.probe_stream(
               cpu, ks=(1, 3), bo=BO, shape=shape, check=True),
           "contig": lambda: probes.probe_stream(
               cpu, ks=(2,), bo=BO, shape=shape, contig=True, check=True),
           "split": lambda: probes.probe_stream(
               cpu, ks=(1, 2, 4), bo=BO, shape=shape, split_same=True,
               check=True)}[form]
    rows = run()
    assert rows
    for row in rows:
        assert row["max_abs_err"] == 0.0
        assert len(row["caught"]) == (2 if form == "split" else 1)
        assert all(n > 0 for n in row["caught"].values()), row
        assert row["io_bytes"] > row["bytes"]


def test_cpu_calls_count_no_launch():
    before = dict(_build.LAUNCHES)
    q = torch.from_numpy(_int8(40, (IN, OUT)))
    t = torch.zeros(1, 1)
    sp.matvec_probe(q, t, BO)
    sp.stream_probe([q, q], t, BO)
    sp.split_probe(q, t, BO, 2)
    sp.kv_probe(q.view(S, KV, HD), q.view(S, KV, HD), torch.zeros(HD), BS)
    assert _build.LAUNCHES == before


def test_wrappers_reject_what_the_kernel_does_not_take():
    """The CUDA branch's checks, reached with ``meta`` tensors (no kernel
    runs): wrong dtype, shape and contiguity raise before any launch."""
    m = torch.device("meta")
    q = torch.empty(IN, OUT, dtype=torch.int8, device=m)
    t = torch.empty(1, 1, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        sp.matvec_probe(q, t, BO)
    with pytest.raises(ValueError, match="no kernel"):
        sp.kv_probe(q.view(S, KV, HD), q.view(S, KV, HD),
                    torch.empty(HD, device=m), BS)
    with pytest.raises(ValueError, match="bo"):
        sp.matvec_probe(q, t, 300)
    with pytest.raises(ValueError, match="K"):
        sp.split_probe(q, t, BO, 3)
    with pytest.raises(ValueError, match="streams"):
        sp.stream_probe([q] * 5, t, BO)
    with pytest.raises(ValueError, match="contig"):
        sp.stream_probe([q], t, BO, contig=True)
    with pytest.raises(ValueError, match="contiguous"):
        sp.matvec_probe(q.float(), t, BO)
    with pytest.raises(ValueError, match="contiguous"):
        sp.stream_probe([q, q.t().contiguous().t()], t, BO)
    with pytest.raises(ValueError, match="t must be"):
        sp.matvec_probe(q, torch.empty(2, device=m), BO)
    with pytest.raises(ValueError, match="bs"):
        sp.kv_probe(q.view(S, KV, HD), q.view(S, KV, HD),
                    torch.empty(HD, device=m), 100)


# ---- B9a's cut of K and V over the SMs (kv_probe_plan), on the host

PROBE_S, PROBE_KV = 32768, 4


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bs", [4096, 8192, 16384])
def test_kv_probe_plan_covers_every_byte_once(bs, sms):
    """At the probe script's shape and every ``--bss`` size, for 132 and
    114 SMs: the CTAs' ranges tile K then V, unit after unit, from the
    first byte to the last; copy units divide a block; every range holds
    the same units give or take one, and touches few enough blocks."""
    plan = sp.kv_probe_plan(PROBE_S, PROBE_KV, HD, bs, sms)
    nbytes = PROBE_S * PROBE_KV * HD
    assert plan.ctas == sms
    assert plan.unit == sp.KV_UNIT
    assert plan.units_per_stream * plan.unit == nbytes
    assert plan.units_per_block * plan.unit == bs * PROBE_KV * HD
    assert plan.begins[0] == 0
    assert plan.begins[-1] == 2 * plan.units_per_stream
    covered = []
    for c in range(plan.ctas):
        covered += range(plan.begins[c], plan.begins[c + 1])
        assert len(plan.blocks_touched(c)) <= sp.KV_MAX_TOUCHED
    assert covered == list(range(2 * plan.units_per_stream))
    sizes = [b - a for a, b in zip(plan.begins, plan.begins[1:])]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bs", [4096, 8192, 16384])
def test_kv_probe_split_sums_equal_the_plain_checksums(bs, sms):
    """The ranges' per-block partial sums (the kernel's one atomic add per
    block a range touches, mirrored on the host) add up to the plain
    version's checksums; a range that crosses a block boundary splits its
    sum there."""
    plan = sp.kv_probe_plan(PROBE_S, PROBE_KV, HD, bs, sms)
    k = torch.from_numpy(_int8(50, (PROBE_S, PROBE_KV, HD)))
    v = torch.from_numpy(_int8(51, (PROBE_S, PROBE_KV, HD)))
    _, want = sp.kv_probe_plain(k, v, torch.zeros(HD), bs)
    assert torch.equal(sp.kv_probe_split_sums(k, v, plan), want)
    # every block boundary either starts a range or splits one
    starts = set(plan.begins)
    upb = plan.units_per_block
    for edge in range(upb, 2 * plan.units_per_stream, upb):
        split = [c for c in range(plan.ctas)
                 if plan.begins[c] < edge < plan.begins[c + 1]]
        assert (edge in starts) != bool(split), edge


@pytest.mark.parametrize("tval", [0.0, 0.375])
def test_kv_probe_plain_rows_equal_the_script_body_in_numpy(tval):
    """kv_probe.py:50-54's kernel body per grid step j, in numpy float32:
    out[8j:8j + 8] = t + k[j bs, 0, :] + v[j bs, 0, :]."""
    k, v = _int8(52, (S, KV, HD)), _int8(53, (S, KV, HD))
    t = np.full((1, HD), tval, np.float32)
    want = np.concatenate([
        np.broadcast_to(t + k[j * BS, 0, :].astype(np.float32)[None]
                        + v[j * BS, 0, :].astype(np.float32)[None], (8, HD))
        for j in range(S // BS)])
    out, _ = sp.kv_probe_plain(torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(t), BS)
    np.testing.assert_array_equal(out.numpy(), want)
