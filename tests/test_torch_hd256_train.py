"""The training forms at head width 256 (Gemma) on the CPU: B2 with the
logsumexp (the kLse instantiation of ``csrc/flash_attention_hd256.cu``)
and B6 at hd 256 (``csrc/flash_attention_bwd_hd256.cu``).

* The kernels' algorithms written out in plain torch against the twins
  (``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain``) at 1e-5
  of the largest reference value: the forward's 128-row query tiles, each
  consumer's 64 rows over the 64-key tiles it sees (one fewer than the
  CTA's where its causal rows end first), the online softmax in base 2,
  the lse of a row with no allowed key (:func:`emulate_prefill`, causal or
  not); B6's CTAs of ``bwd_hd256_plan`` (64 keys, a split of the group's
  heads, each head's query tiles from the causal start), dQ summed over
  the key tiles, the splits' dK / dV partials summed in order, key tiles
  past the length left at zero.
* The launch glue with a stand-in library: the pointers, shapes, plan,
  causal flag and scale handed to each C entry, the launch counts, only
  the outputs and scratch allocated on a second call, no tensor value read
  on the host.
* Three f32 ``train_step``s of the tiny hd-256 Gemma
  (``tests/family_configs.py``) against JAX's, loss and grad_norm within
  1e-4 relative, as ``tests/test_torch_train_step.py`` holds Qwen2.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.config import DataConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention_hd256 as h256
from video3d_tpu_torch.kernels import flash_attention as fa
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from family_configs import jax_params, model_config
from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config
from test_torch_hd256_host import (H100_SMS, _count_allocations,
                                   _no_host_reads, emulate_prefill)

torch.set_num_threads(1)

HD = h256.HEAD_DIM
TILE = 64          # B6's keys per CTA and query rows per tile (csrc kBk, kBq)
REL = 1e-5
LOG2E = math.log2(math.e)


def _inputs(seed, B, L, H, KV):
    g = torch.Generator().manual_seed(seed)
    q = 3.0 * torch.randn(B, L, H, HD, generator=g)
    k = torch.randn(B, L, KV, HD, generator=g)
    v = 0.5 * torch.randn(B, L, KV, HD, generator=g)
    do = torch.randn(B, L, H, HD, generator=g)
    return q, k, v, do


def _close(got, want, what, rel=REL):
    bound = rel * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= bound, f"{what}: max |d| {err:.3e} > {bound:.3e}"


# ---------------------------------------------------------------------------
# the algorithms in plain torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,H,KV,lengths", [
    (2, 200, 8, 2, [200, 77]),      # a ragged 128-row tile, a short row
    (1, 150, 4, 1, [129]),          # the length one past a tile's edge
])
def test_lse_algorithm_matches_the_twin(B, L, H, KV, lengths, causal):
    """The training form's output and lse, causal and not, rows past the
    length included."""
    q, k, v, _ = _inputs(1, B, L, H, KV)
    lens = torch.tensor(lengths)
    got, lse = emulate_prefill(q, k, v, lens, causal)
    ref, ref_lse = h256.prefill_lse_hd256_plain(q, k, v, lens, causal)
    _close(got, ref, "out")
    _close(lse, ref_lse, "lse")


def test_lse_algorithm_of_a_row_with_no_key():
    """A length-0 row: no key is allowed, its output is 0 and its lse
    -1e30 + log(1e-30), the hd-128 kernel's value."""
    q, k, v, _ = _inputs(4, 2, 70, 2, 1)
    got, lse = emulate_prefill(q, k, v, torch.tensor([0, 70]))
    assert not got[0].any()
    want = torch.tensor(-1e30) + torch.log(torch.tensor(1e-30))
    assert bool((lse[0] == want).all())


def _emulate_bwd(q, k, v, do, lse, delta, lens, causal, sms=H100_SMS):
    """B6's algorithm: per CTA of ``bwd_hd256_plan`` (64 keys, batch row,
    kv head, split), none for a key tile at or past the length, else its
    split's heads and each head's query tiles from the tile's own start
    (causal) or 0 to L; S^T, P^T, dP^T, dS^T; dV += P^T dO and dK += dS^T
    Q into the split's partial, dQ += dS K added over the key tiles; the
    partials summed in split order."""
    B, L, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    plan = h256.bwd_hd256_plan(B, L, H, KV, causal, sms)
    assert plan.splits * plan.heads == G
    scale = hd ** -0.5
    dq = torch.zeros(B, L, H, hd)
    dk_part = torch.zeros(plan.partial_shape(B, L, KV))
    dv_part = torch.zeros_like(dk_part)
    for kt in range(plan.key_tiles):
        k0 = kt * TILE
        keys = torch.arange(k0, min(k0 + TILE, L))
        for b in range(B):
            n = min(max(int(lens[b]), 0), L)
            qstart = (k0 if causal else 0) if k0 < n else L
            for g in range(KV):
                kk, vv = k[b, keys, g], v[b, keys, g]
                for sp in range(plan.splits):
                    h0 = g * G + sp * plan.heads
                    for h in range(h0, h0 + plan.heads):
                        for q0 in range(qstart, L, TILE):
                            rows = torch.arange(q0, min(q0 + TILE, L))
                            qt, dot = q[b, rows, h], do[b, rows, h]
                            lse2 = lse[b, h, rows] * LOG2E
                            st = kk @ qt.T
                            ok = (keys[:, None] < n) & (
                                (keys[:, None] <= rows[None])
                                | (not causal))
                            pt = torch.where(ok, torch.exp2(
                                st * scale * LOG2E - lse2[None]), 0.0)
                            dst = pt * (vv @ dot.T
                                        - delta[b, h, rows][None]) * scale
                            dv_part[sp, b, keys, g] += pt @ dot
                            dk_part[sp, b, keys, g] += dst @ qt
                            dq[b, rows, h] += dst.T @ kk
    return dq, dk_part.sum(0), dv_part.sum(0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,H,KV,lengths", [
    (1, 150, 8, 1, [150]),          # Gemma's group of 8, a ragged tile
    (2, 129, 4, 2, [129, 63]),      # groups of 2; a tile past one length
    (1, 130, 2, 2, [65]),           # groups of 1; the length mid-tile
])
def test_bwd_algorithm_matches_the_twin(B, L, H, KV, lengths, causal):
    q, k, v, do = _inputs(2, B, L, H, KV)
    lens = torch.tensor(lengths)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, lens, causal)
    delta = (do * out).sum(-1).transpose(1, 2)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, lens, causal)
    dq, dk, dv = _emulate_bwd(q, k, v, do, lse, delta, lens, causal)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(got, want, name)
    for b, n in enumerate(lengths):     # keys past the length: zeros
        assert not dk[b, n:].any() and not dv[b, n:].any()


# ---------------------------------------------------------------------------
# the launch glue, with a stand-in library
# ---------------------------------------------------------------------------

class _Library:
    """Records each C call by entry; returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("v3d_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.setdefault(name, []).append(args)
            return 0
        return call


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,H,KV", [(1, 8192, 8, 1), (1, 129, 8, 1),
                                      (2, 300, 8, 2)])
def test_lse_launch_hands_the_plan_to_the_c_entry(B, L, H, KV, causal,
                                                  monkeypatch):
    """The training form's C entry gets the tensors, the shapes (its grid
    of 128-row query tiles is the entry's own), the causal flag and the
    scale; a second call allocates only out and lse."""
    q, k = _bf16(B, L, H, HD), _bf16(B, L, KV, HD)
    v = torch.zeros_like(k)
    lens = torch.tensor([L] * B, dtype=torch.int32)
    lib, stream = _Library(), 700 + L
    before = _build.LAUNCHES["flash_attention_lse_hd256"]
    out, lse = h256._launch_prefill(lib, stream, q, k, v, lens, causal,
                                    with_lse=True)
    assert _build.LAUNCHES["flash_attention_lse_hd256"] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    (args,) = lib.calls["v3d_flash_attention_hd256_lse"]
    assert len(args) == len(
        _build._SIGNATURES["v3d_flash_attention_hd256_lse"])
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), lse.data_ptr(), B, L, L,
                    H, KV, int(causal), pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_prefill(lib, stream, q, k, v, lens, causal, with_lse=True)
    assert made == ["empty_like", "empty"]        # out and lse alone


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_launch_hands_its_arguments_to_the_c_entry(causal,
                                                           monkeypatch):
    """The inference form: the same entry arguments without the lse,
    counted as flash_attention_hd256; only the output allocated."""
    B, L, H, KV = 2, 200, 8, 2
    q, k = _bf16(B, L, H, HD), _bf16(B, L, KV, HD)
    v = torch.zeros_like(k)
    lens = torch.tensor([200, 9], dtype=torch.int32)
    lib, stream = _Library(), 77
    before = dict(_build.LAUNCHES)
    out, lse = h256._launch_prefill(lib, stream, q, k, v, lens, causal,
                                    with_lse=False)
    assert lse is None and out.shape == q.shape
    assert {n: _build.LAUNCHES[n] - before[n] for n in before
            if _build.LAUNCHES[n] != before[n]} == {"flash_attention_hd256": 1}
    (args,) = lib.calls["v3d_flash_attention_hd256"]
    assert len(args) == len(_build._SIGNATURES["v3d_flash_attention_hd256"])
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), B, L, L, H, KV,
                    int(causal), pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_prefill(lib, stream, q, k, v, lens, causal, with_lse=False)
    assert made == ["empty_like"]


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_launch_hands_its_arguments_to_the_c_entry(causal,
                                                       monkeypatch):
    """B6's entry gets the plan's split count; the wrapper zeroes the dQ
    scratch, allocates the partials (every element written by the kernel)
    and returns their sums in bf16."""
    B, L, H, KV = 2, 130, 8, 2
    q, do, k = _bf16(B, L, H, HD), _bf16(B, L, H, HD), _bf16(B, L, KV, HD)
    v = torch.zeros_like(k)
    lse, delta = torch.zeros(B, H, L), torch.ones(B, H, L)
    rows = fa.bwd_rows(lse, delta)
    assert rows.shape == (B, H, 2, fa.rows_len(L))
    lens = torch.tensor([130, 7], dtype=torch.int32)
    lib, stream = _Library(), 901
    plan = h256.bwd_hd256_plan(B, L, H, KV, causal, H100_SMS)
    before = _build.LAUNCHES["flash_attention_bwd_hd256"]
    dq, dk, dv = h256._launch_bwd(lib, stream, H100_SMS, q, k, v, do, rows,
                                  lens, causal)
    assert _build.LAUNCHES["flash_attention_bwd_hd256"] == before + 1
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    (args,) = lib.calls["v3d_flash_attention_bwd_hd256"]
    assert len(args) == len(
        _build._SIGNATURES["v3d_flash_attention_bwd_hd256"])
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), rows.data_ptr(), lens.data_ptr())
    assert args[9:] == (B, L, L, H, KV, plan.splits, int(causal),
                        pytest.approx(HD ** -0.5), stream)
    assert len({args[6], args[7], args[8]}) == 3
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_bwd(lib, stream, H100_SMS, q, k, v, do, rows, lens, causal)
    assert made == ["zeros", "empty", "empty"]    # dQ scratch, partials


def test_training_wrappers_refuse_what_they_do_not_take():
    """Shapes the training forms do not take raise a ValueError before any
    launch (the dtype and device checks come first; CPU tensors reach them
    here)."""
    q, k = _bf16(1, 64, 8, HD), _bf16(1, 64, 1, HD)
    lens = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="must be"):     # f16
        h256.prefill_lse_hd256(q.half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError, match="shapes"):      # L != S
        h256.prefill_lse_hd256(q, _bf16(1, 32, 1, HD), _bf16(1, 32, 1, HD),
                               lens)
    with pytest.raises(ValueError, match="shapes"):      # hd 128
        h256.prefill_lse_hd256(_bf16(1, 64, 8, 128), _bf16(1, 64, 1, 128),
                               _bf16(1, 64, 1, 128), lens)
    lse = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="must be"):     # an f32 dO
        h256.bwd_hd256(q, k, k, q.float(), lse, lse, lens)
    with pytest.raises(ValueError, match="do"):          # lse (B, L, H)
        h256.bwd_hd256(q, k, k, q, lse.transpose(1, 2).contiguous(), lse,
                       lens)


# ---------------------------------------------------------------------------
# three f32 train steps of the tiny hd-256 Gemma against JAX's
# ---------------------------------------------------------------------------

USED = ("vision", "projector", "image_newline", "llm")
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)


@pytest.fixture(scope="module")
def gemma_batch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    with open(ann) as f:
        records = json.load(f)
    records[1]["conversations"][0]["value"] += " on the left of the door"
    with open(ann, "w") as f:
        json.dump(records, f)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    ds = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                               image_processor=SigLipImageProcessor(
                                   size=(56, 56)))
    cfg = model_config("gemma_hd256")
    assert cfg.llm.head_dim == HD
    col = jds.Collator(cfg, jds.CollatorConfig(max_len=160,
                                               frames_upbound=2))
    arrays = col([ds[0], ds[1]])
    assert len(set(arrays["seq_len"].tolist())) == 2      # ragged rows
    return cfg, arrays


def test_three_f32_steps_match_jax(gemma_batch):
    """The port's train_step (remat; B2 with the lse and B6 through their
    plain versions at hd 256) against JAX's (XLA's autodiff of its plain
    attention on the CPU): loss and grad_norm of each of three steps within
    1e-4 relative, and the losses moved."""
    cfg, arrays = gemma_batch
    full = jax_params(cfg)
    used = {k: full[k] for k in USED}
    jparams = jax.tree.map(jnp.array, used)          # the JAX step donates
    jtx = joptim.build_optimizer(jparams, joptim.OptimConfig(**OPT))
    jstate = jts.create_train_state(jparams, jtx)
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()
                          if k in jlv.Batch._fields and v is not None})
    tcfg = port_config(cfg)
    tparams = from_jax_params(used, tcfg, device="cpu")
    ttx = toptim.build_optimizer(tparams, toptim.OptimConfig(**OPT))
    tstate = tts.create_train_state(tparams, ttx)
    tbatch = to_batch(arrays, "cpu")
    losses = []
    for step in range(3):
        jstate, jm = jts.train_step(jstate, jbatch, cfg, jtx, remat=False,
                                    scan_layers=False, compute_dtype=None)
        tstate, tm = tts.train_step(tstate, tbatch, tcfg, ttx, remat=True,
                                    compute_dtype=None)
        for key in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4,
                                       err_msg=f"step {step} {key}")
        losses.append(float(tm["lm_loss"]))
    assert losses[2] != losses[0]
    assert tstate.step == 3
