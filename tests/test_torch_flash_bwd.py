"""The training form of the flash attention in the port, on the CPU: the
plain versions of B2 with the logsumexp (``flash_attention_fwd_plain``) and
of B6 (``flash_attention_bwd_plain``) against the JAX package's Pallas
kernel in interpret mode (its forward's lse and ``jax.grad`` of its custom
VJP), and ``FlashAttentionFunction`` against autograd through
``mha_reference``. All in float32; dQ/dK/dV and lse within 1e-4 of the
largest reference magnitude (f32 sums in other orders, over up to 200 keys
and a group of up to 4 heads)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.kernels import flash_attention as jfa
from video3d_tpu_torch.kernels import flash_attention as fa
from video3d_tpu_torch.kernels.attention import mha_reference, mha_train

torch.set_num_threads(1)

REL = 1e-4
CASES = [  # B, L, H, KV, hd, lengths
    (2, 200, 4, 2, 32, [200, 137]),       # L not a block multiple
    (1, 150, 4, 1, 32, [150]),            # a GQA group of 4
]


def _inputs(B, L, H, KV, hd, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, L, H, hd)).astype(np.float32)
    return q, k, v, do, np.asarray(lengths, np.int32)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    bound = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |d| {err:.3e} > {bound:.3e}"


def _jax_lse(q, k, v, lengths, H, KV):
    """The Pallas forward's (B, H, L) lse, with the padding the JAX wrapper
    applies (L to a multiple of the 64-row blocks, hd to 128)."""
    B, L, _, hd = q.shape
    Lp = -(-L // 64) * 64

    def flat(x, heads):
        x = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * heads, L, hd)
        return jnp.pad(x, ((0, 0), (0, Lp - L), (0, 128 - hd)))

    len_bh = jnp.stack([jnp.repeat(jnp.asarray(lengths), H),
                        jnp.zeros((B * H,), jnp.int32)], axis=1)
    _, lse = jfa._fwd_call(flat(q, H), flat(k, KV), flat(v, KV), len_bh, H,
                           KV, True, 64, 64, hd ** -0.5, True, True)
    return np.asarray(lse).reshape(B, H, Lp)[:, :, :L]


@pytest.mark.parametrize("B,L,H,KV,hd,lengths", CASES)
def test_plain_fwd_lse_and_bwd_match_pallas_interpret(B, L, H, KV, hd,
                                                      lengths):
    q, k, v, do, lens = _inputs(B, L, H, KV, hd, lengths)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, lengths=jnp.asarray(lens),
                                  block_q=64, block_k=64, interpret=True)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    out, lse = fa.flash_attention_fwd_plain(t(q), t(k), t(v), t(lens))
    _close(out, jout, "out")
    _close(lse, _jax_lse(q, k, v, lens, H, KV), "lse")
    grads = fa.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(do),
                                         t(lens))
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.shape == want.shape
        _close(got, want, name)


@pytest.mark.parametrize("B,L,H,KV,hd,lengths", CASES)
def test_autograd_function_matches_mha_reference(B, L, H, KV, hd, lengths):
    """mha_train (FlashAttentionFunction, plain versions on the CPU) and
    autograd through mha_reference give the same output and gradients."""
    q, k, v, do, lens = _inputs(B, L, H, KV, hd, lengths, seed=1)
    outs, grads = [], []
    for fn in (lambda q, k, v: mha_train(q, k, v, torch.from_numpy(lens)),
               lambda q, k, v: mha_reference(q, k, v, causal=True,
                                             kv_len=torch.from_numpy(lens))):
        args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*args)
        out.backward(torch.from_numpy(do))
        outs.append(out.detach())
        grads.append([a.grad for a in args])
    _close(outs[0], outs[1].numpy(), "out")
    for name, got, want in zip(("dq", "dk", "dv"), grads[0], grads[1]):
        _close(got, want.numpy(), name)


def test_masked_keys_get_zero_gradient():
    """Keys at or past a row's length get exactly zero dK / dV."""
    q, k, v, do, lens = _inputs(2, 90, 4, 2, 16, [90, 41], seed=2)
    t = torch.from_numpy
    out, lse = fa.flash_attention_fwd_plain(t(q), t(k), t(v), t(lens))
    _, dk, dv = fa.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse,
                                             t(do), t(lens))
    assert float(dk[1, 41:].abs().max()) == 0.0
    assert float(dv[1, 41:].abs().max()) == 0.0
    assert float(dk[1, :41].abs().max()) > 0.0


def test_training_entries_do_not_fall_back_off_the_cpu():
    """A tensor on neither the CPU nor CUDA raises instead of taking the
    plain version."""
    q = torch.zeros((1, 64, 4, 128), device="meta")
    k = torch.zeros((1, 64, 2, 128), device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(q, k, k, lens)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bwd(q, k, k, q, torch.zeros((1, 4, 64),
                                                       device="meta"),
                               q, lens)
