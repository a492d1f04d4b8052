"""Port parity of the attention backward passes, fp32 on the CPU: the plain
versions that CPU tensors take through the B3 (dq) and B4 (dk/dv) wrappers,
inside the flash autograd Function, against ``jax.vjp`` of the JAX Pallas
flash kernel in interpret mode; and ``mh_attention``'s autograd against
``jax.vjp`` of the JAX ``mh_attention``. Bound: max abs error <= 1e-4 of
the reference gradient's max |value| (the ROADMAP bar is 1e-3).

A query row with no valid key is left out of the comparison with JAX by a
zero cotangent on it: the JAX kernel's ``exp(s - lse)`` is 1 on such a row
(ROADMAP C), the port's is 0, so the port gives such rows zero gradients
whatever their cotangent (tested on its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.ops.pallas import flash_attention as jfa
from macaw_llm_tpu.ops.pallas import mh_attention as jmh
from macaw_llm_tpu_torch.ops.kernels import flash_attention as tfa
from macaw_llm_tpu_torch.ops.kernels import mh_attention as tmh

REL = 1e-4


def _inputs(seed, b, sq, sk, n, d, masked_row=False):
    rng = np.random.RandomState(seed)

    def mk(s):
        return (rng.randn(b, s, n, d) * 0.5).astype(np.float32)

    q, k, v, g = mk(sq), mk(sk), mk(sk), mk(sq)
    bias = np.zeros((b, sk), np.float32)
    bias[-1, sk - sk // 3:] = jfa.NEG_INF   # right padding on the last row
    if masked_row:
        bias[0, :] = jfa.NEG_INF            # batch row 0: no valid key
        g[0] = 0.0
    return q, k, v, g, bias


def _close(got, ref, name):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= REL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def _port_grads(fn, arrays, cotangents):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return [t.grad for t in ts]


@pytest.mark.parametrize("sq,sk,d,causal,with_bias", [
    (37, 37, 64, True, True),     # causal, padded, ragged (no tile multiple)
    (29, 45, 64, False, True),    # Sq != Sk, non-causal, ragged both ways
    (50, 50, 32, True, False),    # causal, no bias
    (24, 70, 16, False, False),
])
def test_flash_backward_matches_pallas(sq, sk, d, causal, with_bias):
    b, n = 2, 2
    q, k, v, g, bias = _inputs(0, b, sq, sk, n, d)
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, jb, causal=causal), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    got = _port_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, tb, causal=causal), (q, k, v), (g,))
    for name, a, r in zip("qkv", got, ref):
        _close(a, r, "d" + name)


def test_flash_with_lse_cotangent_matches_pallas():
    """Both outputs carry a cotangent: the LSE's adds p * g_lse to ds
    (the reference's ``_flash_core_lse_bwd``)."""
    b, sq, sk, n, d = 2, 33, 41, 2, 64
    q, k, v, g, bias = _inputs(1, b, sq, sk, n, d, masked_row=True)
    g_lse = np.random.RandomState(2).randn(b, sq, n).astype(np.float32)
    g_lse[0] = 0.0
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, jnp.asarray(bias), causal=False),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    got = _port_grads(lambda q, k, v: tfa.flash_attention_with_lse(
        q, k, v, torch.from_numpy(bias), causal=False), (q, k, v),
        (g, g_lse))
    for name, a, r in zip("qkv", got, ref):
        _close(a, r, "d" + name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradcheck_float64(causal):
    """The autograd Function's backward (the plain recompute formula)
    against finite differences, both outputs used, a padded key."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, s, 2, 4)).requires_grad_()
               for s in (5, 6, 6))
    bias = torch.zeros(1, 6, dtype=torch.float64)
    bias[0, 4] = tfa.NEG_INF

    def fn(q, k, v):
        out, lse = tfa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        return out, lse

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_fully_masked_rows_give_zero_grads():
    """A batch row with no valid key: zero dq, dk, dv whatever its
    cotangent (the JAX kernel's would not be zero there)."""
    b, sq, sk, n, d = 2, 20, 26, 2, 16
    q, k, v, _, bias = _inputs(4, b, sq, sk, n, d, masked_row=True)
    g = np.random.RandomState(5).randn(b, sq, n, d).astype(np.float32)
    dq, dk, dv = _port_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, torch.from_numpy(bias), causal=True), (q, k, v), (g,))
    for t in (dq, dk, dv):
        assert not t[0].any() and t[1].abs().max() > 0
    # the masked keys of the last row get no dk/dv either
    masked = bias[-1] < 0
    assert not dk[-1][masked].any() and not dv[-1][masked].any()


def test_backward_wrappers_on_cpu_count_no_launch():
    """On CPU tensors the B3/B4 wrappers take the plain version (the same
    numbers as the reference formula) and leave their counters alone."""
    b, sq, sk, n, d = 1, 9, 11, 2, 8
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(6, b, sq, sk,
                                                             n, d))
    out, lse = tfa.attention_reference(q, k, v, bias, causal=False)
    delta = tfa.backward_delta(out, g)
    before = (tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    kw = dict(causal=False, scale=d ** -0.5)
    dq = tfa.flash_attention_dq(q, k, v, bias, g, lse, delta, **kw)
    dk, dv = tfa.flash_attention_dkv(q, k, v, bias, g, lse, delta, **kw)
    ref = tfa.attention_backward_reference(q, k, v, bias, lse, g, delta,
                                           **kw)
    for a, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert before == (tfa.flash_attention_dq.launches,
                      tfa.flash_attention_dkv.launches)


@pytest.mark.parametrize("with_lse_grad", [False, True])
def test_delta_plain_version_layout(with_lse_grad):
    """The delta kernel's plain version, ``backward_delta`` (what CPU
    tensors take through ``flash_attention_delta``), against the JAX
    reference's delta (``_flash_bwd``: rowsum(dO * O) less the LSE
    cotangent), laid out [B*N, Sq] in memory so that ``_folded`` hands it
    to B3 and B4 without a copy."""
    b, sq, n, d = 2, 13, 3, 16
    rng = np.random.RandomState(8)
    out, g = (rng.randn(b, sq, n, d).astype(np.float32) for _ in range(2))
    g_lse = rng.randn(b, sq, n).astype(np.float32) if with_lse_grad else None
    ref = np.asarray(jnp.sum(jnp.asarray(g) * jnp.asarray(out), axis=-1))
    if with_lse_grad:
        ref = ref - g_lse
    t = [torch.from_numpy(a) for a in (out, g)]
    tl = None if g_lse is None else torch.from_numpy(g_lse)
    before = tfa.flash_attention_delta.launches
    got = tfa.flash_attention_delta(*t, tl)
    assert tfa.flash_attention_delta.launches == before
    assert got.shape == (b, sq, n)
    folded = tfa._folded(got)
    assert folded.data_ptr() == got.data_ptr()
    torch.testing.assert_close(folded, tfa._folded(tfa.backward_delta(*t, tl)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,causal", [(21, True), (16, False)])
def test_mh_attention_backward_matches_jax(s, causal):
    b, n, d = 2, 2, 16
    q, k, v, g, bias = _inputs(7, b, s, s, n, d)
    _, vjp = jax.vjp(lambda q, k, v: jmh.mh_attention(
        q, k, v, jnp.asarray(bias), causal=causal),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    got = _port_grads(lambda q, k, v: tmh.mh_attention(
        q, k, v, torch.from_numpy(bias), causal=causal), (q, k, v), (g,))
    for name, a, r in zip("qkv", got, ref):
        _close(a, r, "d" + name)
