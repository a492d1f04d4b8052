"""Port parity of the three kernel modules' plain versions (the path a CPU
tensor takes through each wrapper) against the JAX Pallas kernels in
interpret mode, fp32 on the CPU, max abs error <= 1e-5: ``mh_attention``
(B1), ``flash_attention`` forward with LSE (B2) and ``matvec_int8`` (B5).
Cases cover a causal mask, a padding bias, a fully masked row and a ragged
K tail (lengths that are no tile multiple)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.ops.pallas import flash_attention as jfa
from macaw_llm_tpu.ops.pallas import matvec as jmv
from macaw_llm_tpu.ops.pallas import mh_attention as jmh
from macaw_llm_tpu_torch.ops.kernels import flash_attention as tfa
from macaw_llm_tpu_torch.ops.kernels import matvec as tmv
from macaw_llm_tpu_torch.ops.kernels import mh_attention as tmh

TOL = 1e-5


def _qkv(seed, b, sq, sk, n, d):
    rng = np.random.RandomState(seed)
    mk = lambda s: (rng.randn(b, s, n, d) * 0.5).astype(np.float32)  # noqa
    return mk(sq), mk(sk), mk(sk)


def _bias(b, sk, masked_row: bool):
    """Padding bias: right padding on the last row; with ``masked_row``
    every key of row 0 is masked."""
    bias = np.zeros((b, sk), np.float32)
    bias[-1, sk - sk // 3:] = jfa.NEG_INF
    if masked_row:
        bias[0, :] = jfa.NEG_INF
    return bias


@pytest.mark.parametrize("s,d,causal,masked_row", [
    (37, 16, True, True),     # causal, padded, one row with no valid key
    (64, 32, False, True),
    (130, 64, True, False),   # > one 128-key TPU tile, ragged
])
def test_mh_attention_plain_matches_pallas(s, d, causal, masked_row):
    b, n = 2, 3
    q, k, v = _qkv(0, b, s, s, n, d)
    bias = _bias(b, s, masked_row)
    ref = jmh.mh_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(bias), causal=causal)
    got = tmh.mh_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(bias),
                           causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    if masked_row:
        assert not got[0].any()  # no valid key: zeros, not NaN


@pytest.mark.parametrize("sq,sk,d,causal,masked_row", [
    (37, 37, 16, True, True),
    (50, 300, 32, False, True),   # ragged K tail past one 256-key tile
    (130, 70, 64, True, False),   # S_q != S_k, causal by raw index
    (24, 1030, 16, False, False),
])
def test_flash_attention_plain_matches_pallas(sq, sk, d, causal,
                                              masked_row):
    """Out and LSE on every row with a valid key. A row with no valid key
    gives zeros in the port and LSE NEG_INF in both (the TPU kernel's
    output there depends on its K-block padding)."""
    b, n = 2, 2
    q, k, v = _qkv(1, b, sq, sk, n, d)
    bias = _bias(b, sk, masked_row)
    ref, ref_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        causal=causal)
    got, lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), causal=causal)
    ref, ref_lse = np.asarray(ref), np.asarray(ref_lse)
    assert lse.shape == ref_lse.shape == (b, sq, n)
    valid = ref_lse > -1e30
    assert (lse.numpy() > -1e30).tolist() == valid.tolist()
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy()[valid], ref_lse[valid], rtol=0,
                               atol=TOL)
    assert not got.numpy()[~valid].any()
    assert (lse.numpy()[~valid] == ref_lse[~valid]).all()


@pytest.mark.parametrize("b,k,n", [(4, 256, 512), (3, 352, 256),
                                   (1, 128, 200)])
def test_matvec_plain_matches_pallas(b, k, n):
    rng = np.random.RandomState(2)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = (rng.randn(b, k) * 0.1).astype(np.float32)
    scale = np.abs(w).max(0, keepdims=True) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    ref = jmv.matvec_int8(jnp.asarray(x), jnp.asarray(q),
                          jnp.asarray(scale), block_n=128 if n % 128 == 0
                          else n)
    got = tmv.matvec_int8(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_mh_gate_from_shared_memory_budget():
    """The 7b prefill shape (S=312, D=128) fits one block's shared memory
    (a 192-query Q tile beside every 64-key K/V tile of the sequence); a
    sequence whose K/V exceed 227 KB does not, nor does S_q != S_k."""
    assert tmh.fits_mh_attention(312, 312, 128)
    assert tmh.smem_bytes(312, 128) <= tmh.SMEM_BUDGET
    assert not tmh.fits_mh_attention(1500, 1500, 64)
    assert not tmh.fits_mh_attention(312, 300, 128)


def test_kernel_splits_cover_k():
    for k, n in ((4096, 12288), (11008, 4096), (4096, 32007), (64, 100)):
        splits = tmv.k_splits(k, n)
        rows = -(-k // splits)
        assert 1 <= splits <= k and rows <= 1024 and splits * rows >= k


def test_cpu_calls_count_no_launch():
    """The counters count kernel launches only: the plain versions that CPU
    tensors take leave them alone."""
    x = torch.ones(2, 1, 8, 16)
    before = (tmh.mh_attention.launches,
              tfa.flash_attention_with_lse.launches,
              tmv.matvec_int8.launches)
    tmh.mh_attention(x, x, x, causal=True)
    tfa.flash_attention(x, x, x)
    tmv.matvec_int8(torch.ones(2, 16), torch.ones(16, 8, dtype=torch.int8),
                    torch.ones(8))
    assert before == (tmh.mh_attention.launches,
                      tfa.flash_attention_with_lse.launches,
                      tmv.matvec_int8.launches)


@pytest.mark.parametrize("decode_kernel", [True, False])
def test_single_row_int8_matmul_routes(decode_kernel, monkeypatch):
    """quantize.matmul on one row per sequence goes to matvec_int8
    (decode_kernel, the port's default) or to the weight-only matmul; both
    equal the JAX weight-only path in fp32."""
    from macaw_llm_tpu.utils import quantize as jqz
    from macaw_llm_tpu_torch.utils import quantize as tqz
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return tmv.matvec_int8(*args, **kwargs)

    monkeypatch.setattr(tqz, "matvec_int8", spy)
    rng = np.random.RandomState(3)
    w = (rng.randn(64, 48) * 0.05).astype(np.float32)
    x = rng.randn(5, 1, 64).astype(np.float32)
    jq, js = jqz.quantize_tensor(jnp.asarray(w))
    ref = jqz.matmul(jnp.asarray(x), {"q": jq, "s": js}, jnp.float32)
    q, s = tqz.quantize_tensor(torch.from_numpy(w))
    got = tqz.matmul(torch.from_numpy(x), {"q": q, "s": s}, torch.float32,
                     decode_kernel=decode_kernel)
    assert calls == ([(5, 64)] if decode_kernel else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
