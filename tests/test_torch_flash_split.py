"""B2's split over keys, on the CPU: ``split_plan`` (the chunks the CUDA
wrapper cuts the keys into) and the plain version of a split forward
(``split_attention_reference``: per-chunk partials, then the combine
kernel's plain version), held in fp32 against the JAX Pallas flash kernel
in interpret mode and against the port's unsplit ``attention_reference``,
max abs error <= 1e-5 on every row with a valid key."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.ops.pallas import flash_attention as jfa
from macaw_llm_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-5
SMS = 132  # an H100 SXM's SMs


def _qkv(seed, b, sq, sk, n, d):
    rng = np.random.RandomState(seed)
    mk = lambda s: (rng.randn(b, s, n, d) * 0.5).astype(np.float32)  # noqa
    return mk(sq), mk(sk), mk(sk)


def _tiles(sk, per):
    """Chunks of ``per`` whole 64-key tiles (the last one ragged)."""
    step = per * tfa.BLOCK_K
    return [(k0, min(k0 + step, sk)) for k0 in range(0, sk, step)]


def _bias(b, sk, kind):
    bias = np.zeros((b, sk), np.float32)
    bias[-1, sk - sk // 3:] = jfa.NEG_INF  # right padding on the last row
    if kind == "masked_row":
        bias[0, :] = jfa.NEG_INF  # batch row 0: no valid key anywhere
    elif kind == "masked_chunk":
        bias[:, 64:128] = jfa.NEG_INF  # every key of the second chunk
    return bias


def _split(q, k, v, bias, causal, chunks):
    return tfa.split_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), causal=causal, chunks=chunks)


@pytest.mark.parametrize("sq,sk,d,causal,per,kind", [
    (50, 300, 32, False, 5, "none"),          # 1 chunk
    (50, 300, 32, False, 3, "masked_row"),    # 2 chunks, the last ragged
    (37, 300, 16, False, 1, "masked_chunk"),  # 5 chunks, one all masked
    (24, 1030, 16, False, 4, "none"),         # 5 chunks over 17 tiles
    (130, 70, 64, True, 1, "none"),           # causal, S_q > S_k
    (70, 300, 32, True, 2, "masked_row"),     # causal, S_q < S_k
])
def test_split_plain_matches_pallas(sq, sk, d, causal, per, kind):
    b, n = 2, 2
    q, k, v = _qkv(4, b, sq, sk, n, d)
    bias = _bias(b, sk, kind)
    chunks = _tiles(sk, per)
    ref, ref_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        causal=causal)
    got, lse = _split(q, k, v, bias, causal, chunks)
    ref, ref_lse = np.asarray(ref), np.asarray(ref_lse)
    assert lse.shape == ref_lse.shape == (b, sq, n)
    valid = ref_lse > -1e30
    assert (lse.numpy() > -1e30).tolist() == valid.tolist()
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy()[valid], ref_lse[valid], rtol=0,
                               atol=TOL)
    # rows with no valid key: zeros and NEG_INF
    assert not got.numpy()[~valid].any()
    assert (lse.numpy()[~valid] == tfa.NEG_INF).all()
    if kind == "masked_row":
        assert not valid[0].any()


@pytest.mark.parametrize("sq,sk,causal,per,kind", [
    (40, 700, False, 2, "masked_row"),
    (40, 700, False, 1, "masked_chunk"),
    (200, 200, True, 1, "none"),
    (64, 129, True, 1, "masked_row"),
])
def test_split_plain_matches_unsplit_reference(sq, sk, causal, per, kind):
    b, n, d = 2, 3, 32
    q, k, v = _qkv(5, b, sq, sk, n, d)
    bias = _bias(b, sk, kind)
    got, lse = _split(q, k, v, bias, causal, _tiles(sk, per))
    ref, ref_lse = tfa.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), causal=causal)
    assert (got - ref).abs().max().item() <= TOL
    valid = ref_lse > -1e30
    assert torch.equal(lse > -1e30, valid)
    assert (lse[valid] - ref_lse[valid]).abs().max().item() <= TOL
    assert not got[~valid].any()


def test_combine_plain_version_weighs_masked_chunks_zero():
    """A chunk whose lse is NEG_INF adds nothing (its partial output may
    hold anything finite); a row NEG_INF in every chunk gives zeros and
    NEG_INF, with no NaN from exp(NEG_INF - NEG_INF)."""
    part_o = torch.randn(3, 1, 2, 1, 4)
    part_lse = torch.tensor([[0.5, tfa.NEG_INF],
                             [tfa.NEG_INF, tfa.NEG_INF],
                             [-0.25, tfa.NEG_INF]]).view(3, 1, 2, 1)
    out, lse = tfa.combine_reference(part_o, part_lse, torch.float32)
    w = torch.softmax(torch.tensor([0.5, -0.25]), 0)
    want = w[0] * part_o[0, 0, 0, 0] + w[1] * part_o[2, 0, 0, 0]
    assert torch.allclose(out[0, 0, 0], want, atol=1e-6)
    want_lse = torch.logsumexp(torch.tensor([0.5, -0.25]), 0).item()
    assert abs(lse[0, 0, 0].item() - want_lse) < 1e-6
    assert not out[0, 1].any() and lse[0, 1, 0].item() == tfa.NEG_INF
    assert torch.isfinite(out).all()


def test_combine_wrapper_on_cpu_counts_no_launch():
    part_o = torch.randn(2, 1, 3, 2, 64)
    part_lse = torch.randn(2, 1, 3, 2)
    before = tfa.flash_attention_combine.launches
    out, lse = tfa.flash_attention_combine(part_o, part_lse)
    ref, ref_lse = tfa.combine_reference(part_o, part_lse, torch.bfloat16)
    assert tfa.flash_attention_combine.launches == before
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    assert torch.equal(lse, ref_lse)


PLAN_SHAPES = [  # b, sq, sk, n, d, causal
    (8, 1080, 1080, 32, 128, True),   # the 7b train step
    (16, 1500, 1500, 8, 64, False),   # Whisper in the batch-16 prefill
    (16, 1176, 1178, 8, 64, False),   # video-long in the batch-16 prefill
    (16, 624, 32009, 1, 256, False),  # the video alignment fold
    (1, 1500, 1500, 8, 64, False),    # Whisper at an engine admission
    (1, 1176, 1178, 8, 64, False),    # video-long at an engine admission
    (2, 100, 5000, 1, 256, False),
    (1, 300, 64, 2, 128, True),
    (1, 10, 65, 1, 64, False),
    (3, 7, 1, 1, 64, False),
]


@pytest.mark.parametrize("b,sq,sk,n,d,causal", PLAN_SHAPES)
def test_split_plan_covers_keys_in_whole_tiles(b, sq, sk, n, d, causal):
    chunks = tfa.split_plan(b, sq, sk, n, d, causal, SMS)
    assert chunks[0][0] == 0 and chunks[-1][1] == sk
    assert 1 <= len(chunks) <= tfa.MAX_CHUNKS
    for (a0, a1), (b0, _) in zip(chunks, chunks[1:]):
        assert a1 == b0 and a0 % tfa.BLOCK_K == 0
    widths = [k1 - k0 for k0, k1 in chunks]
    assert all(w > 0 for w in widths)
    assert all(w == widths[0] for w in widths[:-1])  # the kernel's stride
    assert widths[0] % tfa.BLOCK_K == 0 or len(chunks) == 1
    assert chunks == tfa.split_plan(b, sq, sk, n, d, causal, SMS)


def test_split_plan_where_it_splits():
    """No split where the blocks fill the card (the train step and the
    batch-16 prefill's towers); a split at the video alignment (80 blocks
    of 501 key tiles) and at an engine admission's batch-1 Whisper (96
    blocks); more SMs never give fewer chunks."""
    plan = lambda *s, sms=SMS: tfa.split_plan(*s, sms)  # noqa
    assert len(plan(8, 1080, 1080, 32, 128, True)) == 1
    assert len(plan(16, 1500, 1500, 8, 64, False)) == 1
    assert len(plan(16, 624, 32009, 1, 256, False)) > 1
    assert len(plan(1, 1500, 1500, 8, 64, False)) > 1
    assert len(plan(1, 1176, 1178, 8, 64, False)) > 1
    assert len(plan(16, 624, 32009, 1, 256, False, sms=1)) == 1
    for sms in (66, 132, 264):
        assert len(plan(16, 624, 32009, 1, 256, False, sms=sms)) >= \
            len(plan(16, 624, 32009, 1, 256, False, sms=sms // 2))
