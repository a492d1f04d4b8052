"""The CUDA kernels against their plain versions on the card (bf16 inputs,
compared in fp32): masked rows, ragged tails, every head dim and row-chunk
instance. Marked ``cuda``; each test skips where no GPU is present. On the
card (the repository conftest imports jax):
``python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest``."""

import pytest
import torch

from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
from macaw_llm_tpu_torch.ops.kernels import matvec as mv
from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh

pytestmark = pytest.mark.cuda

# Attention outputs: each row (one query, one head) against its own
# max |ref|. The kernel and the plain version differ in fp32 summation
# order and bf16 rounding: one ulp of the output (<= 2^-7 of the row max)
# plus the probabilities' rounding (<= 2^-8) stay below 2^-6.
ATTN_ROW_REL = 2.0 ** -6
LSE_TOL = 1e-3
MATVEC_REL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def _bias(kind, b, s, tile):
    """None; "pad": half the keys of the last row masked and none valid in
    the first; "tail": only the keys of the last K tile of ``tile`` keys
    valid (the ragged tail the kernel masks itself)."""
    if kind == "none":
        return None
    if kind == "tail":
        bias = torch.full((b, s), fa.NEG_INF, device="cuda")
        bias[:, s - (s % tile or tile):] = 0.0
        return bias
    bias = torch.zeros(b, s, device="cuda")
    bias[-1, s // 2:] = fa.NEG_INF
    bias[0, :] = fa.NEG_INF  # a row with no valid key
    return bias


def _row_rel_err(out, ref):
    """Largest row error against the row's own max |ref|; a row the
    reference leaves at zero must be zero."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("b,s,n,d,causal,pad", [
    (2, 40, 2, 64, True, "pad"), (2, 312, 4, 128, True, "pad"),
    (2, 200, 3, 128, False, "none"), (3, 17, 2, 64, False, "pad"),
    (2, 312, 4, 128, True, "tail"), (2, 200, 3, 128, False, "tail")])
def test_mh_attention_kernel(gen, b, s, n, d, causal, pad):
    q, k, v = (_rn(gen, b, s, n, d) for _ in range(3))
    bias = _bias(pad, b, s, 16)
    before = mh.mh_attention.launches
    out = mh.mh_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert mh.mh_attention.launches == before + 1
    ref, _ = fa.attention_reference(q, k, v, bias, causal=causal)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    if pad == "pad":
        assert not out[0].any()


@pytest.mark.parametrize("b,sq,sk,n,d,causal,pad", [
    (2, 40, 40, 2, 64, True, "pad"), (2, 100, 130, 2, 256, False, "pad"),
    (2, 300, 300, 4, 128, True, "pad"), (2, 77, 50, 3, 128, True, "none"),
    (1, 200, 1178, 2, 64, False, "none"),
    (1, 200, 1178, 2, 64, False, "tail"),
    (2, 100, 2009, 1, 256, False, "tail")])
def test_flash_attention_kernel(gen, b, sq, sk, n, d, causal, pad):
    q, k, v = _rn(gen, b, sq, n, d), _rn(gen, b, sk, n, d), \
        _rn(gen, b, sk, n, d)
    bias = _bias(pad, b, sk, 64)
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.attention_reference(q, k, v, bias, causal=causal)
    ok = ref_lse > -1e30
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    assert (lse[ok] - ref_lse[ok]).abs().max().item() <= LSE_TOL
    assert (lse[~ok] < -1e30).all()


@pytest.mark.parametrize("b,k,n", [(1, 4096, 4096), (2, 512, 1000),
                                   (4, 4096, 32007), (8, 11008, 4096),
                                   (32, 512, 1024)])
def test_matvec_kernel(gen, b, k, n):
    x = _rn(gen, b, k)
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda"
                      ).to(torch.int8)
    s = torch.rand(1, n, generator=gen, device="cuda") * 0.01
    out = mv.matvec_int8(x, q, s)
    torch.cuda.synchronize()
    ref = mv.matvec_reference(x.float(), q, s)
    err = (out.float() - ref).abs().max() / ref.abs().max()
    assert err.item() <= MATVEC_REL


def test_wrappers_raise_instead_of_falling_back(gen):
    q = _rn(gen, 1, 16, 1, 32)  # head dim 32: no kernel instance
    with pytest.raises(ValueError):
        mh.mh_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        mv.matvec_int8(_rn(gen, 2, 64).float(),
                       torch.zeros(64, 64, dtype=torch.int8, device="cuda"),
                       torch.ones(64, device="cuda"))


# Backward (B3 dq, B4 dk/dv) against the plain backward in fp32 on the same
# bf16 inputs and the same forward output and LSE, row by row (one query or
# key, one head) against the row's own max |ref|. Both round ds and P to
# bf16 before the products that use them; they differ in fp32 summation
# order (which can move a ds or P across a bf16 rounding boundary: one bf16
# ulp, 2^-8 of that one term) and in the kernel's bf16 output (half an ulp,
# 2^-9 of the row max): 2^-6 leaves room for a few such terms per row. A
# row whose exact gradient is zero (the first query of a causal row has one
# key, so its ds is 0 up to rounding) is measured against 2^-10 of the
# whole tensor's max |ref| instead.
BWD_ROW_REL = 2.0 ** -6
BWD_FLOOR = 2.0 ** -10


def _grad_row_err(out, ref):
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(
        BWD_FLOOR * ref.float().abs().max().item())
    return (diff / scale.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("b,sq,sk,n,d,causal,pad,lse_grad", [
    (2, 300, 300, 4, 128, True, "none", False),
    (2, 300, 300, 4, 128, True, "tail", False),
    (2, 300, 300, 4, 128, True, "pad", False),
    (2, 77, 130, 2, 128, False, "pad", True),
    (2, 200, 1178, 2, 64, False, "tail", False),
    (2, 130, 130, 2, 256, True, "pad", False),
    (1, 100, 300, 2, 256, False, "none", True)])
def test_flash_backward_kernels(gen, b, sq, sk, n, d, causal, pad, lse_grad):
    q, k, v = (_rn(gen, b, s, n, d).requires_grad_()
               for s in (sq, sk, sk))
    bias = _bias(pad, b, sk, 64)
    g = _rn(gen, b, sq, n, d)
    g_lse = (torch.randn(b, sq, n, generator=gen, device="cuda")
             if lse_grad else None)
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    outs, cots = (out, lse), (g, g_lse)
    if not lse_grad:
        outs, cots = (out,), (g,)
    dq, dk, dv = torch.autograd.grad(outs, (q, k, v), cots)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) \
        == (before[0] + 1, before[1] + 1)
    delta = fa.backward_delta(out.detach(), g, g_lse)
    ref = fa.attention_backward_reference(
        q.detach(), k.detach(), v.detach(), bias, lse.detach(), g, delta,
        causal=causal, scale=d ** -0.5)
    for got, r in zip((dq, dk, dv), ref):
        assert _grad_row_err(got, r) <= BWD_ROW_REL
    if pad == "pad":  # batch row 0 has no valid key: exact zeros
        for got in (dq, dk, dv):
            assert not got[0].any()


def test_backward_wrappers_raise_instead_of_falling_back(gen):
    q = _rn(gen, 1, 16, 1, 32)  # head dim 32: no kernel instance
    lse = torch.zeros(1, 16, 1, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention_dq(q, q, q, None, q, lse, lse, causal=True,
                              scale=1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_dkv(q, q, q, None, q, lse, lse, causal=True,
                               scale=1.0)
