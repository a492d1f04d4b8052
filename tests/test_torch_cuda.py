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
    bias = _bias(pad, b, s, 64)
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


def _gate_max_s(d):
    """The largest S that mh_attention's shared-memory gate admits."""
    return max(s for s in range(1, 4096) if mh.fits_mh_attention(s, s, d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 17, 64, 311, 312, "max"])
def test_mh_attention_kernel_tail_tile(gen, s, d):
    """B1 at every sequence length class up to the gate's largest, causal,
    with a padding bias that leaves only the keys of the last 64-key tile
    valid (the rows before that tile have no valid key: zeros)."""
    s = _gate_max_s(d) if s == "max" else s
    b, n = 2, 2
    q, k, v = (_rn(gen, b, s, n, d) for _ in range(3))
    bias = _bias("tail", b, s, 64)
    out = mh.mh_attention(q, k, v, bias, causal=True)
    again = mh.mh_attention(q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.attention_reference(q, k, v, bias, causal=True)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    assert not out[ref_lse <= -1e30].any()
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,sq,sk,n,d,pad", [
    (2, 100, 5000, 1, 256, "none"),   # long K, few blocks: split
    (1, 1500, 1500, 8, 64, "none"),   # Whisper at an engine admission
    (1, 1176, 1178, 8, 64, "tail"),   # video-long at an engine admission
    (2, 100, 5000, 1, 256, "chunk"),  # every key outside one chunk masked
    (2, 300, 3000, 2, 128, "pad"),    # rows with no valid key
])
def test_flash_attention_split_kernel(gen, b, sq, sk, n, d, pad):
    """B2 where split_plan cuts the keys into chunks: one combine launch
    per call, out and lse against the unsplit and the split plain versions,
    masked rows zeros and NEG_INF, the same bits on a rerun."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = fa.split_plan(b, sq, sk, n, d, False, sms)
    assert len(chunks) > 1
    q, k, v = _rn(gen, b, sq, n, d), _rn(gen, b, sk, n, d), \
        _rn(gen, b, sk, n, d)
    if pad == "chunk":
        k0, k1 = chunks[len(chunks) // 2]
        bias = torch.full((b, sk), fa.NEG_INF, device="cuda")
        bias[:, k0:k1] = 0.0
    else:
        bias = _bias(pad, b, sk, 64)
    before = (fa.flash_attention_with_lse.launches,
              fa.flash_attention_combine.launches)
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=False)
    out2, lse2 = fa.flash_attention_with_lse(q, k, v, bias, causal=False)
    torch.cuda.synchronize()
    assert (fa.flash_attention_with_lse.launches,
            fa.flash_attention_combine.launches) == tuple(
                x + 2 for x in before)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for ref, ref_lse in (
            fa.attention_reference(q, k, v, bias, causal=False),
            fa.split_attention_reference(q, k, v, bias, causal=False,
                                         chunks=chunks)):
        ok = ref_lse > -1e30
        assert _row_rel_err(out, ref) <= ATTN_ROW_REL
        assert (lse[ok] - ref_lse[ok]).abs().max().item() <= LSE_TOL
        assert (lse[~ok] == fa.NEG_INF).all() and not out[~ok].any()


def test_flash_attention_combine_kernel(gen):
    """The combine kernel alone against its plain version, with a chunk
    whose lse is NEG_INF everywhere and a row NEG_INF in every chunk."""
    c, b, sq, n, d = 5, 2, 70, 3, 128
    part_o = torch.randn(c, b, sq, n, d, generator=gen, device="cuda")
    part_lse = torch.randn(c, b, sq, n, generator=gen, device="cuda")
    part_lse[2] = fa.NEG_INF
    part_lse[:, 1, 7, 2] = fa.NEG_INF
    before = fa.flash_attention_combine.launches
    out, lse = fa.flash_attention_combine(part_o, part_lse)
    torch.cuda.synchronize()
    assert fa.flash_attention_combine.launches == before + 1
    ref, ref_lse = fa.combine_reference(part_o, part_lse, torch.bfloat16)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    ok = ref_lse > -1e30
    assert (lse[ok] - ref_lse[ok]).abs().max().item() <= 1e-5
    assert lse[1, 7, 2].item() == fa.NEG_INF and not out[1, 7, 2].any()
    assert torch.isfinite(out.float()).all()


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


# B6 at the five 7b decode shapes, at a ragged narrow shape and at row
# counts on both sides of the kernel's row instances (8, 16, 24, 32)
PIPELINED_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016),
                    (11008, 4096), (4096, 32007), (352, 250)]


def _matvec_inputs(gen, b, k, n):
    x = _rn(gen, b, k)
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda"
                      ).to(torch.int8)
    s = torch.rand(1, n, generator=gen, device="cuda") * 0.01
    return x, q, s


@pytest.mark.parametrize("k,n", PIPELINED_SHAPES)
@pytest.mark.parametrize("b", [9, 16, 32])
def test_matvec_pipelined_kernel(gen, b, k, n):
    """Every depth against the plain version (the matvec bar); the depths
    agree bitwise with each other (same sums, same order) and a second run
    with itself."""
    x, q, s = _matvec_inputs(gen, b, k, n)
    ref = mv.matvec_reference(x.float(), q, s)
    before = mv.matvec_int8_pipelined.launches
    outs = [mv.matvec_int8_pipelined(x, q, s, depth=d) for d in (1, 2, 4)]
    again = mv.matvec_int8_pipelined(x, q, s, depth=4)
    torch.cuda.synchronize()
    assert mv.matvec_int8_pipelined.launches == before + 4
    for out in outs:
        err = (out.float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= MATVEC_REL
        assert torch.equal(out, outs[0])
    assert torch.equal(again, outs[2])


@pytest.mark.parametrize("b", [1, 3, 8, 17])
def test_matvec_pipelined_other_row_counts(gen, b):
    x, q, s = _matvec_inputs(gen, b, 1000, 520)  # K no multiple of 32
    out = mv.matvec_int8_pipelined(x, q, s, depth=3)
    torch.cuda.synchronize()
    ref = mv.matvec_reference(x.float(), q, s)
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() \
        <= MATVEC_REL


@pytest.mark.parametrize("k,n", [(1000, 520), (4096, 32007)])
@pytest.mark.parametrize("b", [1, 8, 9, 24, 32])
def test_matvec_ragged_row_counts(gen, b, k, n):
    """Both wrappers at a ragged N (rows not 16-byte aligned: the cp.async
    path with the byte offset shifted out in the conversion), K no multiple
    of the 64-row k tile, at row counts on both sides of the 8-row
    instances; the two agree bitwise (one kernel, the same grid)."""
    x, q, s = _matvec_inputs(gen, b, k, n)
    ref = mv.matvec_reference(x.float(), q, s)
    a = mv.matvec_int8(x, q, s)
    p = mv.matvec_int8_pipelined(x, q, s)
    torch.cuda.synchronize()
    assert ((a.float() - ref).abs().max() / ref.abs().max()).item() \
        <= MATVEC_REL
    assert torch.equal(a, p)


@pytest.mark.parametrize("k,n", [(4096, 12288), (11008, 4096),
                                 (4096, 32007), (1000, 520)])
def test_matvec_pipelined_depths_bitwise(gen, k, n):
    """Depth 1 (no overlap) and 8 (the deepest ring) give the same bits."""
    x, q, s = _matvec_inputs(gen, 32, k, n)
    one = mv.matvec_int8_pipelined(x, q, s, depth=1)
    eight = mv.matvec_int8_pipelined(x, q, s, depth=8)
    torch.cuda.synchronize()
    assert torch.equal(one, eight)


def test_matvec_on_an_unaligned_layer_slice(gen):
    """A layer of a stacked [L, K, N] tensor whose start is not 16-byte
    aligned (K N = 257000 bytes a layer): the ragged path, reading the
    aligned chunks around the layer's bytes."""
    k, n = 1000, 257
    stack = torch.randint(-127, 128, (3, k, n), generator=gen, device="cuda"
                          ).to(torch.int8)
    s = torch.rand(3, 1, n, generator=gen, device="cuda") * 0.01
    for b in (4, 20):
        x = _rn(gen, b, k)
        for layer in (1, 2):
            out = mv.matvec_int8_pipelined(x, stack[layer], s[layer])
            torch.cuda.synchronize()
            ref = mv.matvec_reference(x.float(), stack[layer], s[layer])
            assert ((out.float() - ref).abs().max()
                    / ref.abs().max()).item() <= MATVEC_REL


def test_matvec_pipelined_within_one_ulp_of_matvec(gen):
    """B6 against B5 at 16 rows: both round the same fp32 sum, taken in
    another order, to bf16, so an output differs by at most one bf16 ulp
    (2^-7 of its value). An output below 2^-10 of the largest is a sum
    that cancelled, where the order of the fp32 additions shows: it is
    measured against that floor instead."""
    x, q, s = _matvec_inputs(gen, 16, 4096, 12288)
    a = mv.matvec_int8_pipelined(x, q, s).float()
    b5 = mv.matvec_int8(x, q, s).float()
    torch.cuda.synchronize()
    scale = b5.abs().clamp_min(2.0 ** -10 * b5.abs().max().item())
    assert ((a - b5).abs() / scale).max().item() <= 2.0 ** -7


def test_matvec_pipelined_on_a_layer_slice(gen):
    """A layer's weight inside the stacked [L, K, N] tensor (an offset
    pointer, 16-byte aligned) and a scale of shape [1, N]."""
    k, n = 512, 1024
    stack = torch.randint(-127, 128, (3, k, n), generator=gen, device="cuda"
                          ).to(torch.int8)
    s = torch.rand(3, 1, n, generator=gen, device="cuda") * 0.01
    x = _rn(gen, 12, k)
    out = mv.matvec_int8_pipelined(x, stack[1], s[1])
    torch.cuda.synchronize()
    ref = mv.matvec_reference(x.float(), stack[1], s[1])
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() \
        <= MATVEC_REL


def test_wrappers_raise_instead_of_falling_back(gen):
    q = _rn(gen, 1, 16, 1, 32)  # head dim 32: no kernel instance
    with pytest.raises(ValueError):
        mh.mh_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q64 = _rn(gen, 1, 16, 1, 64)
    with pytest.raises(ValueError):  # fp32 inputs
        fa.flash_attention(q64.float(), q64.float(), q64.float())
    with pytest.raises(ValueError):  # a non-contiguous layout
        fa.flash_attention(q64.transpose(1, 2), q64, q64)
    with pytest.raises(ValueError):  # past the shared-memory gate
        s = _gate_max_s(128) + 1
        x = _rn(gen, 1, s, 1, 128)
        mh.mh_attention(x, x, x)
    with pytest.raises(ValueError):  # fp32 partials
        fa.flash_attention_combine(
            torch.zeros(2, 1, 4, 1, 64, device="cuda", dtype=torch.bfloat16),
            torch.zeros(2, 1, 4, 1, device="cuda"))
    with pytest.raises(ValueError):
        mv.matvec_int8(_rn(gen, 2, 64).float(),
                       torch.zeros(64, 64, dtype=torch.int8, device="cuda"),
                       torch.ones(64, device="cuda"))
    w = torch.zeros(64, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # fp32 activations
        mv.matvec_int8_pipelined(_rn(gen, 16, 64).float(), w,
                                 torch.ones(64, device="cuda"))
    with pytest.raises(ValueError):  # more rows than the kernel holds
        mv.matvec_int8_pipelined(_rn(gen, 33, 64), w,
                                 torch.ones(64, device="cuda"))
    with pytest.raises(ValueError):
        mv.matvec_int8_pipelined(_rn(gen, 16, 64), w,
                                 torch.ones(64, device="cuda"), depth=0)
    with pytest.raises(ValueError):  # K no multiple of 8: no TMA map of x
        mv.matvec_int8(_rn(gen, 4, 60), w[:60],
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
    (1, 100, 300, 2, 256, False, "none", True),
    # several 128-row tiles, Sq no multiple of 64: the wgmma kernels' tails
    (2, 1080, 1080, 4, 128, True, "none", False),
    # causal with Sq != Sk, both ways
    (2, 300, 200, 2, 128, True, "none", False),
    (2, 150, 400, 2, 64, True, "pad", True)])
def test_flash_backward_kernels(gen, b, sq, sk, n, d, causal, pad, lse_grad):
    q, k, v = (_rn(gen, b, s, n, d).requires_grad_()
               for s in (sq, sk, sk))
    bias = _bias(pad, b, sk, 64)
    g = _rn(gen, b, sq, n, d)
    g_lse = (torch.randn(b, sq, n, generator=gen, device="cuda")
             if lse_grad else None)
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
    before = _bwd_launches()
    outs, cots = (out, lse), (g, g_lse)
    if not lse_grad:
        outs, cots = (out,), (g,)
    dq, dk, dv = torch.autograd.grad(outs, (q, k, v), cots)
    torch.cuda.synchronize()
    assert _bwd_launches() == tuple(n + 1 for n in before)
    delta = fa.backward_delta(out.detach(), g, g_lse)
    ref = fa.attention_backward_reference(
        q.detach(), k.detach(), v.detach(), bias, lse.detach(), g, delta,
        causal=causal, scale=d ** -0.5)
    for got, r in zip((dq, dk, dv), ref):
        assert _grad_row_err(got, r) <= BWD_ROW_REL
    if pad == "pad":  # batch row 0 has no valid key: exact zeros
        for got in (dq, dk, dv):
            assert not got[0].any()


def _bwd_launches():
    return (fa.flash_attention_delta.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_bitwise_reproducible(gen, d):
    """No atomics and a fixed order of sums: a second run gives the same
    bits."""
    b, s, n = 2, 333, 3
    q, k, v, g = (_rn(gen, b, s, n, d) for _ in range(4))
    bias = _bias("pad", b, s, 64)
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=True)
    delta = fa.flash_attention_delta(out, g)
    kw = dict(causal=True, scale=d ** -0.5)
    runs = [(fa.flash_attention_dq(q, k, v, bias, g, lse, delta, **kw),)
            + fa.flash_attention_dkv(q, k, v, bias, g, lse, delta, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, r in zip(*runs):
        assert torch.equal(a, r)


@pytest.mark.parametrize("d,lse_grad", [(64, False), (128, True),
                                        (256, True)])
def test_flash_delta_kernel(gen, d, lse_grad):
    """delta against its plain version, laid out [B*N, Sq] in memory: the
    same D exact products added in another fp32 order."""
    b, s, n = 2, 77, 3
    out, g = _rn(gen, b, s, n, d), _rn(gen, b, s, n, d)
    g_lse = (torch.randn(b, s, n, generator=gen, device="cuda")
             if lse_grad else None)
    got = fa.flash_attention_delta(out, g, g_lse)
    ref = fa.backward_delta(out, g, g_lse)
    torch.cuda.synchronize()
    assert got.shape == (b, s, n) and got.permute(0, 2, 1).is_contiguous()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def test_backward_wrappers_raise_instead_of_falling_back(gen):
    q = _rn(gen, 1, 16, 1, 32)  # head dim 32: no kernel instance
    lse = torch.zeros(1, 16, 1, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention_dq(q, q, q, None, q, lse, lse, causal=True,
                              scale=1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_dkv(q, q, q, None, q, lse, lse, causal=True,
                               scale=1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_delta(q, q)
    with pytest.raises(ValueError):  # fp32 output
        fa.flash_attention_delta(_rn(gen, 1, 16, 1, 64).float(),
                                 _rn(gen, 1, 16, 1, 64))


def test_continuous_engine_on_the_card(gen):
    """The tiny model's engine on the card, int8 packed weights, int8 KV,
    16 slots: every step is 9 pipelined matvecs (4 per layer and the LM
    head), every admission one matvec_int8; greedy requests repeat their
    tokens and a sampled neighbour does not change them."""
    import dataclasses
    import threading

    from macaw_llm_tpu_torch.config import tiny_model_config
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.serve import ContinuousEngine, Request
    from macaw_llm_tpu_torch.utils import quantize as qz

    class Tok:
        def encode(self, text):
            return [1] + [7 + (sum(map(ord, w)) * 131) % 31000
                          for w in text.split()]

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(i) for i in ids)

    cfg = dataclasses.replace(tiny_model_config(), dtype="bfloat16")
    params = fusion.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    params["llm"] = qz.pack_llama_for_decode(qz.quantize_llama(params["llm"]))
    eng = ContinuousEngine(params, cfg, Tok(), slots=16, prompt_bucket=32,
                           max_new_tokens=6, align_cache="int8",
                           kv_cache_dtype="int8")

    def run(requests):
        results = [None] * len(requests)

        def worker(i):
            results[i] = eng.generate_sync(requests[i], timeout=120)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        return results

    def requests(hot):
        size = cfg.vision.image_size
        image = torch.full((size, size, 3), 90, dtype=torch.uint8).numpy()
        return [Request(prompt=f"question number {i} of the test",
                        max_new_tokens=6, image=image if i % 3 == 0 else None,
                        temperature=hot if i == 1 else 0.0)
                for i in range(20)]

    before = (mv.matvec_int8.launches, mv.matvec_int8_pipelined.launches)
    eng.start()
    try:
        first = run(requests(0.0))
        second = run(requests(1.5))
    finally:
        eng.stop()
    assert all(r is not None and r.get("tokens") == 6 for r in first + second)
    for i, (a, b) in enumerate(zip(first, second)):
        if i != 1:
            assert a == b
    assert eng.stats["requests"] == eng.stats["admitted"] == 40
    per_step = 4 * cfg.llm.num_layers + 1
    assert mv.matvec_int8.launches - before[0] == 40
    assert mv.matvec_int8_pipelined.launches - before[1] == \
        per_step * eng.stats["steps"]


def test_prefetch_side_stream_copies_equal_the_host_batches(gen):
    """``data.loader.device_prefetch`` on the card: pinned copies on a side
    stream, 2 batches ahead, handed out after an event wait; the default
    stream then reads tensors equal to the host batches (int32 columns as
    int64), also while it is busy with other work."""
    import numpy as np
    from macaw_llm_tpu_torch.data.loader import device_prefetch
    rng = np.random.RandomState(0)
    host = [{"input_ids": rng.randint(0, 32000, (1, 8, 256)).astype(np.int32),
             "audios": rng.randn(1, 8, 480000).astype(np.float32),
             "videos": rng.randint(0, 255, (1, 8, 6, 224, 224, 3)
                                   ).astype(np.uint8)} for _ in range(5)]
    busy = torch.randn(4096, 4096, device="cuda", generator=gen)
    got = []
    for batch in device_prefetch(iter(host), device="cuda"):
        for _ in range(8):  # keep the default stream busy meanwhile
            busy = busy @ busy * 1e-3
        got.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for g, r in zip(got, host):
        assert g["input_ids"].dtype == torch.int64 and g["audios"].is_cuda
        for k in r:
            assert np.array_equal(g[k].cpu().numpy(), r[k]), k
