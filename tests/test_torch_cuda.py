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


# a tensor-parallel rank's decode shapes of the 7b at t = 2 and 4: the
# column-parallel qkv and gateup cut N, the row-parallel wo and down cut K
TP_MATVEC_SHAPES = [(4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096),
                    (4096, 3072), (1024, 4096), (4096, 5504), (2752, 4096)]


@pytest.mark.parametrize("k,n", TP_MATVEC_SHAPES)
@pytest.mark.parametrize("b", [4, 16])
def test_matvec_kernels_at_tensor_parallel_shard_shapes(gen, b, k, n):
    """B5 and B6 at a rank's shard shapes against the plain version,
    bitwise on a rerun."""
    x, q, s = _matvec_inputs(gen, b, k, n)
    ref = mv.matvec_reference(x.float(), q, s)
    for fn in (mv.matvec_int8, mv.matvec_int8_pipelined):
        before = fn.launches
        out, again = fn(x, q, s), fn(x, q, s)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        err = (out.float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= MATVEC_REL and torch.equal(out, again)


@pytest.mark.parametrize("k,n", [(4096, 12288), (11008, 4096)])
@pytest.mark.parametrize("b", [4, 16])
def test_matvec_blocks_of_a_tensor_parallel_weight(gen, b, k, n):
    """A column block (its own K split) gives the whole product's columns
    within the plain version's bar; the fp32 output is the kernel's own sum
    unrounded (its bf16 rounding is the bf16 output), and two row blocks'
    fp32 outputs add up to the whole product within a bf16 ulp (above the
    fp32 error of summing the blocks in another association: 2^-16 of the
    largest output, where an output near 0 is the difference of blocks
    thousands of times larger)."""
    x, q, s = _matvec_inputs(gen, b, k, n)
    for fn in (mv.matvec_int8, mv.matvec_int8_pipelined):
        whole = fn(x, q, s)
        cols = fn(x, q[:, :n // 2].contiguous(), s[:, :n // 2].contiguous())
        f32 = fn(x, q, s, out_dtype=torch.float32)
        lo = fn(x[:, :k // 2].contiguous(), q[:k // 2].contiguous(), s,
                out_dtype=torch.float32)
        hi = fn(x[:, k // 2:].contiguous(), q[k // 2:].contiguous(), s,
                out_dtype=torch.float32)
        torch.cuda.synchronize()
        ref = whole[:, :n // 2].float()
        err = (cols.float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= MATVEC_REL
        assert f32.dtype == torch.float32
        assert torch.equal(f32.to(torch.bfloat16), whole)
        err = ((lo + hi).to(torch.bfloat16).float() - whole.float()).abs()
        floor = f32.abs().max() * 2.0 ** -16
        assert (err <= whole.float().abs() * 2.0 ** -7 + floor).all()


@pytest.mark.parametrize("n", [16, 8])
def test_mh_attention_kernel_at_tensor_parallel_heads(gen, n):
    """B1 at the 7b prefill's [16, 312, n, 128] with a rank's heads, a
    row with no valid key and half a row masked."""
    q, k, v = (_rn(gen, 16, 312, n, 128) for _ in range(3))
    bias = _bias("pad", 16, 312, 64)
    out = mh.mh_attention(q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    ref, _ = fa.attention_reference(q, k, v, bias, causal=True)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    assert not out[0].any()


@pytest.mark.parametrize("b,sq,sk,n,d", [
    (16, 1500, 1500, 4, 64), (16, 1500, 1500, 2, 64),   # Whisper, t = 2, 4
    (8, 624, 32009, 1, 256), (4, 624, 32009, 1, 256),   # alignment fold
    (1, 1500, 1500, 4, 64)])                            # an admission
def test_flash_attention_kernel_at_tensor_parallel_heads(gen, b, sq, sk, n,
                                                         d):
    """B2 (split over keys where ``split_plan`` cuts them) at a rank's
    Whisper and alignment shapes against the plain version."""
    q, k, v = _rn(gen, b, sq, n, d), _rn(gen, b, sk, n, d), \
        _rn(gen, b, sk, n, d)
    out, lse = fa.flash_attention_with_lse(q, k, v, None, causal=False)
    torch.cuda.synchronize()
    ref, ref_lse = fa.attention_reference(q, k, v, None, causal=False)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


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


@pytest.mark.parametrize("b,k1", [(1, 4), (1, 5), (2, 4), (4, 5)])
def test_verify_rows_route(gen, b, k1):
    """The speculative verify's decode-shaped projection (``decode_rows``):
    [B, k + 1, K] is the kernel's own call on the [B * (k + 1), K] rows
    (4, 5, 8 and 20 rows: B5 up to 8, B6 above), bit for bit, and within
    1e-2 of max |out| of the weight-only dequant path."""
    from macaw_llm_tpu_torch.utils import quantize as qz
    k, n = 4096, 12288
    x3, q, s = _matvec_inputs(gen, b * k1, k, n)
    x = x3.reshape(b, k1, k)
    rec = {"q": q, "s": s}
    kernel = mv.matvec_int8 if b * k1 <= 8 else mv.matvec_int8_pipelined
    before = kernel.launches
    got = qz.matmul(x, rec, torch.bfloat16, decode_rows=True)
    flat = kernel(x.reshape(b * k1, k).contiguous(), q, s,
                  out_dtype=torch.bfloat16)
    dense = qz.matmul(x, rec, torch.bfloat16)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, flat.reshape(b, k1, n))
    err = (got.float() - dense.float()).abs().max() / dense.float().abs().max()
    assert err.item() <= 1e-2


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


@pytest.mark.parametrize("n", [16, 8])
def test_flash_kernels_at_tensor_parallel_training_heads(gen, n):
    """B2, delta, B3 and B4 at a tensor rank's 7b QLoRA train shape,
    [8, 1080, 32 / t, 128] causal (t = 2 and 4), against the plain
    forward and backward."""
    b, s, d = 8, 1080, 128
    q, k, v = (_rn(gen, b, s, n, d).requires_grad_() for _ in range(3))
    g = _rn(gen, b, s, n, d)
    out, lse = fa.flash_attention_with_lse(q, k, v, None, causal=True)
    ref, ref_lse = fa.attention_reference(q.detach(), k.detach(), v.detach(),
                                          None, causal=True)
    assert _row_rel_err(out.detach(), ref) <= ATTN_ROW_REL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    before = _bwd_launches()
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert _bwd_launches() == tuple(x + 1 for x in before)
    delta = fa.backward_delta(out.detach(), g, None)
    grads = fa.attention_backward_reference(
        q.detach(), k.detach(), v.detach(), None, lse.detach(), g, delta,
        causal=True, scale=d ** -0.5)
    for got, r in zip((dq, dk, dv), grads):
        assert _grad_row_err(got, r) <= BWD_ROW_REL


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


def _graph_engine(max_new_tokens: int = 24):
    """A 2-layer engine at 7b widths (int8 packed weights, int8 KV, 16
    slots), not started."""
    import dataclasses
    import zlib

    from macaw_llm_tpu_torch.config import macaw_7b
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.serve import ContinuousEngine
    from macaw_llm_tpu_torch.utils import quantize as qz

    class Tok:
        def encode(self, text):
            h = zlib.crc32(text.encode())
            return [1] + [16 + (h + 37 * i) % 31000
                          for i in range(8 + h % 40)]

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(i) for i in ids)

    cfg7 = macaw_7b()
    cfg = dataclasses.replace(
        cfg7, llm=dataclasses.replace(cfg7.llm, num_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_layers=2),
        audio=dataclasses.replace(cfg7.audio, encoder_layers=2))
    params = fusion.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    params["llm"] = qz.pack_llama_for_decode(qz.quantize_llama(params["llm"]))
    return ContinuousEngine(params, cfg, Tok(), slots=16, prompt_bucket=64,
                            max_new_tokens=max_new_tokens,
                            align_cache="int8", kv_cache_dtype="int8")


def _graph_engine_runs(eager: bool, waves, seed: int = 7):
    """``_graph_engine``, its real admission thread running: each wave of
    requests is submitted at once and served before the next. ``eager``:
    the engine captures no graph. Returns (results per wave, the change of
    the engine's stats and of B6's launch count while it served, whether
    it captured a sampling graph)."""
    import threading

    from macaw_llm_tpu_torch.ops.kernels import matvec as mv

    eng = _graph_engine()
    if eager:
        eng._capture_steps = lambda: None
    eng._gen_admit.manual_seed(seed)
    eng._gen_step.manual_seed(seed + 1)

    def run(requests):
        results = [None] * len(requests)

        def worker(i):
            results[i] = eng.generate_sync(requests[i], timeout=300)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        return results

    eng.start()
    # after the capture and its warm-up steps
    stats0 = dict(eng.stats, b6=mv.matvec_int8_pipelined.launches)
    try:
        out = [run(wave()) for wave in waves]
    finally:
        eng.stop()
    stats = {k: v - stats0[k] for k, v in dict(
        eng.stats, b6=mv.matvec_int8_pipelined.launches).items()}
    sampled_graph = True in eng._graphs
    del eng
    torch.cuda.empty_cache()
    return out, stats, sampled_graph


def test_engine_graph_replay_serves_the_eager_tokens(gen):
    """The one-card engine replays its captured decode step: 40 greedy
    requests (two with media) over 16 slots with budgets of 1 to 24
    tokens, so slots finish and requests are placed while others decode
    and the control vectors change under the graph; then one request at
    temperature 1.2 alone (slot 0, so its draws do not depend on the
    order of arrival). Every request's tokens equal an eager engine's on
    the same requests with the same generator seeds; every step is a
    replay, the sampled ones included, and counts its B6 launches."""
    from macaw_llm_tpu_torch.serve import Request

    def greedy():
        image = torch.full((224, 224, 3), 90, dtype=torch.uint8).numpy()
        return [Request(prompt=f"graph request number {i}",
                        max_new_tokens=1 + (7 * i) % 24,
                        image=image if i in (5, 23) else None)
                for i in range(40)]

    def sampled():
        return [Request(prompt="a sampled request", max_new_tokens=20,
                        temperature=1.2)]

    graph_out, graph_stats, sampled_graph = _graph_engine_runs(
        False, [greedy, sampled])
    eager_out, eager_stats, _ = _graph_engine_runs(True, [greedy, sampled])
    assert all(r is not None and "error" not in r
               for wave in graph_out for r in wave)
    assert graph_out == eager_out
    assert eager_stats["graph_replays"] == 0 < eager_stats["steps"]
    assert sampled_graph
    assert graph_stats["graph_replays"] == graph_stats["steps"] > 0
    # a replay counts the B6 launches its graph makes: 4 a layer, 1 head
    for stats in (graph_stats, eager_stats):
        assert stats["b6"] == (4 * 2 + 1) * stats["steps"]


def test_a_profile_stops_while_the_engine_replays(gen):
    """A device profile started and stopped three times while the engine
    replays its decode step for 16 long answers, with no admission
    running: each stop returns (a watchdog ends the process with every
    thread's stack after 60 s), steps were replayed meanwhile and every
    request is served."""
    import faulthandler
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from macaw_llm_tpu_torch.serve import Request

    eng = _graph_engine(max_new_tokens=1024)
    eng.start()
    reqs = [Request(prompt=f"a long answer {i}", max_new_tokens=1024)
            for i in range(16)]
    results = [None] * len(reqs)

    def worker(i):
        results[i] = eng.generate_sync(reqs[i], timeout=300)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        while eng.stats["admitted"] < len(reqs):
            time.sleep(0.01)
        replays = []
        for _ in range(3):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            time.sleep(0.1)
            replays.append(eng.stats["graph_replays"])
            faulthandler.dump_traceback_later(60, exit=True)
            try:
                prof.stop()
            finally:
                faulthandler.cancel_dump_traceback_later()
        for t in threads:
            t.join(300)
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    assert replays[-1] > replays[0]
    assert all(r is not None and "error" not in r and r["tokens"] > 0
               for r in results), results


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


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_local_ring_with_the_kernels_against_its_plain_version(gen, layout):
    """``ring_attention_local`` on the card (B2, B3, B4 each step) against
    the same schedule on the CPU (the wrappers' plain versions) on the same
    bf16 inputs: the output row by row within the kernels' bar (2^-6), the
    gradients within twice it (a chunk's gradient sums the rows of the
    steps that see it, each within 2^-6), and the launches of a ring of
    4."""
    from macaw_llm_tpu_torch.parallel import ring_attention as ring
    n, s = 4, 512
    q, k, v, g = (_rn(gen, 2, s, 4, 64) for _ in range(4))
    if layout == "zigzag":
        perm = ring.zigzag_indices(s, n).cuda()
        q, k, v, g = (t[:, perm].contiguous() for t in (q, k, v, g))

    def run(device):
        x = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = ring.ring_attention_local(*x, n, layout)
        out.backward(g.to(device))
        return [out.detach()] + [t.grad for t in x]

    for fn in (fa.flash_attention_with_lse, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    got = run("cuda")
    want = n * (n + 1) // 2 if layout == "contiguous" else n * (2 * n + 1)
    assert [fa.flash_attention_with_lse.launches,
            fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches] == [want] * 3
    out, *grads = run("cpu")
    assert _row_rel_err(got[0].cpu(), out) <= ATTN_ROW_REL
    for a, b in zip(got[1:], grads):
        assert _grad_row_err(a.cpu(), b) <= 2 * BWD_ROW_REL


def test_offloaded_moments_pinned_and_the_same_bits(gen):
    """``offload_optimizer`` on the card: Adam's moments stay in pinned host
    memory after each update (streamed through the device on a side
    stream), and parameters and moments are the bits of the update without
    offload."""
    from macaw_llm_tpu_torch.config import TrainConfig
    from macaw_llm_tpu_torch.train.trainer import AdamW, _offload
    cfg = TrainConfig(learning_rate=1e-2, warmup_ratio=0.0, mu_dtype="bfloat16")
    params = {"a": torch.randn(300, 70, generator=gen, device="cuda"),
              "b": {"c": torch.randn(1000, generator=gen, device="cuda")}}
    grads = [{"a": torch.randn(300, 70, generator=gen, device="cuda"),
              "b": {"c": torch.randn(1000, generator=gen, device="cuda")}}
             for _ in range(3)]
    runs = []
    for offload in (False, True):
        tx = AdamW(cfg, 10)
        p = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
        st = tx.init(p)
        if offload:
            st.mu, st.nu = _offload(st.mu), _offload(st.nu)
        for g in grads:
            tx.update(p, g, st)
            for t in (st.mu["a"], st.nu["a"], st.mu["b"]["c"]):
                assert (t.device.type == "cpu" and t.is_pinned()) == offload
        runs.append((p, st))
    (p0, s0), (p1, s1) = runs
    for x, y in ((p0["a"], p1["a"]), (p0["b"]["c"], p1["b"]["c"]),
                 (s0.mu["a"], s1.mu["a"]), (s0.nu["b"]["c"],
                                             s1.nu["b"]["c"])):
        assert torch.equal(x.cpu(), y.cpu())


NCCL_PROMPTS = ("first question here", "third thing entirely",
                "a longer question about many different things",
                "another one with more words", "short", "last one")


def test_tp_engine_faults_over_nccl_end_every_rank(tmp_path):
    """The TP server's fault rule over NCCL, two ranks on two cards (the
    tiny model in fp32, no kernels: plain products between NCCL
    collectives). A follower's failed admission fails that request on
    both ranks, which serve the rest; a follower's failure inside a
    prefill (the continuous engine) or a batch (the static one) tears the
    group down: the leader, waiting in a collective, learns it from the
    store, aborts its communicator, and both loops end well inside the
    group's timeout with an error for every request not answered."""
    import dataclasses

    from macaw_llm_tpu_torch import config as tconfig
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.parallel.dryrun import spawn
    from macaw_llm_tpu_torch.parallel.mesh import TIMEOUT
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL takes one rank a card)")
    cfg = tconfig.tiny_model_config()
    params, reqs = str(tmp_path / "params.pt"), str(tmp_path / "reqs.pt")
    torch.save(fusion.init_params(0, cfg, dtype=torch.float32,
                                  device="cpu"), params)
    torch.save([dict(prompt=p, max_new_tokens=4) for p in NCCL_PROMPTS],
               reqs)
    engine = dict(kind="engine", requests=reqs, seed=5,
                  kw=dict(slots=2, prompt_bucket=32, max_new_tokens=4))
    static = dict(kind="engine", requests=reqs, seed=5, static=True,
                  kw=dict(max_batch=2, max_new_tokens=4))
    cases = [dict(engine, name="engine"),
             dict(engine, name="admission", follower_fail=[NCCL_PROMPTS[1]]),
             dict(engine, name="prefill", follower_fail_prefill_at=3),
             dict(static, name="static", follower_fail_prefill_at=2)]
    lead, follow = spawn(2, "tp", {"model": dataclasses.asdict(cfg),
                                   "params": params, "cases": cases},
                         str(tmp_path / "job"), device="cuda")
    ok = lead["engine"]["results"]
    assert all("error" not in r for r in ok), ok
    got = lead["admission"]["results"]
    assert got[1] == {"error": "failed on another rank of the tensor group"}
    assert got[:1] + got[2:] == ok[:1] + ok[2:]
    assert follow["admission"]["stats"] == lead["admission"]["stats"]
    for name, prefix, served in (("prefill", "decode loop failed", 2),
                                 ("static", "batch failed", 2)):
        res = lead[name]["results"]
        errors = [r for r in res if "error" in r]
        assert all(r["error"].startswith(prefix) for r in errors), res
        assert len(errors) >= len(res) - served, res
        for rank in (lead, follow):
            assert rank[name]["seconds"] < TIMEOUT.total_seconds() / 10


# ---------------------------------------------------------------------------
# the parallel layer across cards: the tiny model in fp32 (plain products
# between NCCL collectives) spawned one rank a card, against one card


def _need_cards(n: int) -> None:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards (NCCL takes one rank a card)")


def _tiny_model():
    import dataclasses

    from macaw_llm_tpu_torch import config as tconfig
    m = tconfig.tiny_model_config()
    return dataclasses.replace(m, fusion=dataclasses.replace(
        m.fusion, align_dropout=0.0))


# adam_eps 1e-4: noise-sized gradients (tests/test_torch_train.py)
TRAIN_KW = dict(learning_rate=1e-2, warmup_ratio=0.1, grad_accum_steps=1,
                adam_eps=1e-4)
NCCL_LOSS_REL = 1e-4  # fp32 sums of the ranks' partials in another order


def _tiny_weights(model):
    """fp32 weights, lm_head x 10 so that the loss moves."""
    from macaw_llm_tpu_torch.models import fusion
    params = fusion.init_params(0, model, dtype=torch.float32, device="cpu")
    params["llm"]["lm_head"] = params["llm"]["lm_head"] * 10.0
    return params


def _text_batches(n: int, b: int = 4, s: int = 12) -> list:
    """Whole [1, b, s] text batches, the first 3 targets of a row ignored."""
    gen = torch.Generator().manual_seed(40)
    out = []
    for _ in range(n):
        ids = torch.randint(16, 32000, (1, b, s), generator=gen)
        ids[..., 0] = 1
        labels = ids.clone()
        labels[..., :3] = -100
        out.append({"input_ids": ids, "attention_mask": torch.ones_like(ids),
                    "labels": labels})
    return out


def _one_card_steps(model, params, batches):
    """The Trainer on card 0 over ``batches``: it, its state before and
    after the steps, and the losses."""
    from macaw_llm_tpu_torch.config import TrainConfig
    from macaw_llm_tpu_torch.train.trainer import Trainer
    tr = Trainer(model, TrainConfig(**TRAIN_KW), 10, device="cuda")
    st = tr.init_state(params)
    p0 = {k: v.detach().cpu().clone() for k, v in
          _paths(st.trainable).items()}
    losses = []
    for b in batches:
        st, m = tr.train_step(st, {k: v.cuda() for k, v in b.items()})
        losses.append(float(m["loss"]))
    return tr, p0, st, losses


def _paths(tree) -> dict:
    from macaw_llm_tpu_torch.parallel.sharding import tree_paths
    return dict(tree_paths(tree))


def _mesh_run(tmp, model, params, batches, **kw) -> dict:
    import dataclasses
    for name, obj in (("params", params), ("batches", batches)):
        torch.save(obj, tmp / f"{name}.pt")
    return dict(model=dataclasses.asdict(model), train=TRAIN_KW,
                params=str(tmp / "params.pt"),
                batches=str(tmp / "batches.pt"), **kw)


def _same_run(ranks: list, one_losses, one_state, p0) -> None:
    """The ranks' losses the same bits and within NCCL_LOSS_REL of one
    card's; rank 0's gathered trainable leaves' updates within 1e-3 of one
    card's largest update of the leaf plus 4 fp32 ulps of the leaf."""
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
    for a, b in zip(ranks[0]["loss"], one_losses):
        assert abs(a - b) <= NCCL_LOSS_REL * abs(b), (ranks[0]["loss"],
                                                      one_losses)
    got = _paths(ranks[0]["trainable"])
    want = _paths(one_state.trainable)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        upd = x.detach().cpu().double() - p0[k].double()
        err = (got[k].double() - p0[k].double() - upd).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * p0[k].abs().max().item()
        assert err <= 1e-3 * upd.abs().max().item() + 4 * ulp, k


@pytest.fixture(scope="module")
def zero3_over_nccl(tmp_path_factory):
    """3 steps of the tiny model under ZeRO-3 over a (1, 1, 4, 1) mesh,
    one rank a card, then the gathered save; and the same steps on card
    0."""
    _need_cards(4)
    from macaw_llm_tpu_torch.parallel.dryrun import spawn
    tmp = tmp_path_factory.mktemp("zero3")
    model = _tiny_model()
    params, batches = _tiny_weights(model), _text_batches(3)
    run = _mesh_run(tmp, model, params, batches, save=str(tmp / "ckpt"))
    ranks = spawn(4, "train", {"mesh": (1, 1, 4, 1), "runs": [run]},
                  str(tmp / "job"), device="cuda")
    return (model, params, [r["runs"][0] for r in ranks], tmp / "ckpt",
            _one_card_steps(model, params, batches))


def test_zero3_trainer_over_nccl_matches_one_card(zero3_over_nccl):
    """ZeRO-3 over four cards: each rank's shards a quarter of the fsdp
    dims, the collectives issued, the losses and updates one card's."""
    _, _, ranks, _, (_, p0, one, losses) = zero3_over_nccl
    assert all(r["collectives"].get("all_gather") and
               r["collectives"].get("reduce_scatter") for r in ranks)
    wq = [r["shapes"]["trainable"]["llm/layers/attn/wq"] for r in ranks]
    assert all(s == wq[0] for s in wq)
    _same_run(ranks, losses, one, p0)


def test_zero3_checkpoint_over_nccl_restores_on_one_card(zero3_over_nccl):
    """The checkpoint gathered from the four cards' shards restores on one
    card bit for bit against the state the ranks gathered."""
    from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
    _, params, ranks, ckpt, (tr, _, _, _) = zero3_over_nccl
    assert ranks[0]["last_save"]["mode"] == "gathered"
    back = CheckpointManager(str(ckpt)).restore(tr.init_state(params))
    assert back.step == ranks[0]["step"] == 3
    for name, tree in (("trainable", back.trainable),
                       ("mu", back.opt_state.mu), ("nu", back.opt_state.nu)):
        got = _paths(ranks[0][name])
        for path, x in _paths(tree).items():
            assert torch.equal(got[path], x.cpu()), (name, path)


def test_tp_train_and_generate_over_nccl_match_one_card(tmp_path):
    """Megatron over a (1, 1, 1, 2) mesh, one rank a card: 3 train steps
    against one card's, and the tensor-parallel greedy ``generate`` of
    the same weights against one card's tokens."""
    import dataclasses

    from macaw_llm_tpu_torch.generate import generate
    from macaw_llm_tpu_torch.models import llama
    from macaw_llm_tpu_torch.parallel.dryrun import spawn
    _need_cards(2)
    model = _tiny_model()
    params, batches = _tiny_weights(model), _text_batches(3)
    run = _mesh_run(tmp_path, model, params, batches)
    ranks = [r["runs"][0] for r in spawn(
        2, "train", {"mesh": (1, 1, 1, 2), "runs": [run]},
        str(tmp_path / "train"), device="cuda")]
    assert all(r["collectives"].get("all_reduce") for r in ranks)
    _, p0, one, losses = _one_card_steps(model, params, batches)
    _same_run(ranks, losses, one, p0)
    ids = _text_batches(1, b=2, s=9)[0]["input_ids"][0]
    with torch.no_grad():
        emb = llama.embed(params["llm"], ids)
    inputs = {"inputs_embeds": emb, "attention_mask": torch.ones_like(ids)}
    torch.save(inputs, tmp_path / "inputs.pt")
    kw = dict(max_new_tokens=5, eos_id=-1)
    case = dict(name="greedy", kind="generate", kw=kw,
                inputs=str(tmp_path / "inputs.pt"))
    gen = spawn(2, "tp", {"model": dataclasses.asdict(model),
                          "params": str(tmp_path / "params.pt"),
                          "cases": [case]}, str(tmp_path / "gen"),
                device="cuda")
    want = generate(_to_cuda(params["llm"]), model.llm, device="cuda",
                    **_to_cuda(inputs), **kw).tokens.cpu()
    for r in gen:
        assert torch.equal(r["greedy"], want)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_over_nccl_matches_plain_attention(tmp_path, layout):
    """``ring_attention`` over four ranks, one a card (the K/V exchange a
    ``batch_isend_irecv`` over NCCL, B2 forward and B3/B4 backward on each
    card): its output against the plain causal attention in fp32 (rows
    within 2^-6 of their max), output and gradients against the same
    ring's plain version in one process on the CPU
    (``ring_attention_local``: bf16 chunks summed step by step, as the
    ranks sum them) by ``test_ring_local``'s bars; the B2 launches of the
    whole ring n(n+1)/2 or n(2n+1)."""
    from macaw_llm_tpu_torch.parallel import ring_attention as ring
    from macaw_llm_tpu_torch.parallel.dryrun import spawn
    _need_cards(4)
    n, s = 4, 512
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(2, s, 4, 64, generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    perm = (ring.zigzag_indices(s, n) if layout == "zigzag"
            else torch.arange(s))
    torch.save([t[:, perm] for t in (q, k, v, g)], tmp_path / "qkv.pt")
    ranks = spawn(n, "ring", {"qkv": {layout: str(tmp_path / "qkv.pt")},
                              "layouts": [layout]}, str(tmp_path / "job"),
                  device="cuda")
    inv = ring.inverse_permutation(perm)
    out = torch.cat([r[layout]["out"] for r in ranks], 1)[:, inv]
    grads = [torch.cat([r[layout]["grads"][i] for r in ranks], 1)[:, inv]
             for i in range(3)]
    ref, _ = fa.attention_reference(q.float(), k.float(), v.float(), None,
                                    causal=True)
    assert _row_rel_err(out, ref) <= ATTN_ROW_REL
    x = [t[:, perm].requires_grad_() for t in (q, k, v)]
    local = ring.ring_attention_local(*x, n, layout)
    local.backward(g[:, perm])
    assert _row_rel_err(out, local.detach()[:, inv]) <= ATTN_ROW_REL
    for a, b in zip(grads, x):
        assert _grad_row_err(a, b.grad[:, inv]) <= 2 * BWD_ROW_REL
    want = n * (n + 1) // 2 if layout == "contiguous" else n * (2 * n + 1)
    assert sum(r[layout]["launches"]["flash_attention_with_lse"]
               for r in ranks) == want


def test_spans_lie_on_the_device_traces_clock(gen):
    """A span around a 20-ms host sleep between two kernels, under a
    CUDA-activity profile: the span covers at least 90% of the device's
    gap between the kernels, so the recorder's stamps and the profiler's
    device records share a clock (the offsets at both ends are printed).
    A span with a CUDA device reads its device time once its events have
    completed; one on the CPU reads none."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from macaw_llm_tpu_torch.utils.profiling import SpanRecorder
    rec, dev = SpanRecorder(), torch.device("cuda")
    x = torch.randn(2048, 2048, device="cuda", generator=gen)
    x @ x  # both kernels loaded before the profile: a first launch loads
    x + 1  # its module, which takes milliseconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with rec.span("work", device=dev):
            x @ x
        torch.cuda.synchronize()
        with rec.span("sleep", device=dev):
            time.sleep(0.02)
        x + 1
        torch.cuda.synchronize()
    with rec.span("on_cpu", device=torch.device("cpu")):
        pass
    rec.settle()
    ops = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                 for ev in prof.profiler.kineto_results.events()
                 if str(ev.device_type()).endswith("CUDA"))
    gaps = [(a[1], b[0]) for a, b in zip(ops, ops[1:]) if b[0] > a[1]]
    lo, hi = max(gaps, key=lambda g: g[1] - g[0])
    spans = {s.name: s for s in rec.snapshot()[0]}
    sleep = spans["sleep"]
    print(f"span starts {(sleep.start_ns - lo) / 1e3:.1f} us after the "
          f"gap; the gap ends {(hi - sleep.end_ns) / 1e3:.1f} us after "
          f"the span; gap {(hi - lo) / 1e6:.3f} ms")
    covered = min(hi, sleep.end_ns) - max(lo, sleep.start_ns)
    assert covered >= 0.9 * (hi - lo)
    assert spans["work"].device_ms > 0 and spans["sleep"].device_ms > 0
    assert spans["on_cpu"].device_ms is None
