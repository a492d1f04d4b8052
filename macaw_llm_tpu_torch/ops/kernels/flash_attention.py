"""Online-softmax flash attention: forward with log-sum-exp, and its
backward.

Counterpart of ``macaw_llm_tpu/ops/pallas/flash_attention.py``. On CUDA
tensors the forward launches ``csrc/flash_attention.cu`` (B2, a wgmma
kernel fed by TMA) and, where ``split_plan`` cuts the keys into chunks,
that file's combine kernel; the backward launches
``csrc/flash_attention_bwd.cu``: the delta kernel, the dq kernel (B3) and
the dk/dv kernel (B4); at head dims 64 and 128 B3 and B4 are wgmma kernels
fed by TMA (the source notes say how). On CPU tensors each wrapper
computes the plain PyTorch version written next to it, with no split.
``flash_attention`` and ``flash_attention_with_lse`` are
differentiable in q, k and v (a ``torch.autograd.Function``); the padding
bias takes no gradient, as in the reference.

Masked rows: a row whose every key is masked gives zeros and a log-sum-exp
of NEG_INF, and zero gradients. (The TPU kernel's output for such rows
depends on its K-block padding; its log-sum-exp is NEG_INF too, and its
backward's ``exp(s - lse)`` is 1 there.)
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (64, 128, 256)  # template instances of the kernels
# a logit or lse at or below this is masked (NEG_INF plus a finite term)
MASKED_LOGIT = -1e30
# B2's block: 128 query rows (two warpgroups of 64) over key tiles of
# BLOCK_K keys, 128 at head dim 128 (FwdWg in the .cu file)
BLOCK_Q, BLOCK_K = 128, 64


def block_k(d: int) -> int:
    """Keys per K/V tile of B2 at head dim ``d``."""
    return 128 if d == 128 else BLOCK_K

# split_plan's limits: at most this many key chunks (the workspace holds
# an fp32 copy of the output per chunk), and a block's fixed cost (its Q
# load, its epilogue, its share of the combine) in key tiles
MAX_CHUNKS = 32
CHUNK_COST_TILES = 2


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, padding_bias, causal: bool, scale: float,
            k0: int = 0) -> torch.Tensor:
    """Masked, scaled logits [B, N, Sq, Sk] in the accumulate dtype; k holds
    the keys from index ``k0`` on (the causal mask's key indices)."""
    acc = _acc_dtype(q)
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc)) * scale
    if padding_bias is not None:
        logits = logits + padding_bias.to(acc)[:, None, None, :]
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(k0, k0 + sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        logits = torch.where(keep, logits, NEG_INF)
    return torch.clamp(logits, min=NEG_INF)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        padding_bias: Optional[torch.Tensor] = None, *,
                        causal: bool = False,
                        scale: Optional[float] = None):
    """The plain version of both attention kernels: materialized fp32
    logits, single-pass softmax, probabilities rounded to the V dtype
    before the PV product, normalized after it.

    q [B, Sq, N, D], k/v [B, Sk, N, D], padding_bias additive fp32
    [B, Sk] or None; causal keeps key j for query i iff j <= i.
    Returns (out [B, Sq, N, D] in q.dtype, lse [B, Sq, N] fp32).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _acc_dtype(q)
    logits = _scores(q, k, padding_bias, causal, scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.clamp(m, min=-1e30))
    l_sum = p.sum(-1, keepdim=True)
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).to(acc), v.to(acc))
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse


def attention_backward_reference(q, k, v, padding_bias, lse, dout, delta, *,
                                 causal: bool, scale: float):
    """The plain version of both backward kernels, the same recompute
    formula in the accumulate dtype (fp32):

        p = exp(s - lse) (0 where the key is masked or lse is NEG_INF),
        dp = dO V^T,  ds = p (dp - delta) rounded to the q dtype,
        dq = ds K scale,  dk = ds^T Q scale,  dv = p^T dO (p in the dO dtype).

    lse and delta [B, Sq, N]; returns (dq, dk, dv) in the accumulate dtype.
    """
    acc = _acc_dtype(q)
    s = _scores(q, k, padding_bias, causal, scale)
    lse_r = lse.to(acc).permute(0, 2, 1)[..., None]          # [B, N, Sq, 1]
    live = (s > MASKED_LOGIT) & (lse_r > MASKED_LOGIT)
    p = torch.where(live, torch.exp(s - lse_r), 0.0)
    do = dout.to(acc)
    dp = torch.einsum("bqnd,bknd->bnqk", do, v.to(acc))
    ds = p * (dp - delta.to(acc).permute(0, 2, 1)[..., None])
    ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.to(acc)) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.to(acc)) * scale
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(dout.dtype).to(acc), do)
    return dq, dk, dv


@functools.lru_cache(maxsize=256)
def split_plan(b: int, sq: int, sk: int, n: int, d: int, causal: bool,
               sms: int) -> Tuple[Tuple[int, int], ...]:
    """B2's key chunks ((k0, k1), ...): whole key tiles (``block_k(d)``
    keys) covering [0, sk), none empty, one chunk unless a split fills the
    card better.

    B2 runs one block of 128 query rows per (batch x head, chunk); an SM
    holds one block at a time, two at D = 64 (``kMinBlocks`` in the .cu
    file). Without a split there are ``b * n * ceil(sq / 128)`` blocks;
    when they fill fewer slots than the card has, SMs idle while each block
    walks every key tile. A split into ``c`` chunks runs ``c`` times the
    blocks, each over ``ceil(tiles / c)`` tiles plus a fixed cost
    (CHUNK_COST_TILES), in ``ceil(blocks * c / slots)`` waves; the plan
    takes the ``c`` with the fewest tile-times in all (the smaller on a
    tie). At the video alignment (80 blocks of 501 tiles, D = 256) that is
    8 chunks: 640 blocks in 5 waves of 65 tile-times, against one wave of
    503. A causal block's work is at most the full walk, so causal shapes
    take the same count."""
    del causal
    slots = sms * (2 if d == 64 else 1)
    bk = block_k(d)
    tiles = -(-sk // bk)
    blocks = b * n * -(-sq // BLOCK_Q)
    if tiles <= 1 or blocks >= slots:
        return ((0, sk),)
    best, best_cost = 1, None
    for c in range(1, min(tiles, MAX_CHUNKS) + 1):
        per = -(-tiles // c)
        if -(-tiles // per) != c:  # the same chunks as a smaller count
            continue
        cost = -(-(blocks * c) // slots) * (per + CHUNK_COST_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    per = -(-tiles // best) * bk
    return tuple((k0, min(k0 + per, sk)) for k0 in range(0, sk, per))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_reference(q, k, v, padding_bias, *, causal: bool, scale: float,
                    k0: int, k1: int):
    """The plain version of one chunk's block of B2: attention of q over
    keys [k0, k1) alone (the causal mask by the keys' own indices). Returns
    the normalized partial output in the accumulate dtype (fp32) and its
    log-sum-exp [B, Sq, N], NEG_INF on a row with no valid key in the
    chunk."""
    acc = _acc_dtype(q)
    logits = _scores(q, k[:, k0:k1], None if padding_bias is None
                     else padding_bias[:, k0:k1], causal, scale, k0)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.clamp(m, min=-1e30))
    l_sum = p.sum(-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).to(acc),
                       v[:, k0:k1].to(acc))
    out = out / torch.where(l_sum == 0.0, 1.0, l_sum).permute(0, 2, 1, 3)
    lse = torch.where(l_sum > 0.0, m + torch.log(l_sum), NEG_INF)
    return out, lse[..., 0].permute(0, 2, 1)


def combine_reference(part_out: torch.Tensor, part_lse: torch.Tensor,
                      dtype: torch.dtype):
    """The plain version of the combine kernel: chunks' partial outputs
    [C, B, Sq, N, D] and log-sum-exps [C, B, Sq, N] (fp32) merged as
    lse = log sum_i exp(lse_i), out = sum_i exp(lse_i - lse) out_i, in
    chunk order. A chunk whose lse is NEG_INF weighs 0; a row with no valid
    key in any chunk gives zeros and NEG_INF. Returns (out in ``dtype``,
    lse [B, Sq, N])."""
    mx = part_lse.amax(0)
    live = mx > MASKED_LOGIT
    # exp(NEG_INF - NEG_INF) never runs: a dead row is taken against 0
    mref = torch.where(live, mx, 0.0)
    total = torch.where(live, mref + torch.log(torch.exp(
        part_lse - mref).sum(0)), 0.0)
    w = torch.exp(part_lse - total)
    out = (w[..., None] * part_out).sum(0)
    out = torch.where(live[..., None], out, 0.0)
    return out.to(dtype), torch.where(live, total, NEG_INF)


def split_attention_reference(q, k, v, padding_bias=None, *, causal: bool,
                              scale: Optional[float] = None,
                              chunks: Sequence[Tuple[int, int]]):
    """B2 with its keys split: the plain per-chunk partials
    (``chunk_reference``) over ``chunks`` (``split_plan``'s), merged by
    ``combine_reference``. Used by the tests and ``chip_smoke.py``; the
    wrappers compute ``attention_reference`` on the CPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    parts = [chunk_reference(q, k, v, padding_bias, causal=causal,
                             scale=scale, k0=k0, k1=k1) for k0, k1 in chunks]
    return combine_reference(torch.stack([o for o, _ in parts]),
                             torch.stack([lse for _, lse in parts]), q.dtype)


def _check_cuda(q, k, v, padding_bias, what: str, extra=()) -> None:
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, n, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {d} not in {HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError(f"{what} kernel: B*N = {b * n} > 65535")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be a contiguous "
                             f"bf16 tensor on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    if padding_bias is not None and (
            padding_bias.shape != (b, sk) or padding_bias.device != q.device
            or padding_bias.dtype != torch.float32
            or not padding_bias.is_contiguous()):
        raise ValueError(f"{what} kernel: padding_bias must be a contiguous "
                         f"fp32 [{b}, {sk}] tensor on {q.device}")


def _forward(q, k, v, padding_bias, causal: bool, scale: float):
    """B2: (out [B, Sq, N, D], lse [B, Sq, N] fp32)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, padding_bias, causal=causal,
                                   scale=scale)
    _check_cuda(q, k, v, padding_bias, "flash_attention")
    b, sq, n, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
    chunks = split_plan(b, sq, sk, n, d, causal,
                        _sm_count(q.device.index or 0))
    part_o = part_lse = None
    if len(chunks) > 1:  # the workspace of the split, one plane a chunk
        part_o = torch.empty((len(chunks), b, sq, n, d), dtype=torch.float32,
                             device=q.device)
        part_lse = torch.empty((len(chunks), b, sq, n), dtype=torch.float32,
                               device=q.device)
    bk = block_k(d)
    chunk_tiles = (chunks[0][1] - chunks[0][0]) // bk if len(chunks) > 1 \
        else -(-sk // bk)
    err = _build.library().macaw_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_lse is None else part_lse.data_ptr(), b, sq, sk, n, d,
        float(scale), int(causal), chunk_tiles, len(chunks),
        _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention_with_lse.launches += 1
    if part_o is not None:
        _combine(part_o, part_lse, out, lse)
    return out, lse.view(b, n, sq).permute(0, 2, 1)


def _combine(part_out, part_lse, out, lse) -> None:
    c, b, sq, n, d = part_out.shape
    err = _build.library().macaw_flash_attention_combine(
        part_out.data_ptr(), part_lse.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, n, d, c, _build.stream_ptr(part_out))
    _build.check(err, "flash_attention combine")
    flash_attention_combine.launches += 1


def flash_attention_combine(part_out: torch.Tensor, part_lse: torch.Tensor):
    """B2's combine: chunks' partials [C, B, Sq, N, D] and [C, B, Sq, N]
    (fp32) -> (out [B, Sq, N, D] bf16, lse [B, Sq, N] fp32, laid out
    [B*N, Sq] in memory). ``_forward`` launches it after a split; this
    entry, which checks its inputs, serves the tests and ``chip_smoke.py``.
    CPU: ``combine_reference``."""
    c, b, sq, n, d = part_out.shape
    if part_out.device.type == "cpu":
        return combine_reference(part_out, part_lse, torch.bfloat16)
    if d not in HEAD_DIMS or part_lse.shape != (c, b, sq, n):
        raise ValueError(f"flash_attention combine kernel: partials "
                         f"{tuple(part_out.shape)}, {tuple(part_lse.shape)}")
    for name, t in (("part_out", part_out), ("part_lse", part_lse)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != part_out.device:
            raise ValueError(f"flash_attention combine kernel: {name} must "
                             f"be a contiguous fp32 tensor on "
                             f"{part_out.device}")
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16,
                      device=part_out.device)
    lse = torch.empty((b * n, sq), dtype=torch.float32,
                      device=part_out.device)
    _combine(part_out, part_lse, out, lse)
    return out, lse.view(b, n, sq).permute(0, 2, 1)


flash_attention_combine.launches = 0


def _folded(t: torch.Tensor) -> torch.Tensor:
    """[B, Sq, N] fp32 -> contiguous [B*N, Sq], the kernels' layout."""
    b, sq, n = t.shape
    return t.permute(0, 2, 1).float().contiguous().view(b * n, sq)


def flash_attention_dq(q, k, v, padding_bias, dout, lse, delta, *,
                       causal: bool, scale: float) -> torch.Tensor:
    """B3: dq [B, Sq, N, D] in q.dtype. lse and delta [B, Sq, N] fp32."""
    if q.device.type == "cpu":
        return attention_backward_reference(
            q, k, v, padding_bias, lse, dout, delta, causal=causal,
            scale=scale)[0].to(q.dtype)
    _check_cuda(q, k, v, padding_bias, "flash_attention dq",
                (("dout", dout),))
    b, sq, n, d = q.shape
    dq = torch.empty_like(q)
    lse_f, delta_f = _folded(lse), _folded(delta)
    err = _build.library().macaw_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        dout.data_ptr(), lse_f.data_ptr(), delta_f.data_ptr(), dq.data_ptr(),
        b, sq, k.shape[1], n, d, float(scale), int(causal),
        _build.stream_ptr(q))
    _build.check(err, "flash_attention dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, padding_bias, dout, lse, delta, *,
                        causal: bool, scale: float):
    """B4: (dk, dv) [B, Sk, N, D] in k.dtype / v.dtype."""
    if q.device.type == "cpu":
        _, dk, dv = attention_backward_reference(
            q, k, v, padding_bias, lse, dout, delta, causal=causal,
            scale=scale)
        return dk.to(k.dtype), dv.to(v.dtype)
    _check_cuda(q, k, v, padding_bias, "flash_attention dk/dv",
                (("dout", dout),))
    b, sq, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse_f, delta_f = _folded(lse), _folded(delta)
    err = _build.library().macaw_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        dout.data_ptr(), lse_f.data_ptr(), delta_f.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, k.shape[1], n, d, float(scale), int(causal),
        _build.stream_ptr(q))
    _build.check(err, "flash_attention dk/dv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def backward_delta(out: torch.Tensor, dout: torch.Tensor,
                   g_lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the delta kernel: delta = rowsum(dO * O)
    [B, Sq, N] in fp32, less the LSE cotangent (the LSE's own dependence on
    the logits adds p * g_lse to ds). Laid out as the kernels read it,
    [B*N, Sq] in memory, so ``_folded`` hands it over without a copy."""
    acc = _acc_dtype(out)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.to(acc)
    return delta.permute(0, 2, 1).contiguous().permute(0, 2, 1)


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor,
                          g_lse: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """delta [B, Sq, N] fp32, as ``backward_delta`` lays it out. out, dout
    [B, Sq, N, D]; g_lse [B, Sq, N] or None. CUDA: contiguous bf16 out and
    dout."""
    if out.device.type == "cpu":
        return backward_delta(out, dout, g_lse)
    b, sq, n, d = out.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != out.shape or t.device != out.device \
                or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention delta kernel: {name} must be "
                             f"a contiguous bf16 {tuple(out.shape)} tensor "
                             f"on {out.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention delta kernel: head dim {d} not "
                         f"in {HEAD_DIMS}")
    if g_lse is not None:
        g_lse = g_lse.to(torch.float32).contiguous()
    delta = torch.empty((b * n, sq), dtype=torch.float32, device=out.device)
    err = _build.library().macaw_flash_attention_bwd_delta(
        out.data_ptr(), dout.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(), b, sq,
        n, d, _build.stream_ptr(out))
    _build.check(err, "flash_attention delta")
    flash_attention_delta.launches += 1
    return delta.view(b, n, sq).permute(0, 2, 1)


flash_attention_delta.launches = 0


class _FlashAttention(torch.autograd.Function):
    """B2 forward; delta + B3 + B4 backward (plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, padding_bias, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = _forward(q, k, v, padding_bias, causal, scale)
        ctx.save_for_backward(q, k, v, padding_bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, padding_bias, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.contiguous()
        delta = flash_attention_delta(out, g_out, g_lse)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_dq(q, k, v, padding_bias, g_out, lse, delta,
                                **kw)
        dk, dv = flash_attention_dkv(q, k, v, padding_bias, g_out, lse,
                                     delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             padding_bias: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """Flash attention returning (out [B, Sq, N, D], lse [B, Sq, N] fp32),
    differentiable in q, k, v (both outputs).

    q [B, Sq, N, D], k/v [B, Sk, N, D]; padding_bias additive fp32 [B, Sk]
    (0 keep, NEG_INF masked) or None, no gradient. CUDA: contiguous bf16, D
    in HEAD_DIMS; anything else raises.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if padding_bias is not None:
        padding_bias = padding_bias.detach()
    return _FlashAttention.apply(q, k, v, padding_bias, causal, float(scale))


flash_attention_with_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    padding_bias: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention output only ([B, Sq, N, D])."""
    return flash_attention_with_lse(q, k, v, padding_bias, causal=causal,
                                    scale=scale)[0]
