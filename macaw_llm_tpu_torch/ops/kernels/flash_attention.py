"""Online-softmax flash attention: forward with log-sum-exp, and its
backward.

Counterpart of ``macaw_llm_tpu/ops/pallas/flash_attention.py``. On CUDA
tensors the forward launches ``csrc/flash_attention.cu`` (B2) and the
backward ``csrc/flash_attention_bwd.cu``: the delta kernel, the dq kernel
(B3) and the dk/dv kernel (B4); at head dims 64 and 128 B3 and B4 are
wgmma kernels fed by TMA (the source note says how). On CPU tensors each
wrapper computes the plain PyTorch version written next to it.
``flash_attention`` and ``flash_attention_with_lse`` are
differentiable in q, k and v (a ``torch.autograd.Function``); the padding
bias takes no gradient, as in the reference.

Masked rows: a row whose every key is masked gives zeros and a log-sum-exp
of NEG_INF, and zero gradients. (The TPU kernel's output for such rows
depends on its K-block padding; its log-sum-exp is NEG_INF too, and its
backward's ``exp(s - lse)`` is 1 there.)
"""

from __future__ import annotations

from typing import Optional

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (64, 128, 256)  # template instances of the kernels
# a logit or lse at or below this is masked (NEG_INF plus a finite term)
MASKED_LOGIT = -1e30


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, padding_bias, causal: bool, scale: float) -> torch.Tensor:
    """Masked, scaled logits [B, N, Sq, Sk] in the accumulate dtype."""
    acc = _acc_dtype(q)
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc)) * scale
    if padding_bias is not None:
        logits = logits + padding_bias.to(acc)[:, None, None, :]
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sk, device=q.device)[None, :]
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
    out = torch.empty_like(q)
    lse = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
    err = _build.library().macaw_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], n, d, float(scale),
        int(causal), _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention_with_lse.launches += 1
    return out, lse.view(b, n, sq).permute(0, 2, 1)


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
