"""Whole-sequence self-attention for short sequences (S_q == S_k).

Counterpart of ``macaw_llm_tpu/ops/pallas/mh_attention.py``. On CUDA
tensors the wrapper launches ``csrc/mh_attention.cu``, which stages the
whole K and V of one head in shared memory; on CPU tensors it computes the
plain version (``attention_reference``). Rows with no valid key give
zeros. Differentiable in q, k and v: the backward recomputes through the
reference package's einsum math (``mh_reference``), as the reference does;
no TPU kernel exists for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from macaw_llm_tpu_torch.ops.kernels import _build
from macaw_llm_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF, attention_reference)

__all__ = ["NEG_INF", "attention_reference", "fits_mh_attention",
           "mh_attention", "mh_reference"]

# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_BUDGET = 232448
HEAD_DIMS = (64, 128)  # template instances of the kernel


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(s: int, d: int, warps: int) -> int:
    """Shared memory of one block (mirrors MhLayout in the .cu file):
    K and V of the padded sequence at pitch d + 8, plus per warp a 16-row
    Q stage, a 16 x 16 fp32 logit tile and a 16 x 16 bf16 prob tile."""
    pitch = d + 8
    return (2 * _round_up(s, 16) * pitch * 2
            + warps * (16 * pitch * 2 + 16 * 16 * 4 + 16 * 24 * 2))


def fits_mh_attention(sq: int, sk: int, d: int) -> bool:
    """True when the whole padded K and V of one head fit a block's
    shared memory next to one warp's tiles."""
    return sq == sk and smem_bytes(sq, d, 1) <= SMEM_BUDGET


def _warps(s: int, d: int) -> int:
    for w in (8, 4, 2):
        if smem_bytes(s, d, w) <= SMEM_BUDGET:
            return w
    return 1


def mh_reference(q, k, v, padding_bias, scale: float,
                 causal: bool) -> torch.Tensor:
    """The reference package's recompute math of this kernel's backward
    (``mh_attention.py::_reference``): fp32 logits, the softmax normalized
    before the probabilities are rounded to the q dtype for the PV
    product."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc)) * scale
    if padding_bias is not None:
        logits = logits + padding_bias.to(acc)[:, None, None, :]
    if causal:
        idx = torch.arange(q.shape[1], device=q.device)
        logits = torch.where(idx[:, None] >= idx[None, :], logits, NEG_INF)
    logits = torch.clamp(logits, min=NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.clamp(m, min=-1e30))
    l_sum = p.sum(-1, keepdim=True)
    p = p / torch.where(l_sum == 0.0, 1.0, l_sum)
    return torch.einsum("bnqk,bknd->bqnd", p.to(q.dtype).to(acc),
                        v.to(acc)).to(q.dtype)


class _MhAttention(torch.autograd.Function):
    """Forward: the B1 kernel (plain version on the CPU). Backward: autograd
    through ``mh_reference``, as the reference package differentiates its
    ``_reference`` with ``jax.vjp``. That backward is an XLA einsum there
    and no Pallas kernel, so plain PyTorch is its faithful port."""

    @staticmethod
    def forward(ctx, q, k, v, padding_bias, causal, scale):
        ctx.save_for_backward(q, k, v, padding_bias)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q, k, v, padding_bias, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, padding_bias = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mh_reference(*qkv, padding_bias, ctx.scale, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def mh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 padding_bias: Optional[torch.Tensor] = None, *,
                 causal: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Fused short-sequence self-attention, differentiable in q, k, v.
    q/k/v [B, S, N, D]; padding_bias additive fp32 [B, S] or None (no
    gradient). CUDA: contiguous bf16, D in HEAD_DIMS and
    ``fits_mh_attention``; anything else raises."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if padding_bias is not None:
        padding_bias = padding_bias.detach()
    return _MhAttention.apply(q, k, v, padding_bias, causal, float(scale))


def _forward(q, k, v, padding_bias, causal: bool, scale: float):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, padding_bias, causal=causal,
                                   scale=scale)[0]
    b, s, n, d = q.shape
    if d not in HEAD_DIMS or not fits_mh_attention(s, s, d):
        raise ValueError(f"mh_attention kernel: S={s}, D={d} unsupported "
                         f"(D in {HEAD_DIMS}, K/V within shared memory)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"mh_attention kernel: {name} must be a "
                             f"contiguous bf16 tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if padding_bias is not None and (
            padding_bias.shape != (b, s) or padding_bias.device != q.device
            or padding_bias.dtype != torch.float32
            or not padding_bias.is_contiguous()):
        raise ValueError("mh_attention kernel: padding_bias must be a "
                         f"contiguous fp32 [{b}, {s}] tensor on {q.device}")
    out = torch.empty_like(q)
    err = _build.library().macaw_mh_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        out.data_ptr(), b, s, n, d, float(scale), int(causal), _warps(s, d),
        _build.stream_ptr(q))
    _build.check(err, "mh_attention")
    mh_attention.launches += 1
    return out


mh_attention.launches = 0
