"""Online-softmax flash attention, forward with log-sum-exp.

Counterpart of ``macaw_llm_tpu/ops/pallas/flash_attention.py`` (forward).
On CUDA tensors the wrapper launches ``csrc/flash_attention.cu``; on CPU
tensors it computes the plain PyTorch version below. The backward kernels
(dq, dk/dv) belong to the training path and are not ported yet.

Masked rows: a row whose every key is masked gives zeros and a log-sum-exp
of NEG_INF. (The TPU kernel's output for such rows depends on its K-block
padding; its log-sum-exp is NEG_INF too.)
"""

from __future__ import annotations

from typing import Optional

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (64, 128, 256)  # template instances of the kernel


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
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if padding_bias is not None:
        logits = logits + padding_bias.float()[:, None, None, :]
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        logits = torch.where(keep, logits, NEG_INF)
    logits = torch.clamp(logits, min=NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.clamp(m, min=-1e30))
    l_sum = p.sum(-1, keepdim=True)
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             padding_bias: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """Flash attention returning (out [B, Sq, N, D], lse [B, Sq, N] fp32).

    q [B, Sq, N, D], k/v [B, Sk, N, D]; padding_bias additive fp32 [B, Sk]
    (0 keep, NEG_INF masked) or None. CUDA: contiguous bf16, D in
    HEAD_DIMS; anything else raises.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, padding_bias, causal=causal,
                                   scale=scale)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, n, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError(f"flash_attention kernel: B*N = {b * n} > 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be a "
                             f"contiguous bf16 tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if padding_bias is not None and (
            padding_bias.shape != (b, sk) or padding_bias.device != q.device
            or padding_bias.dtype != torch.float32
            or not padding_bias.is_contiguous()):
        raise ValueError("flash_attention kernel: padding_bias must be a "
                         f"contiguous fp32 [{b}, {sk}] tensor on {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
    err = _build.library().macaw_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_bias is None else padding_bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, sk, n, d, float(scale),
        int(causal), _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention_with_lse.launches += 1
    return out, lse.view(b, n, sq).permute(0, 2, 1)


flash_attention_with_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    padding_bias: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention output only ([B, Sq, N, D])."""
    return flash_attention_with_lse(q, k, v, padding_bias, causal=causal,
                                    scale=scale)[0]
