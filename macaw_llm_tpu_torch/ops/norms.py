"""Normalization ops (LLaMA RMSNorm, CLIP/Whisper LayerNorm); statistics in
fp32, result in the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization over the last axis, variance in fp32."""
    dtype = x.dtype
    xf = x.float()
    variance = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(variance + eps))
    return (weight * xf.to(dtype)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in fp32."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * weight.float() + bias.float()).to(dtype)
