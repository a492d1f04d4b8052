"""Rotary position embeddings, rotate-half formulation (LLaMA)."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 base: float = 10000.0, dtype=torch.float32):
    """cos/sin tables for integer ``positions`` [...] -> each
    positions.shape + (head_dim,)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exponents)
    angles = positions.float()[..., None] * inv_freq        # [..., d/2]
    angles = torch.cat([angles, angles], dim=-1)            # [..., d]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor):
    """q, k: [B, S, N, D]; cos, sin: [B, S, D] or [S, D] (broadcast over
    heads)."""
    cos = cos.unsqueeze(-2)
    sin = sin.unsqueeze(-2)
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
