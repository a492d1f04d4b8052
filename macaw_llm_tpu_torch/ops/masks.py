"""Additive fp32 attention masks (NEG_INF = float32 min, clamped after
sums)."""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """[1, 1, q_len, kv_len] additive causal mask; query i sits at
    position i + (kv_len - q_len)."""
    offset = kv_len - q_len
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.where(k_pos <= q_pos, 0.0, NEG_INF).float()
    return mask[None, None]


def padding_mask(attention_mask: torch.Tensor, q_len: int) -> torch.Tensor:
    """Expand a [B, S] {0,1} mask to additive [B, 1, q_len, S]."""
    mask = (1.0 - attention_mask.float()) * NEG_INF
    b, s = attention_mask.shape
    return mask[:, None, None, :].expand(b, 1, q_len, s)


def combine_masks(*masks):
    """Sum additive masks, clamping at NEG_INF."""
    total = None
    for m in masks:
        if m is None:
            continue
        total = m if total is None else total + m
    if total is None:
        return None
    return torch.clamp(total, min=NEG_INF)
