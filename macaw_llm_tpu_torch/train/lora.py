"""LoRA adapters on the LLaMA q and v projections (counterpart of
``macaw_llm_tpu/train/lora.py``): low-rank A/B factors stacked per layer
([L, h, r] and [L, r, out]), A he-uniform, B zero, so the delta starts at
0; the update is (x @ A) @ B * (alpha / r).

``params["llm"]["layers"]["lora"] = init_lora(...)``; the decoder picks it
up. ``merge_lora`` folds the adapters into the base weights."""

from __future__ import annotations

import math
from typing import Optional

import torch

from macaw_llm_tpu_torch.config import LlamaConfig
from macaw_llm_tpu_torch.models._tree import uniform
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar


def init_lora(gen: torch.Generator, cfg: LlamaConfig, rank: int,
              dtype=torch.float32) -> dict:
    """A: he-uniform over fan_in = hidden (limit sqrt(6 / h)); B: zeros."""
    h = cfg.hidden_size
    nkv = cfg.kv_heads * cfg.head_dim
    L = cfg.num_layers
    lim = math.sqrt(6.0 / h)
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "qa": uniform(gen, (L, h, rank), lim, dtype),
        "qb": torch.zeros((L, rank, h), **zeros),
        "va": uniform(gen, (L, h, rank), lim, dtype),
        "vb": torch.zeros((L, rank, nkv), **zeros),
    }


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: float, tp=None, s: Optional[int] = None
               ) -> torch.Tensor:
    """(x @ A) @ B * scale in x's dtype, without the merged weight.

    ``tp`` (``parallel.tensor_parallel``; B this rank's column block, A
    whole): the rank-r middle x @ A passes Megatron's f before B, so that
    its gradient (and A's, and x's through it) sums the ranks' blocks.
    Under ``tp.sequence`` x is this rank's block of ``s`` positions and
    the middle is all-gathered over the sequence first."""
    c = x.dtype
    mid = x @ a.to(c)
    if tp is not None and tp.sequence:
        mid = tpar.gather_sequence(tp, mid, s, cut=False)
    return (tpar.copy(tp, mid) @ b.to(c)) * torch.tensor(scale, dtype=c)


def merge_lora(llm_params: dict, rank: int, alpha: float) -> dict:
    """Fold the adapters into wq / wv (peft's merge_and_unload)."""
    if "lora" not in llm_params.get("layers", {}):
        return llm_params
    layers = dict(llm_params["layers"])
    lora = layers.pop("lora")
    scale = alpha / rank
    attn = dict(layers["attn"])
    attn["wq"] = attn["wq"] + torch.einsum("lhr,lrk->lhk", lora["qa"],
                                           lora["qb"]) * scale
    attn["wv"] = attn["wv"] + torch.einsum("lhr,lrk->lhk", lora["va"],
                                           lora["vb"]) * scale
    layers["attn"] = attn
    out = dict(llm_params)
    out["layers"] = layers
    return out
