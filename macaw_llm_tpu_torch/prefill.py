"""Fused multimodal prefill: raw media + text in, first-token logits out.

The port's counterpart of the reference package's benchmark prefill
(``bench.py``: ``prepare_inputs`` -> ``forward_hidden(use_flash=True)`` ->
last-position ``logits_from_hidden``). The serving configuration is int8
LLaMA weights, packed tower projections and the int8 alignment K/V cache;
int8 projections of >= 256 rows always quantize their activations too
(W8A8), as the reference benchmark sets for its prefill: the LLaMA's, and
the towers' when ``utils.quantize.quantize_towers`` made them int8.
Under a tensor group (``tp``) each rank runs its block of the tree
(``parallel.tensor_parallel``) and every rank returns the whole logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import ModelConfig
from macaw_llm_tpu_torch.models import fusion, llama
from macaw_llm_tpu_torch.parallel.tensor_parallel import TensorParallel


@torch.inference_mode()
def prefill(params: dict, cfg: ModelConfig, batch: dict,
            align_cache: Optional[dict] = None, *,
            video_mode: str = "long",
            device="cuda",
            tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """batch: input_ids [B, S], attention_mask [B, S], images uint8
    [B, H, W, 3], audios fp32 [B, 480000], videos uint8 [B, F, H, W, 3],
    all on ``device``; ``video_mode`` as in ``fusion.prepare_inputs``.
    Returns the last position's fp32 logits [B, V]."""
    device = resolve_device(device)
    if batch["input_ids"].device.type != device.type:
        raise ValueError(f"batch on {batch['input_ids'].device}, expected "
                         f"{device}")
    fused = fusion.prepare_inputs(
        params, cfg, input_ids=batch["input_ids"], images=batch["images"],
        audios=batch["audios"], videos=batch["videos"],
        attention_mask=batch["attention_mask"], align_cache=align_cache,
        video_mode=video_mode, activation_quant=True, tp=tp)
    h = llama.forward_hidden(params["llm"], cfg.llm, fused.inputs_embeds,
                             fused.attention_mask, use_flash=True,
                             activation_quant=True, tp=tp)
    return llama.logits_from_hidden(params["llm"], h[:, -1:],
                                    llama.valid_vocab(cfg.llm), tp=tp)[:, 0]
