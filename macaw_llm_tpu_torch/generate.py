"""Greedy generation from fused embeddings (counterpart of
``macaw_llm_tpu/generate.py::generate``; sampling, beam search and
speculative decoding are not ported yet).

Semantics of the reference package: the prompt positions come from the
attention-mask cumsum, the first token is read at each row's last valid
prompt position, every row stops at EOS or at its own budget and emits PAD
afterwards, and the loop ends once every row has finished. The KV cache is
one preallocated [L, B, S + max_new, N, D] buffer updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import EOS_ID, LlamaConfig, PAD_ID
from macaw_llm_tpu_torch.models import llama


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens], PAD after EOS
    num_steps: int        # decode iterations actually run


@torch.inference_mode()
def generate(params: dict, cfg: LlamaConfig, *,
             inputs_embeds: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None,
             max_new_tokens: int = 128,
             eos_id: int = EOS_ID,
             pad_id: int = PAD_ID,
             budgets: Optional[torch.Tensor] = None,
             device="cuda") -> GenerateResult:
    """Greedy decode from inputs_embeds [B, S, H] (on ``device``).

    ``budgets``: optional per-row [B] cap on generated tokens
    (<= max_new_tokens)."""
    device = resolve_device(device)
    if inputs_embeds.device.type != device.type:
        raise ValueError(f"inputs_embeds on {inputs_embeds.device}, "
                         f"expected {device}")
    b, s, _ = inputs_embeds.shape
    dtype = inputs_embeds.dtype
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=device)
    mask = attention_mask.to(torch.int32)
    full_mask = torch.cat(
        [mask, torch.ones((b, max_new_tokens), dtype=torch.int32,
                          device=device)], dim=1)
    prompt_pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    prompt_len = mask.sum(dim=1)                                   # [B]
    valid = llama.valid_vocab(cfg)

    cache = llama.KVCache.create(cfg, b, s + max_new_tokens, dtype, device)
    h = llama.forward_hidden(params, cfg, inputs_embeds,
                             attention_mask=full_mask, positions=prompt_pos,
                             kv_cache=cache)
    # last VALID prompt position per row (right padding samples there)
    last_valid = (mask * torch.arange(s, device=device)[None, :]).amax(1)
    h_last = h[torch.arange(b, device=device), last_valid][:, None]
    tok = llama.logits_from_hidden(params, h_last, valid)[:, 0].argmax(-1)

    if budgets is None:
        budgets = torch.full((b,), max_new_tokens, dtype=torch.int64,
                             device=device)
    else:
        budgets = torch.clamp(budgets.to(device=device, dtype=torch.int64),
                              max=max_new_tokens)
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int64,
                     device=device)
    out[:, 0] = tok
    finished = (tok == eos_id) | (budgets <= 1)
    step = 1
    while step < max_new_tokens and not bool(finished.all()):
        emb = params["embed_tokens"].to(dtype)[tok][:, None, :]
        pos = (prompt_len + step - 1)[:, None]
        logits = llama.forward(params, cfg, inputs_embeds=emb,
                               attention_mask=full_mask, positions=pos,
                               kv_cache=cache)
        nxt = logits[:, -1].argmax(-1)
        nxt = torch.where(finished, pad_id, nxt)
        out[:, step] = nxt
        tok = nxt
        finished = finished | (nxt == eos_id) | (step + 1 >= budgets)
        step += 1
    return GenerateResult(tokens=out, num_steps=step)
