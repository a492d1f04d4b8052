"""Autoregressive generation from fused embeddings (counterpart of
``macaw_llm_tpu/generate.py``): ``generate`` (greedy or sampled, bf16 or
int8 KV cache), ``generate_from_ids``, ``beam_search`` and the greedy
``generate_speculative`` with its prompt-lookup drafter ``_ngram_propose``.

Semantics of the reference package: the prompt positions come from the
attention-mask cumsum, the first token is read at each row's last valid
prompt position, every row stops at EOS or at its own budget and emits PAD
afterwards, and the loop ends once every row has finished. The KV cache is
one preallocated [L, B, S + max_new, N, D] buffer updated in place.

Sampling draws from an explicit ``torch.Generator`` where the reference
threads a PRNG key; the two give different numbers from the same seed, so
only distributions agree. Without a generator every row decodes greedily.

Under a tensor group (``tp``: ``params`` is this rank's block of a
tensor-parallel tree, ``parallel.tensor_parallel``) every rank runs the
same loop: the row-parallel all-reduces give each rank the same logits,
so every host decision (EOS, budgets, beam reorders, speculative
acceptance, and the draws of a generator seeded alike on every rank) is
the same on every rank and they issue their collectives in one order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import EOS_ID, LlamaConfig, PAD_ID
from macaw_llm_tpu_torch.models import llama
from macaw_llm_tpu_torch.ops.masks import NEG_INF
from macaw_llm_tpu_torch.parallel.tensor_parallel import TensorParallel


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens], PAD after EOS
    num_steps: int        # decode iterations actually run


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature, top_k: int = 0) -> torch.Tensor:
    """Next-token choice from [B, V] logits.

    ``temperature`` is a scalar or a per-row [B] tensor: rows at 0 decode
    greedily even when batched with sampling rows, whatever the generator
    draws. ``top_k`` > 0 keeps each row's k largest logits. Greedy
    everywhere when ``generator`` is None."""
    greedy = logits.argmax(-1)
    if generator is None:
        return greedy
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device).expand(greedy.shape)
    scaled = logits.float() / torch.clamp(temp, min=1e-6)[:, None]
    if top_k > 0:
        kth = scaled.topk(top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temp > 0.0, sampled, greedy)


def _prompt_layout(attention_mask: Optional[torch.Tensor], b: int, s: int,
                   max_new_tokens: int, device):
    """(mask extended by ones over the generated region, positions from
    the mask cumsum, prompt lengths [B], last valid prompt position [B])."""
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=device)
    mask = attention_mask.to(torch.int32)
    full_mask = torch.cat(
        [mask, torch.ones((b, max_new_tokens), dtype=torch.int32,
                          device=device)], dim=1)
    prompt_pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    # last VALID prompt position per row (right padding samples there)
    last_valid = (mask * torch.arange(s, device=device)[None, :]).amax(1)
    return full_mask, prompt_pos, mask.sum(dim=1), last_valid


@torch.inference_mode()
def generate(params: dict, cfg: LlamaConfig, *,
             inputs_embeds: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None,
             max_new_tokens: int = 128,
             eos_id: int = EOS_ID,
             pad_id: int = PAD_ID,
             temperature=0.0,
             top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             budgets: Optional[torch.Tensor] = None,
             cache_dtype: Optional[str] = None,
             device="cuda",
             tp: Optional[TensorParallel] = None) -> GenerateResult:
    """Decode from inputs_embeds [B, S, H] (on ``device``).

    ``budgets``: optional per-row [B] cap on generated tokens
    (<= max_new_tokens). ``temperature`` may be per-row; sampling needs a
    ``generator`` on ``device`` (None: greedy everywhere).
    ``cache_dtype="int8"`` stores the KV cache quantized."""
    device = resolve_device(device)
    if inputs_embeds.device.type != device.type:
        raise ValueError(f"inputs_embeds on {inputs_embeds.device}, "
                         f"expected {device}")
    b, s, _ = inputs_embeds.shape
    dtype = inputs_embeds.dtype
    full_mask, prompt_pos, prompt_len, last_valid = _prompt_layout(
        attention_mask, b, s, max_new_tokens, device)
    valid = llama.valid_vocab(cfg)

    cache = llama.KVCache.create(cfg, b, s + max_new_tokens,
                                 dtype if cache_dtype is None else cache_dtype,
                                 device, tp)
    # hidden states only: the logits are projected for the one sampled
    # position per row, never for the whole prompt
    h = llama.forward_hidden(params, cfg, inputs_embeds,
                             attention_mask=full_mask, positions=prompt_pos,
                             kv_cache=cache, tp=tp)
    h_last = h[torch.arange(b, device=device), last_valid][:, None]
    tok = _sample(llama.logits_from_hidden(params, h_last, valid,
                                           tp=tp)[:, 0],
                  generator, temperature, top_k)

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
        emb = llama.embed(params, tok[:, None], dtype, tp)
        pos = (prompt_len + step - 1)[:, None]
        logits = llama.forward(params, cfg, inputs_embeds=emb,
                               attention_mask=full_mask, positions=pos,
                               kv_cache=cache, tp=tp)
        nxt = _sample(logits[:, -1], generator, temperature, top_k)
        nxt = torch.where(finished, pad_id, nxt)
        out[:, step] = nxt
        tok = nxt
        finished = finished | (nxt == eos_id) | (step + 1 >= budgets)
        step += 1
    return GenerateResult(tokens=out, num_steps=step)


def generate_from_ids(params: dict, cfg: LlamaConfig, *,
                      input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      **kw) -> GenerateResult:
    """Text-only convenience wrapper (no media)."""
    embeds = llama.embed(params, input_ids, tp=kw.get("tp"))
    return generate(params, cfg, inputs_embeds=embeds,
                    attention_mask=attention_mask, **kw)


@torch.inference_mode()
def beam_search(params: dict, cfg: LlamaConfig, *,
                inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                num_beams: int = 4,
                max_new_tokens: int = 128,
                eos_id: int = EOS_ID,
                pad_id: int = PAD_ID,
                length_penalty: float = 1.0,
                device="cuda",
                tp: Optional[TensorParallel] = None) -> GenerateResult:
    """Beam search from fused embeddings: one prefill per example, the
    cache expanded to B x beams rows and reordered each step by a gather
    over the selected parent beams. Returns the best beam per example by
    length-penalized score, PAD after EOS."""
    device = resolve_device(device)
    if inputs_embeds.device.type != device.type:
        raise ValueError(f"inputs_embeds on {inputs_embeds.device}, "
                         f"expected {device}")
    b, s, _ = inputs_embeds.shape
    dtype = inputs_embeds.dtype
    bb = b * num_beams
    full_mask, prompt_pos, prompt_len, last_valid = _prompt_layout(
        attention_mask, b, s, max_new_tokens, device)
    full_mask_bb = full_mask.repeat_interleave(num_beams, dim=0)
    prompt_len_bb = prompt_len.repeat_interleave(num_beams, dim=0)

    cache = llama.KVCache.create(cfg, b, s + max_new_tokens, dtype, device,
                                 tp)
    logits = llama.forward(params, cfg, inputs_embeds=inputs_embeds,
                           attention_mask=full_mask, positions=prompt_pos,
                           kv_cache=cache, tp=tp)
    cache = llama.KVCache(k=cache.k.repeat_interleave(num_beams, dim=1),
                          v=cache.v.repeat_interleave(num_beams, dim=1),
                          length=cache.length)
    first_logits = logits[torch.arange(b, device=device), last_valid]
    scores, tok = torch.log_softmax(first_logits.float(), -1).topk(
        num_beams, dim=-1)                                  # [B, beams]

    out = torch.full((b, num_beams, max_new_tokens), pad_id,
                     dtype=torch.int64, device=device)
    out[:, :, 0] = tok
    finished = tok == eos_id
    vocab = logits.shape[-1]
    # a finished beam may only extend with PAD, at no cost
    pad_only = torch.full((vocab,), NEG_INF, device=device)
    pad_only[pad_id] = 0.0
    batch_offset = torch.arange(b, device=device)[:, None] * num_beams
    step = 1
    while step < max_new_tokens and not bool(finished.all()):
        emb = llama.embed(params, tok.reshape(bb, 1), dtype, tp)
        pos = (prompt_len_bb + step - 1)[:, None]
        logits = llama.forward(params, cfg, inputs_embeds=emb,
                               attention_mask=full_mask_bb, positions=pos,
                               kv_cache=cache, tp=tp)
        lp = torch.log_softmax(logits[:, -1].float(), -1)
        lp = lp.reshape(b, num_beams, vocab)
        lp = torch.where(finished[:, :, None], pad_only[None, None, :], lp)
        cand = scores[:, :, None] + lp                      # [B, beams, V]
        scores, idx = cand.reshape(b, num_beams * vocab).topk(num_beams,
                                                              dim=-1)
        beam_idx = idx // vocab                             # [B, beams]
        tok = idx % vocab
        # reorder everything by the selected parent beam
        flat_parent = (batch_offset + beam_idx).reshape(bb)
        cache.k = cache.k[:, flat_parent]
        cache.v = cache.v[:, flat_parent]
        out = torch.gather(out, 1, beam_idx[:, :, None].expand(
            b, num_beams, max_new_tokens))
        finished = torch.gather(finished, 1, beam_idx)
        tok = torch.where(finished, pad_id, tok)
        out[:, :, step] = tok
        finished = finished | (tok == eos_id)
        step += 1
    lengths = (out != pad_id).float().sum(-1)
    norm = scores / torch.clamp(lengths, min=1.0) ** length_penalty
    best = norm.argmax(dim=1)                               # [B]
    tokens = out[torch.arange(b, device=device), best]
    return GenerateResult(tokens=tokens, num_steps=step)


def _ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor,
                   draft_len: int, ngram: int, pad_id: int) -> torch.Tensor:
    """Prompt-lookup drafts: the ``draft_len`` tokens that followed the
    most recent earlier occurrence of each row's last ``ngram`` tokens.

    hist [B, L] (prompt, then generated, PAD elsewhere); hist_len [B]
    valid lengths. A row with no match proposes PAD, which the verify
    rejects: plain decode speed, never a wrong token."""
    b, L = hist.shape
    device = hist.device
    rows = torch.arange(b, device=device)[:, None]
    s0 = hist_len - ngram                                   # suffix start
    suffix = hist[rows, torch.clamp(
        s0[:, None] + torch.arange(ngram, device=device), 0, L - 1)]
    # match[p]: hist[p : p + ngram] == suffix
    match = torch.ones((b, L - ngram + 1), dtype=torch.bool, device=device)
    for j in range(ngram):
        match &= hist[:, j:L - ngram + 1 + j] == suffix[:, j:j + 1]
    p = torch.arange(L - ngram + 1, device=device)[None, :]
    # an occurrence must start before the suffix itself
    valid = match & (p < s0[:, None]) & (s0[:, None] >= 0)
    best = torch.where(valid, p, -1).amax(1)                # [B]
    idx = best[:, None] + ngram + torch.arange(draft_len, device=device)
    vals = hist[rows, torch.clamp(idx, 0, L - 1)]
    ok = (best[:, None] >= 0) & (idx < hist_len[:, None])
    return torch.where(ok, vals, pad_id)


@torch.inference_mode()
def generate_speculative(params: dict, cfg: LlamaConfig, *,
                         inputs_embeds: torch.Tensor,
                         prompt_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None,
                         max_new_tokens: int = 128,
                         eos_id: int = EOS_ID,
                         pad_id: int = PAD_ID,
                         draft_len: int = 4,
                         ngram: int = 2,
                         cache_dtype: Optional[str] = None,
                         proposer: str = "ngram",
                         oracle_tokens: Optional[torch.Tensor] = None,
                         device="cuda",
                         tp: Optional[TensorParallel] = None
                         ) -> GenerateResult:
    """Greedy decode with speculative verification: the same tokens as
    ``generate``'s greedy ones, in fewer forwards.

    Each round drafts ``draft_len`` tokens per row, runs one verify
    forward over [last token, drafts] (``draft_len + 1`` positions a row,
    written into the cache at each row's own length) and keeps the longest
    prefix of drafts that the verify's argmax confirms, plus the verify's
    next token. The verify's int8 projections are decode-shaped
    (``decode_rows``): at most 32 rows in all take the matvec kernels, so a
    round streams the weights once, as a greedy step does.

    ``proposer="ngram"``: prompt lookup over [prompt_ids; generated]
    (``prompt_ids`` [B, S_p], right-padded text ids: those the fusion
    consumed). ``proposer="oracle"`` drafts from ``oracle_tokens`` [B,
    max_new_tokens] (acceptance 1 when they are the greedy tokens).
    Generated tokens take the RoPE positions that ``generate`` gives them
    (the row's prompt length on), also for right-padded prompts.
    ``GenerateResult.num_steps`` counts the verify rounds."""
    device = resolve_device(device)
    if inputs_embeds.device.type != device.type:
        raise ValueError(f"inputs_embeds on {inputs_embeds.device}, "
                         f"expected {device}")
    if proposer not in ("ngram", "oracle"):
        raise ValueError(f"proposer {proposer!r}: 'ngram' or 'oracle'")
    if proposer == "oracle" and oracle_tokens is None:
        raise ValueError("proposer='oracle' needs oracle_tokens")
    b, s, _ = inputs_embeds.shape
    k = draft_len
    dtype = inputs_embeds.dtype
    # the buffer holds a verify's k writes past the last emitted token, so
    # no write of a live row reaches its end
    full_mask, prompt_pos, prompt_len, last_valid = _prompt_layout(
        attention_mask, b, s, max_new_tokens + k, device)
    valid = llama.valid_vocab(cfg)
    cache = llama.KVCache.create(cfg, b, s + max_new_tokens + k,
                                 dtype if cache_dtype is None else cache_dtype,
                                 device, tp)
    h = llama.forward_hidden(params, cfg, inputs_embeds,
                             attention_mask=full_mask, positions=prompt_pos,
                             kv_cache=cache, tp=tp)
    rows = torch.arange(b, device=device)
    tok = llama.logits_from_hidden(params, h[rows, last_valid][:, None],
                                   valid, tp=tp)[:, 0].argmax(-1)

    # the n-gram corpus: each row's prompt text, then its generated tokens
    prompt_ids = prompt_ids.to(device=device, dtype=torch.int64)
    plen = (prompt_ids != pad_id).sum(1)
    hist = torch.cat([prompt_ids, torch.full((b, max_new_tokens), pad_id,
                                             dtype=torch.int64,
                                             device=device)], 1)
    hist_at = plen[:, None] + torch.arange(max_new_tokens, device=device)
    if oracle_tokens is not None:
        oracle_tokens = oracle_tokens.to(device=device, dtype=torch.int64)

    # one column past the budget takes the writes of rejected positions
    out = torch.full((b, max_new_tokens + 1), pad_id, dtype=torch.int64,
                     device=device)
    out[:, 0] = tok
    n_emit = torch.ones(b, dtype=torch.int64, device=device)
    row_len = torch.full((b,), s, dtype=torch.int64, device=device)
    # a row is finished at EOS or at the budget, so this is the only host
    # read of a round
    finished = (tok == eos_id) | (max_new_tokens <= 1)
    steps = torch.arange(k + 1, device=device)[None, :]
    rounds = 0
    while not bool(finished.all()):
        # ---- draft ----
        if proposer == "oracle":
            idx = n_emit[:, None] + steps[:, :k]
            drafts = torch.where(
                idx < max_new_tokens,
                oracle_tokens[rows[:, None],
                              torch.clamp(idx, max=max_new_tokens - 1)],
                pad_id)
        else:
            hist[rows[:, None], hist_at] = out[:, :max_new_tokens]
            drafts = _ngram_propose(hist, plen + n_emit, k, ngram, pad_id)
        # ---- verify [tok, d1..dk] ----
        seq = torch.cat([tok[:, None], drafts], 1)           # [B, k + 1]
        cache.length = row_len
        logits = llama.forward(
            params, cfg, input_ids=seq, dtype=dtype,
            attention_mask=full_mask,
            positions=(prompt_len + n_emit - 1)[:, None] + steps,
            kv_cache=cache, decode_rows=True, tp=tp)
        t = logits.argmax(-1)                                # [B, k + 1]
        # ---- accept the longest confirmed prefix; stop at EOS / budget ----
        accepted = torch.cumprod((drafts == t[:, :k]).to(torch.int64),
                                 1).sum(1)
        eos_before = torch.cat(
            [torch.zeros((b, 1), dtype=torch.bool, device=device),
             torch.cumsum((t[:, :k] == eos_id).to(torch.int64), 1) > 0], 1)
        at = n_emit[:, None] + steps
        vi = ((steps <= accepted[:, None]) & ~eos_before
              & (at < max_new_tokens) & ~finished[:, None])
        nv = vi.sum(1)
        out.scatter_(1, torch.where(vi, at, max_new_tokens), t)
        n_emit = n_emit + nv
        last = t[rows, torch.clamp(nv - 1, min=0)]
        tok = torch.where(finished, tok, last)
        finished = (finished | (vi & (t == eos_id)).any(1)
                    | (n_emit >= max_new_tokens))
        row_len = row_len + nv
        rounds += 1
    return GenerateResult(tokens=out[:, :max_new_tokens], num_steps=rounds)
