"""LLaMA decoder (counterpart of ``macaw_llm_tpu/models/llama.py``).

Parameters keep the reference package's layout: layers stacked on a
leading [L] axis (the JAX ``lax.scan`` becomes a Python loop over L),
[in, out] weights, optional int8 records and the packed decode layout
(``utils.quantize``). Two paths through ``forward_hidden``:

* no cache (prefill): with ``use_flash`` the attention goes to the
  ``mh_attention`` kernel when the whole sequence fits its shared memory,
  else to the causal ``flash_attention`` kernel; with a ``ring_mesh`` the
  sequence is cut over its ``ring_axis`` and the attention is
  ``parallel.ring_attention`` (no padding bias: long-context training
  packs its sequences);
* cache: a preallocated ``KVCache`` (bf16, or int8 with per-position
  per-head scales) written in place at ``length``, one scalar for the
  batch or one entry per row (continuous batching: every slot has its own
  sequence length), attention through ``dot_product_attention`` or
  ``dot_product_attention_quant`` over the whole buffer with a causal +
  padding mask.

Training: LoRA adapters on q and v (``params["layers"]["lora"]``), remat
per decoder layer (``models.remat``: policy "nothing" or "dots"), the shifted
cross-entropy ``clm_loss``, its chunked form ``clm_loss_chunked``, which
never holds the [B, S, V] fp32 logits, and ``clm_loss_aligned`` for targets
already shifted (the ring path's permuted sequence). Each loss takes a
``reduce_count``: the count of valid targets it divides by, summed over the
ranks that hold the rest of the batch. The attention kernels and int8
matmuls are differentiable in their activations. Under a tensor group
(``tp``) the stack trains Megatron-style (f before the cut column
products, g after the row products, ``parallel.tensor_parallel``), and
with ``shard_sequence`` sequence-parallel between layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from macaw_llm_tpu_torch.config import IGNORE_ID, LlamaConfig
from macaw_llm_tpu_torch.models import _tree
from macaw_llm_tpu_torch.models._tree import layer_fn, normal, num_layers
from macaw_llm_tpu_torch.models.remat import checkpointed
from macaw_llm_tpu_torch.ops.activations import silu
from macaw_llm_tpu_torch.ops.attention import (dot_product_attention,
                                               dot_product_attention_quant)
from macaw_llm_tpu_torch.ops.kernels.flash_attention import flash_attention
from macaw_llm_tpu_torch.ops.kernels.mh_attention import (fits_mh_attention,
                                                          mh_attention)
from macaw_llm_tpu_torch.ops.masks import (NEG_INF, causal_mask,
                                           combine_masks, padding_mask)
from macaw_llm_tpu_torch.ops.norms import rms_norm
from macaw_llm_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
from macaw_llm_tpu_torch.train.lora import lora_delta
from macaw_llm_tpu_torch.utils import quantize as qz


@dataclass
class KVCache:
    """Preallocated per-layer cache, k/v [L, B, S_max, N_kv, D]; ``length``
    positions are valid: an int for the whole batch, or an int tensor [B]
    with one length per row. ``forward_hidden`` writes into k/v (and the
    scales) in place and advances ``length``.

    dtype int8 stores the cache quantized, with symmetric
    per-position-per-head scales in ``k_scale``/``v_scale`` [L, B, S_max,
    N_kv] fp32: half the bytes of the decode attention read. The scales are
    applied outside the attention dots (``dot_product_attention_quant``)."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor] = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu",
               tp: Optional[tpar.TensorParallel] = None) -> "KVCache":
        """Zeros for ``batch`` rows of ``max_len`` positions; under a
        tensor group that cuts the attention, this rank's kv heads."""
        heads = tpar.local(tpar.on(tp, "llm_attn"), cfg.kv_heads)
        shape = (cfg.num_layers, batch, max_len, heads, cfg.head_dim)
        if dtype == "int8":
            dtype = torch.int8
        cache = cls(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
        if dtype == torch.int8:
            cache.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=device)
            cache.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=device)
        return cache


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], fp32 scale [...]): symmetric per-vector
    int8 over the head dim, the contracted axis of both attention dots."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-20)[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def init_params(gen: torch.Generator, cfg: LlamaConfig,
                dtype=torch.float32) -> dict:
    """Random init (normal(initializer_range))."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.padded_vocab
    nkv = cfg.kv_heads * cfg.head_dim
    L = cfg.num_layers

    def rnd(*shape):
        return normal(gen, shape, cfg.initializer_range, dtype)

    def ones(*shape):
        return _tree.ones(gen, shape, dtype)

    return {
        "embed_tokens": rnd(v, h),
        "layers": {
            "attn": {"wq": rnd(L, h, h), "wk": rnd(L, h, nkv),
                     "wv": rnd(L, h, nkv), "wo": rnd(L, h, h)},
            "mlp": {"gate": rnd(L, h, i), "up": rnd(L, h, i),
                    "down": rnd(L, i, h)},
            "input_norm": ones(L, h),
            "post_norm": ones(L, h),
        },
        "norm": ones(h),
        "lm_head": rnd(h, v),
    }


def _attention(cfg: LlamaConfig, p: dict, h: torch.Tensor,
               mask: Optional[torch.Tensor], cos, sin,
               cache: Optional[KVCache], write_at, li: int,
               flash_bias: Optional[torch.Tensor], use_flash: bool,
               activation_quant: bool, lora: Optional[dict] = None,
               lora_scale: float = 1.0,
               decode_rows: bool = False, ring=None,
               tp: Optional[tpar.TensorParallel] = None,
               lora_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention of one layer; under ``tp`` (the attention is cut)
    this rank's heads, their partial output summed over the ranks (or
    reduce-scattered over the sequence under ``tp.sequence``). ``h`` is
    the input of the q/k/v products (``_module_input``), ``lora_x`` that
    of the LoRA branch (default ``h``)."""
    b, s, _ = h.shape
    n, nkv = tpar.local(tp, cfg.num_heads), tpar.local(tp, cfg.kv_heads)
    d = cfg.head_dim
    compute = h.dtype
    mm = lambda x, w, row=None: qz.matmul(  # noqa: E731
        x, w, compute, activation_quant=activation_quant,
        decode_rows=decode_rows, tp=row)
    if "qkv" in p:  # packed decode layout
        if lora is not None:
            raise ValueError("the packed qkv layout takes no LoRA adapters")
        fused = mm(h, p["qkv"])
        q2 = fused[..., :n * d]
        k2 = fused[..., n * d:(n + nkv) * d]
        v2 = fused[..., (n + nkv) * d:]
    else:
        q2, k2, v2 = mm(h, p["wq"]), mm(h, p["wk"]), mm(h, p["wv"])
    if lora is not None:
        lx = h if lora_x is None else lora_x
        q2 = q2 + lora_delta(lx, lora["qa"], lora["qb"], lora_scale, tp, s)
        v2 = v2 + lora_delta(lx, lora["va"], lora["vb"], lora_scale, tp, s)
    q = q2.reshape(b, s, n, d)
    k = k2.reshape(b, s, nkv, d)
    v = v2.reshape(b, s, nkv, d)
    q, k = apply_rope(q, k, cos, sin)

    quant = cache is not None and cache.k_scale is not None
    k_sc = v_sc = None
    if cache is not None:
        # write_at: a slice of positions (one length for the batch) or a
        # (rows, positions) index pair (one length per row)
        at = (li, slice(None), write_at) if isinstance(write_at, slice) \
            else (li,) + write_at
        if quant:
            kw, ks = _quant_kv(k)
            vw, vs = _quant_kv(v)
            if not isinstance(write_at, slice) and s == 1:
                ks, vs = ks[:, 0], vs[:, 0]
            cache.k_scale[at] = ks
            cache.v_scale[at] = vs
        else:
            kw, vw = k.to(cache.k.dtype), v.to(cache.v.dtype)
        if not isinstance(write_at, slice) and s == 1:
            kw, vw = kw[:, 0], vw[:, 0]
        cache.k[at] = kw
        cache.v[at] = vw
        if quant:  # int8 operands, converted inside the attention
            k_full, v_full = cache.k[li], cache.v[li]
            k_sc, v_sc = cache.k_scale[li], cache.v_scale[li]
        else:
            k_full, v_full = cache.k[li].to(compute), cache.v[li].to(compute)
    else:
        k_full, v_full = k, v
    if nkv != n:
        k_full = k_full.repeat_interleave(n // nkv, dim=2)
        v_full = v_full.repeat_interleave(n // nkv, dim=2)
        if quant:
            k_sc = k_sc.repeat_interleave(n // nkv, dim=2)
            v_sc = v_sc.repeat_interleave(n // nkv, dim=2)

    if ring is not None and cache is None:
        from macaw_llm_tpu_torch.parallel.ring_attention import \
            ring_attention
        mesh, axis, layout = ring
        out = ring_attention(q, k_full, v_full, mesh=mesh, axis=axis,
                             layout=layout)
    elif use_flash and cache is None:
        q, k_full, v_full = (t.contiguous() for t in (q, k_full, v_full))
        if fits_mh_attention(s, k_full.shape[1], d):
            out = mh_attention(q, k_full, v_full, flash_bias, causal=True)
        else:
            out = flash_attention(q, k_full, v_full, flash_bias, causal=True)
    elif quant:
        out = dot_product_attention_quant(q, k_full, v_full, k_sc, v_sc, mask)
    else:
        out = dot_product_attention(q, k_full, v_full, mask)
    return mm(out.reshape(b, s, n * d), p["wo"], tp)


def _mlp(p: dict, h: torch.Tensor, activation_quant: bool,
         decode_rows: bool = False,
         tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x)); under ``tp`` (the MLP is cut)
    this rank's FFN columns, the partial output summed over the ranks."""
    c = h.dtype
    mm = lambda x, w, row=None: qz.matmul(  # noqa: E731
        x, w, c, activation_quant=activation_quant,
        decode_rows=decode_rows, tp=row)
    if "gateup" in p:  # packed decode layout
        gu = mm(h, p["gateup"])
        i = gu.shape[-1] // 2
        return mm(silu(gu[..., :i]) * gu[..., i:], p["down"], tp)
    return mm(silu(mm(h, p["gate"])) * mm(h, p["up"]), p["down"], tp)


def _module_input(tp: Optional[tpar.TensorParallel],
                  mtp: Optional[tpar.TensorParallel], x: torch.Tensor,
                  s: int) -> torch.Tensor:
    """The input of a layer's attention or MLP: ``x`` through Megatron's f
    where the module is cut (``mtp``); under sequence parallelism the whole
    sequence of ``s`` positions from this rank's block."""
    if tp is not None and tp.sequence:
        return tpar.gather_sequence(tp, x, s, cut=mtp is not None)
    return tpar.copy(mtp, x)


def _module_output(tp: Optional[tpar.TensorParallel],
                   mtp: Optional[tpar.TensorParallel],
                   y: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism a whole module's output becomes this
    rank's block (a cut module's row product reduce-scattered it)."""
    if tp is not None and tp.sequence and mtp is None:
        return tpar.split_sequence(tp, y)
    return y


def _decoder_layer(cfg: LlamaConfig, lp: dict, h: torch.Tensor, mask, cos,
                   sin, kv_cache: Optional[KVCache], write_at, li: int,
                   flash_bias,
                   use_flash: bool, activation_quant: bool,
                   lora_scale: float, decode_rows: bool = False, ring=None,
                   tp: Optional[tpar.TensorParallel] = None,
                   seq_len: Optional[int] = None) -> torch.Tensor:
    """Pre-norm attention + residual, pre-norm SwiGLU + residual. Under a
    sequence-parallel ``tp`` h is this rank's block of the ``seq_len``
    positions, and so are the norms' rows."""
    atp, mtp = tpar.on(tp, "llm_attn"), tpar.on(tp, "llm_mlp")
    x = rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
    xa = _module_input(tp, atp, x, seq_len)
    h = h + _module_output(tp, atp, _attention(
        cfg, lp["attn"], xa, mask, cos, sin, kv_cache, write_at, li,
        flash_bias, use_flash, activation_quant, lp.get("lora"), lora_scale,
        decode_rows, ring, atp, lora_x=x if atp is not None else xa))
    x = rms_norm(h, lp["post_norm"], cfg.rms_norm_eps)
    return h + _module_output(tp, mtp, _mlp(
        lp["mlp"], _module_input(tp, mtp, x, seq_len), activation_quant,
        decode_rows, mtp))


def embed(params: dict, input_ids: torch.Tensor,
          dtype=torch.float32,
          tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """Token embedding lookup ([B, S] -> [B, S, H]). ``F.embedding`` and
    not ``table[ids]``: on the CPU the backward of advanced indexing
    accumulates repeated ids in a varying order, so a resumed run would not
    reproduce an uninterrupted one bit for bit. Under a ``tp`` that cuts
    the vocab, the vocab-parallel lookup (``tensor_parallel.embed``)."""
    return tpar.embed(tpar.on(tp, "vocab"), params["embed_tokens"].to(dtype),
                      input_ids)


def forward_hidden(params: dict, cfg: LlamaConfig,
                   inputs_embeds: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   kv_cache: Optional[KVCache] = None,
                   use_flash: bool = False,
                   activation_quant: bool = False,
                   remat=False,
                   lora_scale: float = 1.0,
                   decode_rows: bool = False,
                   ring_mesh=None, ring_axis: str = "tensor",
                   ring_layout: str = "zigzag",
                   tp: Optional[tpar.TensorParallel] = None,
                   shard_sequence: bool = False) -> torch.Tensor:
    """Decoder stack over ``inputs_embeds`` [B, S, H] -> final-normed hidden
    states [B, S, H].

    attention_mask: [B, S_total] {0, 1} over the full key length (the
    cache length when a cache is given). positions: [B, S] RoPE positions,
    by default continuing from the cache length. With a per-row
    ``kv_cache.length`` [B], query i of row r sits at position length[r] +
    i, is written there (a position past the buffer, which only a slot
    that has already finished can reach, is written to the last one
    instead, where no live query looks) and sees the keys up to there.
    ``activation_quant``
    turns on W8A8 for int8 weights at >= 256 rows. ``remat`` (False, True
    or a policy of ``models.remat``) checkpoints each decoder layer
    (training without a cache): the backward recomputes the layer, int8
    dequantization included, and keeps its input ("nothing") or its input
    and its matmul outputs ("dots"). ``decode_rows`` marks every position
    as decode-shaped (the speculative verify): int8 projections of at most
    32 rows in all take the matvec kernels. ``ring_mesh`` (no cache):
    ``inputs_embeds`` is this rank's chunk of a sequence cut over the mesh
    axis ``ring_axis`` in the ``ring_layout`` order, ``positions`` its
    original indices, and the attention is ring attention (no padding
    bias; ``attention_mask`` is refused). ``tp``: this rank's block of a
    tensor-parallel tree (``parallel.tensor_parallel``; the cache holds
    its heads); the hidden states are every rank's, whole.
    ``shard_sequence`` under a ``tp`` of 2 or more ranks, without a cache
    or a ring: sequence parallelism, the residual stream between layers
    this rank's block of the sequence (padded to a multiple of the
    ranks); the numbers are those without it.
    """
    if remat and kv_cache is not None:
        raise ValueError("remat is for the no-cache (training) path")
    ring = None
    if ring_mesh is not None and kv_cache is None:
        if attention_mask is not None:
            raise ValueError("ring attention takes no attention_mask (pack "
                             "the sequences instead of padding)")
        ring = (ring_mesh, ring_axis, ring_layout)
        use_flash = False
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    mask = None
    flash_bias = None
    write_at = None
    if kv_cache is not None:
        start = kv_cache.length
        kv_len = kv_cache.k.shape[2]
        steps = torch.arange(s, device=device)
        k_pos = torch.arange(kv_len, device=device)
        if torch.is_tensor(start) and start.dim() == 1:
            q_pos = start[:, None] + steps[None, :]                # [B, s]
            if positions is None:
                positions = q_pos
            mask = torch.where(k_pos[None, None, :] <= q_pos[:, :, None],
                               0.0, NEG_INF).float()[:, None]  # [B, 1, s, kv]
            rows = torch.arange(b, device=device)
            cols = torch.clamp(q_pos, max=kv_len - 1)
            write_at = (rows, cols[:, 0]) if s == 1 else (rows[:, None], cols)
        else:
            start = int(start)
            if positions is None:
                positions = start + steps[None, :]
            mask = torch.where(k_pos[None, :] <= start + steps[:, None], 0.0,
                               NEG_INF).float()[None, None]
            write_at = slice(start, start + s)
        if attention_mask is not None:
            mask = combine_masks(mask, padding_mask(attention_mask, s))
    else:
        if positions is None:
            positions = torch.arange(s, device=device)[None, :].expand(b, s)
        if use_flash:
            # the kernels apply the causal mask and this padding bias
            if attention_mask is not None:
                flash_bias = torch.where(attention_mask.to(torch.int32) == 1,
                                         0.0, NEG_INF).float().contiguous()
        elif ring is None:
            mask = causal_mask(s, s, device)
            if attention_mask is not None:
                mask = combine_masks(mask, padding_mask(attention_mask, s))

    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    use_kernel = use_flash and kv_cache is None
    stp = tpar.sequence_parallel(tp) if shard_sequence and \
        kv_cache is None and ring is None else None
    h = inputs_embeds
    if stp is not None:
        tp = stp
        h = tpar.split_sequence(tp, h)
    layers = params["layers"]
    for li in range(num_layers(layers)):
        args = (mask, cos, sin, kv_cache, write_at, li, flash_bias,
                use_kernel, activation_quant, lora_scale, decode_rows, ring,
                tp, s)
        h = checkpointed(layer_fn(partial(_decoder_layer, cfg), layers, li),
                         remat, h, *args)
    if kv_cache is not None:
        kv_cache.length = kv_cache.length + s
    h = rms_norm(h, params["norm"].to(h.dtype), cfg.rms_norm_eps)
    if stp is not None:
        h = tpar.gather(stp, h, 1)[:, :s]
    return h


def logits_from_hidden(params: dict, h: torch.Tensor,
                       valid: Optional[int] = None,
                       decode_rows: bool = False,
                       tp: Optional[tpar.TensorParallel] = None
                       ) -> torch.Tensor:
    """CLM head, fp32 logits; ``valid`` masks padded vocab columns. Under
    a ``tp`` that cuts the vocab, each rank's columns are all-gathered
    first."""
    vtp = tpar.on(tp, "vocab")
    logits = qz.matmul(tpar.copy(vtp, h), params["lm_head"], h.dtype,
                       decode_rows=decode_rows)
    if vtp is not None:
        logits = tpar.gather(vtp, logits, -1)
    return _mask_padded_vocab(logits.float(), valid)


def _mask_padded_vocab(logits: torch.Tensor,
                       valid: Optional[int]) -> torch.Tensor:
    if valid is None or valid >= logits.shape[-1]:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < valid, logits, NEG_INF)


def valid_vocab(cfg: LlamaConfig) -> Optional[int]:
    """The real vocab size when the storage vocab is padded, else None."""
    return cfg.vocab_size if cfg.padded_vocab > cfg.vocab_size else None


def forward(params: dict, cfg: LlamaConfig,
            input_ids: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[KVCache] = None,
            use_flash: bool = False,
            activation_quant: bool = False,
            dtype=torch.float32,
            remat=False,
            lora_scale: float = 1.0,
            decode_rows: bool = False,
            ring_mesh=None, ring_axis: str = "tensor",
            ring_layout: str = "zigzag",
            tp: Optional[tpar.TensorParallel] = None,
            shard_sequence: bool = False) -> torch.Tensor:
    """Full CLM forward -> logits [B, S, V] fp32. Takes token ids or
    embeddings, never both."""
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("pass exactly one of input_ids / inputs_embeds")
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids, dtype, tp)
    h = forward_hidden(params, cfg, inputs_embeds, attention_mask, positions,
                       kv_cache, use_flash, activation_quant, remat,
                       lora_scale, decode_rows, ring_mesh, ring_axis,
                       ring_layout, tp, shard_sequence)
    return logits_from_hidden(params, h, valid_vocab(cfg), decode_rows, tp)


def _nll(logits: torch.Tensor, targets: torch.Tensor):
    """Summed negative log-likelihood of the targets that are not
    IGNORE_ID, and their count."""
    ok = targets != IGNORE_ID
    safe = torch.where(ok, targets, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(ok, nll, 0.0).sum(), ok.sum()


def _mean(nll: torch.Tensor, count: torch.Tensor,
          reduce_count=None) -> torch.Tensor:
    """nll / count, the count first summed over the ranks that share the
    batch (``reduce_count``, when given): the global mean over valid
    targets."""
    if reduce_count is not None:
        count = reduce_count(count)
    return nll / torch.clamp(count, min=1)


def clm_loss(logits: torch.Tensor, labels: torch.Tensor,
             reduce_count=None) -> torch.Tensor:
    """Shift-by-one cross-entropy, mean over the labels that are not
    IGNORE_ID (-100)."""
    nll, count = _nll(logits[:, :-1, :], labels[:, 1:])
    return _mean(nll, count, reduce_count)


def clm_loss_aligned(logits: torch.Tensor, targets: torch.Tensor,
                     reduce_count=None) -> torch.Tensor:
    """Position-aligned cross-entropy: ``targets[:, i]`` is the token the
    logits at position i predict (IGNORE_ID elsewhere): ``clm_loss`` after
    the caller has shifted the labels, for layouts whose positions are
    permuted (the ring's zig-zag), where a shift inside the loss would be
    wrong."""
    nll, count = _nll(logits, targets)
    return _mean(nll, count, reduce_count)


def _chunk_nll(w, valid: Optional[int], vtp, h_c: torch.Tensor,
               t_c: torch.Tensor):
    logits = qz.matmul(tpar.copy(vtp, h_c), w, h_c.dtype)
    if vtp is not None:
        logits = tpar.gather(vtp, logits, -1)
    return _nll(_mask_padded_vocab(logits.float(), valid), t_c)


def clm_loss_chunked(params: dict, h: torch.Tensor, labels: torch.Tensor,
                     chunk: int = 1024, valid: Optional[int] = None,
                     targets_aligned: bool = False,
                     reduce_count=None,
                     tp: Optional[tpar.TensorParallel] = None
                     ) -> torch.Tensor:
    """``clm_loss(logits_from_hidden(params, h), labels)`` straight from the
    final hidden states, ``chunk`` positions at a time: each chunk's fp32
    logits exist only inside its checkpointed function (recomputed in the
    backward), never the whole [B, S, V]. ``targets_aligned``: the labels
    are already the next-token targets of their positions
    (``clm_loss_aligned``). Under a ``tp`` that cuts the vocab each
    chunk's logits are this rank's columns, all-gathered."""
    b = h.shape[0]
    if targets_aligned:
        targets = labels
    else:
        targets = torch.cat([labels[:, 1:],
                             labels.new_full((b, 1), IGNORE_ID)], dim=1)
    fn = partial(_chunk_nll, params["lm_head"], valid, tpar.on(tp, "vocab"))
    nll_sum, count = 0.0, 0
    for start in range(0, h.shape[1], chunk):
        nll, cnt = checkpoint(fn, h[:, start:start + chunk],
                              targets[:, start:start + chunk],
                              use_reentrant=False)
        nll_sum, count = nll_sum + nll, count + cnt
    return _mean(nll_sum, count, reduce_count)
