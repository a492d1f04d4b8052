"""Attention ops (counterpart of ``macaw_llm_tpu/ops/attention.py``).

* ``dot_product_attention``: the materialized einsum core, fp32 logits and
  softmax, additive mask clamped at float32 min (a fully masked row gets
  uniform probabilities). Used for the cached decode attention and the
  towers' short sequences.
* ``dot_product_attention_quant``: the same core over an int8 K/V cache,
  the K scale applied to the logits and the V scale to the probabilities.
* ``mha_apply`` / ``pack_mha``: CLIP / Whisper multi-head attention with
  per-projection or packed q/k/v weights; long unmasked sequences go to the
  flash kernel.
* ``torch_mha_apply`` and the ``shared_kv`` variants: the semantics of
  torch.nn.MultiheadAttention with ``add_bias_kv`` and ``add_zero_attn``
  (the alignment and video-long attentions); with a dropout generator
  (training) the attention goes through ``dropout_attention_chunked``.

All apply functions are batch-first: [B, S, E]. Under a tensor group
that cuts them (``tp``, ``parallel.tensor_parallel``) ``mha_apply`` and
the alignment's shared-K/V paths (cached, memory-projecting, and the
dropout one of training) run this rank's heads: its q/k/v columns (and
bias_k/bias_v), its rows of the out-projection, whose partials are summed
over the ranks before its bias is added once. ``mha_init`` and
``torch_mha_init`` draw the two layouts' weights.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from macaw_llm_tpu_torch.models._tree import normal, uniform, zeros
from macaw_llm_tpu_torch.ops.kernels.flash_attention import flash_attention
from macaw_llm_tpu_torch.ops.linear import dense
from macaw_llm_tpu_torch.ops.masks import NEG_INF
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
from macaw_llm_tpu_torch.utils import quantize as qz


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, N, D], k/v [B, Sk, N, D]; mask additive fp32
    [B or 1, 1 or N, Sq, Sk] or None. Returns [B, Sq, N, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(),
                          k.to(q.dtype).float()) * scale
    if mask is not None:
        logits = torch.clamp(logits + mask, min=NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.to(q.dtype))


def dot_product_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                                v_q: torch.Tensor, k_s: torch.Tensor,
                                v_s: torch.Tensor,
                                mask: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Attention over an int8-quantized K/V cache (the decode path).

    q [B, Sq, N, D] float; k_q/v_q [B, Sk, N, D] int8 (or already
    converted: integers <= 127 are exact in bf16); k_s/v_s [B, Sk, N] fp32
    per-position-per-head scales. Each scale is constant along the
    contracted D axis, so it commutes with its dot exactly: K's scale
    multiplies the logits, V's folds into the probabilities."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k_q.float()) * scale
    logits = logits * k_s.permute(0, 2, 1)[:, :, None, :]
    if mask is not None:
        logits = torch.clamp(logits + mask, min=NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = (probs * v_s.permute(0, 2, 1)[:, :, None, :]).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v_q.to(q.dtype))


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal, unmasked flash attention for encoder self/cross
    attention, q/k/v [B, S, N, D]. The kernel takes head dims 64, 128 and
    256 as they are (no padding of D)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           None, causal=False, scale=scale)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, n, d = x.shape
    return x.reshape(b, s, n * d)


def _on(device, x: torch.Tensor) -> torch.Tensor:
    return x if device is None else x.to(device)


def mha_init(gen: torch.Generator, embed_dim: int, num_heads: int, *,
             bias: bool = True, initializer_range: float = 0.02,
             dtype=torch.float32, device=None) -> dict:
    """A CLIP/Whisper attention's weights (``mha_apply``): q/k/v/o [E, E]
    [in, out] weights drawn from normal(initializer_range) in that order
    by ``gen`` (on its device), zero [E] biases; on ``device`` (default:
    the generator's)."""
    e = embed_dim
    params = {name: {"w": _on(device, normal(gen, (e, e), initializer_range,
                                             dtype))}
              for name in ("q", "k", "v", "o")}
    if bias:
        for p in params.values():
            p["b"] = _on(device, zeros(gen, (e,), dtype))
    return params


def torch_mha_init(gen: torch.Generator, embed_dim: int, num_heads: int, *,
                   add_bias_kv: bool = True, dtype=torch.float32,
                   device=None) -> dict:
    """torch.nn.MultiheadAttention's weights (``torch_mha_apply``):
    xavier-uniform in_proj [3E, E], uniform(sqrt(3 / E)) out_proj [E, E],
    zero biases and, with ``add_bias_kv``, xavier-normal bias_k/bias_v
    [E], drawn in that order by ``gen``; on ``device`` (default: the
    generator's)."""
    e = embed_dim
    params = {
        "in_proj_w": uniform(gen, (3 * e, e), math.sqrt(6.0 / (4 * e)),
                             dtype),
        "in_proj_b": zeros(gen, (3 * e,), dtype),
        "out_proj_w": uniform(gen, (e, e), math.sqrt(3.0 / e), dtype),
        "out_proj_b": zeros(gen, (e,), dtype),
    }
    if add_bias_kv:
        std = math.sqrt(2.0 / (1 + e))
        params["bias_k"] = normal(gen, (e,), std, dtype)
        params["bias_v"] = normal(gen, (e,), std, dtype)
    return {k: _on(device, v) for k, v in params.items()}


def pack_mha(params: dict) -> dict:
    """Inference layout: one [E, 3E] (stacked [L, E, 3E]) in-projection
    for q/k/v (plain weights or int8 records, whose per-column scales
    concatenate the same way). Idempotent: an already packed tree comes
    back as it is. On a rank's block (``tensor_parallel.tp_params``) it
    packs [its q | its k | its v]."""
    if "qkv" in params:
        return params
    q, k, v = params["q"], params["k"], params["v"]
    packed = {"w": qz.cat_columns(q["w"], k["w"], v["w"])}
    if "b" in q:
        packed["b"] = torch.cat([q["b"], k["b"], v["b"]], dim=-1)
    return {"qkv": packed, "o": params["o"]}


def mha_apply(params: dict, num_heads: int, q_in: torch.Tensor,
              kv_in: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              use_flash: bool = False,
              activation_quant: bool = False,
              tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """Self- or cross-attention with per-projection weights, [B, S, E]
    in/out. use_flash sends unmasked attention over >= 1024 keys (Whisper's
    1500 frames) to the flash kernel; shorter sequences (CLIP's 197
    tokens) stay on the einsum path, as in the reference package.
    ``activation_quant``: W8A8 for int8 projection records. ``tp``: the
    weights are this rank's block of ``num_heads`` heads."""
    def _proj(p: dict, x: torch.Tensor) -> torch.Tensor:
        return dense(x, p["w"], p.get("b"), activation_quant)

    n = tpar.local(tp, num_heads)
    if "qkv" in params:
        if kv_in is not None and kv_in is not q_in:
            raise ValueError("packed qkv layout is self-attention only")
        y = _proj(params["qkv"], q_in)
        e = y.shape[-1] // 3
        q = _split_heads(y[..., :e], n)
        k = _split_heads(y[..., e:2 * e], n)
        v = _split_heads(y[..., 2 * e:], n)
    else:
        if kv_in is None:
            kv_in = q_in
        q = _split_heads(_proj(params["q"], q_in), n)
        k = _split_heads(_proj(params["k"], kv_in), n)
        v = _split_heads(_proj(params["v"], kv_in), n)
    if use_flash and mask is None and k.shape[1] >= 1024:
        out = flash_sdpa(q, k, v)
    else:
        out = dot_product_attention(q, k, v, mask)
    o = params["o"]
    return dense(_merge_heads(out), o["w"], o.get("b"), activation_quant, tp)


# (first row, rows of the whole batch) of this process's batch rows, set by
# a trainer that cuts the batch over a mesh (``batch_rows``)
_BATCH_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(first: int, total: int):
    """Within it, the dropout masks are drawn for the whole batch of
    ``total`` rows and this process keeps its rows ``first:first + B``: the
    masks of one device whatever the mesh."""
    token = _BATCH_ROWS.set((first, total))
    try:
        yield
    finally:
        _BATCH_ROWS.reset(token)


def dropout_seed(rng: torch.Generator) -> int:
    """One 63-bit seed from a (CPU) generator: the base of an attention's
    per-chunk dropout masks."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng))


def _dropout_keep(seed: int, start: int, shape, rate: float,
                  device) -> torch.Tensor:
    """Keep-mask of the key chunk starting at ``start``: a function of
    (seed, start) alone, so the backward's recompute draws the same mask."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + start) % (2 ** 63))
    return torch.rand(shape, generator=gen, device=device) >= rate


def _dropout_chunk(q, k_c, v_c, scale: float, rate: float, seed: int,
                   start: int, shared: bool, rows=None, heads=None):
    acc = torch.promote_types(q.dtype, torch.float32)
    eq = "bqnd,knd->bnqk" if shared else "bqnd,bknd->bnqk"
    logits = torch.einsum(eq, q.to(acc), k_c.to(acc)) * scale
    m = logits.amax(-1)                                    # [B, N, Sq]
    p = torch.exp(logits - m[..., None])
    # rows, heads: (first, total) of this process's batch rows and heads:
    # the whole batch's and heads' mask, this process's block of it
    b, n = p.shape[:2]
    first_b, total_b = rows or (0, b)
    first_n, total_n = heads or (0, n)
    keep = _dropout_keep(seed, start, (total_b, total_n) + tuple(p.shape[2:]),
                         rate, p.device)[first_b:first_b + b,
                                         first_n:first_n + n]
    pd = torch.where(keep, p, 0.0).to(v_c.dtype).to(acc)
    part = torch.einsum("bnqk,knd->bnqd" if shared else "bnqk,bknd->bnqd",
                        pd, v_c.to(acc))
    return m, p.sum(-1), part


def dropout_attention_chunked(qh: torch.Tensor, kh: torch.Tensor,
                              vh: torch.Tensor, *, scale: float, rate: float,
                              rng: torch.Generator,
                              chunk: int = 0,
                              heads: Optional[tuple] = None) -> torch.Tensor:
    """Attention-probability dropout without the [.., Sq, Sk] probs.

    Streams K/V in chunks with an online softmax. ``dropout(softmax(s)) V``
    commutes with the online normalization because the mask scales the
    numerator terms only: the DROPPED unnormalized probs go against V and
    the UNDROPPED row sums into the denominator, divided at the end. Each
    chunk is checkpointed; its mask is a function of (seed, chunk start)
    drawn again in the backward, so peak memory is one chunk's fp32 logits.

    qh [B, Sq, N, D]; kh/vh [B, Sk, N, D], or [Sk, N, D] for a batch-shared
    memory; ``rng`` a CPU generator that gives the seed. Returns
    [B, Sq, N, D] in qh.dtype. chunk=0 picks ~64 MB logits chunks.
    ``heads`` (first, total): qh holds heads first..first + N of ``total``
    (a tensor-parallel rank's), whose masks are those of one device.
    """
    shared = kh.dim() == 3
    b, sq, n, d = qh.shape
    sk = kh.shape[0] if shared else kh.shape[1]
    if chunk <= 0:
        whole = n if heads is None else heads[1]
        chunk = max(128, (64 * 2 ** 20) // max(b * whole * sq * 4, 1))
        chunk = min(sk, ((chunk + 127) // 128) * 128)
    seed = dropout_seed(rng)
    rows = _BATCH_ROWS.get()
    acc = torch.promote_types(qh.dtype, torch.float32)
    m_run = torch.full((b, n, sq), NEG_INF, dtype=acc, device=qh.device)
    l_run = torch.zeros((b, n, sq), dtype=acc, device=qh.device)
    out = torch.zeros((b, n, sq, d), dtype=acc, device=qh.device)
    for start in range(0, sk, chunk):
        if shared:
            k_c, v_c = kh[start:start + chunk], vh[start:start + chunk]
        else:
            k_c, v_c = kh[:, start:start + chunk], vh[:, start:start + chunk]
        m_c, l_c, part = checkpoint(_dropout_chunk, qh, k_c, v_c, scale,
                                    rate, seed, start, shared, rows, heads,
                                    use_reentrant=False)
        m_new = torch.maximum(m_run, m_c)
        corr_run = torch.exp(m_run - m_new)
        corr_c = torch.exp(m_c - m_new)
        out = out * corr_run[..., None] + part * corr_c[..., None]
        l_run = l_run * corr_run + l_c * corr_c
        m_run = m_new
    out = out / (torch.clamp(l_run, min=1e-20)[..., None] * (1.0 - rate))
    return out.permute(0, 2, 1, 3).to(qh.dtype)


def _in_proj(params: dict, dtype: torch.dtype):
    return params["in_proj_w"].to(dtype), params["in_proj_b"].to(dtype)


def _out_proj(params: dict, out: torch.Tensor,
              tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    y = tpar.row_mm(tp, out, params["out_proj_w"].to(out.dtype).T)
    return y + params["out_proj_b"].to(out.dtype)


def torch_mha_apply(params: dict, num_heads: int, query: torch.Tensor,
                    key: torch.Tensor, value: torch.Tensor, *,
                    add_zero_attn: bool = True,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[torch.Generator] = None,
                    use_flash: bool = False) -> torch.Tensor:
    """torch.nn.MultiheadAttention forward (batch-first): packed
    in-projection, the bias_k/bias_v row and the zero row appended to the
    keys/values, softmax attention (with attention dropout when a
    ``dropout_rng`` is given), out-projection."""
    e = query.shape[-1]
    w, b = _in_proj(params, query.dtype)
    q = query @ w[:e].T + b[:e]
    k = key @ w[e:2 * e].T + b[e:2 * e]
    v = value @ w[2 * e:].T + b[2 * e:]
    bsz = q.shape[0]
    if "bias_k" in params:
        k = torch.cat([k, params["bias_k"].to(k.dtype).expand(bsz, 1, e)], 1)
        v = torch.cat([v, params["bias_v"].to(v.dtype).expand(bsz, 1, e)], 1)
    if add_zero_attn:
        zeros = k.new_zeros((bsz, 1, e))
        k = torch.cat([k, zeros], 1)
        v = torch.cat([v, zeros], 1)
    qh = _split_heads(q, num_heads)
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    scale = (e // num_heads) ** -0.5
    if dropout_rate > 0.0 and dropout_rng is not None:
        out = dropout_attention_chunked(qh, kh, vh, scale=scale,
                                        rate=dropout_rate, rng=dropout_rng)
    elif use_flash:
        out = flash_sdpa(qh, kh, vh, scale=scale)
    else:
        logits = torch.einsum("bqnd,bknd->bnqk", qh.float(),
                              kh.float()) * scale
        probs = torch.softmax(logits, dim=-1).to(query.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, vh)
    return _out_proj(params, _merge_heads(out))


def shared_kv_project(params: dict, memory: torch.Tensor, *,
                      add_zero_attn: bool = True):
    """Project a batch-shared K=V memory once: [M, E] -> ([M2, E], [M2, E])
    with the bias_k/bias_v row and the zero row appended. On a rank's
    block of the in-projection, its heads' columns [M2, E / t]."""
    w, b = _in_proj(params, memory.dtype)
    e = w.shape[0] // 3
    rows_k = [memory @ w[e:2 * e].T + b[e:2 * e]]
    rows_v = [memory @ w[2 * e:].T + b[2 * e:]]
    if "bias_k" in params:
        rows_k.append(params["bias_k"].to(memory.dtype)[None])
        rows_v.append(params["bias_v"].to(memory.dtype)[None])
    if add_zero_attn:
        zero = memory.new_zeros((1, e))
        rows_k.append(zero)
        rows_v.append(zero)
    return torch.cat(rows_k, 0), torch.cat(rows_v, 0)


def torch_mha_apply_shared_kv_dropout(params: dict, num_heads: int,
                                      query: torch.Tensor,
                                      memory: Optional[torch.Tensor], *,
                                      rate: float, rng: torch.Generator,
                                      add_zero_attn: bool = True,
                                      kv_cache: Optional[tuple] = None,
                                      tp: Optional[tpar.TensorParallel] = None
                                      ) -> torch.Tensor:
    """``torch_mha_apply`` with attention dropout for a batch-shared K = V
    memory [M, E], projected once (``shared_kv_project``) or taken from
    ``kv_cache``, a precomputed (k, v) [M2, E] pair that already holds the
    bias and zero rows (no gradient reaches the K/V weights through it).
    The attention streams the memory in chunks
    (``dropout_attention_chunked``). ``tp``: this rank's heads, with the
    dropout masks one device draws for them."""
    n, d, e = _local_heads(query, num_heads, tp)
    w, bias = _in_proj(params, query.dtype)
    q = query @ w[:e].T + bias[:e]
    if kv_cache is not None:
        k, v = (t.to(query.dtype) for t in kv_cache)
    else:
        k, v = shared_kv_project(params, memory, add_zero_attn=add_zero_attn)
    bsz, sq, _ = q.shape
    out = dropout_attention_chunked(
        q.reshape(bsz, sq, n, d), k.reshape(-1, n, d), v.reshape(-1, n, d),
        scale=d ** -0.5, rate=rate, rng=rng,
        heads=None if tp is None else (tp.rank * n, num_heads))
    return _out_proj(params, out.reshape(bsz, sq, e), tp)


def _local_heads(query: torch.Tensor, num_heads: int,
                 tp: Optional[tpar.TensorParallel]):
    """(heads, head dim, width) of this rank's share of ``num_heads``
    heads over the query width."""
    d = query.shape[-1] // num_heads
    n = tpar.local(tp, num_heads)
    return n, d, n * d


def torch_mha_apply_shared_kv_einsum(params: dict, num_heads: int,
                                     query: torch.Tensor,
                                     kv_cache: tuple,
                                     tp: Optional[tpar.TensorParallel] = None
                                     ) -> torch.Tensor:
    """Alignment attention over the cached (optionally int8) K/V rows.

    kv_cache: ((k, k_scale), (v, v_scale)); scale None for a plain cache,
    fp32 [M2, 1] per-row scales for int8. The int8 rows enter the dots as
    they are (|q| <= 127 is exact in bf16) and the per-row scales multiply
    the logits (K) and the probabilities (V) after the dots: exact, since
    each scale is constant along the contracted axis. ``tp``: this rank's
    heads (the cache holds their columns)."""
    n, d, e = _local_heads(query, num_heads, tp)
    b, sq, _ = query.shape
    (kq, ks), (vq, vs) = kv_cache
    m2 = kq.shape[0]
    w, bias = _in_proj(params, query.dtype)
    q = query @ w[:e].T + bias[:e]
    qh = q.reshape(b, sq, n, d)
    k8 = kq.reshape(m2, n, d).to(query.dtype)
    v8 = vq.reshape(m2, n, d).to(query.dtype)
    logits = torch.einsum("bqnd,knd->bnqk", qh.float(), k8.float()) \
        * (d ** -0.5)
    if ks is not None:
        logits = logits * ks[:, 0]
    probs = torch.softmax(logits, dim=-1)
    if vs is not None:
        probs = probs * vs[:, 0]
    out = torch.einsum("bnqk,knd->bqnd", probs.to(query.dtype), v8)
    return _out_proj(params, out.reshape(b, sq, e), tp)


def torch_mha_apply_shared_kv_flash(params: dict, num_heads: int,
                                    query: torch.Tensor,
                                    memory: Optional[torch.Tensor], *,
                                    add_zero_attn: bool = True,
                                    kv_cache: Optional[tuple] = None,
                                    tp: Optional[tpar.TensorParallel] = None
                                    ) -> torch.Tensor:
    """Alignment attention through the flash kernel. The batch-shared
    memory folds the whole attention into one non-causal call: heads
    become the batch axis and (batch x queries) the query sequence, so the
    kernel streams one long K/V sequence per head.

    kv_cache: optional precomputed (k, v) [M2, E] pair; otherwise the
    memory is projected here (``shared_kv_project``). ``tp``: this rank's
    heads."""
    num_heads, d, e = _local_heads(query, num_heads, tp)
    bsz, sq, _ = query.shape
    w, bias = _in_proj(params, query.dtype)
    q = query @ w[:e].T + bias[:e]
    if kv_cache is not None:
        k, v = (t.to(query.dtype) for t in kv_cache)
    else:
        k, v = shared_kv_project(params, memory, add_zero_attn=add_zero_attn)
    m2 = k.shape[0]
    qh = q.reshape(bsz, sq, num_heads, d).permute(2, 0, 1, 3) \
        .reshape(num_heads, bsz * sq, 1, d)
    kh = k.reshape(m2, num_heads, d).transpose(0, 1)[:, :, None, :]
    vh = v.reshape(m2, num_heads, d).transpose(0, 1)[:, :, None, :]
    out = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                          None, causal=False, scale=d ** -0.5)
    out = out.reshape(num_heads, bsz, sq, d).permute(1, 2, 0, 3) \
        .reshape(bsz, sq, e)
    return _out_proj(params, out, tp)
