"""Int8 quantization of the LLaMA weights and the encoder towers for
serving.

Counterpart of ``macaw_llm_tpu/utils/quantize.py``: symmetric
per-output-channel int8 records {"q": int8 [.., in, out], "s": fp32
[.., 1, out]}, the decode packing, and ``matmul`` with its three routes:

* single-row decode (x [B, 1, K]) -> a matvec kernel picked by the row
  count B: up to 8 rows ``matvec_int8`` (8 rows per block), 9 to 32 rows
  ``matvec_int8_pipelined`` (all rows against each weight tile, every
  weight byte read once); more than 32 rows raise. A caller whose
  positions are all decode-shaped (``decode_rows=True``: the speculative
  verify's [B, k + 1, K]) takes the same kernels over its B * (k + 1)
  flattened rows while they are at most 32;
* W8A8 (``activation_quant=True``, >= 256 rows): per-token int8
  activations x int8 weights through ``torch._int_mm``, both scales
  applied after the integer dot;
* otherwise weight-only int8: ``(x @ q) * s``.

The W8A8 and decode switches that the JAX package keeps as process-wide
setters (``set_activation_quant`` / ``set_decode_kernel``) are explicit
keyword flags of ``matmul`` here.

Under a tensor group (``tp``: a row-parallel weight's block of rows) the
ranks' partial products are summed over the group; W8A8's input takes the
whole row's per-token scale and the ranks' int32 dots are summed before
the scales, exactly: a rank computes one device's product bit for bit.

Both multi-row routes are differentiable in x; the int8 records never take
a gradient. The weight-only backward keeps only the int8 record and
dequantizes it again in the backward (one layer at a time inside the
decoder's loop), so no bf16 copy of a weight outlives its matmul. W8A8's
backward is the straight-through estimator of the reference package
(``_w8a8_dot``'s custom VJP): g @ (q * s)^T.
"""

from __future__ import annotations

from typing import Tuple

import torch

from macaw_llm_tpu_torch.ops.kernels.matvec import (matvec_int8,
                                                    matvec_int8_pipelined)
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
from macaw_llm_tpu_torch.utils.profiling import SPANS

QUANT_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
ACT_QUANT_MIN_ROWS = 256
MATVEC_MAX_ROWS = 8  # single-row calls above this go to the pipelined kernel
PIPELINED_MAX_ROWS = 32  # decode_rows calls above this keep the GEMM routes


def is_record(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_tensor(w: torch.Tensor, tp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with a per-output-channel fp32 scale, reducing |w|
    over the contraction axis (-2). Stacked [L, in, out] weights quantize
    one layer at a time, so the fp32 temporary is one layer. ``tp`` (a
    ``parallel.tensor_parallel.TensorParallel``): ``w`` is this rank's
    block of the contraction rows (a row-parallel weight), and the scale
    is the whole column's, its max over the ranks: the record is the
    rank's block of the whole weight's."""
    layers = [w[i] for i in range(w.shape[0])] if w.dim() == 3 else [w]
    amax = torch.stack([x.float().abs().amax(-2, keepdim=True)
                        for x in layers])
    amax = tpar.reduce_max(tp, amax)
    parts = []
    for x, m in zip(layers, amax):
        scale = m / 127.0
        q = torch.clamp(torch.round(x.float() / torch.clamp(scale,
                                                            min=1e-12)),
                        -127, 127)
        parts.append((q.to(torch.int8), scale))
    if w.dim() != 3:
        return parts[0]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def maybe_dequant(w, dtype) -> torch.Tensor:
    """A weight as a plain tensor of ``dtype``: an int8 record dequantized,
    a plain tensor cast."""
    if is_record(w):
        return dequantize(w["q"], w["s"], dtype)
    return w.to(dtype)


def quantize_llama(params: dict, tp=None) -> dict:
    """LLaMA params -> the same tree with the attention/MLP weights and
    lm_head replaced by int8 records. Norms and embeddings stay as they
    are (embeddings feed the alignment memory and the prefix lookups).
    ``tp``: ``params`` is this rank's block of a tensor-parallel tree, and
    the records are the blocks of the whole tree's (``quantize_tensor``:
    the row-parallel wo and down take their scales over the ranks)."""
    out = dict(params)
    layers = dict(params["layers"])
    row = {"wo": tpar.on(tp, "llm_attn"), "down": tpar.on(tp, "llm_mlp")}
    with SPANS.span("setup.quantize",
                    device=params["embed_tokens"].device):
        for group in ("attn", "mlp"):
            g = dict(layers[group])
            for name in list(g):
                if name in QUANT_KEYS:
                    qv, sv = quantize_tensor(g[name], row.get(name))
                    g[name] = {"q": qv, "s": sv}
            layers[group] = g
        qh, sh = quantize_tensor(params["lm_head"])
    out["layers"] = layers
    out["lm_head"] = {"q": qh, "s": sh}
    return out


def cat_columns(*parts):
    """Weights concatenated along the output dim: plain tensors, or int8
    records with their per-output scales concatenated the same way."""
    if is_record(parts[0]):
        return {"q": torch.cat([p["q"] for p in parts], dim=-1),
                "s": torch.cat([p["s"] for p in parts], dim=-1)}
    return torch.cat(parts, dim=-1)


def pack_llama_for_decode(params: dict) -> dict:
    """Serving layout: wq/wk/wv -> "qkv" and gate/up -> "gateup",
    concatenated along the output dim (``cat_columns``). One matvec per
    packed stream instead of three or two. On a rank's block
    (``parallel.tensor_parallel.tp_params``) it packs [its q heads | its k
    heads | its v heads] and [its gate | its up]: pack after cutting."""
    out = dict(params)
    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    mlp = dict(layers["mlp"])
    with SPANS.span("setup.pack", device=params["embed_tokens"].device):
        attn["qkv"] = cat_columns(attn.pop("wq"), attn.pop("wk"),
                                  attn.pop("wv"))
        mlp["gateup"] = cat_columns(mlp.pop("gate"), mlp.pop("up"))
    layers["attn"] = attn
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


def quantize_towers(params: dict) -> dict:
    """The CLIP and Whisper towers' projections as int8 records for the
    W8A8 prefill: attention q/k/v/o (or the packed qkv), MLP fc1/fc2 and
    CLIP's visual_projection, stacked [L, in, out] weights one layer at a
    time. Conv front ends, embeddings and norms stay as they are. The
    towers' projections run thousands of rows a call, past the W8A8 gate,
    so with ``activation_quant`` every one takes ``torch._int_mm``."""
    def record(w: torch.Tensor) -> dict:
        qv, sv = quantize_tensor(w)
        return {"q": qv, "s": sv}

    def proj(p: dict) -> dict:
        return dict(p, w=record(p["w"]))

    def tower(t: dict) -> dict:
        out = dict(t)
        layers = dict(t["layers"])
        layers["attn"] = {k: proj(v) if isinstance(v, dict) and "w" in v
                          else v for k, v in layers["attn"].items()}
        layers["mlp"] = dict(layers["mlp"], fc1=proj(layers["mlp"]["fc1"]),
                             fc2=proj(layers["mlp"]["fc2"]))
        out["layers"] = layers
        if "visual_projection" in out:
            out["visual_projection"] = record(out["visual_projection"])
        return out

    out = dict(params)
    for name in ("image_encoder", "video_encoder", "audio_encoder"):
        if name in out:
            out[name] = tower(out[name])
    return out


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32. On CUDA, ``torch._int_mm``
    needs M > 16 and K, N multiples of 8: other shapes raise."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"W8A8 int8 matmul: shape [{m}, {k}] x [{k}, {n}] "
                         "needs M > 16 and K, N multiples of 8 on CUDA")
    return torch._int_mm(a, b)


def w8a8_dot(x: torch.Tensor, q: torch.Tensor,
             s: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-token symmetric int8 activations x int8 weights, int32 dot,
    fp32 rescale by (per-token scale) x (per-channel scale). Returns fp32
    [..., N]; differentiable in x by the straight-through estimator.
    ``tp``: x is this rank's block of a row-parallel input; the per-token
    scale is the whole row's (its max over the ranks), so the int8
    activations are the block of one device's, and the int32 dots are
    summed over the ranks (exactly) before the scales: one device's
    product, bit for bit."""
    return _W8A8Dot.apply(x, q, s, tp)


def _w8a8_forward(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor, tp=None) -> torch.Tensor:
    xf = x.float()
    amax = tpar.reduce_max(tp, xf.abs().amax(-1, keepdim=True))
    xs = torch.clamp(amax, min=1e-12) / 127.0
    xq = torch.round(xf / xs).to(torch.int8)
    y32 = tpar.reduce(tp, _int_mm(xq.reshape(-1, xq.shape[-1]), q))
    y = y32.reshape(*x.shape[:-1], q.shape[-1]).float()
    return y * xs * s.reshape(-1)


class _W8A8Dot(torch.autograd.Function):
    """Forward: the W8A8 integer dot. Backward (STE): the rounding of the
    activations is taken as the identity, gx = g @ (q * s)^T in fp32, cast
    to x's dtype; the int8 weight and its scale take no gradient."""

    @staticmethod
    def forward(ctx, x, q, s, tp):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x.dtype
        return _w8a8_forward(x, q, s, tp)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        w = q.float() * s
        return (g.float() @ w.T).to(ctx.x_dtype), None, None, None


class _Int8Matmul(torch.autograd.Function):
    """Weight-only int8: ``((x @ q) * s)`` in ``compute``. Saves the int8
    record, not its dequantized copy; the backward converts it again:
    gx = ((g * s) in compute) @ q^T."""

    @staticmethod
    def forward(ctx, x, q, s, compute):
        ctx.save_for_backward(q, s)
        ctx.compute = compute
        # the scale is per output channel, so (x @ q) * s == x @ (q * s)
        y = x @ q.to(compute)
        return (y * s.reshape(-1)).to(compute)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        gy = (g.float() * s.reshape(-1)).to(ctx.compute)
        return gy @ q.to(ctx.compute).T, None, None, None


def matmul(x: torch.Tensor, w, compute: torch.dtype, *,
           activation_quant: bool = False,
           decode_kernel: bool = True,
           decode_rows: bool = False, tp=None) -> torch.Tensor:
    """x [..., K] @ weight (plain tensor or int8 record) -> [..., N] in
    ``compute``. See the module docstring for the three int8 routes;
    ``decode_kernel=False`` keeps single-row calls on the weight-only
    matmul; ``decode_rows=True`` sends x [B, S, K] of at most 32 rows in
    all to the matvec kernels.

    Tensor parallel (``parallel.tensor_parallel``): under ``tp`` w is this
    rank's block of the rows of a row-parallel weight, and the ranks'
    partial products are summed over the group: W8A8's exactly, as int32
    dots (``w8a8_dot``), the others in fp32 and rounded once to
    ``compute``, as one device rounds its fp32 sum once (the sum's order
    differs)."""
    if not is_record(w):
        return tpar.row_mm(tp, x, w.to(compute))
    q, s = w["q"], w["s"]
    rows = x.numel() // x.shape[-1]
    if decode_kernel and x.dim() == 3 and q.dim() == 2 and (
            x.shape[1] == 1 or (decode_rows and rows <= PIPELINED_MAX_ROWS)):
        x1 = x.reshape(rows, x.shape[-1]).to(compute).contiguous()
        kernel = matvec_int8 if rows <= MATVEC_MAX_ROWS \
            else matvec_int8_pipelined
        if tp is None:
            y = kernel(x1, q, s, out_dtype=compute)
        else:
            y = tpar.reduce(tp, kernel(x1, q, s, out_dtype=torch.float32)
                            ).to(compute)
        return y.reshape(x.shape[0], x.shape[1], y.shape[-1])
    if activation_quant and rows >= ACT_QUANT_MIN_ROWS and q.dim() == 2:
        return w8a8_dot(x, q, s, tp).to(compute)
    if tp is not None:  # rounded once, then scaled, as _Int8Matmul does
        y = tpar.row_mm(tp, x, q)
        return (y * s.reshape(-1)).to(compute)
    return _Int8Matmul.apply(x, q, s, compute)
