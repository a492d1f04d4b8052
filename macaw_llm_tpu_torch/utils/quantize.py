"""Int8 quantization of the LLaMA weights for serving.

Counterpart of ``macaw_llm_tpu/utils/quantize.py``: symmetric
per-output-channel int8 records {"q": int8 [.., in, out], "s": fp32
[.., 1, out]}, the decode packing, and ``matmul`` with its three routes:

* single-row decode (x [B, 1, K]) -> a matvec kernel picked by the row
  count B: up to 8 rows ``matvec_int8`` (8 rows per block), 9 to 32 rows
  ``matvec_int8_pipelined`` (all rows against each weight tile, every
  weight byte read once); more than 32 rows raise;
* W8A8 (``activation_quant=True``, >= 256 rows): per-token int8
  activations x int8 weights through ``torch._int_mm``, both scales
  applied after the integer dot;
* otherwise weight-only int8: ``(x @ q) * s``.

The W8A8 and decode switches that the JAX package keeps as process-wide
setters (``set_activation_quant`` / ``set_decode_kernel``) are explicit
keyword flags of ``matmul`` here.

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

QUANT_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
ACT_QUANT_MIN_ROWS = 256
MATVEC_MAX_ROWS = 8  # single-row calls above this go to the pipelined kernel


def is_record(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_tensor(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with a per-output-channel fp32 scale, reducing |w|
    over the contraction axis (-2). Stacked [L, in, out] weights quantize
    one layer at a time, so the fp32 temporary is one layer."""
    if w.dim() == 3:
        parts = [quantize_tensor(w[i]) for i in range(w.shape[0])]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    wf = w.float()
    scale = wf.abs().amax(-2, keepdim=True) / 127.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_llama(params: dict) -> dict:
    """LLaMA params -> the same tree with the attention/MLP weights and
    lm_head replaced by int8 records. Norms and embeddings stay as they
    are (embeddings feed the alignment memory and the prefix lookups)."""
    out = dict(params)
    layers = dict(params["layers"])
    for group in ("attn", "mlp"):
        g = dict(layers[group])
        for name in list(g):
            if name in QUANT_KEYS:
                qv, sv = quantize_tensor(g[name])
                g[name] = {"q": qv, "s": sv}
        layers[group] = g
    out["layers"] = layers
    qh, sh = quantize_tensor(params["lm_head"])
    out["lm_head"] = {"q": qh, "s": sh}
    return out


def pack_llama_for_decode(params: dict) -> dict:
    """Serving layout: wq/wk/wv -> "qkv" and gate/up -> "gateup",
    concatenated along the output dim (plain tensors or int8 records; the
    per-output scales concatenate the same way). One matvec per packed
    stream instead of three or two."""
    def cat(*parts):
        if is_record(parts[0]):
            return {"q": torch.cat([p["q"] for p in parts], dim=-1),
                    "s": torch.cat([p["s"] for p in parts], dim=-1)}
        return torch.cat(parts, dim=-1)

    out = dict(params)
    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    attn["qkv"] = cat(attn.pop("wq"), attn.pop("wk"), attn.pop("wv"))
    layers["attn"] = attn
    mlp = dict(layers["mlp"])
    mlp["gateup"] = cat(mlp.pop("gate"), mlp.pop("up"))
    layers["mlp"] = mlp
    out["layers"] = layers
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
             s: torch.Tensor) -> torch.Tensor:
    """Per-token symmetric int8 activations x int8 weights, int32 dot,
    fp32 rescale by (per-token scale) x (per-channel scale). Returns fp32
    [..., N]; differentiable in x by the straight-through estimator."""
    return _W8A8Dot.apply(x, q, s)


def _w8a8_forward(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    xq = torch.round(xf / xs).to(torch.int8)
    y32 = _int_mm(xq.reshape(-1, xq.shape[-1]), q)
    y = y32.reshape(*x.shape[:-1], q.shape[-1]).float()
    return y * xs * s.reshape(-1)


class _W8A8Dot(torch.autograd.Function):
    """Forward: the W8A8 integer dot. Backward (STE): the rounding of the
    activations is taken as the identity, gx = g @ (q * s)^T in fp32, cast
    to x's dtype; the int8 weight and its scale take no gradient."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x.dtype
        return _w8a8_forward(x, q, s)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        w = q.float() * s
        return (g.float() @ w.T).to(ctx.x_dtype), None, None


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
           decode_kernel: bool = True) -> torch.Tensor:
    """x [..., K] @ weight (plain tensor or int8 record) -> [..., N] in
    ``compute``. See the module docstring for the three int8 routes;
    ``decode_kernel=False`` keeps single-row calls on the weight-only
    matmul."""
    if not is_record(w):
        return x @ w.to(compute)
    q, s = w["q"], w["s"]
    if decode_kernel and x.dim() == 3 and x.shape[1] == 1 and q.dim() == 2:
        x1 = x[:, 0].to(compute).contiguous()
        kernel = matvec_int8 if x1.shape[0] <= MATVEC_MAX_ROWS \
            else matvec_int8_pipelined
        return kernel(x1, q, s, out_dtype=compute)[:, None]
    rows = x.numel() // x.shape[-1]
    if activation_quant and rows >= ACT_QUANT_MIN_ROWS and q.dim() == 2:
        return w8a8_dot(x, q, s).to(compute)
    return _Int8Matmul.apply(x, q, s, compute)
