"""Int8 weight-streaming matvec for single-token decode.

Counterpart of ``macaw_llm_tpu/ops/pallas/matvec.py::matvec_int8``. On
CUDA tensors the wrapper launches ``csrc/matvec.cu``; on CPU tensors it
computes the plain version ``(x @ q) * s`` with the int8 weight converted
to x's dtype (exact: |q| <= 127).
"""

from __future__ import annotations

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

MAX_ROWS = 32
_COLS_PER_BLOCK = 512   # csrc/matvec.cu kCols
_TARGET_BLOCKS = 264    # two blocks per SM on a 132-SM H100
_MAX_ROWS_PER_SPLIT = 1024  # bounds the activation slice in shared memory


def matvec_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """The plain version: (x @ q) * s, fp32 scale applied after the dot."""
    y = (x @ q.to(x.dtype)).float() * s.reshape(1, -1).float()
    return y.to(out_dtype or x.dtype)


def k_splits(k: int, n: int) -> int:
    """How many K ranges the kernel's grid splits the contraction into:
    enough blocks to fill the card, at most 1024 rows per range."""
    tiles = -(-n // _COLS_PER_BLOCK)
    splits = max(-(-_TARGET_BLOCKS // tiles), -(-k // _MAX_ROWS_PER_SPLIT))
    return max(1, min(splits, k))


def matvec_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [B, K] @ int8 q [K, N] with per-output fp32 scales s ([N] or
    [1, N]) -> [B, N] in ``out_dtype`` (default x.dtype). CUDA: bf16 x and
    output, B <= 32, contiguous operands; anything else raises."""
    b, k = x.shape
    k2, n = q.shape
    if k != k2 or s.numel() != n:
        raise ValueError(f"shapes x {x.shape} q {q.shape} s {s.shape}")
    if x.device.type == "cpu":
        return matvec_reference(x, q, s, out_dtype)
    out_dtype = out_dtype or x.dtype
    if (x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16
            or q.dtype != torch.int8 or s.dtype != torch.float32):
        raise ValueError("matvec_int8 kernel: needs bf16 x and output, int8 "
                         f"q, fp32 s; got {x.dtype}, {out_dtype}, {q.dtype}, "
                         f"{s.dtype}")
    if b > MAX_ROWS:
        raise ValueError(f"matvec_int8 kernel: {b} rows > {MAX_ROWS}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"matvec_int8 kernel: {name} must be contiguous "
                             f"on {x.device}")
    splits = k_splits(k, n)
    ws = torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    err = _build.library().macaw_matvec_int8(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, k, n, splits, _build.stream_ptr(x))
    _build.check(err, "matvec_int8")
    matvec_int8.launches += 1
    return out


matvec_int8.launches = 0
