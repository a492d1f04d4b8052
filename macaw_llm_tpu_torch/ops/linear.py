"""Dense projection with the leading dims flattened around the matmul."""

from __future__ import annotations

from typing import Optional

import torch

from macaw_llm_tpu_torch.utils import quantize as qz


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
          activation_quant: bool = False, tp=None) -> torch.Tensor:
    """``x @ w + b`` over x [..., E]; w is [E, F] or an int8 record
    {"q", "s"} (utils.quantize: W8A8 at >= 256 rows under
    ``activation_quant``, else weight-only); b is [F] or None ->
    [..., F]. ``tp``: w is this rank's block of a row-parallel weight's
    rows, the partial products are summed over the tensor group
    (``utils.quantize.matmul``) and b is added once, after the sum."""
    shape = x.shape
    if x.dim() > 2:
        x = x.reshape(-1, shape[-1])
    y = qz.matmul(x, w, x.dtype, activation_quant=activation_quant, tp=tp)
    if b is not None:
        y = y + b.to(y.dtype)
    if len(shape) > 2:
        y = y.reshape(*shape[:-1], y.shape[-1])
    return y
