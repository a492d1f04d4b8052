"""Turn a reference-package parameter tree, already converted to numpy,
into the port's tensor tree with the layout unchanged.

The caller converts every leaf with ``np.asarray`` (this module imports
neither jax nor the reference package). Float leaves are cast to
``dtype``; int8 records {"q", "s"} keep int8 rows and fp32 scales, and so
do the (rows, scale) pairs of an alignment cache (scale may be None).
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device, dtype=None) -> torch.Tensor:
    # np.array copies: arrays converted from jax are read-only
    t = torch.from_numpy(np.array(x)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """numpy pytree (dicts, tuples, lists, None) -> torch tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {"q": _tensor(tree["q"], device),
                    "s": _tensor(tree["s"], device, torch.float32)}
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if (len(tree) == 2 and isinstance(tree[0], np.ndarray)
                and tree[0].dtype == np.int8):
            scale = None if tree[1] is None else \
                _tensor(tree[1], device, torch.float32)
            return (_tensor(tree[0], device), scale)
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _tensor(tree, device, dtype)
