"""Turn a reference-package parameter tree, already converted to numpy,
into the port's tensor tree with the layout unchanged; and a reference
train state's trainable and frozen trees into the port's ``TrainState``.

The caller converts every leaf with ``np.asarray`` (this module imports
neither jax nor the reference package). Float leaves are cast to ``dtype``
(or keep their own dtype, bf16 included, when ``dtype`` is None); int8
records {"q", "s"} keep int8 rows and fp32 scales, and so do the (rows,
scale) pairs of an alignment cache (scale may be None). LoRA adapters
(``llm/layers/lora``) are plain stacked leaves and carry over as they are,
and so do the records packed for decode (``qkv``, ``gateup``): they are
{"q", "s"} dicts like any other. ``kv_cache_from_numpy`` turns a
reference ``KVCache`` (float or int8 with scales, scalar or per-row
length) into the port's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(x, device, dtype=None) -> torch.Tensor:
    x = np.array(x)  # copies: arrays converted from jax are read-only
    if x.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    t = t.to(device)
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


def kv_cache_from_numpy(k, v, length, k_scale=None, v_scale=None,
                        device="cpu"):
    """A reference ``KVCache``'s fields (numpy) as the port's ``KVCache``:
    k/v keep their dtype (int8 rows stay int8, with their fp32 scales); a
    0-d ``length`` becomes an int, a [B] one an int64 tensor."""
    from macaw_llm_tpu_torch.models.llama import KVCache
    length = np.asarray(length)
    return KVCache(
        k=_tensor(k, device), v=_tensor(v, device),
        length=int(length) if length.ndim == 0
        else torch.from_numpy(length.astype(np.int64)).to(device),
        k_scale=None if k_scale is None
        else _tensor(k_scale, device, torch.float32),
        v_scale=None if v_scale is None
        else _tensor(v_scale, device, torch.float32))


def train_state_from_numpy(trainable, frozen, tx, *, step: int = 0,
                           seed: int = 1, device="cpu",
                           generator: Optional[torch.Generator] = None):
    """A reference ``TrainState``'s trainable and frozen trees (numpy, leaf
    dtypes kept) as the port's ``TrainState`` with fresh moments from
    ``tx`` (a ``trainer.AdamW``): the state both packages start a fine-tune
    from, so that they train the same weights."""
    from macaw_llm_tpu_torch.train.state import TrainState
    t = params_from_numpy(trainable, device, None)
    f = params_from_numpy(frozen, device, None)
    return TrainState(step=step, trainable=t, frozen=f, opt_state=tx.init(t),
                      rng=generator if generator is not None else
                      torch.Generator().manual_seed(seed))
