"""Per-layer activation checkpointing with the reference package's two
policies (``jax.checkpoint_policies``):

* ``"nothing"`` (or True): keep only the layer's input and recompute the
  whole layer in the backward (``nothing_saveable``);
* ``"dots"``: also keep the outputs of the matmuls with no batch
  dimensions (``dots_with_no_batch_dims_saveable``): ``aten.mm``,
  ``aten.addmm`` and ``aten._int_mm`` are saved, while attention's
  batched ``bmm`` and every elementwise op are recomputed. Selective
  activation checkpointing, non-reentrant.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, policy, *args):
    """``fn(*args)`` under ``policy``: False or None, no checkpoint;
    "dots"; any other (True, "nothing"), the whole layer recomputed, as the
    reference package reads it. Without autograd there is nothing to save,
    and fn runs as it is."""
    if not policy or not torch.is_grad_enabled():
        return fn(*args)
    if policy != "dots":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, _dots_policy))
