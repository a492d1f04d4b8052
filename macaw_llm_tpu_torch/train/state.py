"""Train state: the trainable and frozen parameter trees, the optimizer
state and the step (counterpart of ``macaw_llm_tpu/train/state.py``).

Parameters are split so that gradients are computed and optimizer state is
kept only for the trainable subtree. The state is updated in place by
``trainer.train_step`` (the reference's is an immutable pytree)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

FROZEN_PREFIXES = ("image_encoder", "video_encoder", "audio_encoder")


@dataclass
class TrainState:
    step: int                  # optimizer steps taken
    trainable: dict            # parameter tree the optimizer updates
    frozen: dict               # parameter tree held constant
    opt_state: Any             # trainer.AdamWState over ``trainable``
    rng: torch.Generator       # CPU generator of the dropout seeds


def split_params(params: dict, freeze_encoders: bool = True,
                 lora: bool = False) -> Tuple[dict, dict]:
    """Split the fusion-model parameter dict into (trainable, frozen).

    ``freeze_encoders`` freezes the CLIP and Whisper towers. With ``lora``
    the LLaMA base is frozen too and only the adapter subtree
    (llm/layers/lora) and the fusion modules train."""
    if not freeze_encoders and not lora:
        return params, {}
    trainable = {k: v for k, v in params.items()
                 if k not in FROZEN_PREFIXES}
    frozen = {k: v for k, v in params.items() if k in FROZEN_PREFIXES}
    if not freeze_encoders:
        trainable = dict(trainable)
        trainable.update(frozen)
        frozen = {}
    if lora:
        llm = trainable.pop("llm")
        layers = dict(llm["layers"])
        lora_tree = layers.pop("lora")
        frozen = dict(frozen)
        frozen["llm"] = {**llm, "layers": layers}
        trainable["llm"] = {"layers": {"lora": lora_tree}}
    return trainable, frozen


def merge_params(trainable: dict, frozen: dict) -> dict:
    """Deep merge of the two trees (disjoint except the llm/layers split
    under LoRA)."""
    def _merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = _merge(a[k], v) if k in a else v
            return out
        return a if b is None else b

    return _merge(dict(trainable), frozen)
