"""Activation functions used by the three towers."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)  # LLaMA SwiGLU gate


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form (Whisper)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)  # CLIP


_ACT = {
    "silu": silu,
    "gelu": gelu,
    "gelu_new": gelu_tanh,
    "gelu_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
}


def get_activation(name: str):
    return _ACT[name]
