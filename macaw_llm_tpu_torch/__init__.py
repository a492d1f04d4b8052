"""PyTorch/CUDA port of the Macaw multimodal LLM framework.

The JAX package ``macaw_llm_tpu`` is the reference; this package keeps its
module names and parameter layout (nested dicts, stacked ``[L, ...]``
layers, ``[in, out]`` weights) so each function has a findable
counterpart. It imports ``torch`` and never ``jax``; the TPU Pallas kernels
on the serving path are hand-written CUDA kernels under ``csrc/``.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) requires a GPU; the CPU is used only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return device
