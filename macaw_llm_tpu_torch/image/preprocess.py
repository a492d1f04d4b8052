"""CLIP image preprocessing on the device, and the frame-sampling policy.

Counterpart of ``macaw_llm_tpu/image/preprocess.py``: resize the shortest
side to ``size`` (bicubic, antialiased), center crop, CLIP normalize;
``sample_frame_indices`` picks the video frames.

The resize reproduces ``jax.image.resize(..., "bicubic", antialias=True)``
rather than ``torch.nn.functional.interpolate``: the Keys cubic kernel with
a = -0.5 (torch's bicubic uses a = -0.75), widened by the scale factor when
downsampling, half-pixel centers, weights normalized per output sample.
It is built here as one [in, out] weight matrix per spatial axis; an axis
whose size does not change is left as it is, as JAX does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from macaw_llm_tpu_torch import resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def sample_frame_indices(n_stored: int = 120,
                         n_sampled: int = 6) -> np.ndarray:
    """Uniform frame subsampling with the last frame pinned: stride =
    n_stored // n_sampled, the last index replaced by n_stored - 1."""
    stride = n_stored // n_sampled
    idx = np.arange(0, n_stored, stride)[:n_sampled].copy()
    idx[-1] = n_stored - 1
    return idx


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys (1981) cubic convolution kernel with a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """[in_size, out_size] antialiased bicubic resampling matrix."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 or float [B, H, W, 3] -> CLIP-normalized fp32 [B, 3, size,
    size]."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    _, h, w, _ = x.shape
    if h < w:
        new_h, new_w = size, max(size, int(round(size * w / h)))
    else:
        new_h, new_w = max(size, int(round(size * h / w))), size
    if new_h != h:
        x = torch.einsum("bhwc,hH->bHwc", x,
                         resize_weights(h, new_h, x.device))
    if new_w != w:
        x = torch.einsum("bhwc,wW->bhWc", x,
                         resize_weights(w, new_w, x.device))
    top = (new_h - size) // 2
    left = (new_w - size) // 2
    x = x[:, top:top + size, left:left + size]
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def preprocess_batch_numpy(images: Sequence[np.ndarray], size: int = 224,
                           device="cuda") -> np.ndarray:
    """Host-side convenience for ragged input sizes: each uint8 [H, W, 3]
    image preprocessed on ``device`` (the card unless the CPU is asked
    for) on its own, the results stacked on the host as fp32
    [N, 3, size, size]."""
    device = resolve_device(device)
    return np.stack([preprocess(torch.from_numpy(np.asarray(im)[None])
                                .to(device), size)[0].cpu().numpy()
                     for im in images])
