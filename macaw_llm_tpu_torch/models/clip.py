"""CLIP ViT vision tower + visual projection (counterpart of
``macaw_llm_tpu/models/clip.py``).

HF ``CLIPVisionTransformer`` semantics: patch embedding (no bias) + class
token + learned positions, pre-layernorm, residual blocks
(LN -> MHA -> res, LN -> MLP(quick_gelu) -> res); the patch tokens are
projected without the post-layernorm and the CLS token is dropped (the
reference's ``encode_image``). ``encode_pooled`` is CLIP's
``get_image_features``: the post-layernormed CLS token, projected.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from macaw_llm_tpu_torch.config import ClipVisionConfig
from macaw_llm_tpu_torch.models import _tree
from macaw_llm_tpu_torch.models._tree import layer_fn, normal, num_layers
from macaw_llm_tpu_torch.models.remat import checkpointed
from macaw_llm_tpu_torch.ops.activations import quick_gelu
from macaw_llm_tpu_torch.ops.attention import mha_apply
from macaw_llm_tpu_torch.ops.linear import dense
from macaw_llm_tpu_torch.ops.norms import layer_norm
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar


def init_params(gen: torch.Generator, cfg: ClipVisionConfig,
                dtype=torch.float32) -> dict:
    """Random init (normal(initializer_range)), stacked [L, ...] layers,
    [in, out] weights."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    std = cfg.initializer_range

    def rnd(*shape):
        return normal(gen, shape, std, dtype)

    def zeros(*shape):
        return _tree.zeros(gen, shape, dtype)

    def ones(*shape):
        return _tree.ones(gen, shape, dtype)

    attn = {name: {"w": rnd(L, h, h), "b": zeros(L, h)}
            for name in ("q", "k", "v", "o")}
    return {
        "class_embedding": rnd(h),
        "patch_embedding": rnd(cfg.patch_size, cfg.patch_size, 3, h),
        "position_embedding": rnd(cfg.seq_len, h),
        "pre_layernorm": {"w": ones(h), "b": zeros(h)},
        "layers": {
            "ln1": {"w": ones(L, h), "b": zeros(L, h)},
            "ln2": {"w": ones(L, h), "b": zeros(L, h)},
            "attn": attn,
            "mlp": {"fc1": {"w": rnd(L, h, i), "b": zeros(L, i)},
                    "fc2": {"w": rnd(L, i, h), "b": zeros(L, h)}},
        },
        "post_layernorm": {"w": ones(h), "b": zeros(h)},
        "visual_projection": rnd(h, cfg.projection_dim),
    }


def _embeddings(params: dict, cfg: ClipVisionConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] -> [B, 1 + P, hidden]. The stride == kernel
    patch conv is a space-to-depth reshape and one [B*P, k*k*3] x
    [k*k*3, hidden] matmul, in the conv kernel's (h, w, in) order."""
    compute = pixels.dtype
    b = pixels.shape[0]
    k = cfg.patch_size
    gh, gw = pixels.shape[2] // k, pixels.shape[3] // k
    x = pixels.reshape(b, 3, gh, k, gw, k).permute(0, 2, 4, 3, 5, 1) \
        .reshape(b * gh * gw, k * k * 3)
    w = params["patch_embedding"].to(compute).reshape(-1, cfg.hidden_size)
    patches = (x @ w).reshape(b, gh * gw, cfg.hidden_size)
    cls = params["class_embedding"].to(compute).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1)
    return x + params["position_embedding"].to(compute)[None]


def _encoder_layer(cfg: ClipVisionConfig, lp: dict, h: torch.Tensor,
                   use_flash: bool = False,
                   activation_quant: bool = False,
                   tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """Pre-norm attention + residual, pre-norm MLP + residual; under ``tp``
    the cut attention and MLP run this rank's heads and FFN columns."""
    aq = activation_quant
    ln1 = layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], cfg.layer_norm_eps)
    h = h + mha_apply(lp["attn"], cfg.num_heads, ln1, use_flash=use_flash,
                      activation_quant=aq, tp=tpar.on(tp, "clip_attn"))
    ln2 = layer_norm(h, lp["ln2"]["w"], lp["ln2"]["b"], cfg.layer_norm_eps)
    m = quick_gelu(dense(ln2, lp["mlp"]["fc1"]["w"], lp["mlp"]["fc1"]["b"],
                         aq))
    m = dense(m, lp["mlp"]["fc2"]["w"], lp["mlp"]["fc2"]["b"], aq,
              tpar.on(tp, "clip_mlp"))
    return h + m


def _encode(params: dict, cfg: ClipVisionConfig, pixels: torch.Tensor,
            use_flash: bool, remat, activation_quant: bool,
            tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """pixels -> the last layer's hidden states [B, 1 + P, hidden]."""
    h = _embeddings(params, cfg, pixels)
    h = layer_norm(h, params["pre_layernorm"]["w"],
                   params["pre_layernorm"]["b"], cfg.layer_norm_eps)
    layers = params["layers"]
    for i in range(num_layers(layers)):
        fn = layer_fn(partial(_encoder_layer, cfg), layers, i)
        h = checkpointed(partial(fn, use_flash=use_flash,
                                 activation_quant=activation_quant, tp=tp),
                         remat, h)
    return h


def encode_patches(params: dict, cfg: ClipVisionConfig,
                   pixels: torch.Tensor, use_flash: bool = False,
                   remat=False, activation_quant: bool = False,
                   tp: Optional[tpar.TensorParallel] = None
                   ) -> torch.Tensor:
    """pixels [B, 3, H, W] -> projected patch tokens [B, P,
    projection_dim] (CLS dropped). ``remat`` (False, True, "nothing" or
    "dots", ``models.remat``) checkpoints each layer while the tower takes
    a gradient; ``activation_quant`` sends int8 records to W8A8; ``tp``: a
    rank's block of a tensor-parallel tree."""
    h = _encode(params, cfg, pixels, use_flash, remat, activation_quant, tp)
    return dense(h, params["visual_projection"], None,
                 activation_quant)[:, 1:, :]


def encode_pooled(params: dict, cfg: ClipVisionConfig,
                  pixels: torch.Tensor, remat=False,
                  activation_quant: bool = False,
                  tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """pixels [B, 3, H, W] -> [B, projection_dim]: the post-layernormed
    CLS token through visual_projection (the reference package runs these
    layers without the flash path)."""
    h = _encode(params, cfg, pixels, False, remat, activation_quant, tp)
    cls = layer_norm(h[:, 0], params["post_layernorm"]["w"],
                     params["post_layernorm"]["b"], cfg.layer_norm_eps)
    return dense(cls, params["visual_projection"], None, activation_quant)
