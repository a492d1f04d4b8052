"""Whisper audio encoder (counterpart of ``macaw_llm_tpu/models/whisper.py``).

HF WhisperEncoder: Conv1d(80 -> d, k=3, p=1) + GELU, Conv1d(d -> d, k=3,
s=2, p=1) + GELU, learned positions, pre-norm layers, final LayerNorm.
Conv weights keep the reference package's WIO layout [k, in, out].

Training-only LayerDrop skips each layer with probability
``encoder_layerdrop``, one draw per layer for the whole batch (the
reference's ``modeling.py:766-768``). The keep vector is drawn on the host
(``layerdrop_keep``, from a CPU generator), so a dropped layer is a Python
branch that launches nothing, and the card and the CPU drop the same
layers.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from macaw_llm_tpu_torch.config import WhisperConfig
from macaw_llm_tpu_torch.models import _tree
from macaw_llm_tpu_torch.models._tree import layer_fn, normal, num_layers
from macaw_llm_tpu_torch.models.remat import checkpointed
from macaw_llm_tpu_torch.ops.activations import gelu
from macaw_llm_tpu_torch.ops.attention import mha_apply
from macaw_llm_tpu_torch.ops.linear import dense
from macaw_llm_tpu_torch.ops.norms import layer_norm
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar


def init_params(gen: torch.Generator, cfg: WhisperConfig,
                dtype=torch.float32) -> dict:
    d, f, L = cfg.d_model, cfg.encoder_ffn_dim, cfg.encoder_layers
    std = cfg.initializer_range

    def rnd(*shape):
        return normal(gen, shape, std, dtype)

    def zeros(*shape):
        return _tree.zeros(gen, shape, dtype)

    def ones(*shape):
        return _tree.ones(gen, shape, dtype)

    attn = {name: {"w": rnd(L, d, d), "b": zeros(L, d)}
            for name in ("q", "k", "v", "o")}
    return {
        "conv1": {"w": rnd(3, cfg.num_mel_bins, d), "b": zeros(d)},
        "conv2": {"w": rnd(3, d, d), "b": zeros(d)},
        "embed_positions": rnd(cfg.max_source_positions, d),
        "layers": {
            "self_attn_ln": {"w": ones(L, d), "b": zeros(L, d)},
            "attn": attn,
            "final_ln": {"w": ones(L, d), "b": zeros(L, d)},
            "mlp": {"fc1": {"w": rnd(L, d, f), "b": zeros(L, f)},
                    "fc2": {"w": rnd(L, f, d), "b": zeros(L, d)}},
        },
        "layer_norm": {"w": ones(d), "b": zeros(d)},
    }


def conv1d_nwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """x [B, T, C_in] (NWC) with a WIO kernel [k, C_in, C_out] ->
    [B, T', C_out]; no bias."""
    out = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
                   stride=stride, padding=padding)
    return out.transpose(1, 2)


def _conv1d(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    return conv1d_nwc(x, p["w"], stride, 1) + p["b"].to(x.dtype)


def _encoder_layer(cfg: WhisperConfig, lp: dict, h: torch.Tensor,
                   use_flash: bool = False,
                   activation_quant: bool = False,
                   tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """Pre-norm attention + residual, pre-norm MLP + residual; under ``tp``
    the cut attention and MLP run this rank's heads and FFN columns."""
    aq = activation_quant
    ln = layer_norm(h, lp["self_attn_ln"]["w"], lp["self_attn_ln"]["b"],
                    cfg.layer_norm_eps)
    h = h + mha_apply(lp["attn"], cfg.encoder_attention_heads, ln,
                      use_flash=use_flash, activation_quant=aq,
                      tp=tpar.on(tp, "whisper_attn"))
    ln = layer_norm(h, lp["final_ln"]["w"], lp["final_ln"]["b"],
                    cfg.layer_norm_eps)
    m = gelu(dense(ln, lp["mlp"]["fc1"]["w"], lp["mlp"]["fc1"]["b"], aq))
    m = dense(m, lp["mlp"]["fc2"]["w"], lp["mlp"]["fc2"]["b"], aq,
              tpar.on(tp, "whisper_mlp"))
    return h + m


def layerdrop_keep(rng: torch.Generator, n_layers: int,
                   rate: float) -> list:
    """LayerDrop's keep vector: one uniform draw a layer from the CPU
    generator ``rng``, kept when it is >= ``rate``."""
    u = torch.rand(n_layers, generator=rng)
    return (u >= rate).tolist()


def encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor,
           use_flash: bool = False, remat=False,
           layer_keep: Optional[Sequence[bool]] = None,
           activation_quant: bool = False,
           tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """mel [B, 80, 3000] -> [B, 1500, d_model]. ``remat`` (False, True,
    "nothing" or "dots", ``models.remat``) checkpoints each layer while the
    tower takes a gradient; ``layer_keep`` (one bool a layer, LayerDrop)
    skips the layers it marks False; ``activation_quant`` sends int8
    records to W8A8; ``tp``: a rank's block of a tensor-parallel tree."""
    x = mel.transpose(1, 2)
    x = gelu(_conv1d(params["conv1"], x, 1))
    x = gelu(_conv1d(params["conv2"], x, 2))  # 3000 -> 1500
    x = x + params["embed_positions"].to(x.dtype)[None, :x.shape[1]]
    layers = params["layers"]
    n = num_layers(layers)
    if layer_keep is not None and len(layer_keep) != n:
        raise ValueError(f"layer_keep has {len(layer_keep)} entries for "
                         f"{n} layers")
    for i in range(n):
        if layer_keep is not None and not layer_keep[i]:
            continue
        fn = layer_fn(partial(_encoder_layer, cfg), layers, i)
        x = checkpointed(partial(fn, use_flash=use_flash,
                                 activation_quant=activation_quant, tp=tp),
                         remat, x)
    return layer_norm(x, params["layer_norm"]["w"], params["layer_norm"]["b"],
                      cfg.layer_norm_eps)
