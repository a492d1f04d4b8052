"""The port's parameter trees back to HF / torch state-dict layout
(counterpart of ``macaw_llm_tpu/utils/hf_export.py``), the inverse of
``hf_import``: a model fine-tuned here loads with HF ``from_pretrained``
or the reference's MM_LLMs.

Values are fp32 numpy arrays keyed exactly like the torch state dicts,
read from tensors on any device; ``save_torch`` writes them as a
``pytorch_model.bin`` and ``utils.safetensors_io.save_safetensors`` as
safetensors. Imports neither ``transformers`` nor jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from macaw_llm_tpu_torch.config import LlamaConfig, ModelConfig


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def export_llama(params: dict, cfg: LlamaConfig,
                 prefix: str = "") -> Dict[str, np.ndarray]:
    """Stacked-layer LLaMA tree -> HF ``LlamaForCausalLM`` keys; every
    [in, out] projection goes back to HF's [out, in]."""
    sd: Dict[str, np.ndarray] = {}
    sd[prefix + "model.embed_tokens.weight"] = _np(params["embed_tokens"])
    layers = params["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    for i in range(cfg.num_layers):
        base = f"{prefix}model.layers.{i}."
        sd[base + "self_attn.q_proj.weight"] = _np(attn["wq"][i]).T
        sd[base + "self_attn.k_proj.weight"] = _np(attn["wk"][i]).T
        sd[base + "self_attn.v_proj.weight"] = _np(attn["wv"][i]).T
        sd[base + "self_attn.o_proj.weight"] = _np(attn["wo"][i]).T
        sd[base + "mlp.gate_proj.weight"] = _np(mlp["gate"][i]).T
        sd[base + "mlp.up_proj.weight"] = _np(mlp["up"][i]).T
        sd[base + "mlp.down_proj.weight"] = _np(mlp["down"][i]).T
        sd[base + "input_layernorm.weight"] = _np(layers["input_norm"][i])
        sd[base + "post_attention_layernorm.weight"] = \
            _np(layers["post_norm"][i])
    sd[prefix + "model.norm.weight"] = _np(params["norm"])
    sd[prefix + "lm_head.weight"] = _np(params["lm_head"]).T
    return sd


def export_fusion_modules(params: dict, cfg: ModelConfig
                          ) -> Dict[str, np.ndarray]:
    """The fusion subtree -> the reference MM_LLMs module names."""
    fp = params["fusion"]
    sd: Dict[str, np.ndarray] = {}

    def mha(name: str, p: dict):
        sd[f"{name}.in_proj_weight"] = _np(p["in_proj_w"])
        sd[f"{name}.in_proj_bias"] = _np(p["in_proj_b"])
        sd[f"{name}.out_proj.weight"] = _np(p["out_proj_w"])
        sd[f"{name}.out_proj.bias"] = _np(p["out_proj_b"])
        if "bias_k" in p:
            sd[f"{name}.bias_k"] = _np(p["bias_k"])[None, None, :]
            sd[f"{name}.bias_v"] = _np(p["bias_v"])[None, None, :]

    mha("image_align_attention", fp["image_align"])
    mha("audio_align_attention", fp["audio_align"])
    mha("video_align_attention", fp["video_align"])
    mha("video_long_self_attention", fp["video_long_attn"])
    mha("temporal_self_attention", fp["temporal_attn"])
    sd["temporal_position_embeddings.weight"] = _np(fp["temporal_pos_emb"])
    for mod in ("video", "audio", "image"):
        sd[f"transform_{mod}_to_hidden.weight"] = \
            _np(fp["to_hidden"][mod]["w"]).T
        sd[f"transform_{mod}_to_hidden.bias"] = _np(fp["to_hidden"][mod]["b"])
    for mod in ("image", "video", "audio"):
        # [k, C_in, C_out] -> torch Conv1d [C_out, C_in, k]
        sd[f"project_{mod}.weight"] = \
            _np(fp["conv"][mod]["w"]).transpose(2, 1, 0)
        sd[f"project_{mod}.bias"] = _np(fp["conv"][mod]["b"])
    return sd


def save_torch(sd: Dict[str, np.ndarray], path: str) -> None:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
