"""HF checkpoint import: torch state dicts -> the port's parameter trees
(counterpart of ``macaw_llm_tpu/utils/hf_import.py``).

Each function takes a state dict of tensors (a live ``state_dict()``) or
of numpy arrays (``utils.safetensors_io.load_checkpoint_dir``) and returns
the tree in ``dtype`` on ``device``, in the reference package's layout:
HF Linear ``[out, in]`` becomes ``[in, out]``, Conv2d ``[out, in, kh, kw]``
becomes HWIO, Conv1d ``[out, in, k]`` becomes ``[k, in, out]``, layers are
stacked on a leading ``[L]`` axis. Every value passes through fp32, as in
the reference package. Imports neither ``transformers`` nor jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from macaw_llm_tpu_torch.config import (ClipVisionConfig, LlamaConfig,
                                        WhisperConfig)


def _t(x) -> torch.Tensor:
    """A state-dict value as an fp32 CPU tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


class _Reader:
    """Reads, transposes and stacks state-dict entries into ``dtype`` on
    ``device``."""

    def __init__(self, get, dtype, device):
        self.get, self.dtype, self.device = get, dtype, device

    def put(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(device=self.device, dtype=self.dtype)

    def one(self, key: str, transpose: bool = False) -> torch.Tensor:
        t = _t(self.get(key))
        return self.put(t.T if transpose else t)

    def stack(self, fmt: str, n: int, transpose: bool = True
              ) -> torch.Tensor:
        ws = [_t(self.get(fmt.format(i))) for i in range(n)]
        return self.put(torch.stack([w.T if transpose else w for w in ws]))


def import_llama(sd: Mapping[str, object], cfg: LlamaConfig,
                 dtype=torch.float32, device="cpu",
                 prefix: str = "") -> dict:
    """HF ``LlamaForCausalLM`` state dict -> the stacked-layer LLaMA
    tree."""
    r = _Reader(lambda k: sd[prefix + k], dtype, device)
    L = cfg.num_layers
    lyr = "model.layers.{}."
    return {
        "embed_tokens": r.one("model.embed_tokens.weight"),
        "layers": {
            "attn": {
                "wq": r.stack(lyr + "self_attn.q_proj.weight", L),
                "wk": r.stack(lyr + "self_attn.k_proj.weight", L),
                "wv": r.stack(lyr + "self_attn.v_proj.weight", L),
                "wo": r.stack(lyr + "self_attn.o_proj.weight", L),
            },
            "mlp": {
                "gate": r.stack(lyr + "mlp.gate_proj.weight", L),
                "up": r.stack(lyr + "mlp.up_proj.weight", L),
                "down": r.stack(lyr + "mlp.down_proj.weight", L),
            },
            "input_norm": r.stack(lyr + "input_layernorm.weight", L, False),
            "post_norm": r.stack(lyr + "post_attention_layernorm.weight", L,
                                 False),
        },
        "norm": r.one("model.norm.weight"),
        "lm_head": r.one("lm_head.weight", transpose=True),
    }


def resize_token_embeddings(params: dict, new_vocab: int) -> dict:
    """Grow embed_tokens rows / lm_head columns to ``new_vocab`` (the
    reference's 32000 -> 32007). New entries are the mean of the old ones
    (HF draws them from a normal init; the mean keeps new special tokens
    stable)."""
    emb, head = params["embed_tokens"], params["lm_head"]
    old = emb.shape[0]
    if new_vocab == old:
        return params
    if new_vocab < old:
        raise ValueError(f"cannot shrink the vocab {old} -> {new_vocab}")
    n_new = new_vocab - old
    out = dict(params)
    out["embed_tokens"] = torch.cat(
        [emb, emb.mean(0, keepdim=True).expand(n_new, emb.shape[1])], 0)
    out["lm_head"] = torch.cat(
        [head, head.mean(1, keepdim=True).expand(head.shape[0], n_new)], 1)
    return out


def pad_vocab(params: dict, pad_to: int) -> dict:
    """Pad embed_tokens rows / lm_head columns with zeros up to
    ``pad_to`` (``vocab_pad_to``): padded ids are never real tokens and
    their logits are masked, so zeros are exact."""
    emb, head = params["embed_tokens"], params["lm_head"]
    old = emb.shape[0]
    if pad_to == old:
        return params
    if pad_to < old:
        raise ValueError(f"cannot pad the vocab {old} down to {pad_to}")
    out = dict(params)
    out["embed_tokens"] = torch.cat(
        [emb, emb.new_zeros((pad_to - old, emb.shape[1]))], 0)
    out["lm_head"] = torch.cat(
        [head, head.new_zeros((head.shape[0], pad_to - head.shape[1]))], 1)
    return out


def _ln(r: _Reader, fmt_w: str, fmt_b: str, n: int) -> dict:
    return {"w": r.stack(fmt_w, n, False), "b": r.stack(fmt_b, n, False)}


def import_clip_vision(sd: Mapping[str, object], cfg: ClipVisionConfig,
                       dtype=torch.float32, device="cpu") -> dict:
    """HF ``CLIPModel`` state dict (vision tower and visual_projection) ->
    the tree of ``models/clip.py``."""
    r = _Reader(lambda k: sd[k], dtype, device)
    L = cfg.num_layers
    vp = "vision_model."
    lyr = vp + "encoder.layers.{}."

    def proj(name):
        return {"w": r.stack(lyr + f"self_attn.{name}.weight", L),
                "b": r.stack(lyr + f"self_attn.{name}.bias", L, False)}

    def fc(name):
        return {"w": r.stack(lyr + f"mlp.{name}.weight", L),
                "b": r.stack(lyr + f"mlp.{name}.bias", L, False)}

    # Conv2d [out, in, kh, kw] -> HWIO
    patch = _t(sd[vp + "embeddings.patch_embedding.weight"]).permute(
        2, 3, 1, 0)
    return {
        "class_embedding": r.one(vp + "embeddings.class_embedding"),
        "patch_embedding": r.put(patch),
        "position_embedding": r.one(
            vp + "embeddings.position_embedding.weight"),
        # HF spells the pre-encoder LayerNorm "pre_layrnorm"
        "pre_layernorm": {"w": r.one(vp + "pre_layrnorm.weight"),
                          "b": r.one(vp + "pre_layrnorm.bias")},
        "layers": {
            "ln1": _ln(r, lyr + "layer_norm1.weight",
                       lyr + "layer_norm1.bias", L),
            "ln2": _ln(r, lyr + "layer_norm2.weight",
                       lyr + "layer_norm2.bias", L),
            "attn": {"q": proj("q_proj"), "k": proj("k_proj"),
                     "v": proj("v_proj"), "o": proj("out_proj")},
            "mlp": {"fc1": fc("fc1"), "fc2": fc("fc2")},
        },
        "post_layernorm": {"w": r.one(vp + "post_layernorm.weight"),
                           "b": r.one(vp + "post_layernorm.bias")},
        "visual_projection": r.one("visual_projection.weight",
                                   transpose=True),
    }


def _conv1d_wio(x) -> torch.Tensor:
    """torch Conv1d weight [C_out, C_in, k] -> [k, C_in, C_out]."""
    return _t(x).permute(2, 1, 0)


def import_whisper_encoder(sd: Mapping[str, object], cfg: WhisperConfig,
                           dtype=torch.float32, device="cpu",
                           prefix: str = "") -> dict:
    """HF ``WhisperModel`` state dict (the encoder half) -> the tree of
    ``models/whisper.py``. Keys are looked up under ``prefix``, then
    ``model.``, then bare."""
    def get(k):
        for p in (prefix, "model.", ""):
            if p + k in sd:
                return sd[p + k]
        raise KeyError(k)

    r = _Reader(get, dtype, device)
    L = cfg.encoder_layers
    lyr = "encoder.layers.{}."

    def proj(name, bias=True):
        w = r.stack(lyr + f"self_attn.{name}.weight", L)
        if not bias:  # Whisper's k_proj has no bias
            return {"w": w, "b": r.put(torch.zeros(L, cfg.d_model))}
        return {"w": w, "b": r.stack(lyr + f"self_attn.{name}.bias", L,
                                     False)}

    def fc(name):
        return {"w": r.stack(lyr + f"{name}.weight", L),
                "b": r.stack(lyr + f"{name}.bias", L, False)}

    return {
        "conv1": {"w": r.put(_conv1d_wio(get("encoder.conv1.weight"))),
                  "b": r.one("encoder.conv1.bias")},
        "conv2": {"w": r.put(_conv1d_wio(get("encoder.conv2.weight"))),
                  "b": r.one("encoder.conv2.bias")},
        "embed_positions": r.one("encoder.embed_positions.weight"),
        "layers": {
            "self_attn_ln": _ln(r, lyr + "self_attn_layer_norm.weight",
                                lyr + "self_attn_layer_norm.bias", L),
            "attn": {"q": proj("q_proj"), "k": proj("k_proj", bias=False),
                     "v": proj("v_proj"), "o": proj("out_proj")},
            "final_ln": _ln(r, lyr + "final_layer_norm.weight",
                            lyr + "final_layer_norm.bias", L),
            "mlp": {"fc1": fc("fc1"), "fc2": fc("fc2")},
        },
        "layer_norm": {"w": r.one("encoder.layer_norm.weight"),
                       "b": r.one("encoder.layer_norm.bias")},
    }


def _torch_mha_params(sd: Mapping[str, object], prefix: str,
                      dtype=torch.float32, device="cpu") -> dict:
    """A ``torch.nn.MultiheadAttention`` state-dict slice -> the tree of
    ``ops.attention.torch_mha_apply``."""
    r = _Reader(lambda k: sd[prefix + k], dtype, device)
    p = {"in_proj_w": r.one("in_proj_weight"),
         "in_proj_b": r.one("in_proj_bias"),
         "out_proj_w": r.one("out_proj.weight"),
         "out_proj_b": r.one("out_proj.bias")}
    if prefix + "bias_k" in sd:
        p["bias_k"] = r.put(_t(sd[prefix + "bias_k"])[0, 0])
        p["bias_v"] = r.put(_t(sd[prefix + "bias_v"])[0, 0])
    return p


def _linear_params(sd: Mapping[str, object], prefix: str,
                   dtype=torch.float32, device="cpu") -> dict:
    r = _Reader(lambda k: sd[prefix + k], dtype, device)
    return {"w": r.one("weight", transpose=True), "b": r.one("bias")}


def _conv1d_params(sd: Mapping[str, object], prefix: str,
                   dtype=torch.float32, device="cpu") -> dict:
    r = _Reader(lambda k: sd[prefix + k], dtype, device)
    return {"w": r.put(_conv1d_wio(sd[prefix + "weight"])),
            "b": r.one("bias")}


def sub_state_dict(sd: Mapping[str, object],
                   prefix: str) -> Dict[str, object]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def import_mm_llms(sd: Mapping[str, object], cfg, dtype=torch.float32,
                   device="cpu") -> dict:
    """The reference MM_LLMs state dict -> the whole fusion-model tree
    (``cfg``: a ``ModelConfig``)."""
    kw = dict(dtype=dtype, device=device)

    def mha(name):
        return _torch_mha_params(sd, name + ".", **kw)

    return {
        "image_encoder": import_clip_vision(
            sub_state_dict(sd, "image_encoder."), cfg.vision, **kw),
        "video_encoder": import_clip_vision(
            sub_state_dict(sd, "video_encoder."), cfg.vision, **kw),
        "audio_encoder": import_whisper_encoder(
            sub_state_dict(sd, "audio_encoder."), cfg.audio, **kw),
        "llm": import_llama(sd, cfg.llm, prefix="llm.", **kw),
        "fusion": {
            "image_align": mha("image_align_attention"),
            "audio_align": mha("audio_align_attention"),
            "video_align": mha("video_align_attention"),
            "video_long_attn": mha("video_long_self_attention"),
            "temporal_attn": mha("temporal_self_attention"),
            "temporal_pos_emb": _Reader(sd.__getitem__, dtype, device).one(
                "temporal_position_embeddings.weight"),
            "to_hidden": {
                mod: _linear_params(sd, f"transform_{mod}_to_hidden.", **kw)
                for mod in ("video", "audio", "image")},
            "conv": {mod: _conv1d_params(sd, f"project_{mod}.", **kw)
                     for mod in ("image", "video", "audio")},
        },
    }
