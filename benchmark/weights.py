"""Seeded random weights of a configuration, made on the device.

The tree has the layout the program takes (nested dicts, layers stacked on
a leading [L] axis, [in, out] matmul weights, ``torch.nn.MultiheadAttention``
records for the fusion's attentions), and the values are the benchmark's
own: the program's initializers are not used, so the reference reads the
same numbers without reading anything the program made. Every leaf is one
call of a generator on the card (a stacked leaf holds all its layers), in
bf16, the type the weights are served in; the same seed gives the same
tree, so the reference draws it again after the measured window instead of
keeping a copy beside the program.

Norm weights are near one and biases near zero but not exactly, so that a
dropped scale or bias shows in the comparison with the reference.
"""

from __future__ import annotations

import math

import torch

STD = 0.02


class _Draw:
    def __init__(self, seed: int, device, dtype=torch.bfloat16):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device, self.dtype = device, dtype

    def normal(self, shape, std: float = STD, mean: float = 0.0):
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=self.dtype)
        x.mul_(std)
        if mean:
            x.add_(mean)
        return x

    def uniform(self, shape, limit: float):
        x = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=self.dtype)
        return x.mul_(2.0 * limit).sub_(limit)

    def norm(self, shape):
        return self.normal(shape, 0.05, 1.0)

    def bias(self, shape):
        return self.normal(shape, 0.01)


def _clip(d: _Draw, v: dict) -> dict:
    h, i, L = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    p = v["patch_size"]
    t = (v["image_size"] // p) ** 2 + 1
    return {
        "class_embedding": d.normal((h,)),
        "patch_embedding": d.normal((p, p, 3, h)),
        "position_embedding": d.normal((t, h)),
        "pre_layernorm": {"w": d.norm((h,)), "b": d.bias((h,))},
        "layers": {
            "ln1": {"w": d.norm((L, h)), "b": d.bias((L, h))},
            "ln2": {"w": d.norm((L, h)), "b": d.bias((L, h))},
            "attn": {n: {"w": d.normal((L, h, h)), "b": d.bias((L, h))}
                     for n in ("q", "k", "v", "o")},
            "mlp": {"fc1": {"w": d.normal((L, h, i)), "b": d.bias((L, i))},
                    "fc2": {"w": d.normal((L, i, h)), "b": d.bias((L, h))}},
        },
        "post_layernorm": {"w": d.norm((h,)), "b": d.bias((h,))},
        "visual_projection": d.normal((h, v["projection_dim"])),
    }


def _whisper(d: _Draw, a: dict) -> dict:
    m, f, L = a["d_model"], a["encoder_ffn_dim"], a["encoder_layers"]
    return {
        "conv1": {"w": d.normal((3, a["num_mel_bins"], m)),
                  "b": d.bias((m,))},
        "conv2": {"w": d.normal((3, m, m)), "b": d.bias((m,))},
        "embed_positions": d.normal((a["max_source_positions"], m)),
        "layers": {
            "self_attn_ln": {"w": d.norm((L, m)), "b": d.bias((L, m))},
            "attn": {n: {"w": d.normal((L, m, m)), "b": d.bias((L, m))}
                     for n in ("q", "k", "v", "o")},
            "final_ln": {"w": d.norm((L, m)), "b": d.bias((L, m))},
            "mlp": {"fc1": {"w": d.normal((L, m, f)), "b": d.bias((L, f))},
                    "fc2": {"w": d.normal((L, f, m)), "b": d.bias((L, m))}},
        },
        "layer_norm": {"w": d.norm((m,)), "b": d.bias((m,))},
    }


def _llama(d: _Draw, c: dict) -> dict:
    h, i, L = c["hidden_size"], c["intermediate_size"], \
        c["num_hidden_layers"]
    kv = c["num_key_value_heads"] * (h // c["num_attention_heads"])
    v = c["vocab_size"]
    return {
        "embed_tokens": d.normal((v, h)),
        "layers": {
            "attn": {"wq": d.normal((L, h, h)), "wk": d.normal((L, h, kv)),
                     "wv": d.normal((L, h, kv)), "wo": d.normal((L, h, h))},
            "mlp": {"gate": d.normal((L, h, i)), "up": d.normal((L, h, i)),
                    "down": d.normal((L, i, h))},
            "input_norm": d.norm((L, h)),
            "post_norm": d.norm((L, h)),
        },
        "norm": d.norm((h,)),
        "lm_head": d.normal((h, v)),
    }


def _mha(d: _Draw, e: int) -> dict:
    """``torch.nn.MultiheadAttention`` with bias_k/bias_v: the packed
    in-projection [3E, E] and the out-projection [E, E] in torch's
    [out, in] layout."""
    return {"in_proj_w": d.uniform((3 * e, e), math.sqrt(6.0 / (4 * e))),
            "in_proj_b": d.bias((3 * e,)),
            "out_proj_w": d.uniform((e, e), math.sqrt(3.0 / e)),
            "out_proj_b": d.bias((e,)),
            "bias_k": d.normal((e,), math.sqrt(2.0 / (1 + e))),
            "bias_v": d.normal((e,), math.sqrt(2.0 / (1 + e)))}


def _fusion(d: _Draw, c: dict) -> dict:
    h = c["hidden_size"]
    pd = c["vision"]["projection_dim"]
    dm = c["audio"]["d_model"]
    f = c["fusion"]

    def linear(din, dout):
        lim = 1.0 / math.sqrt(din)
        return {"w": d.uniform((din, dout), lim),
                "b": d.uniform((dout,), lim)}

    def conv(ch, k):
        lim = 1.0 / math.sqrt(ch * k)
        return {"w": d.uniform((k, ch, ch), lim), "b": d.uniform((ch,), lim)}

    return {
        "image_align": _mha(d, h), "audio_align": _mha(d, h),
        "video_align": _mha(d, h), "video_long_attn": _mha(d, pd),
        "to_hidden": {"video": linear(pd, h), "audio": linear(dm, h),
                      "image": linear(pd, h)},
        "conv": {"image": conv(pd, f["image_conv_kernel"]),
                 "video": conv(pd, f["video_conv_kernel"]),
                 "audio": conv(dm, f["audio_conv_kernel"])},
        # the pooled-video path's leaves (the long path does not read them)
        "temporal_attn": _mha(d, pd),
        "temporal_pos_emb": d.normal((f["n_frames"], pd), 1.0),
    }


def make_tree(cfg: dict, seed: int, device, lora_rank: int = 0) -> dict:
    """The whole model's weights from ``seed`` on ``device``, in bf16.
    With ``lora_rank`` > 0, the LoRA adapters on q and v (A uniform, B
    zero, so the adapted model starts as the base) under
    ``llm/layers/lora``."""
    d = _Draw(seed, device)
    tree = {"image_encoder": _clip(d, cfg["vision"]),
            "video_encoder": _clip(d, cfg["vision"]),
            "audio_encoder": _whisper(d, cfg["audio"]),
            "llm": _llama(d, cfg),
            "fusion": _fusion(d, cfg)}
    if lora_rank > 0:
        h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
        kv = cfg["num_key_value_heads"] * (h // cfg["num_attention_heads"])
        lim = math.sqrt(6.0 / h)
        tree["llm"]["layers"]["lora"] = {
            "qa": d.uniform((L, h, lora_rank), lim),
            "qb": torch.zeros((L, lora_rank, h), dtype=d.dtype,
                              device=device),
            "va": d.uniform((L, h, lora_rank), lim),
            "vb": torch.zeros((L, lora_rank, kv), dtype=d.dtype,
                              device=device)}
    return tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix: str = "") -> dict:
    """{"a/b/c": tensor} of a nested tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
