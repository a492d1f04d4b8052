"""The Macaw model in plain PyTorch, float32, written from the published
description and not from the program: the Whisper log-mel front end, the
CLIP ViT and Whisper encoders, the video self-attention with Macaw's
sinusoidal positions, the VALID conv downsampling, the projection to the
LLM width, the alignment attention (``torch.nn.MultiheadAttention`` with
bias_k/bias_v and a zero row) over the whole token-embedding matrix, the
splice, and a LLaMA-architecture decoder (RMSNorm, rotate-half RoPE,
SwiGLU, untied head).

Weights come as the benchmark's tree (``weights.make_tree``): layers
stacked on a leading axis, [in, out] matmul weights. Every function casts
what it reads to float32. Nothing here imports the program.

Departures from a generic description, each Macaw's own: the CLIP patch
tokens are projected without the post-layernorm and the CLS token is
dropped; the video positions use Macaw's sinusoid, whose pair i has the
frequency 10000^(-2i/d) with i stepping by 2.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Macaw-LLM's added tokens around each modality's block
MARKERS = {"image": (32000, 32001), "audio": (32002, 32003),
           "video": (32004, 32005)}
IGNORE = -100
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# --------------------------------------------------------------------------
# media front ends
# --------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    safe = np.maximum(f, min_log_hz)
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep, mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa's slaney mel filterbank [n_mels, n_fft // 2 + 1]."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fft_freqs)
    w = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        w[i] = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w


def log_mel(audio: torch.Tensor, acfg: dict) -> torch.Tensor:
    """Whisper's front end: [B, samples] -> [B, mels, frames]."""
    n_fft, hop = acfg["n_fft"], acfg["hop_length"]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                               device=audio.device)
    stft = torch.stft(audio.double(), n_fft, hop, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filt = torch.from_numpy(mel_filters(acfg["sample_rate"], n_fft,
                                        acfg["num_mel_bins"])).to(audio.device)
    mel = torch.log10(torch.clamp(filt @ power, min=1e-10))
    mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
    return f32((mel + 4.0) / 4.0)


def pixels(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [N, size, size, 3] -> CLIP-normalized [N, 3, size, size]. The
    traffic draws frames at the tower's size, so no resize is needed."""
    if tuple(frames.shape[1:3]) != (size, size):
        raise ValueError(f"frames {tuple(frames.shape)}: the reference takes "
                         f"{size}x{size} frames")
    x = f32(frames) / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------

def layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], f32(p["w"]), f32(p["b"]), eps)


def linear(x, w, b=None):
    y = x @ f32(w)
    return y if b is None else y + f32(b)


def self_attention(x, p: dict, heads: int) -> torch.Tensor:
    """Encoder self-attention with separate q/k/v/o [in, out] weights."""
    b, s, e = x.shape
    d = e // heads

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)

    q = split(linear(x, p["q"]["w"], p["q"]["b"]))
    k = split(linear(x, p["k"]["w"], p["k"]["b"]))
    v = split(linear(x, p["v"]["w"], p["v"]["b"]))
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, s, e)
    return linear(o, p["o"]["w"], p["o"]["b"])


def _layer(tree: dict, i: int) -> dict:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def clip_patches(t: dict, vcfg: dict, px: torch.Tensor) -> torch.Tensor:
    """CLIP ViT: [N, 3, H, W] -> projected patch tokens [N, P, proj]."""
    p, h = vcfg["patch_size"], vcfg["hidden_size"]
    eps = vcfg["layer_norm_eps"]
    w = f32(t["patch_embedding"]).permute(3, 2, 0, 1)      # [h, 3, p, p]
    x = F.conv2d(px, w, stride=p).flatten(2).transpose(1, 2)
    cls = f32(t["class_embedding"]).expand(x.shape[0], 1, h)
    x = torch.cat([cls, x], 1) + f32(t["position_embedding"])[None]
    x = layer_norm(x, t["pre_layernorm"], eps)
    for i in range(vcfg["num_hidden_layers"]):
        lp = _layer(t["layers"], i)
        x = x + self_attention(layer_norm(x, lp["ln1"], eps), lp["attn"],
                               vcfg["num_attention_heads"])
        m = linear(layer_norm(x, lp["ln2"], eps), lp["mlp"]["fc1"]["w"],
                   lp["mlp"]["fc1"]["b"])
        m = m * torch.sigmoid(1.702 * m)
        x = x + linear(m, lp["mlp"]["fc2"]["w"], lp["mlp"]["fc2"]["b"])
    return linear(x, t["visual_projection"])[:, 1:]


def whisper_encode(t: dict, acfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """Whisper encoder: [N, mels, frames] -> [N, frames / 2, d]."""
    eps = 1e-5
    x = F.gelu(F.conv1d(mel, f32(t["conv1"]["w"]).permute(2, 1, 0),
                        f32(t["conv1"]["b"]), padding=1))
    x = F.gelu(F.conv1d(x, f32(t["conv2"]["w"]).permute(2, 1, 0),
                        f32(t["conv2"]["b"]), stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + f32(t["embed_positions"])[None, :x.shape[1]]
    for i in range(acfg["encoder_layers"]):
        lp = _layer(t["layers"], i)
        x = x + self_attention(layer_norm(x, lp["self_attn_ln"], eps),
                               lp["attn"], acfg["encoder_attention_heads"])
        m = F.gelu(linear(layer_norm(x, lp["final_ln"], eps),
                          lp["mlp"]["fc1"]["w"], lp["mlp"]["fc1"]["b"]))
        x = x + linear(m, lp["mlp"]["fc2"]["w"], lp["mlp"]["fc2"]["b"])
    return layer_norm(x, t["layer_norm"], eps)


def macaw_sinusoid(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(0, dim, 2, dtype=torch.float64, device=device)[None]
    ang = pos * torch.exp(-(math.log(10000.0) / dim) * (2.0 * i))
    pe = torch.zeros((length, dim), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return f32(pe)


# --------------------------------------------------------------------------
# torch.nn.MultiheadAttention with bias_k/bias_v and add_zero_attn
# --------------------------------------------------------------------------

def mha_kv(p: dict, memory: torch.Tensor):
    """K and V rows of a memory [.., M, E] with the bias row and the zero
    row appended: [.., M + 2, E] each."""
    w, b = f32(p["in_proj_w"]), f32(p["in_proj_b"])
    e = w.shape[1]
    k = memory @ w[e:2 * e].T + b[e:2 * e]
    v = memory @ w[2 * e:].T + b[2 * e:]
    lead = memory.shape[:-2]
    extra_k = torch.stack([f32(p["bias_k"]), torch.zeros_like(b[:e])])
    extra_v = torch.stack([f32(p["bias_v"]), torch.zeros_like(b[:e])])
    return (torch.cat([k, extra_k.expand(*lead, 2, e)], -2),
            torch.cat([v, extra_v.expand(*lead, 2, e)], -2))


def mha(p: dict, heads: int, query: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, keep: Optional[torch.Tensor] = None,
        rate: float = 0.0) -> torch.Tensor:
    """query [B, Sq, E]; k, v [Sk, E] (shared by the batch) or [B, Sk, E];
    ``keep`` a [B, heads, Sq, Sk] keep-mask of attention dropout at
    ``rate`` (kept probabilities scaled by 1 / (1 - rate))."""
    w, bias = f32(p["in_proj_w"]), f32(p["in_proj_b"])
    bsz, sq, e = query.shape
    d = e // heads
    q = (query @ w[:e].T + bias[:e]).reshape(bsz, sq, heads, d)
    kh = k.reshape(*k.shape[:-1], heads, d)
    vh = v.reshape(*v.shape[:-1], heads, d)
    eq = "bqnd,knd->bnqk" if k.dim() == 2 else "bqnd,bknd->bnqk"
    a = torch.softmax(torch.einsum(eq, q, kh) / math.sqrt(d), dim=-1)
    if keep is not None:
        a = torch.where(keep, a, 0.0) / (1.0 - rate)
    eq = "bnqk,knd->bqnd" if k.dim() == 2 else "bnqk,bknd->bqnd"
    o = torch.einsum(eq, a, vh).reshape(bsz, sq, e)
    return o @ f32(p["out_proj_w"]).T + f32(p["out_proj_b"])


def quant_rows(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-row quantization over the last axis, returned
    dequantized."""
    top = 2 ** (bits - 1) - 1
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / top)
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def quant_columns(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-output-column quantization of an [in, out] weight
    (the max over the input axis), returned dequantized in float32."""
    top = 2 ** (bits - 1) - 1
    wf = f32(w)
    scale = wf.abs().amax(-2, keepdim=True) / top
    return torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)),
                       -top, top) * scale


# --------------------------------------------------------------------------
# fusion
# --------------------------------------------------------------------------

def conv_down(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    w = f32(p["w"]).permute(2, 1, 0)                       # [out, in, k]
    return F.conv1d(x.transpose(1, 2), w, f32(p["b"]),
                    stride=stride).transpose(1, 2)


def media_features(tree: dict, cfg: dict, image, audio, video,
                   video_keep=None, rate: float = 0.0) -> dict:
    """The three modalities' features before the conv, from raw media:
    image uint8 [B, H, W, 3], audio fp32 [B, samples], video uint8
    [B, F, H, W, 3]."""
    v, a = cfg["vision"], cfg["audio"]
    size = v["image_size"]
    b, nf = video.shape[:2]
    with torch.no_grad():
        img = clip_patches(tree["image_encoder"], v, pixels(image, size))
        vid = clip_patches(tree["video_encoder"], v,
                           pixels(video.reshape(b * nf, size, size, 3), size))
        aud = whisper_encode(tree["audio_encoder"], a, log_mel(audio, a))
    vid = vid.reshape(b, -1, vid.shape[-1])
    vid = vid + macaw_sinusoid(vid.shape[1], vid.shape[2], vid.device)[None]
    p = tree["fusion"]["video_long_attn"]
    k, vv = mha_kv(p, vid)
    vid = mha(p, cfg["fusion"]["attention_heads"], vid, k, vv, video_keep,
              rate)
    return {"image": img, "audio": aud, "video": vid}


def align_memory(tree: dict, cache: bool, bits: int = 8) -> dict:
    """Per modality, the alignment's K and V rows over the whole token
    embedding ([V + 2, E] each); ``cache`` quantizes every row to ``bits``
    bits (the int8 alignment cache of the training form)."""
    memory = f32(tree["llm"]["embed_tokens"])
    out = {}
    for mod in ("image", "audio", "video"):
        with torch.no_grad():
            k, v = mha_kv(tree["fusion"][f"{mod}_align"], memory)
            if cache:
                k, v = quant_rows(k, bits), quant_rows(v, bits)
        out[mod] = (k, v)
    return out


def fuse(tree: dict, cfg: dict, feats: dict, kv: dict, ids: torch.Tensor,
         keeps: Optional[dict] = None, rate: float = 0.0) -> torch.Tensor:
    """[BOS][<image> i </image>][<audio> a </audio>][<video> v </video>]
    [text]: the fused embeddings [B, P + S, H] of ``ids`` [B, S] (BOS
    first) and the modalities' features."""
    f = cfg["fusion"]
    emb = f32(tree["llm"]["embed_tokens"])
    b = ids.shape[0]
    parts = [emb[ids[:, :1]]]
    for mod in ("image", "audio", "video"):
        x = conv_down(tree["fusion"]["conv"][mod], feats[mod],
                      f[f"{mod}_conv_stride"])
        th = tree["fusion"]["to_hidden"][mod]
        x = linear(x, th["w"], th["b"])
        k, v = kv[mod]
        keep = None if keeps is None else keeps.get(mod)
        x = mha(tree["fusion"][f"{mod}_align"], 2 * f["attention_heads"], x,
                k, v, keep, rate)
        start, end = MARKERS[mod]
        parts += [emb[start].expand(b, 1, -1), x, emb[end].expand(b, 1, -1)]
    parts.append(emb[ids[:, 1:]])
    return torch.cat(parts, 1)


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f32(w)


def rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate-half RoPE of x [B, S, N, D] at integer positions [B, S]."""
    d = x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64,
                                      device=x.device) / d)
    ang = pos.double()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = f32(torch.cos(ang))[:, :, None], f32(torch.sin(ang))[:, :, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def decoder_layer(cfg: dict, lp: dict, h: torch.Tensor, pos: torch.Tensor,
                  mask: torch.Tensor, lora: Optional[dict] = None,
                  lora_scale: float = 1.0,
                  kv_bits: Optional[int] = None) -> torch.Tensor:
    """One pre-norm decoder layer over h [B, S, H]; ``mask`` [B, 1, S, S]
    boolean, True where a query sees a key; ``lora`` A/B factors on q and
    v; ``kv_bits`` stores each position's key (after RoPE) and value per
    head quantized over the head dim, as a quantized KV cache holds
    them."""
    b, s, hd = h.shape
    n, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = hd // n
    eps = cfg["rms_norm_eps"]
    x = rms_norm(h, lp["input_norm"], eps)
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if lora is not None:
        q = q + (x @ lora["qa"]) @ lora["qb"] * lora_scale
        v = v + (x @ lora["va"]) @ lora["vb"] * lora_scale
    q = rope(q.reshape(b, s, n, d), pos, cfg["rope_theta"])
    k = rope(k.reshape(b, s, nkv, d), pos, cfg["rope_theta"])
    v = v.reshape(b, s, nkv, d)
    if kv_bits:
        k, v = quant_rows(k, kv_bits), quant_rows(v, kv_bits)
    if nkv != n:
        k = k.repeat_interleave(n // nkv, dim=2)
        v = v.repeat_interleave(n // nkv, dim=2)
    att = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(d)
    att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bnqk,bknd->bqnd", att, v).reshape(b, s, hd)
    h = h + o @ lp["wo"]
    x = rms_norm(h, lp["post_norm"], eps)
    return h + (F.silu(x @ lp["gate"]) * (x @ lp["up"])) @ lp["down"]


def causal(lengths, s: int, device) -> torch.Tensor:
    """[B, 1, S, S] mask: causal within each row's first ``lengths`` keys
    (right padding)."""
    i = torch.arange(s, device=device)
    m = i[None, :] <= i[:, None]
    valid = i[None, :] < torch.as_tensor(lengths, device=device)[:, None]
    return (m[None] & valid[:, None, :])[:, None]


LAYER_KEYS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
              ("attn", "wo"), ("mlp", "gate"), ("mlp", "up"),
              ("mlp", "down"))


def layer_weights(llm: dict, i: int, bits: Optional[int] = None) -> dict:
    """Layer ``i``'s decoder weights in float32; ``bits`` quantizes each
    matmul weight per output column first."""
    out = {"input_norm": f32(llm["layers"]["input_norm"][i]),
           "post_norm": f32(llm["layers"]["post_norm"][i])}
    for group, name in LAYER_KEYS:
        w = llm["layers"][group][name][i]
        out[name] = quant_columns(w, bits) if bits else f32(w)
    return out
