"""Multimodal fusion (counterpart of ``macaw_llm_tpu/models/fusion.py``).

CLIP image and 6-frame video encoders, the Whisper encoder, VALID Conv1d
sequence downsamplers, linear adapters to the LLM width, alignment
cross-attention (modality features as queries, the LLM's token-embedding
matrix as keys/values) and the prefix splice:

    [BOS][<image> im </image>][<audio> au </audio>][<video> vi </video>][text]

``forward`` is the training forward: the fused batch, labels extended
with IGNORE_ID over the prefix, the LLaMA stack (remat and LoRA from the
config and arguments) and the loss, chunked when ``cfg.loss_chunk`` > 0.
A ``dropout_rng`` (a CPU ``torch.Generator``) turns on the alignment and
video-long attention dropout. A tower whose parameters take no gradient
(frozen) runs under ``torch.no_grad()``.

Not ported yet: ``encode_video_simple`` (unused by the reference's forward)
and Whisper LayerDrop (off in the reference's configuration).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from macaw_llm_tpu_torch.config import (AUDIO_END, AUDIO_START, IGNORE_ID,
                                        IMAGE_END, IMAGE_START, ModelConfig,
                                        VIDEO_END, VIDEO_START)
from macaw_llm_tpu_torch.models import clip, llama, whisper
from macaw_llm_tpu_torch.models._tree import normal, uniform, zeros
from macaw_llm_tpu_torch.ops.attention import (
    pack_mha, shared_kv_project, torch_mha_apply,
    torch_mha_apply_shared_kv_dropout, torch_mha_apply_shared_kv_einsum,
    torch_mha_apply_shared_kv_flash)
from macaw_llm_tpu_torch.ops.linear import dense

# alignment logits above this many bytes go to the flash kernel
ALIGN_EINSUM_MAX_BYTES = int(4e8)


class FusedBatch(NamedTuple):
    inputs_embeds: torch.Tensor                   # [B, P+S, H]
    attention_mask: Optional[torch.Tensor]        # [B, P+S]
    labels: Optional[torch.Tensor] = None         # [B, P+S]


def _frozen(tree) -> contextlib.AbstractContextManager:
    """``torch.no_grad()`` when no tensor of ``tree`` takes a gradient."""
    def grads(t):
        if isinstance(t, dict):
            return any(grads(v) for v in t.values())
        return isinstance(t, torch.Tensor) and t.requires_grad
    return contextlib.nullcontext() if grads(tree) else torch.no_grad()


def _torch_mha_init(gen, e: int, dtype) -> dict:
    """torch.nn.MultiheadAttention init: xavier-uniform in_proj [3E, E],
    uniform(1/sqrt(E)) out_proj, xavier-normal bias_k/bias_v, zero
    biases."""
    std_kv = math.sqrt(2.0 / (1 + e))
    return {
        "in_proj_w": uniform(gen, (3 * e, e), math.sqrt(6.0 / (4 * e)),
                             dtype),
        "in_proj_b": zeros(gen, (3 * e,), dtype),
        "out_proj_w": uniform(gen, (e, e), math.sqrt(3.0 / e), dtype),
        "out_proj_b": zeros(gen, (e,), dtype),
        "bias_k": normal(gen, (e,), std_kv, dtype),
        "bias_v": normal(gen, (e,), std_kv, dtype),
    }


def init_params(seed: int, cfg: ModelConfig, *, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random weights of the whole model from ``seed``, made on
    ``device`` (the GPU unless ``device="cpu"`` is asked for)."""
    from macaw_llm_tpu_torch import resolve_device
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h = cfg.llm.hidden_size
    pd = cfg.vision.projection_dim
    dm = cfg.audio.d_model

    def linear(din, dout):
        lim = 1.0 / math.sqrt(din)
        return {"w": uniform(gen, (din, dout), lim, dtype),
                "b": uniform(gen, (dout,), lim, dtype)}

    def conv1d(ch, kernel):
        lim = 1.0 / math.sqrt(ch * kernel)
        return {"w": uniform(gen, (kernel, ch, ch), lim, dtype),
                "b": uniform(gen, (ch,), lim, dtype)}

    return {
        "image_encoder": clip.init_params(gen, cfg.vision, dtype),
        "video_encoder": clip.init_params(gen, cfg.vision, dtype),
        "audio_encoder": whisper.init_params(gen, cfg.audio, dtype),
        "llm": llama.init_params(gen, cfg.llm, dtype),
        "fusion": {
            "image_align": _torch_mha_init(gen, h, dtype),
            "audio_align": _torch_mha_init(gen, h, dtype),
            "video_align": _torch_mha_init(gen, h, dtype),
            "video_long_attn": _torch_mha_init(gen, pd, dtype),
            "to_hidden": {"video": linear(pd, h), "audio": linear(dm, h),
                          "image": linear(pd, h)},
            "conv": {"image": conv1d(pd, cfg.fusion.image_conv_kernel),
                     "video": conv1d(pd, cfg.fusion.video_conv_kernel),
                     "audio": conv1d(dm, cfg.fusion.audio_conv_kernel)},
        },
    }


def sinusoidal_pe(length: int, dim: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """The reference's sinusoidal PE with its quirk: the frequency of pair
    i is 10000^(-2i/dim) with i stepping by 2 (not 10000^(-i/dim))."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[None, :]
    div_term = torch.exp(-(math.log(10000.0) / dim) * (2.0 * i))
    angles = pos * div_term
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


def encode_image(params: dict, cfg: ModelConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, P, projection_dim]."""
    with _frozen(params["image_encoder"]):
        return clip.encode_patches(params["image_encoder"], cfg.vision,
                                   images, use_flash=cfg.tower_flash)


def encode_video_long(params: dict, cfg: ModelConfig,
                      videos: torch.Tensor,
                      dropout_rng: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """[B, F, 3, H, W] -> [B, F*P, projection_dim]: per-frame patch tokens
    concatenated over frames, the sinusoidal PE, one self-attention (with
    attention dropout when ``dropout_rng`` is given)."""
    b, f = videos.shape[:2]
    frames = videos.reshape((b * f,) + tuple(videos.shape[2:]))
    with _frozen(params["video_encoder"]):
        feats = clip.encode_patches(params["video_encoder"], cfg.vision,
                                    frames, use_flash=cfg.tower_flash)
    feats = feats.reshape(b, f * feats.shape[1], feats.shape[2])
    feats = feats + sinusoidal_pe(feats.shape[1], feats.shape[2],
                                  feats.dtype, feats.device)[None]
    return torch_mha_apply(params["fusion"]["video_long_attn"],
                           cfg.fusion.attention_heads, feats, feats, feats,
                           add_zero_attn=True,
                           dropout_rate=cfg.fusion.align_dropout,
                           dropout_rng=dropout_rng,
                           use_flash=cfg.tower_flash)


def encode_audio(params: dict, cfg: ModelConfig,
                 audios: torch.Tensor) -> torch.Tensor:
    """[B, 80, 3000] -> [B, 1500, d_model]."""
    with _frozen(params["audio_encoder"]):
        return whisper.encode(params["audio_encoder"], cfg.audio, audios,
                              use_flash=cfg.tower_flash)


def _conv_downsample(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Channel-preserving VALID Conv1d over the sequence axis, [B, L, C]
    -> [B, L', C], WIO kernel."""
    return whisper.conv1d_nwc(x, p["w"], stride, 0) + p["b"].to(x.dtype)


def _align(p: dict, heads: int, feats: torch.Tensor,
           memory: Optional[torch.Tensor], kv_cache=None,
           dropout_rate: float = 0.0,
           rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Alignment cross-attention: Q = modality features, K = V = the token
    embedding memory. With a cache, the einsum over the (int8) cached rows
    while its fp32 logits stay within ALIGN_EINSUM_MAX_BYTES, else the
    flash kernel over the dequantized rows; without one, the flash kernel
    over the memory projected here. With dropout (``rng`` given, rate > 0)
    the chunked dropout attention over the dequantized cache or the memory.
    """
    if rng is not None and dropout_rate > 0.0:
        kv = None
        if kv_cache is not None:
            kv = (_dequant_rows(kv_cache["k"], feats.dtype),
                  _dequant_rows(kv_cache["v"], feats.dtype))
        return torch_mha_apply_shared_kv_dropout(
            p, heads, feats, memory, rate=dropout_rate, rng=rng,
            add_zero_attn=True, kv_cache=kv)
    if kv_cache is not None:
        b, sq, _ = feats.shape
        m2 = kv_cache["k"][0].shape[0]
        if b * heads * sq * m2 * 4 <= ALIGN_EINSUM_MAX_BYTES:
            return torch_mha_apply_shared_kv_einsum(
                p, heads, feats, (kv_cache["k"], kv_cache["v"]))
        kv = (_dequant_rows(kv_cache["k"], feats.dtype),
              _dequant_rows(kv_cache["v"], feats.dtype))
        return torch_mha_apply_shared_kv_flash(p, heads, feats, memory,
                                               kv_cache=kv)
    return torch_mha_apply_shared_kv_flash(p, heads, feats, memory,
                                           add_zero_attn=True)


def _quant_rows(x: torch.Tensor):
    """Symmetric per-row int8: [M, E] -> (int8 [M, E], fp32 scale [M, 1])."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(amax == 0.0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant_rows(entry, dtype) -> torch.Tensor:
    q, scale = entry
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale).to(dtype)


def precompute_align_cache(params: dict, cfg: ModelConfig,
                           quantize: bool = False) -> dict:
    """The alignment attentions' batch-shared K/V projections of the
    token-embedding memory: {mod: {"k": (rows, scale), "v": (rows,
    scale)}}; scale is None for a plain cache and per-row fp32 for int8.
    Run it before ``quantize_llama``: it reads the compute-dtype
    embed_tokens, which are never quantized."""
    compute = getattr(torch, cfg.dtype)
    memory = params["llm"]["embed_tokens"].to(compute)
    if cfg.fusion.align_memory_rows is not None:
        memory = memory[:cfg.fusion.align_memory_rows]
    cache = {}
    for mod in ("image", "audio", "video"):
        k, v = shared_kv_project(params["fusion"][f"{mod}_align"], memory,
                                 add_zero_attn=True)
        if quantize:
            cache[mod] = {"k": _quant_rows(k), "v": _quant_rows(v)}
        else:
            cache[mod] = {"k": (k, None), "v": (v, None)}
    return cache


def pack_towers(params: dict) -> dict:
    """Pack each CLIP/Whisper attention layer's q/k/v into one in-proj
    (``pack_mha``; idempotent). Towers only."""
    out = dict(params)
    for tower in ("image_encoder", "video_encoder", "audio_encoder"):
        t = dict(out[tower])
        layers = dict(t["layers"])
        layers["attn"] = pack_mha(layers["attn"])
        t["layers"] = layers
        out[tower] = t
    return out


def strip_align_kv(params: dict) -> dict:
    """Drop the K/V rows of the alignment in-projections after
    ``precompute_align_cache``: the cache path reads only the Q rows."""
    out = dict(params)
    fp = dict(params["fusion"])
    for mod in ("image", "audio", "video"):
        p = dict(fp[f"{mod}_align"])
        e = p["in_proj_w"].shape[1]
        p["in_proj_w"] = p["in_proj_w"][:e]
        fp[f"{mod}_align"] = p
    out["fusion"] = fp
    return out


def _boundary(llm_params: dict, token_id: int, batch: int,
              dtype) -> torch.Tensor:
    """[B, 1, H] embedding of a boundary special token."""
    emb = llm_params["embed_tokens"][token_id].to(dtype)
    return emb.expand(batch, 1, emb.shape[0])


def prepare_inputs(params: dict, cfg: ModelConfig, *,
                   input_ids: torch.Tensor,
                   images: Optional[torch.Tensor],
                   audios: Optional[torch.Tensor],
                   videos: Optional[torch.Tensor],
                   attention_mask: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None,
                   dropout_rng: Optional[torch.Generator] = None,
                   align_cache: Optional[dict] = None) -> FusedBatch:
    """Fused embeddings, the mask extended with ones and the labels with
    IGNORE_ID over the prefix. Raw media are featurized here: waveforms
    [B, samples] -> log-mel, uint8 frames [.., H, W, 3] -> CLIP pixels.

    ``dropout_rng`` (training) turns on the attention dropout of the
    alignments and the video-long attention. Training with an
    ``align_cache`` freezes the align K/V projections: the cache is a
    constant, so the in-proj K/V rows and bias_k/bias_v take no gradient.
    """
    bids = {"image": (IMAGE_START, IMAGE_END),
            "audio": (AUDIO_START, AUDIO_END),
            "video": (VIDEO_START, VIDEO_END)}
    if audios is not None and audios.dim() == 2:
        from macaw_llm_tpu_torch.audio.mel import log_mel_spectrogram
        audios = log_mel_spectrogram(audios, n_mels=cfg.audio.num_mel_bins)
    if images is not None and images.dim() == 4 and images.shape[-1] == 3:
        from macaw_llm_tpu_torch.image.preprocess import preprocess
        images = preprocess(images, size=cfg.vision.image_size)
    if videos is not None and videos.dim() == 5 and videos.shape[-1] == 3:
        from macaw_llm_tpu_torch.image.preprocess import preprocess
        bv, fv = videos.shape[:2]
        flat = preprocess(videos.reshape((bv * fv,) + tuple(videos.shape[2:])),
                          size=cfg.vision.image_size)
        videos = flat.reshape((bv, fv) + tuple(flat.shape[1:]))
    compute = getattr(torch, cfg.dtype)
    lp = params["llm"]
    fp = params["fusion"]
    b = input_ids.shape[0]
    heads2 = cfg.fusion.attention_heads * 2
    cache = align_cache or {}
    drop = cfg.fusion.align_dropout if dropout_rng is not None else 0.0

    text_emb = llama.embed(lp, input_ids, compute)
    # K/V memory of the alignments without a cache: the whole vocab
    # embedding matrix, shared across the batch
    token_memory = lp["embed_tokens"].to(compute)
    if cfg.fusion.align_memory_rows is not None:
        token_memory = token_memory[:cfg.fusion.align_memory_rows]

    blocks = []

    def add_block(mod: str, feats: torch.Tensor, conv_stride: int) -> None:
        x = _conv_downsample(fp["conv"][mod], feats, conv_stride)
        x = dense(x, fp["to_hidden"][mod]["w"], fp["to_hidden"][mod]["b"])
        x = _align(fp[f"{mod}_align"], heads2, x, token_memory,
                   kv_cache=cache.get(mod), dropout_rate=drop,
                   rng=dropout_rng)
        blocks.append(torch.cat([_boundary(lp, bids[mod][0], b, compute), x,
                                 _boundary(lp, bids[mod][1], b, compute)], 1))

    if images is not None:
        add_block("image", encode_image(params, cfg, images.to(compute)),
                  cfg.fusion.image_conv_stride)
    if audios is not None:
        add_block("audio", encode_audio(params, cfg, audios.to(compute)),
                  cfg.fusion.audio_conv_stride)
    if videos is not None:
        add_block("video", encode_video_long(params, cfg, videos.to(compute),
                                             dropout_rng),
                  cfg.fusion.video_conv_stride)
    prefix_len = sum(blk.shape[1] for blk in blocks)

    fused = torch.cat([text_emb[:, :1]] + blocks + [text_emb[:, 1:]], dim=1)
    out_mask = None
    if attention_mask is not None:
        out_mask = torch.cat([attention_mask.new_ones((b, prefix_len)),
                              attention_mask], dim=1)
    out_labels = None
    if labels is not None:
        out_labels = torch.cat([labels.new_full((b, prefix_len), IGNORE_ID),
                                labels], dim=1)
    return FusedBatch(fused, out_mask, out_labels)


def forward(params: dict, cfg: ModelConfig, *,
            input_ids: torch.Tensor,
            images: Optional[torch.Tensor],
            audios: Optional[torch.Tensor],
            videos: Optional[torch.Tensor],
            attention_mask: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            dropout_rng: Optional[torch.Generator] = None,
            lora_scale: float = 1.0,
            align_cache: Optional[dict] = None):
    """Training forward: fuse, run the LLaMA stack over the fused
    embeddings, return (loss, logits). With ``cfg.loss_chunk`` > 0 and
    labels the loss comes from the hidden states in chunks and logits is
    None (no [B, S, V] fp32 tensor)."""
    batch = prepare_inputs(params, cfg, input_ids=input_ids, images=images,
                           audios=audios, videos=videos,
                           attention_mask=attention_mask, labels=labels,
                           dropout_rng=dropout_rng, align_cache=align_cache)
    kw = dict(attention_mask=batch.attention_mask, use_flash=cfg.use_flash,
              remat=cfg.remat, lora_scale=lora_scale)
    if cfg.loss_chunk > 0 and batch.labels is not None:
        h = llama.forward_hidden(params["llm"], cfg.llm, batch.inputs_embeds,
                                 **kw)
        loss = llama.clm_loss_chunked(params["llm"], h, batch.labels,
                                      chunk=cfg.loss_chunk,
                                      valid=llama.valid_vocab(cfg.llm))
        return loss, None
    logits = llama.forward(params["llm"], cfg.llm,
                           inputs_embeds=batch.inputs_embeds, **kw)
    loss = None
    if batch.labels is not None:
        loss = llama.clm_loss(logits, batch.labels)
    return loss, logits
