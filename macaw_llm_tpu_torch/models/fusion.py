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
video-long attention dropout and Whisper's LayerDrop. A tower whose
parameters take no gradient (frozen) runs under ``torch.no_grad()``.
``video_mode="simple"`` selects ``encode_video_simple`` (one pooled CLIP
feature a frame and a temporal attention over the frames) in place of the
reference forward's ``encode_video_long``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from macaw_llm_tpu_torch.config import (AUDIO_END, AUDIO_START, IGNORE_ID,
                                        IMAGE_END, IMAGE_START, ModelConfig,
                                        VIDEO_END, VIDEO_START)
from macaw_llm_tpu_torch.models import _tree, clip, llama, whisper
from macaw_llm_tpu_torch.models._tree import normal, uniform
from macaw_llm_tpu_torch.ops.attention import (
    pack_mha, shared_kv_project, torch_mha_apply,
    torch_mha_apply_shared_kv_dropout, torch_mha_apply_shared_kv_einsum,
    torch_mha_apply_shared_kv_flash, torch_mha_init)
from macaw_llm_tpu_torch.ops.linear import dense
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
from macaw_llm_tpu_torch.utils.profiling import SPANS

# alignment logits above this many bytes go to the flash kernel
ALIGN_EINSUM_MAX_BYTES = int(4e8)


class FusedBatch(NamedTuple):
    inputs_embeds: torch.Tensor                   # [B, P+S, H]
    attention_mask: Optional[torch.Tensor]        # [B, P+S]
    labels: Optional[torch.Tensor] = None         # [B, P+S]


def _frozen(tree) -> contextlib.AbstractContextManager:
    """``torch.no_grad()`` when no tensor of ``tree`` takes a gradient."""
    def grads(t):
        if isinstance(t, dict):  # StackedShards tell it themselves
            return getattr(t, "requires_grad", False) or \
                any(grads(v) for v in t.values())
        return isinstance(t, torch.Tensor) and t.requires_grad
    return contextlib.nullcontext() if grads(tree) else torch.no_grad()


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
    heads = cfg.fusion.attention_heads

    def mha(e, n):
        return torch_mha_init(gen, e, n, dtype=dtype)

    def linear(din, dout):
        lim = 1.0 / math.sqrt(din)
        return {"w": uniform(gen, (din, dout), lim, dtype),
                "b": uniform(gen, (dout,), lim, dtype)}

    def conv1d(ch, kernel):
        lim = 1.0 / math.sqrt(ch * kernel)
        return {"w": uniform(gen, (kernel, ch, ch), lim, dtype),
                "b": uniform(gen, (ch,), lim, dtype)}

    params = {
        "image_encoder": clip.init_params(gen, cfg.vision, dtype),
        "video_encoder": clip.init_params(gen, cfg.vision, dtype),
        "audio_encoder": whisper.init_params(gen, cfg.audio, dtype),
        "llm": llama.init_params(gen, cfg.llm, dtype),
        "fusion": {
            "image_align": mha(h, heads * 2),
            "audio_align": mha(h, heads * 2),
            "video_align": mha(h, heads * 2),
            "video_long_attn": mha(pd, heads),
            "to_hidden": {"video": linear(pd, h), "audio": linear(dm, h),
                          "image": linear(pd, h)},
            "conv": {"image": conv1d(pd, cfg.fusion.image_conv_kernel),
                     "video": conv1d(pd, cfg.fusion.video_conv_kernel),
                     "audio": conv1d(dm, cfg.fusion.audio_conv_kernel)},
        },
    }
    # encode_video_simple's leaves, drawn after every other leaf so that a
    # seed gives the rest of the tree the same weights as without them
    params["fusion"].update(
        temporal_attn=mha(pd, heads),
        temporal_pos_emb=normal(gen, (cfg.fusion.n_frames, pd), 1.0, dtype))
    return params


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


def _remat(cfg: ModelConfig):
    """The remat policy of every stack: ``cfg.remat_policy`` under
    ``cfg.remat``, else False."""
    return cfg.remat_policy if cfg.remat else False


def encode_image(params: dict, cfg: ModelConfig, images: torch.Tensor,
                 activation_quant: bool = False,
                 tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """[B, 3, H, W] -> [B, P, projection_dim]."""
    with _frozen(params["image_encoder"]):
        return clip.encode_patches(params["image_encoder"], cfg.vision,
                                   images, use_flash=cfg.tower_flash,
                                   remat=_remat(cfg),
                                   activation_quant=activation_quant, tp=tp)


def encode_video_long(params: dict, cfg: ModelConfig,
                      videos: torch.Tensor,
                      dropout_rng: Optional[torch.Generator] = None,
                      activation_quant: bool = False,
                      tp: Optional[tpar.TensorParallel] = None
                      ) -> torch.Tensor:
    """[B, F, 3, H, W] -> [B, F*P, projection_dim]: per-frame patch tokens
    concatenated over frames, the sinusoidal PE, one self-attention (with
    attention dropout when ``dropout_rng`` is given)."""
    b, f = videos.shape[:2]
    frames = videos.reshape((b * f,) + tuple(videos.shape[2:]))
    with _frozen(params["video_encoder"]):
        feats = clip.encode_patches(params["video_encoder"], cfg.vision,
                                    frames, use_flash=cfg.tower_flash,
                                    remat=_remat(cfg),
                                    activation_quant=activation_quant, tp=tp)
    feats = feats.reshape(b, f * feats.shape[1], feats.shape[2])
    feats = feats + sinusoidal_pe(feats.shape[1], feats.shape[2],
                                  feats.dtype, feats.device)[None]
    return torch_mha_apply(params["fusion"]["video_long_attn"],
                           cfg.fusion.attention_heads, feats, feats, feats,
                           add_zero_attn=True,
                           dropout_rate=cfg.fusion.align_dropout,
                           dropout_rng=dropout_rng,
                           use_flash=cfg.tower_flash)


def encode_video_simple(params: dict, cfg: ModelConfig,
                        videos: torch.Tensor,
                        dropout_rng: Optional[torch.Generator] = None,
                        activation_quant: bool = False,
                        tp: Optional[tpar.TensorParallel] = None
                        ) -> torch.Tensor:
    """[B, F, 3, H, W] -> [B, F, projection_dim]: the reference's pooled
    ``encode_video`` (CLIP's ``get_image_features``: the post-layernormed
    CLS token through visual_projection, one per frame), plus a learned
    temporal position embedding, then a self-attention over the frames
    (with attention dropout when ``dropout_rng`` is given)."""
    b, f = videos.shape[:2]
    frames = videos.reshape((b * f,) + tuple(videos.shape[2:]))
    with _frozen(params["video_encoder"]):
        pooled = clip.encode_pooled(params["video_encoder"], cfg.vision,
                                    frames, remat=_remat(cfg),
                                    activation_quant=activation_quant, tp=tp)
    pos = params["fusion"]["temporal_pos_emb"].to(pooled.dtype)
    pooled = pooled + pos[torch.arange(f, device=pos.device).repeat(b)]
    feats = pooled.reshape(b, f, pooled.shape[-1])
    return torch_mha_apply(params["fusion"]["temporal_attn"],
                           cfg.fusion.attention_heads, feats, feats, feats,
                           add_zero_attn=True,
                           dropout_rate=cfg.fusion.align_dropout,
                           dropout_rng=dropout_rng)


def encode_audio(params: dict, cfg: ModelConfig, audios: torch.Tensor,
                 dropout_rng: Optional[torch.Generator] = None,
                 activation_quant: bool = False,
                 tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """[B, 80, 3000] -> [B, 1500, d_model]. With ``dropout_rng`` and
    ``cfg.audio.encoder_layerdrop`` > 0, Whisper's LayerDrop: the keep
    vector is drawn here on the host from ``dropout_rng``."""
    keep = None
    if dropout_rng is not None and cfg.audio.encoder_layerdrop > 0.0:
        n = _tree.num_layers(params["audio_encoder"]["layers"])
        keep = whisper.layerdrop_keep(dropout_rng, n,
                                      cfg.audio.encoder_layerdrop)
    with _frozen(params["audio_encoder"]):
        return whisper.encode(params["audio_encoder"], cfg.audio, audios,
                              use_flash=cfg.tower_flash,
                              remat=_remat(cfg), layer_keep=keep,
                              activation_quant=activation_quant, tp=tp)


def _conv_downsample(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Channel-preserving VALID Conv1d over the sequence axis, [B, L, C]
    -> [B, L', C], WIO kernel. A sequence shorter than the kernel has no
    output position (L' = 0, as in the reference package): the pooled
    video's F frames against the 7b video kernel of 36."""
    if x.shape[1] < p["w"].shape[0]:
        return x.new_zeros((x.shape[0], 0, p["w"].shape[2]))
    return whisper.conv1d_nwc(x, p["w"], stride, 0) + p["b"].to(x.dtype)


def _align(p: dict, heads: int, feats: torch.Tensor,
           memory: Optional[torch.Tensor], kv_cache=None,
           dropout_rate: float = 0.0,
           rng: Optional[torch.Generator] = None,
           tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """Alignment cross-attention: Q = modality features, K = V = the token
    embedding memory. With a cache, the einsum over the (int8) cached rows
    while its fp32 logits stay within ALIGN_EINSUM_MAX_BYTES, else the
    flash kernel over the dequantized rows; without one, the flash kernel
    over the memory projected here. With dropout (``rng`` given, rate > 0)
    the chunked dropout attention over the dequantized cache or the memory.
    ``tp``: this rank's heads, which also count in the einsum's logits
    bytes; in training the features reach the in-projection through
    Megatron's f.
    """
    feats = tpar.copy(tp, feats)
    if rng is not None and dropout_rate > 0.0:
        kv = None
        if kv_cache is not None:
            kv = (_dequant_rows(kv_cache["k"], feats.dtype),
                  _dequant_rows(kv_cache["v"], feats.dtype))
        return torch_mha_apply_shared_kv_dropout(
            p, heads, feats, memory, rate=dropout_rate, rng=rng,
            add_zero_attn=True, kv_cache=kv, tp=tp)
    if kv_cache is not None:
        b, sq, _ = feats.shape
        m2 = kv_cache["k"][0].shape[0]
        if b * tpar.local(tp, heads) * sq * m2 * 4 <= ALIGN_EINSUM_MAX_BYTES:
            return torch_mha_apply_shared_kv_einsum(
                p, heads, feats, (kv_cache["k"], kv_cache["v"]), tp)
        kv = (_dequant_rows(kv_cache["k"], feats.dtype),
              _dequant_rows(kv_cache["v"], feats.dtype))
        return torch_mha_apply_shared_kv_flash(p, heads, feats, memory,
                                               kv_cache=kv, tp=tp)
    return torch_mha_apply_shared_kv_flash(p, heads, feats, memory,
                                           add_zero_attn=True, tp=tp)


def _quant_rows(x: torch.Tensor,
                tp: Optional[tpar.TensorParallel] = None):
    """Symmetric per-row int8: [M, E] -> (int8 [M, E], fp32 scale [M, 1]).
    Under ``tp`` x is this rank's columns of the rows and the scale is the
    whole row's (its max over the ranks): the one-device cache's columns."""
    xf = x.float()
    amax = tpar.reduce_max(tp, xf.abs().amax(-1, keepdim=True))
    scale = torch.where(amax == 0.0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant_rows(entry, dtype) -> torch.Tensor:
    q, scale = entry
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale).to(dtype)


def _token_memory(params: dict, cfg: ModelConfig, compute,
                  tp: Optional[tpar.TensorParallel]) -> torch.Tensor:
    """The alignments' K/V memory: the whole token-embedding matrix (its
    first ``align_memory_rows``), all-gathered when the vocab is cut; in
    training it reaches the cut alignments' K/V projections through
    Megatron's f."""
    memory = params["llm"]["embed_tokens"].to(compute)
    vtp = tpar.on(tp, "vocab")
    if vtp is not None:
        memory = tpar.gather(vtp, memory, 0)
    if cfg.fusion.align_memory_rows is not None:
        memory = memory[:cfg.fusion.align_memory_rows]
    return tpar.copy(tpar.on(tp, "align"), memory)


def precompute_align_cache(params: dict, cfg: ModelConfig,
                           quantize: bool = False,
                           tp: Optional[tpar.TensorParallel] = None) -> dict:
    """The alignment attentions' batch-shared K/V projections of the
    token-embedding memory: {mod: {"k": (rows, scale), "v": (rows,
    scale)}}; scale is None for a plain cache and per-row fp32 for int8.
    Run it before ``quantize_llama``: it reads the compute-dtype
    embed_tokens, which are never quantized. Under ``tp`` the rows are
    this rank's heads' columns, scaled as whole rows."""
    compute = getattr(torch, cfg.dtype)
    memory = _token_memory(params, cfg, compute, tp)
    atp = tpar.on(tp, "align")
    cache = {}
    for mod in ("image", "audio", "video"):
        k, v = shared_kv_project(params["fusion"][f"{mod}_align"], memory,
                                 add_zero_attn=True)
        if quantize:
            cache[mod] = {"k": _quant_rows(k, atp), "v": _quant_rows(v, atp)}
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
        p["in_proj_w"] = p["in_proj_w"][:p["in_proj_w"].shape[0] // 3]
        fp[f"{mod}_align"] = p
    out["fusion"] = fp
    return out


def _boundary(llm_params: dict, token_id: int, batch: int, dtype,
              tp: Optional[tpar.TensorParallel] = None) -> torch.Tensor:
    """[B, 1, H] embedding of a boundary special token."""
    table = llm_params["embed_tokens"]
    ids = torch.full((1, 1), token_id, dtype=torch.int64, device=table.device)
    emb = llama.embed(llm_params, ids, dtype, tp)
    return emb.expand(batch, 1, emb.shape[-1])


def featurize(cfg: ModelConfig, images: Optional[torch.Tensor],
              audios: Optional[torch.Tensor],
              videos: Optional[torch.Tensor]):
    """Raw media as the towers take them: waveforms [B, samples] ->
    log-mel [B, 80, frames], uint8 frames [.., H, W, 3] -> CLIP pixels
    [.., 3, H, W]; media already featurized (or None) pass as they are.
    No collective: a serving rank runs it before a prefill's first."""
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
    return images, audios, videos


def prepare_inputs(params: dict, cfg: ModelConfig, *,
                   input_ids: torch.Tensor,
                   images: Optional[torch.Tensor],
                   audios: Optional[torch.Tensor],
                   videos: Optional[torch.Tensor],
                   attention_mask: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None,
                   dropout_rng: Optional[torch.Generator] = None,
                   video_mode: str = "long",
                   align_cache: Optional[dict] = None,
                   activation_quant: bool = False,
                   tp: Optional[tpar.TensorParallel] = None) -> FusedBatch:
    """Fused embeddings, the mask extended with ones and the labels with
    IGNORE_ID over the prefix. Raw media are featurized here: waveforms
    [B, samples] -> log-mel, uint8 frames [.., H, W, 3] -> CLIP pixels.

    ``dropout_rng`` (training) turns on the attention dropout of the
    alignments and the video attention, and Whisper's LayerDrop. Training
    with an ``align_cache`` freezes the align K/V projections: the cache is
    a constant, so the in-proj K/V rows and bias_k/bias_v take no gradient.
    ``video_mode``: "long" (``encode_video_long``) or "simple"
    (``encode_video_simple``). ``activation_quant`` sends the towers' int8
    records (``utils.quantize.quantize_towers``) to W8A8. ``tp``:
    ``params`` and ``align_cache`` are this rank's blocks of a
    tensor-parallel tree; the fused batch is every rank's, whole (and so
    is its gradient).
    """
    if video_mode not in ("long", "simple"):
        raise ValueError(f"video_mode {video_mode!r}: 'long' or 'simple'")
    bids = {"image": (IMAGE_START, IMAGE_END),
            "audio": (AUDIO_START, AUDIO_END),
            "video": (VIDEO_START, VIDEO_END)}
    images, audios, videos = featurize(cfg, images, audios, videos)
    compute = getattr(torch, cfg.dtype)
    lp = params["llm"]
    fp = params["fusion"]
    b = input_ids.shape[0]
    heads2 = cfg.fusion.attention_heads * 2
    cache = align_cache or {}
    drop = cfg.fusion.align_dropout if dropout_rng is not None else 0.0

    text_emb = llama.embed(lp, input_ids, compute, tp)
    # K/V memory of the alignments without a cache: the whole vocab
    # embedding matrix, shared across the batch
    token_memory = None
    if any(mod not in cache for mod in ("image", "audio", "video")):
        token_memory = _token_memory(params, cfg, compute, tp)

    blocks = []

    def add_block(mod: str, feats: torch.Tensor, conv_stride: int) -> None:
        with SPANS.child("align"):
            x = _conv_downsample(fp["conv"][mod], feats, conv_stride)
            x = dense(x, fp["to_hidden"][mod]["w"],
                      fp["to_hidden"][mod]["b"])
            x = _align(fp[f"{mod}_align"], heads2, x, token_memory,
                       kv_cache=cache.get(mod), dropout_rate=drop,
                       rng=dropout_rng, tp=tpar.on(tp, "align"))
            blocks.append(torch.cat(
                [_boundary(lp, bids[mod][0], b, compute, tp), x,
                 _boundary(lp, bids[mod][1], b, compute, tp)], 1))

    # the towers' and the alignments' spans inside the caller's (an
    # admission's or a train step's forward)
    aq = activation_quant
    if images is not None:
        with SPANS.child("towers"):
            feats = encode_image(params, cfg, images.to(compute), aq, tp)
        add_block("image", feats, cfg.fusion.image_conv_stride)
    if audios is not None:
        with SPANS.child("towers"):
            feats = encode_audio(params, cfg, audios.to(compute),
                                 dropout_rng, aq, tp)
        add_block("audio", feats, cfg.fusion.audio_conv_stride)
    if videos is not None:
        encode_video = encode_video_long if video_mode == "long" \
            else encode_video_simple
        with SPANS.child("towers"):
            feats = encode_video(params, cfg, videos.to(compute),
                                 dropout_rng, aq, tp)
        add_block("video", feats, cfg.fusion.video_conv_stride)
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
            video_mode: str = "long",
            lora_scale: float = 1.0,
            align_cache: Optional[dict] = None,
            ring_mesh=None, reduce_count=None,
            tp: Optional[tpar.TensorParallel] = None):
    """Training forward: fuse, run the LLaMA stack over the fused
    embeddings, return (loss, logits). With ``cfg.loss_chunk`` > 0 and
    labels the loss comes from the hidden states in chunks and logits is
    None (no [B, S, V] fp32 tensor). ``cfg.remat`` checkpoints every
    decoder and tower layer under ``cfg.remat_policy``. ``ring_mesh``
    (with ``cfg.ring_attention``) takes the ring path (``_forward_ring``).
    ``reduce_count`` sums the loss's count of valid targets over the ranks
    that share the batch (the loss is then the global mean). ``tp``:
    Megatron tensor parallelism over this rank's block of the tree
    (``parallel.tensor_parallel``), with sequence parallelism in the
    LLaMA stack under ``cfg.shard_sequence``; the loss is the whole
    batch's on every rank."""
    batch = prepare_inputs(params, cfg, input_ids=input_ids, images=images,
                           audios=audios, videos=videos,
                           attention_mask=attention_mask, labels=labels,
                           dropout_rng=dropout_rng, video_mode=video_mode,
                           align_cache=align_cache, tp=tp)
    if ring_mesh is not None and cfg.ring_attention:
        return _forward_ring(params, cfg, batch, lora_scale, ring_mesh,
                             reduce_count)
    kw = dict(attention_mask=batch.attention_mask, use_flash=cfg.use_flash,
              remat=_remat(cfg), lora_scale=lora_scale, tp=tp,
              shard_sequence=cfg.shard_sequence)
    if cfg.loss_chunk > 0 and batch.labels is not None:
        h = llama.forward_hidden(params["llm"], cfg.llm, batch.inputs_embeds,
                                 **kw)
        loss = llama.clm_loss_chunked(params["llm"], h, batch.labels,
                                      chunk=cfg.loss_chunk,
                                      valid=llama.valid_vocab(cfg.llm),
                                      reduce_count=reduce_count, tp=tp)
        return loss, None
    logits = llama.forward(params["llm"], cfg.llm,
                           inputs_embeds=batch.inputs_embeds, **kw)
    loss = None
    if batch.labels is not None:
        loss = llama.clm_loss(logits, batch.labels, reduce_count)
    return loss, logits


def _forward_ring(params: dict, cfg: ModelConfig, batch: FusedBatch,
                  lora_scale: float, ring_mesh, reduce_count=None):
    """The LLaMA stack over the fused sequence cut across the ring axis.

    The towers and the splice ran on this rank's batch rows; the fused
    sequence is laid out in the ring's order (zig-zag: permuted so that
    every rank holds one early and one late block), and this rank keeps
    its chunk through the whole stack: only attention talks across ranks.
    RoPE positions carry the original indices; the loss takes the
    pre-shifted next-token targets, permuted the same way
    (``clm_loss_aligned``; ``clm_loss_chunked`` with ``targets_aligned``
    under ``loss_chunk``). The logits returned are this rank's chunk, in
    the ring's order. No padding: the mask must be all ones."""
    from macaw_llm_tpu_torch.parallel.mesh import axis_index, axis_size
    from macaw_llm_tpu_torch.parallel.ring_attention import zigzag_indices
    embeds = batch.inputs_embeds
    b, s, _ = embeds.shape
    if batch.attention_mask is not None and \
            not bool(batch.attention_mask.all()):
        raise ValueError("ring attention requires an all-ones "
                         "attention_mask (pack sequences instead of "
                         "padding)")
    axis = cfg.ring_axis
    n = axis_size(ring_mesh, (axis,))
    me = axis_index(ring_mesh, (axis,))
    if s % n:
        raise ValueError(f"ring: fused length {s} is not a multiple of the "
                         f"{n} ranks of axis {axis!r}")
    order = torch.arange(s)
    if cfg.ring_layout == "zigzag":
        order = zigzag_indices(s, n)
    mine = order[me * (s // n):(me + 1) * (s // n)].to(embeds.device)
    embeds = embeds[:, mine]
    positions = mine[None].expand(b, -1)
    targets = None
    if batch.labels is not None:
        ext = batch.labels
        targets = torch.cat([ext[:, 1:], ext.new_full((b, 1), IGNORE_ID)],
                            dim=1)[:, mine]
    kw = dict(positions=positions, remat=_remat(cfg), lora_scale=lora_scale,
              ring_mesh=ring_mesh, ring_axis=axis,
              ring_layout=cfg.ring_layout)
    if cfg.loss_chunk > 0 and targets is not None:
        h = llama.forward_hidden(params["llm"], cfg.llm, embeds, **kw)
        loss = llama.clm_loss_chunked(params["llm"], h, targets,
                                      chunk=cfg.loss_chunk,
                                      valid=llama.valid_vocab(cfg.llm),
                                      targets_aligned=True,
                                      reduce_count=reduce_count)
        return loss, None
    logits = llama.forward(params["llm"], cfg.llm, inputs_embeds=embeds,
                           **kw)
    loss = None
    if targets is not None:
        loss = llama.clm_loss_aligned(logits, targets, reduce_count)
    return loss, logits
