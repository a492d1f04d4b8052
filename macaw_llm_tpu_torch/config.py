"""Configuration: the port's own copy of the reference package's config
dataclasses (``macaw_llm_tpu/config.py``): model / mesh / train / data in
one ``Config`` tree with the same fields, defaults and JSON form, so a run
config written by either package loads in the other. Defaults are the
reference's (LLaMA-7B + CLIP ViT-B/16 + Whisper-base, Macaw-LLM's
MM_LLMs_Config; the optimizer of its train.sh and DeepSpeed config).
Every value the reference accepts selects a ported path."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Special-token vocabulary (Macaw-LLM llm_trainer.py:126-133; pad id 32006).
IMAGE_START = 32000   # <image>
IMAGE_END = 32001     # </image>
AUDIO_START = 32002   # <audio>
AUDIO_END = 32003     # </audio>
VIDEO_START = 32004   # <video>
VIDEO_END = 32005     # </video>
PAD_ID = 32006        # [PAD]
BOS_ID = 1
EOS_ID = 2
IGNORE_ID = -100      # loss-mask label

SPECIAL_TOKENS = {
    "<image>": IMAGE_START,
    "</image>": IMAGE_END,
    "<audio>": AUDIO_START,
    "</audio>": AUDIO_END,
    "<video>": VIDEO_START,
    "</video>": VIDEO_END,
}


def _conv_out_len(length: int, kernel: int, stride: int) -> int:
    """Output length of a VALID 1-D conv: floor((L - k) / s) + 1."""
    return (length - kernel) // stride + 1


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA decoder; defaults are LLaMA-7B with the vocab extended to
    32007. ``vocab_pad_to`` pads embed_tokens/lm_head rows (padded logits
    are masked to -inf)."""

    vocab_size: int = 32007
    vocab_pad_to: Optional[int] = None
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    max_position_embeddings: int = 2048
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    pad_token_id: int = PAD_ID
    bos_token_id: int = BOS_ID
    eos_token_id: int = EOS_ID
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Storage vocab width (embed_tokens rows / lm_head cols)."""
        return self.vocab_pad_to or self.vocab_size

    def validate(self) -> None:
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")
        if self.vocab_pad_to is not None \
                and self.vocab_pad_to < self.vocab_size:
            raise ValueError(f"vocab_pad_to {self.vocab_pad_to} < vocab "
                             f"{self.vocab_size}")


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (clip-vit-base-patch16)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # 196 for B/16 @224

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +CLS


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper encoder (whisper-base) and its mel frontend constants."""

    num_mel_bins: int = 80
    d_model: int = 512
    encoder_layers: int = 6
    encoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # LayerDrop rate of the training forward (0 in whisper-base)
    encoder_layerdrop: float = 0.0
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    chunk_length_s: int = 30

    @property
    def n_audio_samples(self) -> int:
        return self.sample_rate * self.chunk_length_s  # 480000

    @property
    def n_mel_frames(self) -> int:
        return self.n_audio_samples // self.hop_length  # 3000

    @property
    def encoder_seq_len(self) -> int:
        return self.n_mel_frames // 2  # conv2 stride 2: 3000 -> 1500


@dataclass(frozen=True)
class FusionConfig:
    """Multimodal fusion hyper-parameters (MM_LLMs_Config)."""

    n_frames: int = 6
    attention_heads: int = 8
    image_conv_kernel: int = 48
    image_conv_stride: int = 36
    video_conv_kernel: int = 36
    video_conv_stride: int = 30
    audio_conv_kernel: int = 240
    audio_conv_stride: int = 220
    # attention-probability dropout of the alignment and video-long
    # attentions; applied only when a dropout generator is passed (training)
    align_dropout: float = 0.1
    # rows of the vocab-embedding K/V memory the alignment attention sees;
    # None = the full vocabulary (the reference's behavior)
    align_memory_rows: Optional[int] = None


@dataclass(frozen=True)
class ModelConfig:
    """Composite model config."""

    llm: LlamaConfig = field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    audio: WhisperConfig = field(default_factory=WhisperConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    dtype: str = "bfloat16"   # compute dtype
    param_dtype: str = "float32"  # dtype of the master weights
    # training: checkpoint every decoder and tower layer (models.remat):
    # "nothing" recomputes the whole layer in the backward, "dots" keeps
    # the outputs of its matmuls with no batch dims
    remat: bool = False
    remat_policy: str = "nothing"
    use_flash: bool = False   # attention kernels in the LLM prefill
    tower_flash: bool = False  # streaming kernel in the CLIP/Whisper towers
    # sequence parallelism of the LLaMA stack over the mesh's tensor axis
    # (training without a ring: the activations between layers cut on the
    # sequence; the numbers do not change); ring attention over the mesh
    # axis ``ring_axis``, "zigzag" or "contiguous" (training: the fused
    # sequence is cut over that axis)
    shard_sequence: bool = False
    ring_attention: bool = False
    ring_axis: str = "tensor"
    ring_layout: str = "zigzag"
    # training: shifted CE over chunks of this many positions straight from
    # the hidden states (no [B, S, V] fp32 logits); 0 = full logits
    loss_chunk: int = 0

    @property
    def image_prefix_len(self) -> int:
        return _conv_out_len(self.vision.num_patches,
                             self.fusion.image_conv_kernel,
                             self.fusion.image_conv_stride)  # 196 -> 5

    @property
    def video_prefix_len(self) -> int:
        return _conv_out_len(self.fusion.n_frames * self.vision.num_patches,
                             self.fusion.video_conv_kernel,
                             self.fusion.video_conv_stride)  # 1176 -> 39

    @property
    def audio_prefix_len(self) -> int:
        return _conv_out_len(self.audio.encoder_seq_len,
                             self.fusion.audio_conv_kernel,
                             self.fusion.audio_conv_stride)  # 1500 -> 6

    @property
    def total_prefix_len(self) -> int:
        """Injected positions incl. the 6 boundary tokens:
        [BOS][<image> im </image>][<audio> au </audio>][<video> vi </video>]
        [text]."""
        return (self.image_prefix_len + self.video_prefix_len
                + self.audio_prefix_len + 6)

    def validate(self) -> None:
        """The reference's geometry checks."""
        self.llm.validate()
        h = self.fusion.attention_heads
        if self.llm.hidden_size % (h * 2):
            raise ValueError(f"align attention heads {h}*2 must divide llm "
                             f"hidden size {self.llm.hidden_size}")
        if self.vision.projection_dim % h:
            raise ValueError(f"align attention heads {h} must divide the "
                             f"CLIP projection dim "
                             f"{self.vision.projection_dim}")
        if self.ring_layout not in ("zigzag", "contiguous"):
            raise ValueError(f"ring_layout {self.ring_layout!r}: 'zigzag' or "
                             "'contiguous'")
        if self.ring_axis not in ("dcn", "data", "fsdp", "tensor"):
            raise ValueError(f"ring_axis {self.ring_axis!r} is not a mesh "
                             "axis")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes of the reference (dcn x data x fsdp x tensor; -1 =
    all remaining devices): one process per device, the batch cut over
    (dcn, data, fsdp), parameters and Adam moments over fsdp and tensor
    (``parallel.sharding``)."""

    dcn: int = 1
    data: int = 1
    fsdp: int = -1
    tensor: int = 1

    def resolved(self, n_devices: int) -> Tuple[int, int, int, int]:
        c, d, f, t = self.dcn, self.data, self.fsdp, self.tensor
        prod = 1
        for x in (c, d, f, t):
            if x != -1:
                prod *= x
        if -1 in (c, d, f, t):
            rem = n_devices // prod
            c, d, f, t = (rem if x == -1 else x for x in (c, d, f, t))
        if c * d * f * t != n_devices:
            raise ValueError(f"mesh {c}x{d}x{f}x{t} != {n_devices} devices")
        return c, d, f, t


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule, the fine-tune's form and the run's cadence
    (the reference's train.sh and DeepSpeed config: AdamW, lr 3e-5, cosine
    with 3% warmup, grad-clip 1.0, a checkpoint every 5000 steps, keep 1)."""

    learning_rate: float = 3e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"      # "cosine" | "linear" | "constant"
    num_epochs: int = 3
    per_device_batch_size: int = 4
    grad_accum_steps: int = 3
    max_grad_norm: float = 1.0
    seed: int = 1
    freeze_encoders: bool = True     # CLIP/Whisper towers take no gradient
    lora_rank: int = 0               # 0 = full fine-tune; > 0 LoRA on q, v
    lora_alpha: float = 16.0
    grad_dtype: str = "float32"      # "bfloat16": grads of bf16-cast params
    mu_dtype: str = "float32"        # dtype of Adam's first moment
    # storage dtype of the frozen params ("param" keeps them as given);
    # the fp32 scales of int8 records stay fp32
    frozen_dtype: str = "bfloat16"
    # LoRA only: precompute the alignment K/V projections of the frozen
    # vocabulary memory once ("int8" or "bf16") or project every step
    # ("off"). A cache freezes the align in-proj K/V rows and bias_k/bias_v.
    align_cache: str = "int8"
    quantize_base: bool = False      # LoRA only: int8 frozen LLaMA base
    # AdamW moments in (pinned) host memory between steps, streamed to the
    # device leaf by leaf for the update
    offload_optimizer: bool = False
    pack_frozen_towers: bool = False  # one [h, 3h] in-proj per tower layer
    save_steps: int = 5000           # checkpoint cadence; 0 = no checkpoints
    save_total_limit: int = 1        # checkpoints kept
    # checkpoint saves copy the mutable state on the device and write it
    # from a background thread; False (or too little free device memory)
    # copies it to the host before the save returns
    ckpt_snapshot: bool = True
    log_steps: int = 10              # metrics.jsonl rows flushed this often
    # every N optimizer steps, `eval_batches` forward-only eval batches
    # (eval loss and token accuracy); 0 = only the final --do-eval pass
    eval_steps: int = 0
    eval_batches: int = 8
    checkpoint_dir: str = "checkpoints"
    resume: bool = True              # resume from the newest checkpoint


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline (the reference's preprocess scripts and trainer
    globals): text length, stored and sampled video frames, media dirs."""

    max_text_len: int = 256
    n_stored_frames: int = 120
    n_sampled_frames: int = 6
    image_dir: str = "data/avsd/frames/"
    audio_dir: str = "data/avsd/audios/"
    coco_dir: str = "data/coco/train2014/"
    cache_path: str = "data/train_total_new_vname.cache"
    max_eval_samples: int = 2000
    max_new_tokens: int = 128


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def validate(self, world_size: int = 1, serving: bool = False) -> None:
        """``ModelConfig.validate``, then the mesh against ``world_size``
        processes (one device each; ``ValueError`` when its size differs).
        ``serving`` (generation and the server, whatever mesh trained the
        checkpoint) runs on a world of ``mesh.tensor`` processes, one
        tensor-parallel group: the mesh's other axes are read as one
        replica."""
        self.model.validate()
        if not serving:
            self.mesh.resolved(world_size)
            return
        t = world_size if self.mesh.tensor == -1 else self.mesh.tensor
        if t != world_size:
            raise ValueError(f"mesh tensor={self.mesh.tensor}: generation and "
                             f"serving run on {t} processes (one tensor "
                             f"group), not {world_size}")


def _from_dict(cls: Any, d: dict) -> Any:
    """A dataclass from a dict: unknown keys are ignored, missing ones
    take their defaults, nested dataclass fields recurse."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        factory = f.default_factory
        if factory is not dataclasses.MISSING \
                and dataclasses.is_dataclass(factory):
            kwargs[f.name] = _from_dict(factory, d[f.name])
        else:
            kwargs[f.name] = d[f.name]
    return cls(**kwargs)


def tiny_model_config() -> ModelConfig:
    """CPU-sized model for tests (same geometry rules as the 7b profile)."""
    return ModelConfig(
        llm=LlamaConfig(vocab_size=32007, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=4,
                        max_position_embeddings=512),
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64,
                                num_layers=2, num_heads=2, image_size=32,
                                patch_size=16, projection_dim=16),
        audio=WhisperConfig(num_mel_bins=80, d_model=32, encoder_layers=2,
                            encoder_attention_heads=2, encoder_ffn_dim=64,
                            max_source_positions=1500),
        fusion=FusionConfig(attention_heads=2,
                            image_conv_kernel=2, image_conv_stride=1,
                            video_conv_kernel=6, video_conv_stride=4,
                            audio_conv_kernel=240, audio_conv_stride=220),
        dtype="float32",
        param_dtype="float32",
    )


def macaw_7b() -> ModelConfig:
    """Reference-parity flagship: LLaMA-7B + 2x CLIP ViT-B/16 +
    Whisper-base, ~7.3B params, attention kernels on."""
    return ModelConfig(use_flash=True, tower_flash=True)


def macaw_1b() -> ModelConfig:
    """Single-device profile: the reference's CLIP/Whisper towers and
    fusion geometry with LLaMA scaled to ~1.1B (hidden 2048, 16 layers,
    16 heads), bf16 compute, attention kernels on."""
    return ModelConfig(
        llm=LlamaConfig(hidden_size=2048, intermediate_size=5504,
                        num_layers=16, num_heads=16),
        dtype="bfloat16",
        use_flash=True,
        tower_flash=True,
    )
