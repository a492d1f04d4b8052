"""Model configuration: the port's own copy of the reference package's
config dataclasses (``macaw_llm_tpu/config.py``), trimmed to what the
serving and training paths read. Defaults are the reference's (LLaMA-7B +
CLIP ViT-B/16 + Whisper-base, Macaw-LLM's MM_LLMs_Config; the optimizer of
its train.sh and DeepSpeed config)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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
    use_flash: bool = False   # attention kernels in the LLM prefill
    tower_flash: bool = False  # streaming kernel in the CLIP/Whisper towers
    # training: torch.utils.checkpoint per decoder layer, which recomputes
    # the whole layer in the backward (the reference's policy "nothing")
    remat: bool = False
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


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule and the fine-tune's form (the reference's
    train.sh and DeepSpeed config: AdamW, lr 3e-5, cosine with 3% warmup,
    grad-clip 1.0). The fields the port's trainer reads."""

    learning_rate: float = 3e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"      # "cosine" | "linear" | "constant"
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
    pack_frozen_towers: bool = False  # one [h, 3h] in-proj per tower layer


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
    )


def macaw_7b() -> ModelConfig:
    """Reference-parity flagship: LLaMA-7B + 2x CLIP ViT-B/16 +
    Whisper-base, ~7.3B params, attention kernels on."""
    return ModelConfig(use_flash=True, tower_flash=True)
