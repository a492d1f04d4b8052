"""The one place that reaches into the program under test
(``macaw_llm_tpu_torch``): its configuration built from a configuration
file, its serving engine and trainer, and its kernels' launch counters.
The reference never imports this module. Every import of the program is
inside a function, so that the harness can refuse a machine without a card
before the program loads.
"""

from __future__ import annotations

import re

def model_config(cfg: dict, training: bool = False):
    """The program's ``ModelConfig`` of a configuration file: the LLM at
    its stated sizes, CLIP and Whisper and the fusion as stated, bf16
    compute, the attention kernels on, the token ids the run assumes;
    training adds remat and the chunked loss of the QLoRA form."""
    from macaw_llm_tpu_torch.config import (ClipVisionConfig, FusionConfig,
                                            LlamaConfig, ModelConfig,
                                            WhisperConfig)
    v, a, f = cfg["vision"], cfg["audio"], cfg["fusion"]
    kv = cfg["num_key_value_heads"]
    llm = LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=None if kv == cfg["num_attention_heads"] else kv,
        max_position_embeddings=cfg["max_position_embeddings"],
        rope_base=float(cfg["rope_theta"]), rms_norm_eps=cfg["rms_norm_eps"],
        initializer_range=cfg["initializer_range"],
        bos_token_id=cfg["assumed"]["bos_token_id"],
        eos_token_id=cfg["assumed"]["eos_token_id"],
        tie_word_embeddings=cfg["tie_word_embeddings"])
    vision = ClipVisionConfig(
        hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
        image_size=v["image_size"], patch_size=v["patch_size"],
        projection_dim=v["projection_dim"], layer_norm_eps=v["layer_norm_eps"],
        hidden_act=v["hidden_act"])
    audio = WhisperConfig(
        num_mel_bins=a["num_mel_bins"], d_model=a["d_model"],
        encoder_layers=a["encoder_layers"],
        encoder_attention_heads=a["encoder_attention_heads"],
        encoder_ffn_dim=a["encoder_ffn_dim"],
        max_source_positions=a["max_source_positions"],
        sample_rate=a["sample_rate"], n_fft=a["n_fft"],
        hop_length=a["hop_length"], chunk_length_s=a["chunk_length_s"])
    fusion = FusionConfig(
        n_frames=f["n_frames"], attention_heads=f["attention_heads"],
        image_conv_kernel=f["image_conv_kernel"],
        image_conv_stride=f["image_conv_stride"],
        video_conv_kernel=f["video_conv_kernel"],
        video_conv_stride=f["video_conv_stride"],
        audio_conv_kernel=f["audio_conv_kernel"],
        audio_conv_stride=f["audio_conv_stride"],
        align_dropout=f["align_dropout"])
    form = cfg["training"] if training else {}
    return ModelConfig(llm=llm, vision=vision, audio=audio, fusion=fusion,
                       dtype=cfg["dtype"], param_dtype="float32",
                       use_flash=True, tower_flash=True,
                       remat=bool(form.get("remat", False)),
                       loss_chunk=int(form.get("loss_chunk", 0)))


def train_config(form: dict, total_steps: int):
    from macaw_llm_tpu_torch.config import TrainConfig
    return TrainConfig(
        learning_rate=form["learning_rate"], adam_b1=form["adam_b1"],
        adam_b2=form["adam_b2"], adam_eps=form["adam_eps"],
        weight_decay=0.0, warmup_ratio=form["warmup_ratio"],
        lr_schedule="cosine", grad_accum_steps=1,
        max_grad_norm=form["max_grad_norm"], freeze_encoders=True,
        lora_rank=form["lora_rank"], lora_alpha=form["lora_alpha"],
        grad_dtype="float32", mu_dtype="float32", frozen_dtype="bfloat16",
        align_cache=form["align_cache"], quantize_base=form["base"] == "int8",
        save_steps=0)


class Tokenizer:
    """The engine's tokenizer stand-in: a prompt carries the key of a
    request whose ids the harness drew (``[req N]``), and ``encode`` gives
    those ids back exactly; ``decode`` writes ids as text."""

    KEY = re.compile(r"\[req (-?\d+)\]")

    def __init__(self):
        self.ids = {}

    def prompt(self, index: int, ids: list) -> str:
        self.ids[index] = ids
        return f"[req {index}]"

    def encode(self, text: str) -> list:
        return list(self.ids[int(self.KEY.search(text).group(1))])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(str(int(i)) for i in ids)


def serving_params(tree: dict):
    """The serving form's tree: the LLM's matmul weights and head as int8
    records packed for decode; the engine builds its int8 alignment cache
    from the bf16 embeddings and packs the towers itself."""
    from macaw_llm_tpu_torch.utils import quantize as qz
    return dict(tree, llm=qz.pack_llama_for_decode(
        qz.quantize_llama(tree["llm"])))


def engine(params, mcfg, tokenizer, spec: dict, form: dict, device):
    from macaw_llm_tpu_torch.serve import ContinuousEngine
    return ContinuousEngine(
        params, mcfg, tokenizer, slots=spec["slots"],
        prompt_bucket=spec["prompt_bucket"],
        max_new_tokens=spec["answer_tokens"]["max"],
        align_cache=form["align_cache"], kv_cache_dtype=form["kv_cache"],
        device=device)


def request(**kw):
    from macaw_llm_tpu_torch.serve import Request
    return Request(**kw)


def trainer(mcfg, tcfg, total_steps: int, device):
    from macaw_llm_tpu_torch.train.trainer import Trainer
    return Trainer(mcfg, tcfg, total_steps=total_steps, device=device)


def launches() -> dict:
    """Each kernel wrapper's launch counter (CUDA launches only)."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh
    fns = {"mh_attention": mh.mh_attention,
           "flash_attention": fa.flash_attention_with_lse,
           "flash_attention_combine": fa.flash_attention_combine,
           "flash_attention_dq": fa.flash_attention_dq,
           "flash_attention_dkv": fa.flash_attention_dkv,
           "flash_attention_delta": fa.flash_attention_delta,
           "matvec_int8": mv.matvec_int8,
           "matvec_int8_pipelined": mv.matvec_int8_pipelined}
    return {k: int(f.launches) for k, f in fns.items()}
