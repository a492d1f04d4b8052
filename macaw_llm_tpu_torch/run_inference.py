"""Inference/eval entry point (counterpart of
``macaw_llm_tpu/run_inference.py``): restore the whole trained model from
a checkpoint dir written by ``run_train``, read
``data/{ds}/{ds}_val_inference.json``, cap the examples (default 2000),
run batched generation with the Alpaca prompt and dump
``eval_outputs/{ds}_eval_outputs.json``. Runs on the GPU unless
``--device cpu`` is given.

Usage:
    python -m macaw_llm_tpu_torch.run_inference --checkpoint out/ \\
        --dataset vqa --val-json data/vqa/vqa_val_inference.json \\
        --tokenizer trained_models/llama_tokenizer
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import Config
from macaw_llm_tpu_torch.data.loader import MediaSource
from macaw_llm_tpu_torch.eval import (batch_inference_generation,
                                      load_val_examples)
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  load_config)
from macaw_llm_tpu_torch.train.state import merge_params
from macaw_llm_tpu_torch.train.trainer import Trainer
from macaw_llm_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("macaw.inference")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Macaw inference/eval (PyTorch)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint dir written by run_train")
    p.add_argument("--dataset", type=str, default="vqa")
    p.add_argument("--val-json", type=str, default=None)
    p.add_argument("--names", type=str, default=None)
    p.add_argument("--tokenizer", type=str, required=True,
                   help="tokenizer dir/name; generation cannot encode "
                        "prompts without it")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-examples", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--num-beams", type=int, default=1)
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding: K draft "
                        "tokens a verify round (0 = plain greedy)")
    p.add_argument("--output-dir", type=str, default="eval_outputs")
    p.add_argument("--align-cache", default="bf16",
                   choices=["bf16", "int8", "off"],
                   help="precomputed alignment K/V projections + packed "
                        "tower qkv (inference layout; off = per-step "
                        "projection)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default: the GPU)")
    return p.parse_args(argv)


def restore_params(checkpoint_dir: str, cfg: Config, device="cuda") -> dict:
    """The whole model's parameters from the newest checkpoint under
    ``checkpoint_dir``, on ``device``, in the layout ``cfg``'s trainer
    gives them (frozen leaves in ``frozen_dtype``, an int8 base under
    ``quantize_base``, LoRA adapters under ``lora_rank``). A checkpoint
    written on a mesh holds whole tensors and restores here as well; a
    config that asks for a tensor axis above 1 is refused (tensor-parallel
    serving, ROADMAP A7)."""
    cfg.validate(serving=True)
    device = resolve_device(device)
    trainer = Trainer(cfg.model, cfg.train, total_steps=1, device=device)
    params = fusion.init_params(cfg.train.seed, cfg.model,
                                dtype=getattr(torch, cfg.model.param_dtype),
                                device=device)
    if cfg.train.lora_rank > 0:  # the adapters are part of the saved tree
        from macaw_llm_tpu_torch.train.lora import init_lora
        params["llm"]["layers"]["lora"] = init_lora(
            torch.Generator(device=device).manual_seed(cfg.train.seed + 1),
            cfg.model.llm, cfg.train.lora_rank)
    state = trainer.init_state(params)
    del params
    restored = CheckpointManager(checkpoint_dir).restore(state)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    return merge_params(restored.trainable, restored.frozen)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    cfg = load_config(args.checkpoint) or Config()
    params = restore_params(args.checkpoint, cfg, device=args.device)
    from macaw_llm_tpu_torch.serve import _init_align_cache
    params, align_cache = _init_align_cache(params, cfg.model,
                                            args.align_cache)

    val_json = args.val_json or os.path.join(
        "data", args.dataset, f"{args.dataset}_val_inference.json")
    cap = args.max_examples or cfg.data.max_eval_samples
    examples = load_val_examples(val_json, cap)

    media = None
    if args.names:
        with open(args.names) as f:
            names = json.load(f)["list"]
        media = MediaSource(names, cfg.data,
                            image_size=cfg.model.vision.image_size,
                            n_frames=cfg.model.fusion.n_frames)

    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)

    out_path = os.path.join(args.output_dir,
                            f"{args.dataset}_eval_outputs.json")
    results = batch_inference_generation(
        params, cfg, tokenizer, examples, media,
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        num_beams=args.num_beams,
        speculative=args.speculative,
        out_path=out_path,
        align_cache=align_cache,
        device=args.device)
    logger.info("wrote %d generations to %s", len(results), out_path)
    return results


if __name__ == "__main__":
    main()
