"""Inference/eval entry point (counterpart of
``macaw_llm_tpu/run_inference.py``): restore the whole trained model from
a checkpoint dir written by ``run_train``, read
``data/{ds}/{ds}_val_inference.json``, cap the examples (default 2000),
run batched generation with the Alpaca prompt and dump
``eval_outputs/{ds}_eval_outputs.json``. Runs on the GPU unless
``--device cpu`` is given.

A run config whose mesh has ``tensor = t > 1`` generates tensor-parallel
over ``t`` processes, one per card (``torchrun --nproc-per-node t``, or the
reference's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID environment):
each rank restores the whole checkpoint, keeps its block
(``parallel.tensor_parallel``), and rank 0 writes the outputs.

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
from typing import Optional

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import Config
from macaw_llm_tpu_torch.data.loader import MediaSource
from macaw_llm_tpu_torch.eval import (batch_inference_generation,
                                      load_val_examples)
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          tp_params)
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


def restore_params(checkpoint_dir: str, cfg: Config, device="cuda",
                   tp: Optional[TensorParallel] = None) -> dict:
    """The whole model's parameters from the newest checkpoint under
    ``checkpoint_dir``, on ``device``, in the layout ``cfg``'s trainer
    gives them (frozen leaves in ``frozen_dtype``, an int8 base under
    ``quantize_base``, LoRA adapters under ``lora_rank``). A checkpoint
    written on a mesh holds whole tensors and restores here as well. Under
    ``tp`` (``cfg.mesh.tensor`` ranks) this rank's block of the tree."""
    cfg.validate(world_size=1 if tp is None else tp.size, serving=True)
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
    return tp_params(merge_params(restored.trainable, restored.frozen), tp)


def serving_group(cfg: Config, device) -> Optional[TensorParallel]:
    """The tensor group of a serving process: joins the job's process
    group (torchrun's or the reference's environment) when there is one,
    checks that its world is ``cfg.mesh.tensor`` ranks, and returns the
    group (None for one process)."""
    from macaw_llm_tpu_torch.config import MeshConfig
    from macaw_llm_tpu_torch.parallel.mesh import (create_mesh,
                                                   multihost_initialize)
    import torch.distributed as dist
    world = dist.get_world_size() if multihost_initialize(device) else 1
    cfg.validate(world_size=world, serving=True)
    if world == 1:
        return None
    mesh = create_mesh(MeshConfig(dcn=1, data=1, fsdp=1, tensor=world),
                       device)
    return TensorParallel.from_mesh(mesh, cfg.model)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    cfg = load_config(args.checkpoint) or Config()
    tp = serving_group(cfg, args.device)
    params = restore_params(args.checkpoint, cfg, device=args.device, tp=tp)
    from macaw_llm_tpu_torch.serve import _init_align_cache
    params, align_cache = _init_align_cache(params, cfg.model,
                                            args.align_cache, tp)

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
        out_path=out_path if tp is None or tp.leader else None,
        align_cache=align_cache,
        device=args.device, tp=tp)
    if tp is None or tp.leader:
        logger.info("wrote %d generations to %s", len(results), out_path)
    return results


if __name__ == "__main__":
    main()
