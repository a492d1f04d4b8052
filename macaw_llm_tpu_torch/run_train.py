"""Training entry point (counterpart of ``macaw_llm_tpu/run_train.py``):
config from a JSON file or flags, dataset cache or JSONL stream in, the
epoch loop with gradient accumulation, periodic eval and checkpoints,
resume, SIGTERM/SIGINT checkpoint-and-exit, ``metrics.jsonl``.

Runs on one device, the GPU unless ``--device cpu`` is given, or across
processes, one device each: started with the reference's environment
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) or by ``torchrun``, the
processes join one group (nccl on cards, gloo on CPUs) and train over the
config's mesh (``parallel.mesh``; its size must be the number of
processes). The global batch is per_device_batch_size x processes x
grad_accum_steps; each process loads its rows; rank 0 writes
metrics.jsonl and the checkpoints. The model starts from random weights
made from ``train.seed``; ``--llama-weights``, ``--clip-weights`` and
``--whisper-weights`` load HF checkpoints over them.

Usage:
    python -m macaw_llm_tpu_torch.run_train --config cfg.json \\
        --cache data/train.npz --names data/all_visual_names.json \\
        --tokenizer trained_models/llama_tokenizer --output-dir out/
    python -m macaw_llm_tpu_torch.run_train --device cpu --tiny --synthetic
    torchrun --nproc-per-node 8 -m macaw_llm_tpu_torch.run_train \\
        --config cfg.json ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import Config, IGNORE_ID, tiny_model_config
from macaw_llm_tpu_torch.data.datasets import TokenizedDataset
from macaw_llm_tpu_torch.data.loader import (BatchLoader, MediaSource,
                                             device_prefetch)
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.parallel.mesh import create_mesh, multihost_initialize
from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
from macaw_llm_tpu_torch.train.trainer import Trainer, batch_layout
from macaw_llm_tpu_torch.utils.logging import MetricsLogger, setup_logging

logger = logging.getLogger("macaw.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Macaw training (PyTorch)")
    p.add_argument("--config", type=str, default=None,
                   help="JSON Config file (macaw_llm_tpu_torch.config.Config;"
                        " the reference package's files load as they are)")
    p.add_argument("--cache", type=str, default=None,
                   help="tokenized dataset cache (.npz)")
    p.add_argument("--stream", type=str, nargs="+", default=None,
                   help="streaming mode: JSONL instruction shards tokenized "
                        "on the fly (no prebuilt cache). Requires --steps "
                        "and --tokenizer; rows carry prompt/output (or "
                        "Alpaca instruction/input/output) plus optional "
                        "image/audio/video name-table keys")
    p.add_argument("--shuffle-buffer", type=int, default=1024,
                   help="streaming shuffle buffer size (rows)")
    p.add_argument("--names", type=str, default=None,
                   help="media name table JSON ({'list': [...]})")
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--output-dir", type=str, default="checkpoints")
    p.add_argument("--llama-weights", type=str, default=None,
                   help="HF LLaMA checkpoint dir (safetensors, a sharded "
                        "index or pytorch_model.bin)")
    p.add_argument("--clip-weights", type=str, default=None)
    p.add_argument("--whisper-weights", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="hard step cap (overrides epochs for smoke runs)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on random synthetic data (smoke test)")
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test model config")
    p.add_argument("--profile", default=None, choices=["1b", "7b"],
                   help="use a named model profile instead of --config's")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override cfg.train.per_device_batch_size")
    p.add_argument("--no-media", action="store_true",
                   help="text-only batches (no image/audio/video columns)")
    p.add_argument("--lora-rank", type=int, default=None,
                   help="enable LoRA fine-tuning at this rank")
    p.add_argument("--eval-cache", type=str, default=None,
                   help="tokenized eval-split cache (.npz); with "
                        "--synthetic a held-out synthetic split is used")
    p.add_argument("--do-eval", action="store_true",
                   help="run a final eval pass (loss + token accuracy) "
                        "after training; periodic eval follows "
                        "cfg.train.eval_steps")
    p.add_argument("--eval-steps", type=int, default=None,
                   help="override cfg.train.eval_steps")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default: the GPU)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend of a job (default: nccl on "
                        "the GPU, gloo on the CPU; gloo lets several "
                        "ranks share one card)")
    return p.parse_args(argv)


def load_pretrained(cfg: Config, args) -> dict:
    """The fusion model in ``model.param_dtype`` on ``args.device``: random
    weights from ``train.seed``, with the pretrained LLaMA (its vocab
    resized to ``vocab_size`` and padded to ``vocab_pad_to``), CLIP (both
    the image and the video tower) and Whisper of the weight flags (HF
    checkpoint dirs: a sharded safetensors index, safetensors files or a
    ``pytorch_model.bin``)."""
    from macaw_llm_tpu_torch.utils import hf_import
    from macaw_llm_tpu_torch.utils.safetensors_io import load_checkpoint_dir
    dtype = getattr(torch, cfg.model.param_dtype)
    kw = dict(dtype=dtype, device=args.device)
    params = fusion.init_params(cfg.train.seed, cfg.model, **kw)
    m = cfg.model
    if args.llama_weights:
        llm = hf_import.import_llama(load_checkpoint_dir(args.llama_weights),
                                     m.llm, **kw)
        llm = hf_import.resize_token_embeddings(llm, m.llm.vocab_size)
        if m.llm.padded_vocab > m.llm.vocab_size:
            llm = hf_import.pad_vocab(llm, m.llm.padded_vocab)
        params["llm"] = llm
    if args.clip_weights:
        sd = load_checkpoint_dir(args.clip_weights)
        params["image_encoder"] = hf_import.import_clip_vision(sd, m.vision,
                                                               **kw)
        params["video_encoder"] = hf_import.import_clip_vision(sd, m.vision,
                                                               **kw)
    if args.whisper_weights:
        params["audio_encoder"] = hf_import.import_whisper_encoder(
            load_checkpoint_dir(args.whisper_weights), m.audio, **kw)
    return params


def synthetic_dataset(cfg: Config, n: int = 64,
                      seed: int = 0) -> TokenizedDataset:
    rng = np.random.RandomState(seed)
    L = cfg.data.max_text_len
    ids = rng.randint(16, min(cfg.model.llm.vocab_size, 32000), (n, L))
    ids[:, 0] = 1
    labels = ids.copy()
    labels[:, :8] = IGNORE_ID
    return TokenizedDataset(
        input_ids=ids.astype(np.int32),
        attention_mask=np.ones((n, L), np.int32),
        labels=labels.astype(np.int32),
        images=np.full((n,), -1, np.int32),
        audios=np.full((n,), -1, np.int32),
        videos=np.full((n,), -1, np.int32),
    )


class _NullCkpt:
    """save_steps=0: no checkpoints (benchmark runs)."""

    last_save = None

    def save(self, *a, **k):
        return False

    def wait(self):
        pass

    def close(self):
        pass

    def latest_step(self):
        return None


def main(argv=None, on_step=None):
    """Train; returns the final ``TrainState``. ``on_step(step, state,
    metrics)``, when given, is called after every optimizer step (before
    that step's checkpoint and preemption checks)."""
    args = parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)
    multi = multihost_initialize(device, backend=args.backend)
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=tiny_model_config())
    if args.profile:
        from macaw_llm_tpu_torch.config import macaw_1b, macaw_7b
        prof = {"1b": macaw_1b, "7b": macaw_7b}[args.profile]()
        prof = dataclasses.replace(prof, dtype="bfloat16", remat=True,
                                   loss_chunk=256)
        cfg = dataclasses.replace(cfg, model=prof)
    if args.batch_size is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, per_device_batch_size=args.batch_size))
    if args.lora_rank is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           lora_rank=args.lora_rank))
    if args.eval_steps is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           eval_steps=args.eval_steps))
    cfg.validate(world_size=world)
    mesh = create_mesh(cfg.mesh, device, args.backend) if multi \
        else None
    if mesh is not None:
        device = torch.device(device.type, torch.cuda.current_device()) \
            if device.type == "cuda" else device
        logger.info("rank %d of %d, mesh %s", rank, world,
                    dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    logger.info("training on %s", device)

    # ---- data ----
    global_batch = (cfg.train.per_device_batch_size * world
                    * cfg.train.grad_accum_steps)
    # this process's rows: its block of the batch axes (ranks that differ
    # only on the other axes load the same rows)
    shard_index, shard_count = batch_layout(cfg.model, mesh)
    local_batch = global_batch // shard_count
    epochs = args.epochs or cfg.train.num_epochs
    names, name_table = [], {}
    if args.names:
        with open(args.names) as f:
            table = json.load(f)
        names = table["list"]
        name_table = table.get("dict") or {n: i for i, n
                                           in enumerate(names)}
    if args.stream:
        if not args.steps:
            raise SystemExit("--stream requires --steps (a stream has "
                             "no epoch length)")
        if not args.tokenizer:
            raise SystemExit("--stream requires --tokenizer (rows are "
                             "tokenized on the fly)")
        from transformers import AutoTokenizer

        from macaw_llm_tpu_torch.data.loader import StreamingBatchLoader
        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        media = (None if args.no_media else
                 MediaSource(names, cfg.data,
                             image_size=cfg.model.vision.image_size,
                             n_frames=cfg.model.fusion.n_frames))
        steps_per_epoch = max(1, -(-args.steps // max(epochs, 1)))
        loader = StreamingBatchLoader(
            args.stream, tokenizer, media=media, name_table=name_table,
            global_batch=local_batch, accum=cfg.train.grad_accum_steps,
            max_text_len=cfg.data.max_text_len,
            shuffle_buffer=args.shuffle_buffer, seed=cfg.train.seed,
            steps_per_epoch=steps_per_epoch, process_index=shard_index,
            process_count=shard_count)
    else:
        if args.synthetic or not args.cache:
            ds = synthetic_dataset(cfg)
            media = None if args.no_media else _zero_media(cfg)
        else:
            ds = TokenizedDataset.load(args.cache)
            media = MediaSource(names, cfg.data,
                                image_size=cfg.model.vision.image_size,
                                n_frames=cfg.model.fusion.n_frames)
        loader = BatchLoader(ds, media, global_batch=local_batch,
                             accum=cfg.train.grad_accum_steps,
                             seed=cfg.train.seed, process_index=shard_index,
                             process_count=shard_count)
    total_steps = max(1, loader.steps_per_epoch * epochs)
    if args.steps:
        total_steps = min(total_steps, args.steps)

    # ---- eval split ----
    eval_loader = None
    want_eval = args.do_eval or args.eval_cache or cfg.train.eval_steps > 0
    if want_eval:
        if args.eval_cache:
            eval_ds = TokenizedDataset.load(args.eval_cache)
            eval_media = media
        else:  # held-out synthetic split (different seed than training)
            eval_ds = synthetic_dataset(cfg, n=32, seed=1234)
            eval_media = None if args.no_media else _zero_media(cfg)
        eval_loader = BatchLoader(
            eval_ds, eval_media,
            global_batch=cfg.train.per_device_batch_size * world
            // shard_count, accum=1, seed=cfg.train.seed,
            process_index=shard_index, process_count=shard_count)

    # ---- model / trainer / resume ----
    params = load_pretrained(cfg, args)
    if cfg.train.lora_rank > 0:
        from macaw_llm_tpu_torch.train.lora import init_lora
        params["llm"]["layers"]["lora"] = init_lora(
            torch.Generator(device=device).manual_seed(cfg.train.seed + 1),
            cfg.model.llm, cfg.train.lora_rank)
    trainer = Trainer(cfg.model, cfg.train, total_steps, device=device,
                      mesh=mesh)
    state = trainer.init_state(params)
    del params

    if cfg.train.save_steps > 0:
        ckpt = CheckpointManager(args.output_dir,
                                 save_steps=cfg.train.save_steps,
                                 max_to_keep=cfg.train.save_total_limit,
                                 snapshot=cfg.train.ckpt_snapshot,
                                 trainer=trainer)
    else:
        ckpt = _NullCkpt()
    restore_s = None
    if cfg.train.resume and ckpt.latest_step() is not None:
        logger.info("resuming from step %s", ckpt.latest_step())
        t0 = time.perf_counter()
        state = ckpt.restore(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0

    metrics_log = MetricsLogger(
        os.path.join(args.output_dir, "metrics.jsonl") if rank == 0
        else None, log_every=cfg.train.log_steps)
    if restore_s is not None:  # the resume's cost, once
        metrics_log.log(state.step, {"ckpt_restore_s": restore_s})
        metrics_log.flush()

    logged_saves = set()

    def save_and_wait(state):
        """A forced save of ``state``'s step (unless one was made), waited
        for; its cost goes to metrics.jsonl once."""
        ckpt.save(state, cfg, force=True)
        ckpt.wait()
        s = ckpt.last_save
        if s is not None and s["step"] not in logged_saves and rank == 0:
            logged_saves.add(s["step"])
            metrics_log.log(s["step"], {
                "ckpt_bytes": s["bytes"], "ckpt_blocking_ms": s["blocking_ms"],
                "ckpt_write_s": s["write_s"],
                "ckpt_snapshot": float(s["mode"] == "snapshot")})
            metrics_log.flush()

    # preemption: on SIGTERM/SIGINT finish the current step, checkpoint,
    # and exit cleanly
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        logger.warning("signal %s received — checkpointing and exiting",
                       signum)
        preempted["flag"] = True

    old_handlers = {sig: signal.signal(sig, _on_signal)
                    for sig in (signal.SIGTERM, signal.SIGINT)}

    # ---- loop ----
    tokens_per_batch = global_batch * cfg.data.max_text_len
    start_step = int(state.step)
    done = start_step >= total_steps
    try:
        for epoch in range(epochs):
            if done:
                break
            # resume fast-forward: skip this epoch's already-trained prefix
            # without assembling it (no media decode for skipped batches)
            skip = min(max(0, start_step - epoch * loader.steps_per_epoch),
                       loader.steps_per_epoch)
            if skip == loader.steps_per_epoch:
                continue
            batch_iter = iter(device_prefetch(loader.epoch(epoch, skip=skip),
                                              device=device))
            # prime the pipeline outside the stall metric: the first fetch
            # starts the decode pools and fills the prefetch window
            t_prime = time.perf_counter()
            batch = next(batch_iter, None)
            logger.info("loader primed in %.3f s",
                        time.perf_counter() - t_prime)
            loader_wait_s = 0.0
            while batch is not None:
                state, m = trainer.train_step(state, batch)
                step = int(state.step)
                m = dict(m)
                m["loader_wait_s"] = round(loader_wait_s, 6)
                metrics_log.log(step, m, tokens_per_batch=tokens_per_batch,
                                examples_per_batch=global_batch,
                                n_chips=world)
                if on_step is not None:
                    on_step(step, state, m)
                if (eval_loader is not None and cfg.train.eval_steps > 0
                        and step % cfg.train.eval_steps == 0):
                    em = _run_eval(trainer, state, eval_loader,
                                   cfg.train.eval_batches, device)
                    metrics_log.log(step, em)
                    metrics_log.flush()
                ckpt.save(state, cfg)
                if multi:  # every rank stops at the same step
                    flag = torch.tensor(float(preempted["flag"]),
                                        device=device)
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    preempted["flag"] = bool(flag.item())
                if preempted["flag"]:
                    save_and_wait(state)
                    logger.warning("checkpointed at step %d after "
                                   "preemption signal; resume with the same "
                                   "command", step)
                    done = True
                    break
                if step >= total_steps:
                    done = True
                    break
                # loader stall: host time blocked waiting for the next batch
                t_wait = time.perf_counter()
                batch = next(batch_iter, None)
                loader_wait_s = time.perf_counter() - t_wait

        save_and_wait(state)
        if args.do_eval and eval_loader is not None:
            em = _run_eval(trainer, state, eval_loader,
                           cfg.train.eval_batches, device)
            metrics_log.log(int(state.step), em)
            logger.info("final eval: loss=%.4f token_accuracy=%.4f",
                        em["eval_loss"], em["eval_token_accuracy"])
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        ckpt.close()
        metrics_log.close()
    logger.info("training done at step %d", int(state.step))
    return state


def _run_eval(trainer, state, eval_loader, max_batches: int, device):
    """Forward-only pass over up to max_batches eval batches; the loader
    yields [1, B, ...] (accum=1) — strip the accum axis."""
    def gen():
        n = 0
        for batch in device_prefetch(eval_loader.epoch(0), device=device):
            if n >= max_batches:
                break
            n += 1
            yield {k: v[0] for k, v in batch.items()}
    return trainer.evaluate(state, gen())


def _zero_media(cfg: Config):
    """Synthetic media source: always-zero tensors (the reference's
    absent-modality behavior)."""
    return MediaSource([], cfg.data,
                       image_size=cfg.model.vision.image_size,
                       n_frames=cfg.model.fusion.n_frames)


if __name__ == "__main__":
    main()
