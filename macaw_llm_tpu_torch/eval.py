"""Evaluation / inference harness (counterpart of ``macaw_llm_tpu/eval.py``):
read ``{ds}_val_inference.json`` rows (image/video/audio name or 'None',
instruction, response), cap the example count, run batched greedy or beam
generation over the fused multimodal prefix (greedy, beam search, or
greedy with prompt-lookup speculative decoding), and dump the generations
beside the ground truth; plus the shifted token-accuracy metric."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import Config, EOS_ID, IGNORE_ID, PAD_ID
from macaw_llm_tpu_torch.data.loader import MediaSource, host_tensor
from macaw_llm_tpu_torch.data.templates import format_prompt
from macaw_llm_tpu_torch.generate import (beam_search, generate,
                                          generate_speculative)
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.parallel.tensor_parallel import TensorParallel


def token_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Shifted argmax accuracy ignoring IGNORE_ID."""
    preds = logits[:, :-1].argmax(-1)
    refs = labels[:, 1:]
    valid = refs != IGNORE_ID
    if valid.sum() == 0:
        return 0.0
    return float((preds[valid] == refs[valid]).mean())


def batch_inference_generation(
        params: dict, cfg: Config, tokenizer, examples: List[dict],
        media: Optional[MediaSource] = None, *,
        batch_size: int = 8, max_new_tokens: Optional[int] = None,
        num_beams: int = 1,
        speculative: int = 0,
        out_path: Optional[str] = None,
        align_cache: Optional[dict] = None,
        device="cuda",
        tp: Optional[TensorParallel] = None) -> List[dict]:
    """Batched generation over val rows on ``device`` (where ``params``
    live; the GPU unless ``device="cpu"``).

    Each row: {'instruction': str, 'response': str, 'image'|'video'|'audio':
    name or 'None'}. Absent media become zero tensors, matching training.
    ``speculative`` = K > 0 drafts K tokens a round by prompt lookup over
    the prompt text (``generate_speculative``): the greedy tokens.
    ``tp``: ``params`` and ``align_cache`` are this rank's blocks of a
    tensor-parallel tree; every rank of the group runs the same batches
    and gets the same results.
    """
    device = resolve_device(device)
    mcfg = cfg.model
    max_new = max_new_tokens or cfg.data.max_new_tokens
    max_len = cfg.data.max_text_len
    vis = mcfg.vision
    results = []

    name_idx = {}
    if media is not None:
        name_idx = {n: i for i, n in enumerate(media.names)}

    def dev(x: np.ndarray) -> torch.Tensor:
        return host_tensor(x).to(device)

    for start in range(0, len(examples), batch_size):
        chunk = examples[start:start + batch_size]
        b = len(chunk)
        ids = np.full((b, max_len), PAD_ID, np.int32)
        mask = np.zeros((b, max_len), np.int32)
        for i, e in enumerate(chunk):
            prompt = format_prompt(e["instruction"], e.get("input", ""))
            t = tokenizer.encode(prompt)
            # strip a trailing EOS if the tokenizer appends one
            if t and t[-1] == EOS_ID:
                t = t[:-1]
            t = t[:max_len]
            ids[i, :len(t)] = t
            mask[i, :len(t)] = 1

        if media is not None:
            images = np.stack([
                media.image(name_idx.get(e.get("image", "None"), -1))
                for e in chunk])
            audios = np.stack([
                media.audio(name_idx.get(e.get("audio", "None"), -1))
                for e in chunk])
            videos = np.stack([
                media.video(name_idx.get(e.get("video", "None"), -1))
                for e in chunk])
        else:
            images = np.zeros((b, vis.image_size, vis.image_size, 3),
                              np.uint8)
            audios = np.zeros((b, mcfg.audio.n_audio_samples), np.float32)
            videos = np.zeros((b, mcfg.fusion.n_frames, vis.image_size,
                               vis.image_size, 3), np.uint8)

        with torch.inference_mode():
            batch = fusion.prepare_inputs(
                params, mcfg, input_ids=dev(ids), images=dev(images),
                audios=dev(audios), videos=dev(videos),
                attention_mask=dev(mask), align_cache=align_cache, tp=tp)
            if num_beams > 1:
                out = beam_search(params["llm"], mcfg.llm,
                                  inputs_embeds=batch.inputs_embeds,
                                  attention_mask=batch.attention_mask,
                                  num_beams=num_beams,
                                  max_new_tokens=max_new, eos_id=EOS_ID,
                                  pad_id=PAD_ID, device=device, tp=tp)
            elif speculative > 0:
                out = generate_speculative(
                    params["llm"], mcfg.llm,
                    inputs_embeds=batch.inputs_embeds,
                    prompt_ids=dev(ids), attention_mask=batch.attention_mask,
                    max_new_tokens=max_new, draft_len=speculative,
                    eos_id=EOS_ID, pad_id=PAD_ID, device=device, tp=tp)
            else:
                out = generate(params["llm"], mcfg.llm,
                               inputs_embeds=batch.inputs_embeds,
                               attention_mask=batch.attention_mask,
                               max_new_tokens=max_new, eos_id=EOS_ID,
                               pad_id=PAD_ID, device=device, tp=tp)
        toks = out.tokens.cpu().numpy()
        for i, e in enumerate(chunk):
            gen = toks[i]
            gen = gen[(gen != PAD_ID)]
            text = tokenizer.decode(gen.tolist(),
                                    skip_special_tokens=True) \
                if hasattr(tokenizer, "decode") else gen.tolist()
            results.append({
                "instruction": e["instruction"],
                "generation": text,
                "response": e.get("response", ""),
                "image": e.get("image", "None"),
                "video": e.get("video", "None"),
                "audio": e.get("audio", "None"),
            })
        if out_path:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    return results


def load_val_examples(path: str, cap: int) -> List[dict]:
    """Read {ds}_val_inference.json and cap the example count. Accepts a
    bare list (AVSD) or a {'data': [...]} wrapper (VQA)."""
    with open(path) as f:
        rows = json.load(f)
    if isinstance(rows, dict):
        rows = rows["data"]
    return rows[:cap]
