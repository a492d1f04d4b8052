"""Offline preprocessing entry point (the port's copy of
``macaw_llm_tpu/run_preprocess.py``, which uses no JAX): the
preprocess_data*.py scripts of the reference.

Stage 1 (media extraction, host tools): video -> 120 sampled JPEG frames +
16 kHz WAV audio (reference preprocess_data.py). Needs OpenCV/ffmpeg on
the host; both are gated and reported if missing.

Stage 2 (dataset build): VQA / Alpaca / AVSD JSON -> tokenized npz cache +
name table (reference preprocess_data_supervised.py:378-451), using the
exact prompt/masking recipe (see data/datasets.py). The
``build-unsupervised`` variant covers the GPT-3.5-generated instruction
mixer with its content filters (preprocess_data_unsupervised.py:214-311),
``build-val`` emits the {ds}_val_inference.json files run_inference
consumes (preprocess_data_supervised.py:40-93), and ``resize-images`` is
the 336px thumbnail pass (:362-375).

Usage:
    python -m macaw_llm_tpu_torch.run_preprocess extract-media \
        --videos data/avsd/videos --out data/avsd
    python -m macaw_llm_tpu_torch.run_preprocess build \
        --tokenizer trained_models/llama_tokenizer \
        --vqa data/vqa/train.json --alpaca data/alpaca_data.json \
        --avsd data/avsd/train.json --out data/train_cache.npz \
        --names-out data/all_visual_names.json --per-part 50000
    python -m macaw_llm_tpu_torch.run_preprocess build-unsupervised \
        --tokenizer trained_models/llama_tokenizer \
        --coco data/generated_examples_coco.json \
        --avsd data/generated_examples_avsd.json \
        --out data/train_instruction.npz
    python -m macaw_llm_tpu_torch.run_preprocess build-val \
        --vqa-annotations data/vqa/mscoco_val2014_annotations.json \
        --vqa-questions data/vqa/OpenEnded_mscoco_val2014_questions.json \
        --avsd-metadata data/avsd/avsd_val.json
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np

from macaw_llm_tpu_torch.config import SPECIAL_TOKENS
from macaw_llm_tpu_torch.data.datasets import (build_alpaca, build_avsd,
                                         build_avsd_val,
                                         build_instruction_avsd,
                                         build_instruction_coco,
                                         build_instruction_name_table,
                                         build_name_table, build_vqa,
                                         build_vqa_val, mix_datasets)
from macaw_llm_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("macaw.preprocess")


def extract_media(videos_dir: str, out_dir: str, n_frames: int = 120):
    """Frames via OpenCV (reference preprocess_data.py:42-86 semantics:
    uniform n_frames sample, resample if shorter) + audio via ffmpeg
    (moviepy equivalent, :29-39)."""
    frames_dir = os.path.join(out_dir, "frames")
    audio_dir = os.path.join(out_dir, "audios")
    os.makedirs(frames_dir, exist_ok=True)
    os.makedirs(audio_dir, exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
        logger.warning("OpenCV unavailable — frame extraction skipped")
    import shutil
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        logger.warning("ffmpeg unavailable — audio extraction skipped")

    for path in sorted(glob.glob(os.path.join(videos_dir, "*.mp4"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if cv2 is not None:
            cap = cv2.VideoCapture(path)
            frames = []
            ok, frame = cap.read()
            while ok:
                frames.append(frame)
                ok, frame = cap.read()
            cap.release()
            if frames:
                idx = np.linspace(0, len(frames) - 1, n_frames).astype(int)
                for i, fi in enumerate(idx):
                    cv2.imwrite(os.path.join(frames_dir,
                                             f"{name}_{i}.jpg"),
                                frames[fi])
        if ffmpeg:
            subprocess.run(
                [ffmpeg, "-y", "-i", path, "-vn", "-ac", "1", "-ar",
                 "16000", os.path.join(audio_dir, f"{name}.wav")],
                check=False, capture_output=True)
        logger.info("extracted %s", name)


def build(args):
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    # centralize the vocab extension (reference added specials twice,
    # preprocess_data_supervised.py:384-398 — SURVEY quirk #6)
    tokenizer.add_special_tokens({
        "additional_special_tokens": list(SPECIAL_TOKENS.keys()),
        "pad_token": "[PAD]",
    })
    if args.tokenizer_out:
        tokenizer.save_pretrained(args.tokenizer_out)

    image_names, video_names = [], []
    parts = []
    rng = np.random.RandomState(args.seed)

    vqa_rows = json.load(open(args.vqa)) if args.vqa else []
    avsd_rows = json.load(open(args.avsd)) if args.avsd else []
    alpaca_rows = json.load(open(args.alpaca)) if args.alpaca else []

    image_names = sorted({r["image"] for r in vqa_rows if "image" in r})
    video_names = sorted({r["video"] for r in avsd_rows})
    table = build_name_table(image_names, video_names)
    if args.names_out:
        with open(args.names_out, "w") as f:
            json.dump(table, f)

    if vqa_rows:
        parts.append(build_vqa(tokenizer, vqa_rows, table["dict"],
                               args.max_len))
    if alpaca_rows:
        parts.append(build_alpaca(tokenizer, alpaca_rows, args.max_len))
    if avsd_rows:
        parts.append(build_avsd(tokenizer, avsd_rows, table["dict"],
                                args.max_len))
    if not parts:
        logger.error("no input datasets given")
        return 1
    mixed = mix_datasets(rng, parts, per_part=args.per_part)
    mixed.save(args.out)
    logger.info("wrote %d examples to %s", len(mixed), args.out)
    return 0


def build_unsupervised(args):
    """GPT-3.5-generated instruction mixer (the reference's
    preprocess_data_unsupervised.py:214-311): COCO + Alpaca + AVSD
    instruction examples, content-filtered ('caption'/' no '/'not'),
    name table over the generated-example ids, npz cache out."""
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    tokenizer.add_special_tokens({
        "additional_special_tokens": list(SPECIAL_TOKENS.keys()),
        "pad_token": "[PAD]",
    })
    if args.tokenizer_out:
        tokenizer.save_pretrained(args.tokenizer_out)

    coco_rows = json.load(open(args.coco))["data"] if args.coco else []
    avsd_rows = json.load(open(args.avsd))["data"] if args.avsd else []
    alpaca_rows = json.load(open(args.alpaca)) if args.alpaca else []

    table = build_instruction_name_table(coco_rows, avsd_rows)
    if args.names_out:
        with open(args.names_out, "w") as f:
            json.dump(table, f)

    parts = []
    if coco_rows:
        parts.append(build_instruction_coco(tokenizer, coco_rows,
                                            table["dict"], args.max_len))
    if alpaca_rows:
        parts.append(build_alpaca(tokenizer, alpaca_rows, args.max_len))
    if avsd_rows:
        parts.append(build_instruction_avsd(tokenizer, avsd_rows,
                                            table["dict"], args.max_len))
    if not parts:
        logger.error("no input datasets given")
        return 1
    rng = np.random.RandomState(args.seed)
    mixed = mix_datasets(rng, parts, per_part=args.per_part)
    mixed.save(args.out)
    logger.info("wrote %d instruction examples to %s", len(mixed), args.out)
    return 0


def build_val(args):
    """Emit {ds}_val_inference.json for run_inference (the reference's
    preprocess_vqa2_to_val_dataset / preprocess_avsd_to_val_dataset,
    preprocess_data_supervised.py:40-93)."""
    wrote = 0
    if args.vqa_annotations and args.vqa_questions:
        ann = json.load(open(args.vqa_annotations))["annotations"]
        qs = json.load(open(args.vqa_questions))["questions"]
        rows = build_vqa_val(ann, qs)
        out = args.vqa_out or "data/vqa/vqa_val_inference.json"
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"data": rows}, f)   # reference wraps VQA (:65-66)
        logger.info("wrote %d VQA val rows to %s", len(rows), out)
        wrote += 1
    if args.avsd_metadata:
        md = json.load(open(args.avsd_metadata))
        rows = build_avsd_val(md, path=args.avsd_path)
        out = args.avsd_out or "data/avsd/avsd_val_inference.json"
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f)             # reference dumps AVSD bare (:93)
        logger.info("wrote %d AVSD val rows to %s", len(rows), out)
        wrote += 1
    if not wrote:
        logger.error("no val inputs given")
        return 1
    return 0


def resize_images(src_dir: str, out_dir: str, size: int = 336):
    """Thumbnail every image in src_dir to fit size x size (the
    reference's resize_images utility,
    preprocess_data_supervised.py:362-375)."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        path = os.path.join(src_dir, name)
        if not os.path.isfile(path):
            continue
        try:
            with Image.open(path) as im:
                im.thumbnail((size, size))
                im.save(os.path.join(out_dir, name))
            n += 1
        except OSError:
            logger.warning("skipping unreadable image %s", name)
    logger.info("resized %d images into %s", n, out_dir)
    return 0


def main(argv=None):
    setup_logging()
    p = argparse.ArgumentParser(description="Macaw-TPU preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("extract-media")
    pe.add_argument("--videos", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--n-frames", type=int, default=120)

    pb = sub.add_parser("build")
    pb.add_argument("--tokenizer", required=True)
    pb.add_argument("--tokenizer-out", default=None)
    pb.add_argument("--vqa", default=None)
    pb.add_argument("--alpaca", default=None)
    pb.add_argument("--avsd", default=None)
    pb.add_argument("--out", required=True)
    pb.add_argument("--names-out", default=None)
    pb.add_argument("--max-len", type=int, default=256)
    pb.add_argument("--per-part", type=int, default=50000)
    pb.add_argument("--seed", type=int, default=0)

    pu = sub.add_parser("build-unsupervised",
                        help="GPT-3.5-generated instruction data "
                             "(reference preprocess_data_unsupervised.py)")
    pu.add_argument("--tokenizer", required=True)
    pu.add_argument("--tokenizer-out", default=None)
    pu.add_argument("--coco", default=None,
                    help="generated_examples_coco.json")
    pu.add_argument("--avsd", default=None,
                    help="generated_examples_avsd.json")
    pu.add_argument("--alpaca", default=None)
    pu.add_argument("--out", required=True)
    pu.add_argument("--names-out", default=None)
    pu.add_argument("--max-len", type=int, default=256)
    pu.add_argument("--per-part", type=int, default=50000)
    pu.add_argument("--seed", type=int, default=0)

    pv = sub.add_parser("build-val",
                        help="emit {ds}_val_inference.json for eval")
    pv.add_argument("--vqa-annotations", default=None)
    pv.add_argument("--vqa-questions", default=None)
    pv.add_argument("--vqa-out", default=None)
    pv.add_argument("--avsd-metadata", default=None)
    pv.add_argument("--avsd-path", default="data/avsd/")
    pv.add_argument("--avsd-out", default=None)

    pr = sub.add_parser("resize-images",
                        help="336px thumbnail pass over a frame dir")
    pr.add_argument("--src", required=True)
    pr.add_argument("--out", required=True)
    pr.add_argument("--size", type=int, default=336)

    args = p.parse_args(argv)
    if args.cmd == "extract-media":
        extract_media(args.videos, args.out, args.n_frames)
        return 0
    if args.cmd == "build-unsupervised":
        return build_unsupervised(args)
    if args.cmd == "build-val":
        return build_val(args)
    if args.cmd == "resize-images":
        return resize_images(args.src, args.out, args.size)
    return build(args)


if __name__ == "__main__":
    sys.exit(main())
