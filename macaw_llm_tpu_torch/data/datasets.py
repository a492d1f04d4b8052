"""Dataset construction: instruction JSON -> tokenized numpy arrays.

Replicates the reference's offline tokenization recipe
(preprocess_data_supervised.py:96-168 VQA, :171-216 Alpaca, :292-359 AVSD,
:378-451 mixer) with its exact masking semantics:

  * full text  = prompt + '\\n {output} \\n\\n'
  * input_ids  = encode(full)[:max_len], padded with pad_token_id
  * prefix_len = len(encode(prompt)) - 1
  * labels     = [-100]*prefix_len + ids[prefix_len:], padded with -100
  * examples whose prompt alone reaches max_len are dropped (:143)
  * media columns are integer indices into a name table, -1 = absent

Output is a dict of numpy arrays (the cache format), written with
np.savez instead of pickled torch tensors.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from macaw_llm_tpu_torch.config import IGNORE_ID
from macaw_llm_tpu_torch.data.templates import format_prompt


@dataclass
class TokenizedDataset:
    input_ids: np.ndarray        # [N, L] int32
    attention_mask: np.ndarray   # [N, L] int32
    labels: np.ndarray           # [N, L] int32
    images: np.ndarray           # [N] int32 index into name table, -1 absent
    audios: np.ndarray           # [N] int32
    videos: np.ndarray           # [N] int32

    def __len__(self):
        return self.input_ids.shape[0]

    def select(self, idx) -> "TokenizedDataset":
        return TokenizedDataset(*(getattr(self, f)[idx] for f in (
            "input_ids", "attention_mask", "labels", "images", "audios",
            "videos")))

    @staticmethod
    def concatenate(parts: Sequence["TokenizedDataset"]) -> "TokenizedDataset":
        return TokenizedDataset(*(np.concatenate(
            [getattr(p, f) for p in parts]) for f in (
            "input_ids", "attention_mask", "labels", "images", "audios",
            "videos")))

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, input_ids=self.input_ids,
                 attention_mask=self.attention_mask, labels=self.labels,
                 images=self.images, audios=self.audios, videos=self.videos)

    @staticmethod
    def load(path: str) -> "TokenizedDataset":
        z = np.load(path)
        return TokenizedDataset(z["input_ids"], z["attention_mask"],
                                z["labels"], z["images"], z["audios"],
                                z["videos"])


def tokenize_example(tokenizer, prompt: str, output: str,
                     max_len: int = 256) -> Optional[Dict[str, np.ndarray]]:
    """One example -> ids/mask/labels per the reference recipe
    (preprocess_data_supervised.py:137-152). Returns None if the prompt
    alone fills max_len (the reference skips those)."""
    pad_id = tokenizer.pad_token_id
    t_prompt = tokenizer.encode(prompt)
    if len(t_prompt) >= max_len:
        return None
    t_all = tokenizer.encode(prompt + "\n {} \n\n".format(output))
    t_all = t_all[:max_len]
    mask = [1] * len(t_all) + [0] * (max_len - len(t_all))
    ids = t_all + [pad_id] * (max_len - len(t_all))
    prefix_len = len(t_prompt) - 1
    labels = [IGNORE_ID] * prefix_len + ids[prefix_len:]
    labels = labels[:max_len]
    labels = labels + [IGNORE_ID] * (max_len - len(labels))
    # pad positions must not contribute to loss (the reference re-maps pad
    # 32006 -> -100 at load time, run_clm_llms.py:353-355)
    labels = [l if m == 1 else IGNORE_ID for l, m in zip(labels, mask)]
    return {
        "input_ids": np.asarray(ids, np.int32),
        "attention_mask": np.asarray(mask, np.int32),
        "labels": np.asarray(labels, np.int32),
    }


def _build(tokenizer, rows, max_len) -> TokenizedDataset:
    cols = {"input_ids": [], "attention_mask": [], "labels": [],
            "images": [], "audios": [], "videos": []}
    for prompt, output, im, au, vi in rows:
        tok = tokenize_example(tokenizer, prompt, output, max_len)
        if tok is None:
            continue
        for k, v in tok.items():
            cols[k].append(v)
        cols["images"].append(im)
        cols["audios"].append(au)
        cols["videos"].append(vi)
    return TokenizedDataset(
        np.stack(cols["input_ids"]) if cols["input_ids"] else
        np.zeros((0, max_len), np.int32),
        np.stack(cols["attention_mask"]) if cols["attention_mask"] else
        np.zeros((0, max_len), np.int32),
        np.stack(cols["labels"]) if cols["labels"] else
        np.zeros((0, max_len), np.int32),
        np.asarray(cols["images"], np.int32),
        np.asarray(cols["audios"], np.int32),
        np.asarray(cols["videos"], np.int32),
    )


def build_alpaca(tokenizer, examples: List[dict],
                 max_len: int = 256) -> TokenizedDataset:
    """Text-only instruction data (preprocess_data_supervised.py:171-216):
    media indices all -1."""
    rows = [(format_prompt(e["instruction"], e.get("input", "")),
             e["output"], -1, -1, -1) for e in examples]
    return _build(tokenizer, rows, max_len)


def build_vqa(tokenizer, examples: List[dict], name_table: Dict[str, int],
              max_len: int = 256) -> TokenizedDataset:
    """VQA-style rows {'instruction', 'output', 'image'}
    (preprocess_data_supervised.py:96-168). COCO image-id zero-padding to
    12 digits (:127-130) is applied to the name lookup."""
    rows = []
    for e in examples:
        name = coco_pad_image_name(e["image"])
        idx = name_table.get(name, -1)
        rows.append((format_prompt(e["instruction"], e.get("input", "")),
                     e["output"], idx, -1, -1))
    return _build(tokenizer, rows, max_len)


def build_avsd(tokenizer, dialogs: List[dict], name_table: Dict[str, int],
               max_len: int = 256) -> TokenizedDataset:
    """AVSD dialogs -> one example per turn
    (preprocess_data_supervised.py:292-359); video and audio share the
    same name index. Each dialog: {'video': name, 'turns':
    [{'question', 'answer'}, ...]}."""
    rows = []
    for d in dialogs:
        idx = name_table.get(d["video"], -1)
        for turn in d["turns"]:
            rows.append((format_prompt(turn["question"]), turn["answer"],
                         -1, idx, idx))
    return _build(tokenizer, rows, max_len)


def coco_pad_image_name(name: str) -> str:
    """Zero-pad the numeric id in COCO file names to 12 digits
    (preprocess_data_supervised.py:127-130)."""
    stem = name.split("_")[-1].split(".")[0]
    if len(stem) < 12:
        return name.replace(stem, "0" * (12 - len(stem)) + stem)
    return name


def build_name_table(image_names: Sequence[str],
                     video_names: Sequence[str]) -> Dict[str, object]:
    """Global media-name index (combine_visual_and_audio_names,
    preprocess_data_supervised.py:454-490): image file names + video keys
    -> {'dict': name->idx, 'list': [names]}."""
    names = list(image_names) + list(video_names)
    return {"dict": {n: i for i, n in enumerate(names)}, "list": names}


def mix_datasets(rng: np.random.RandomState,
                 parts: Sequence[TokenizedDataset],
                 per_part: int = 50000) -> TokenizedDataset:
    """Sample up to ``per_part`` from each part and concatenate
    (preprocess_all_datasets, preprocess_data_supervised.py:404-451)."""
    picked = []
    for p in parts:
        if len(p) <= per_part:
            picked.append(p)
        else:
            idx = rng.choice(len(p), per_part, replace=False)
            picked.append(p.select(idx))
    return TokenizedDataset.concatenate(picked)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Validation-set builders — produce the {ds}_val_inference.json rows that
# run_inference consumes (reference preprocess_data_supervised.py:40-93).
# ---------------------------------------------------------------------------

def build_vqa_val(annotations: List[dict],
                  questions: List[dict]) -> List[dict]:
    """VQA v2 val annotations + questions -> inference rows
    (preprocess_vqa2_to_val_dataset, preprocess_data_supervised.py:40-66).
    Each row: image path (COCO id zero-padded to 12 digits), video/audio
    'None', instruction = question, response = multiple_choice_answer."""
    q_by_id = {e["question_id"]: e["question"] for e in questions}
    rows = []
    for e in annotations:
        image = coco_pad_image_name(e["image_path"])
        rows.append({
            "image": image,
            "video": "None",
            "audio": "None",
            "instruction": q_by_id[e["question_id"]],
            "response": e["multiple_choice_answer"],
        })
    return rows


def build_avsd_val(metadata: Dict[str, dict],
                   path: str = "data/avsd/") -> List[dict]:
    """AVSD val metadata -> one inference row per dialog turn
    (preprocess_avsd_to_val_dataset, preprocess_data_supervised.py:68-93).
    video -> {path}/frames/{key}, audio -> {path}/audios/{key}.mp4.wav."""
    rows = []
    for key, md in metadata.items():
        video_dir = os.path.join(path, "frames/{}".format(key))
        audio_dir = os.path.join(path, "audios/{}.mp4.wav".format(key))
        for dialog in md["data"]:
            rows.append({
                "image": "None",
                "video": video_dir,
                "audio": audio_dir,
                "instruction": dialog["question"],
                "response": dialog["answer"],
            })
    return rows


# ---------------------------------------------------------------------------
# GPT-3.5-generated instruction data (the "unsupervised" variant,
# reference preprocess_data_unsupervised.py:214-311).
# ---------------------------------------------------------------------------

def instruction_filter(example: dict) -> bool:
    """Content filter of the instruction pipeline: drop examples whose
    instruction mentions 'caption' or whose response contains 'caption',
    ' no ' or 'not' (reference preprocess_data_unsupervised.py:51,172 —
    the authors scrub caption-style and negative answers). Returns True
    when the example should be KEPT."""
    return not ("caption" in example["instruction"]
                or "caption" in example["response"]
                or " no " in example["response"]
                or "not" in example["response"])


def build_instruction_coco(tokenizer, examples: List[dict],
                           name_table: Dict[str, int],
                           max_len: int = 256) -> TokenizedDataset:
    """COCO instruction rows {'id', 'instruction', 'response'} -> image
    examples (preprocess_coco_to_tensor_dataset,
    preprocess_data_unsupervised.py:40-92): content-filtered, Alpaca
    no-input prompt, image index from the instruction name table."""
    rows = []
    for e in examples:
        if not instruction_filter(e):
            continue
        idx = name_table.get(e["id"], -1)
        rows.append((format_prompt(e["instruction"]), e["response"],
                     idx, -1, -1))
    return _build(tokenizer, rows, max_len)


def build_instruction_avsd(tokenizer, examples: List[dict],
                           name_table: Dict[str, int],
                           max_len: int = 256) -> TokenizedDataset:
    """AVSD instruction rows {'id', 'instruction', 'response'} -> video+
    audio examples (preprocess_avsd_to_tensor_dataset,
    preprocess_data_unsupervised.py:156-211): content-filtered; the
    reference's inline prompt + ' Response:'-split prefix masking is
    identical to the standard recipe (prompt = Alpaca no-input template,
    full text = prompt + '\\n {response} \\n\\n'), so tokenize_example is
    reused. Video and audio share the same name index."""
    rows = []
    for e in examples:
        if not instruction_filter(e):
            continue
        idx = name_table.get(e["id"], -1)
        rows.append((format_prompt(e["instruction"]), e["response"],
                     -1, idx, idx))
    return _build(tokenizer, rows, max_len)


def build_instruction_name_table(coco_examples: List[dict],
                                 avsd_examples: List[dict]) -> Dict[str, object]:
    """Name table over the generated-example ids
    (combine_visual_and_audio_names, preprocess_data_unsupervised.py:
    290-306): COCO ids then AVSD ids, unfiltered (the reference indexes
    the raw example lists)."""
    return build_name_table([e["id"] for e in coco_examples],
                            [e["id"] for e in avsd_examples])
