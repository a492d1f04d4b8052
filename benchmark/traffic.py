"""The one general traffic generator. A traffic mix is a data file,
``traffic/<name>.json``; its ``kind`` says which window drives it:

* ``serve``: requests sent open loop to the program's continuous-batching
  engine at ``arrival.rate_per_s`` on average. The gaps between arrivals
  are evenly spaced, or, with ``arrival.gap_cv`` (their coefficient of
  variation: 1 for Poisson arrivals, above 1 for bursts), a fixed pool of
  ``POOL`` gamma-distributed gaps of mean one. Prompt and answer lengths
  come from a fixed pool too (``POOL`` pairs at evenly spaced quantiles of
  their distributions, paired by a fixed shuffle). So every seed serves
  the same set of sizes and gaps; the seed orders both pools and draws the
  token ids and the media.
* ``train``: optimizer steps over batches of ``rows`` rows of
  ``text_tokens`` tokens, every row with an image, a video clip and audio
  (``media`` "all") or text alone (``media`` "none"); labels on the text.
  Each batch is drawn from the seed on the device.

``kind`` also names the module that drives the window,
``drive_<kind>.py``. Token ids are drawn from the text range of the
vocabulary: never a marker, BOS, EOS or the pad id.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

# ids the traffic never draws as text: BOS, EOS, and Macaw's markers and
# pad (32000-32006); the first 16 ids are the tokenizer's specials
SPECIAL_LOW = 16
MARKER_IDS = range(32000, 32007)
# requests of a serving mix cycle through this many sizes and gaps
POOL = 512


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    if spec.get("media") not in ("all", "none"):
        raise ValueError(f"{path}: media must be 'all' or 'none'")
    return spec


def _grid(dist: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles (k + 1/2) / n of ``dist``:
    {"min", "max", "dist": "log_uniform" | "uniform"}."""
    lo, hi = dist["min"], dist["max"]
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def text_ids(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """``n`` ids uniform over the text range of the vocabulary."""
    width = vocab - SPECIAL_LOW - len(MARKER_IDS)
    ids = rng.integers(0, width, n) + SPECIAL_LOW
    return np.where(ids >= MARKER_IDS.start, ids + len(MARKER_IDS), ids)


def _gaps(cv: float, seed: int) -> np.ndarray:
    """``POOL`` gaps between arrivals, of mean exactly one: all equal for
    ``cv`` 0, else a fixed draw from the gamma distribution of that
    coefficient of variation, ordered by the seed."""
    if cv == 0:
        return np.ones(POOL)
    shape = 1.0 / cv ** 2
    g = np.random.default_rng(0).gamma(shape, 1.0 / shape, POOL)
    g *= POOL / g.sum()
    return g[np.random.default_rng([seed, 4]).permutation(POOL)]


class ServeTraffic:
    """Request ``i`` of a seed: its prompt ids (BOS first), answer budget
    and media (an index into the media pool, or None), and its arrival in
    mean gaps from the first (``arrival(i)``)."""

    def __init__(self, spec: dict, cfg: dict, seed: int):
        self.spec, self.cfg, self.seed = spec, cfg, int(seed)
        prompts = _grid(spec["prompt_tokens"], POOL)
        answers = _grid(spec["answer_tokens"], POOL)
        answers = answers[np.random.default_rng(0).permutation(POOL)]
        order = np.random.default_rng([self.seed, 1]).permutation(POOL)
        self.sizes = [(int(prompts[k]), int(answers[k])) for k in order]
        gaps = _gaps(spec["arrival"].get("gap_cv", 0), self.seed)
        self._starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        self.media_pool = self._media_pool() if spec["media"] == "all" \
            else None

    def arrival(self, i: int) -> float:
        """Request ``i``'s arrival after request 0's, in mean gaps."""
        return (i // POOL) * POOL + float(self._starts[i % POOL])

    def _media_pool(self) -> list:
        rng = np.random.default_rng([self.seed, 2])
        v, a = self.cfg["vision"], self.cfg["audio"]
        s, f = v["image_size"], self.cfg["fusion"]["n_frames"]
        n = a["sample_rate"] * a["chunk_length_s"]
        return [(rng.integers(0, 256, (s, s, 3), dtype=np.uint8),
                 (rng.standard_normal(n) * 0.1).astype(np.float32),
                 rng.integers(0, 256, (f, s, s, 3), dtype=np.uint8))
                for _ in range(self.spec["media_pool"])]

    def request(self, i: int) -> dict:
        prompt, answer = self.sizes[i % len(self.sizes)]
        rng = np.random.default_rng([self.seed, 3, i])
        ids = [1] + text_ids(rng, prompt - 1, self.cfg["vocab_size"]).tolist()
        media = None
        if self.media_pool is not None:
            media = int(rng.integers(len(self.media_pool)))
        return {"index": i, "ids": ids, "max_new": answer, "media": media}

    def media(self, index):
        return None if index is None else self.media_pool[index]


def train_batch(spec: dict, cfg: dict, seed: int, k: int, device) -> dict:
    """Batch ``k`` of a seed: [rows, text] ids (BOS first) with labels on
    every text position after BOS, an all-ones mask and, with ``media``
    "all", uint8 images and frames at the tower's size and 30 s of
    audio."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7919 * (k + 1)) % (2 ** 63))
    b, s = spec["rows"], spec["text_tokens"]
    vocab = cfg["vocab_size"]
    width = vocab - SPECIAL_LOW - len(MARKER_IDS)
    ids = torch.randint(0, width, (b, s), generator=gen, device=device) \
        + SPECIAL_LOW
    ids = torch.where(ids >= MARKER_IDS.start, ids + len(MARKER_IDS), ids)
    ids[:, 0] = 1
    labels = ids.clone()
    labels[:, 0] = -100
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": torch.ones_like(ids)}
    if spec["media"] == "none":
        return batch
    v, a = cfg["vision"], cfg["audio"]
    sz, f = v["image_size"], cfg["fusion"]["n_frames"]
    n = a["sample_rate"] * a["chunk_length_s"]

    def frames(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8)

    return dict(batch, images=frames(b, sz, sz, 3),
                audios=torch.randn((b, n), generator=gen, device=device) * 0.1,
                videos=frames(b, f, sz, sz, 3))
