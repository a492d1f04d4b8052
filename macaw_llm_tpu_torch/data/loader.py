"""Online batch loader with host-side prefetch (counterpart of
``macaw_llm_tpu/data/loader.py``).

A thread pool decodes media for the next batches while the device computes
the current one, and the heavy DSP (log-mel, resize/normalize) runs on the
device inside the model: the loader ships raw uint8 frames [H, W, 3] and
raw fp32 waveforms [480000]. ``device_prefetch`` copies batches to the GPU
from pinned host memory on a side stream, a few batches ahead.

Semantics of the reference's data pipeline:
  * absent media (-1 index) -> zero tensors
  * 6-of-120 frame subsampling, last frame pinned
  * 30 s audio pad-or-trim
  * frames at data/avsd/frames/{name}_{i}.jpg, audio at
    data/avsd/audios/{name}.wav, COCO under data/coco/train2014/
"""

from __future__ import annotations

import os
import wave
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from macaw_llm_tpu_torch.audio.mel import N_SAMPLES, SAMPLE_RATE
from macaw_llm_tpu_torch.config import DataConfig
from macaw_llm_tpu_torch.data.datasets import TokenizedDataset
from macaw_llm_tpu_torch.image.preprocess import sample_frame_indices

def load_wav(path: str, target_len: int = N_SAMPLES,
             target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """WAV -> fp32 mono waveform at target_rate, padded or trimmed to
    ``target_len`` (30 s). Sources at another rate are resampled by linear
    interpolation.

    Uses the native C++ decoder (native/libmacaw_media.so) when built,
    falling back to the stdlib ``wave`` module."""
    from macaw_llm_tpu_torch.data import native
    if native.available():
        out = native.load_wav(path, target_len, target_rate)
        if out is not None:
            return out
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        sw = w.getsampwidth()
        ch = w.getnchannels()
        rate = w.getframerate()
    if sw == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        audio = np.frombuffer(raw, np.uint8).astype(np.float32) / 128.0 - 1.0
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    if rate != target_rate and rate > 0 and audio.shape[0] > 1:
        n_new = int(round(audio.shape[0] * target_rate / rate))
        audio = np.interp(
            np.arange(n_new, dtype=np.float64) * rate / target_rate,
            np.arange(audio.shape[0], dtype=np.float64),
            audio).astype(np.float32)
    if audio.shape[0] >= target_len:
        return audio[:target_len]
    return np.pad(audio, (0, target_len - audio.shape[0]))


def load_image(path: str, size: int) -> np.ndarray:
    """JPEG/PNG -> uint8 [size, size, 3] (resize shortest side + center
    crop on host; normalization happens on-device).

    JPEGs go through the native C++ decoder (libjpeg + bilinear resize,
    GIL-free) when built; PIL is the fallback and the PNG path."""
    from macaw_llm_tpu_torch.data import native
    if native.available() and path.lower().endswith((".jpg", ".jpeg")):
        with open(path, "rb") as f:
            out = native.decode_jpeg_crop(f.read(), size)
        if out is not None:
            return out
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if w < h:
            nw, nh = size, max(size, round(size * h / w))
        else:
            nw, nh = max(size, round(size * w / h)), size
        im = im.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)


@dataclass
class MediaSource:
    """Resolves media-name-table indices to arrays."""

    names: Sequence[str]                 # the global name table list
    data_cfg: DataConfig
    image_size: int = 224
    n_frames: int = 6

    def image(self, idx: int) -> np.ndarray:
        if idx < 0:
            return np.zeros((self.image_size, self.image_size, 3), np.uint8)
        name = self.names[idx]
        for base in (self.data_cfg.coco_dir, self.data_cfg.image_dir):
            p = os.path.join(base, name)
            if os.path.exists(p):
                return load_image(p, self.image_size)
        return np.zeros((self.image_size, self.image_size, 3), np.uint8)

    def audio(self, idx: int) -> np.ndarray:
        if idx < 0:
            return np.zeros((N_SAMPLES,), np.float32)
        name = self.names[idx]
        p = os.path.join(self.data_cfg.audio_dir, f"{name}.wav")
        if not os.path.exists(p):
            return np.zeros((N_SAMPLES,), np.float32)
        return load_wav(p)

    def video(self, idx: int) -> np.ndarray:
        shape = (self.n_frames, self.image_size, self.image_size, 3)
        if idx < 0:
            return np.zeros(shape, np.uint8)
        name = self.names[idx]
        frame_ids = sample_frame_indices(self.data_cfg.n_stored_frames,
                                         self.n_frames)
        frames = []
        for i in frame_ids:
            p = os.path.join(self.data_cfg.image_dir, f"{name}_{i}.jpg")
            if os.path.exists(p):
                frames.append(load_image(p, self.image_size))
            else:
                frames.append(np.zeros((self.image_size, self.image_size, 3),
                                       np.uint8))
        return np.stack(frames)


def _assemble(ds: TokenizedDataset, media: Optional[MediaSource],
              idx: np.ndarray, accum: int,
              pool=None) -> Dict[str, np.ndarray]:
    rows = ds.select(idx)
    n = len(idx)
    out = {
        "input_ids": rows.input_ids.astype(np.int32),
        "attention_mask": rows.attention_mask.astype(np.int32),
        "labels": rows.labels.astype(np.int32),
    }
    if media is not None:
        if pool is not None:
            # fan the 3*B media decodes over the pool — the native C++
            # decoder releases the GIL, so this is true parallel decode
            img_f = [pool.submit(media.image, i) for i in rows.images]
            aud_f = [pool.submit(media.audio, i) for i in rows.audios]
            vid_f = [pool.submit(media.video, i) for i in rows.videos]
            out["images"] = np.stack([f.result() for f in img_f])
            out["audios"] = np.stack([f.result() for f in aud_f])
            out["videos"] = np.stack([f.result() for f in vid_f])
        else:
            out["images"] = np.stack([media.image(i) for i in rows.images])
            out["audios"] = np.stack([media.audio(i) for i in rows.audios])
            out["videos"] = np.stack([media.video(i) for i in rows.videos])
    mb = n // accum
    return {k: v.reshape((accum, mb) + v.shape[1:]) for k, v in out.items()}


def device_prefetch(batches: Iterator[Dict[str, np.ndarray]], device="cuda",
                    lookahead: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Overlap the host-to-device copy of the next batches with the step.

    Each batch is copied from pinned host memory with ``non_blocking``
    copies on a side stream, ``lookahead`` batches ahead of the one handed
    out; a batch is handed out only after the consumer's stream waits on
    its copy's event (and the tensors are recorded on that stream, so the
    allocator does not reuse them early). On the CPU the batches are
    converted in order, with no copy."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: host_tensor(v) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    pending = deque()
    for batch in batches:
        with torch.cuda.stream(side):
            out = {k: host_tensor(v).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        pending.append((out, done))
        if len(pending) > lookahead:
            yield _ready(*pending.popleft())
    while pending:
        yield _ready(*pending.popleft())


def host_tensor(x: np.ndarray) -> torch.Tensor:
    """A host array as a tensor (no copy where it can share memory); int32
    arrays become int64, the index dtype of torch's gathers."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if t.dtype == torch.int32 else t


def _ready(batch: Dict[str, torch.Tensor],
           done: torch.cuda.Event) -> Dict[str, torch.Tensor]:
    stream = torch.cuda.current_stream()
    stream.wait_event(done)
    for t in batch.values():
        t.record_stream(stream)
    return batch


class BatchLoader:
    """Shuffled, epoch-aware iterator of device-ready batches.

    Two levels of host parallelism keep the device fed (the reference's
    biggest liability is per-step synchronous CPU media work,
    llm_trainer.py:306-381):
      * ``num_workers`` decode threads fan out the per-example JPEG/WAV
        decodes inside every batch (GIL-free via the native decoder)
      * up to ``prefetch`` whole batches are assembled ahead of the
        training step, in order, on assembly threads

    Across processes each takes every ``process_count``-th example of the
    shuffled order from ``process_index`` on, ``global_batch`` of them a
    step (its rows of the step's batch). The last partial batch of an
    epoch is always dropped (shapes stay static): steps_per_epoch =
    n // (global_batch * process_count).
    """

    def __init__(self, ds: TokenizedDataset, media: Optional[MediaSource],
                 global_batch: int, accum: int = 1, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1):
        assert global_batch % accum == 0
        self.ds = ds
        self.media = media
        self.global_batch = global_batch
        self.accum = accum
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.steps_per_epoch = len(ds) // (global_batch * process_count)
        self._decode_pool = None
        self._batch_pool = None

    def _pools(self):
        from concurrent.futures import ThreadPoolExecutor
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="macaw-decode")
            self._batch_pool = ThreadPoolExecutor(
                max_workers=self.prefetch,
                thread_name_prefix="macaw-batch")
        return self._decode_pool, self._batch_pool

    def epoch(self, epoch: int,
              skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this epoch's batches, starting at batch index ``skip``.

        ``skip`` is how resume fast-forwards: skipped batches are never
        assembled (no JPEG/WAV decode, no array work) — replaying a
        1000-step prefix costs index arithmetic, not media decode. The
        shuffled order is deterministic per epoch, so skipping preserves
        the exact resume position."""
        rng = np.random.RandomState(self.seed + epoch)
        perm = rng.permutation(len(self.ds))
        # this process's share of the shuffled order
        shard = perm[self.process_index::self.process_count]
        decode_pool, batch_pool = self._pools()

        def assemble(step: int):
            idx = shard[step * self.global_batch:
                        (step + 1) * self.global_batch]
            return _assemble(self.ds, self.media, idx, self.accum,
                             pool=decode_pool if self.media is not None
                             else None)

        # in-order sliding window of `prefetch` in-flight batch futures
        pending = deque()
        next_step = min(max(skip, 0), self.steps_per_epoch)
        try:
            while next_step < self.steps_per_epoch or pending:
                while (len(pending) < self.prefetch
                       and next_step < self.steps_per_epoch):
                    pending.append(batch_pool.submit(assemble, next_step))
                    next_step += 1
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


def stream_jsonl(paths: Sequence[str], process_index: int = 0,
                 process_count: int = 1) -> Iterator[dict]:
    """Yield the JSON rows of the shard files in order, skipping blank
    lines, round-robin across processes by row index: every process sees
    a disjoint 1/process_count of the stream, whatever the file
    boundaries."""
    import json
    i = 0
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if i % process_count == process_index:
                    yield json.loads(line)
                i += 1


class StreamingBatchLoader:
    """Streaming dataset mode (reference ``DataTrainingArguments.streaming``,
    run_clm_llms.py:268-273 — scaffolded there, wired to HF hub streaming,
    never used with the pickle cache). Here: train straight
    from JSONL instruction shards larger than host RAM — rows are tokenized
    on the fly, shuffled in a bounded buffer, and assembled into the same
    device-ready [A, B, ...] batches as ``BatchLoader``; no prebuilt npz
    cache pass.

    Row schema (one JSON object per line):
      * text: either ``{"prompt": ..., "output": ...}`` (pre-formatted) or
        Alpaca fields ``{"instruction", "input"?, "output"}`` which are
        formatted with the reference's exact template
        (preprocess_data_supervised.py:27-38)
      * media (optional): ``"image"``/``"audio"``/``"video"`` name-table
        keys; absent or unknown names become -1 -> zero tensors, the
        reference's absent-media behavior (llm_trainer.py:314-352)

    Shuffling is a seeded streaming buffer (fill ``shuffle_buffer`` rows,
    emit a uniformly drawn one, refill) — deterministic per (seed, epoch),
    so ``epoch(e, skip=k)`` resumes exactly: skipped batches replay the
    same row consumption and rng draws (tokenizing to re-check row
    validity, which is cheap) but never decode media (the expensive part).

    ``steps_per_epoch`` must be given (a stream has no len(); the
    reference's streaming mode likewise requires max_steps).
    """

    def __init__(self, paths: Sequence[str], tokenizer,
                 media: Optional[MediaSource] = None,
                 name_table: Optional[Dict[str, int]] = None,
                 global_batch: int = 8, accum: int = 1,
                 max_text_len: int = 256, shuffle_buffer: int = 1024,
                 seed: int = 0, steps_per_epoch: int = 0,
                 prefetch: int = 2, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1):
        assert global_batch % accum == 0
        assert steps_per_epoch > 0, \
            "streaming mode needs an explicit steps_per_epoch (--steps)"
        self.paths = list(paths)
        self.tokenizer = tokenizer
        self.media = media
        self.name_table = name_table or {}
        self.global_batch = global_batch
        self.accum = accum
        self.max_text_len = max_text_len
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.seed = seed
        self.steps_per_epoch = steps_per_epoch
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self._decode_pool = None

    def _shuffled_rows(self, rng: np.random.RandomState) -> Iterator[dict]:
        buf = []
        for row in stream_jsonl(self.paths, self.process_index,
                                self.process_count):
            buf.append(row)
            if len(buf) >= self.shuffle_buffer:
                j = rng.randint(len(buf))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        while buf:
            j = rng.randint(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()

    def _row_to_example(self, row: dict):
        from macaw_llm_tpu_torch.data.datasets import tokenize_example
        from macaw_llm_tpu_torch.data.templates import format_prompt
        if "prompt" in row:
            prompt = row["prompt"]
        else:
            prompt = format_prompt(row["instruction"], row.get("input", ""))
        tok = tokenize_example(self.tokenizer, prompt,
                               row.get("output", row.get("response", "")),
                               self.max_text_len)
        if tok is None:
            return None
        nt = self.name_table
        ids = tuple(nt.get(row[k], -1) if row.get(k) else -1
                    for k in ("image", "audio", "video"))
        return tok, ids

    def epoch(self, epoch: int,
              skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed + epoch)
        rows = self._shuffled_rows(rng)
        pool = None
        if self.media is not None:
            from concurrent.futures import ThreadPoolExecutor
            if self._decode_pool is None:
                self._decode_pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="macaw-stream-decode")
            pool = self._decode_pool

        gb = self.global_batch
        # resume fast-forward: replay the skipped prefix's row consumption
        # exactly (a batch consumes rows until gb VALID ones, so validity
        # must be re-checked — tokenize, which is cheap, but never decode
        # media, which is the expensive part the skip avoids)
        skipped = 0
        while skipped < min(max(skip, 0), self.steps_per_epoch) * gb:
            row = next(rows, None)
            if row is None:
                return
            if self._row_to_example(row) is not None:
                skipped += 1
        for step in range(max(skip, 0), self.steps_per_epoch):
            cols = {"input_ids": [], "attention_mask": [], "labels": []}
            idx = {"images": [], "audios": [], "videos": []}
            while len(cols["input_ids"]) < gb:
                row = next(rows, None)
                if row is None:
                    return  # stream dried up before steps_per_epoch
                ex = self._row_to_example(row)
                if ex is None:
                    continue
                tok, (im, au, vi) = ex
                for k, v in tok.items():
                    cols[k].append(v)
                idx["images"].append(im)
                idx["audios"].append(au)
                idx["videos"].append(vi)
            ds = TokenizedDataset(
                np.stack(cols["input_ids"]),
                np.stack(cols["attention_mask"]),
                np.stack(cols["labels"]),
                np.asarray(idx["images"], np.int32),
                np.asarray(idx["audios"], np.int32),
                np.asarray(idx["videos"], np.int32))
            yield _assemble(ds, self.media, np.arange(gb), self.accum,
                            pool=pool)
