"""Serving layer: batched multimodal generation over HTTP (counterpart of
``macaw_llm_tpu/serve.py``).

  * ContinuousEngine (default): slot-based continuous batching: admission
    prefill on its own thread (and, on the GPU, its own CUDA stream),
    per-slot budgets and temperatures, token streaming
  * InferenceEngine (``continuous=False``): request queue + background
    batcher: requests are grouped up to ``max_batch`` or
    ``batch_timeout_ms``, padded to a shared bucketed prompt length, run as
    one fused prefill + decode with per-row temperature and token budgets,
    and fanned back out
  * media: base64 WAV audio, base64 JPEG image, a list of base64 frames,
    or absent (zeros)
  * stdlib-only HTTP (POST /generate, GET /healthz); JSON in and out

Programmatic use (no HTTP) goes through ``Engine.generate_sync``. Both
engines run on the GPU unless ``device="cpu"`` is asked for.

Where the reference compiles its prefill, admit and step functions and
donates the cache to them, this module runs eagerly: the cache, ``lengths``
and ``toks`` are preallocated tensors that admission and the decode step
update in place.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import EOS_ID, ModelConfig, PAD_ID
from macaw_llm_tpu_torch.data.templates import format_prompt
from macaw_llm_tpu_torch.generate import _sample, generate
from macaw_llm_tpu_torch.models import fusion, llama

logger = logging.getLogger("macaw.serve")

PROMPT_BUCKETS = (32, 64, 128, 256)
READBACK_DEPTH = 2  # decode steps dispatched before a step's tokens are read


def _init_align_cache(params: dict, mcfg: ModelConfig, mode: str):
    """Engine-side alignment K/V cache setup (see
    ``fusion.precompute_align_cache``): serving never trains, so the
    weight-only projections are computed once at startup and the dead K/V
    in-projection rows are dropped. mode: "bf16" (exact, in the compute
    dtype), "int8" (half the memory, about 0.2% row error), or "off"."""
    if mode == "off":
        return fusion.pack_towers(params), None
    with torch.inference_mode():
        cache = fusion.precompute_align_cache(params, mcfg,
                                              quantize=mode == "int8")
    return fusion.pack_towers(fusion.strip_align_kv(params)), cache


def _seed_from_clock() -> int:
    return int(time.time() * 1e3) % 2**31


@dataclass
class Request:
    prompt: str
    image: Optional[np.ndarray] = None      # uint8 [H, W, 3]
    audio: Optional[np.ndarray] = None      # fp32 [480000]
    video: Optional[np.ndarray] = None      # uint8 [F, H, W, 3]
    max_new_tokens: int = 128
    temperature: float = 0.0
    stream_cb: Optional[object] = None      # callable(token_id) per token
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional[dict] = None


def _prompt_tokens(tokenizer, prompt: str) -> List[int]:
    t = tokenizer.encode(format_prompt(prompt))
    if t and t[-1] == EOS_ID:
        t = t[:-1]
    return t


def _decode_text(tokenizer, ids: List[int]):
    if hasattr(tokenizer, "decode"):
        return tokenizer.decode(ids, skip_special_tokens=True)
    return ids


class InferenceEngine:
    """Owns the model params and the batching loop."""

    supports_streaming = False  # one generate() call per batch: no
                                # per-token callback; use ContinuousEngine

    def __init__(self, params: dict, cfg: ModelConfig, tokenizer,
                 max_batch: int = 8, batch_timeout_ms: float = 20.0,
                 max_new_tokens: int = 128, align_cache: str = "bf16",
                 kv_cache_dtype: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.params, self.align_cache = _init_align_cache(params, cfg,
                                                          align_cache)
        self.kv_cache_dtype = kv_cache_dtype
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.max_new_tokens = max_new_tokens
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(_seed_from_clock())
        self.stats = {"requests": 0, "batches": 0, "tokens": 0}

    # -------------------- lifecycle --------------------

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    # -------------------- public API --------------------

    def generate_sync(self, req: Request, timeout: float = 300.0) -> dict:
        self.queue.put(req)
        if not req._done.wait(timeout):
            raise TimeoutError("generation timed out")
        return req._result

    # -------------------- batching loop --------------------

    def _collect(self) -> List[Request]:
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.batch_timeout
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                with torch.inference_mode():
                    self._run_batch(batch)
            except Exception as e:  # noqa: BLE001: fail the batch only
                logger.exception("batch failed")
                for r in batch:
                    r._result = {"error": str(e)}
                    r._done.set()

    def _bucket(self, n: int) -> int:
        for b in PROMPT_BUCKETS:
            if n <= b:
                return b
        return PROMPT_BUCKETS[-1]

    def _run_batch(self, batch: List[Request]):
        t0 = time.perf_counter()
        mcfg = self.cfg
        vis = mcfg.vision
        # no padding of the request list to max_batch (the reference pads
        # to reuse its compiled graph; rows are independent, so a request's
        # result does not depend on how many ride along)
        n_real = b = len(batch)

        token_lists = [_prompt_tokens(self.tokenizer, r.prompt)
                       for r in batch]
        seq = self._bucket(max(len(t) for t in token_lists))
        ids = np.full((b, seq), PAD_ID, np.int64)
        mask = np.zeros((b, seq), np.int64)
        for i, t in enumerate(token_lists):
            t = t[:seq]
            ids[i, :len(t)] = t
            mask[i, :len(t)] = 1

        images = np.zeros((b, vis.image_size, vis.image_size, 3), np.uint8)
        audios = np.zeros((b, mcfg.audio.n_audio_samples), np.float32)
        videos = np.zeros((b, mcfg.fusion.n_frames, vis.image_size,
                           vis.image_size, 3), np.uint8)
        for i, r in enumerate(batch):
            if r.image is not None:
                images[i] = r.image
            if r.audio is not None:
                audios[i] = r.audio
            if r.video is not None:
                videos[i] = r.video

        dev = self.device
        fused = fusion.prepare_inputs(
            self.params, mcfg, input_ids=torch.from_numpy(ids).to(dev),
            images=torch.from_numpy(images).to(dev),
            audios=torch.from_numpy(audios).to(dev),
            videos=torch.from_numpy(videos).to(dev),
            attention_mask=torch.from_numpy(mask).to(dev),
            align_cache=self.align_cache)
        # per-request semantics: each row keeps its own temperature
        # (greedy rows stay greedy when batched with sampling rows) and
        # its own token budget
        temps = np.zeros((b,), np.float32)
        budgets = np.ones((b,), np.int64)
        for i, r in enumerate(batch):
            temps[i] = r.temperature
            budgets[i] = max(1, min(r.max_new_tokens, self.max_new_tokens))
        out = generate(self.params["llm"], mcfg.llm,
                       inputs_embeds=fused.inputs_embeds,
                       attention_mask=fused.attention_mask,
                       max_new_tokens=self.max_new_tokens,
                       eos_id=EOS_ID, pad_id=PAD_ID,
                       temperature=torch.from_numpy(temps).to(dev),
                       budgets=torch.from_numpy(budgets).to(dev),
                       cache_dtype=self.kv_cache_dtype,
                       generator=self._gen if (temps > 0).any() else None,
                       device=dev)
        toks = out.tokens.cpu().numpy()
        dt = time.perf_counter() - t0

        for i, r in enumerate(batch):
            gen = toks[i][: r.max_new_tokens]
            gen = gen[gen != PAD_ID]
            r._result = {
                "text": _decode_text(self.tokenizer, gen.tolist()),
                "tokens": int(gen.shape[0]),
                "batch_size": n_real,
                "latency_ms": round(dt * 1000, 1),
            }
            r._done.set()
        self.stats["requests"] += n_real
        self.stats["batches"] += 1
        self.stats["tokens"] += int((toks != PAD_ID).sum())


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------

def _decode_one_image(raw: bytes, size: int) -> np.ndarray:
    from macaw_llm_tpu_torch.data import native
    image = native.decode_jpeg_crop(raw, size) if native.available() \
        else None
    if image is None:
        from PIL import Image
        with Image.open(io.BytesIO(raw)) as im:
            im = im.convert("RGB").resize((size, size))
            image = np.asarray(im, np.uint8)
    return image


def _decode_media(payload: dict, cfg: ModelConfig):
    """base64 fields -> arrays (image: JPEG/PNG; audio: WAV; video: a list
    of JPEG/PNG frames)."""
    image = audio = video = None
    size = cfg.vision.image_size
    if payload.get("image_b64"):
        image = _decode_one_image(base64.b64decode(payload["image_b64"]),
                                  size)
    if payload.get("audio_b64"):
        import tempfile
        from macaw_llm_tpu_torch.data.loader import load_wav
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(base64.b64decode(payload["audio_b64"]))
            f.flush()
            audio = load_wav(f.name)
    if payload.get("video_b64"):
        # list of base64 frames, resampled to n_frames with the last frame
        # pinned (the training data's 6-of-120 subsampling, generalized to
        # any frame count)
        from macaw_llm_tpu_torch.image.preprocess import sample_frame_indices
        frames = [_decode_one_image(base64.b64decode(f), size)
                  for f in payload["video_b64"]]
        if not frames:
            raise ValueError("video_b64 must be a non-empty list of "
                             "base64-encoded frames")
        n = cfg.fusion.n_frames
        if len(frames) < n:
            frames = frames + [frames[-1]] * (n - len(frames))
        idx = sample_frame_indices(len(frames), n)
        video = np.stack([frames[i] for i in idx])
    return image, audio, video


def make_handler(engine, cfg: ModelConfig):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **engine.stats})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                image, audio, video = _decode_media(payload, cfg)
                req = Request(
                    prompt=payload["prompt"],
                    image=image, audio=audio, video=video,
                    max_new_tokens=int(payload.get("max_new_tokens", 128)),
                    temperature=float(payload.get("temperature", 0.0)))
                if payload.get("stream"):
                    if not getattr(engine, "supports_streaming", False):
                        self._send(400, {
                            "error": "streaming requires the continuous "
                                     "engine (serve(continuous=True))"})
                        return
                    self._stream(req)
                    return
                result = engine.generate_sync(req)
                self._send(200 if "error" not in result else 500, result)
            except Exception as e:  # noqa: BLE001
                self._send(400, {"error": str(e)})

        def _stream(self, req: Request):
            """Chunked transfer: one JSON line per generated token, then a
            final line with the full result."""
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonl")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            lock = threading.Lock()

            def write_chunk(obj):
                data = (json.dumps(obj) + "\n").encode()
                with lock:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

            def on_tok(tok_id: int):
                piece = (engine.tokenizer.decode(
                    [tok_id], skip_special_tokens=True)
                    if hasattr(engine.tokenizer, "decode") else str(tok_id))
                write_chunk({"token": tok_id, "text": piece})

            req.stream_cb = on_tok
            result = engine.generate_sync(req)
            write_chunk({"done": True, **result})
            with lock:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

    return Handler


def serve(params: dict, cfg: ModelConfig, tokenizer, *,
          host: str = "0.0.0.0", port: int = 8000, max_batch: int = 8,
          batch_timeout_ms: float = 20.0,
          max_new_tokens: int = 128,
          continuous: bool = True,
          align_cache: str = "bf16",
          kv_cache_dtype: Optional[str] = None,
          device="cuda") -> ThreadingHTTPServer:
    """Start an engine and return the HTTP server bound to it (the caller
    runs ``serve_forever``; ``server.engine`` is the engine)."""
    if continuous:
        engine = ContinuousEngine(params, cfg, tokenizer, slots=max_batch,
                                  max_new_tokens=max_new_tokens,
                                  align_cache=align_cache,
                                  kv_cache_dtype=kv_cache_dtype,
                                  device=device)
    else:
        engine = InferenceEngine(params, cfg, tokenizer,
                                 max_batch=max_batch,
                                 batch_timeout_ms=batch_timeout_ms,
                                 max_new_tokens=max_new_tokens,
                                 align_cache=align_cache,
                                 kv_cache_dtype=kv_cache_dtype,
                                 device=device)
    engine.start()
    server = ThreadingHTTPServer((host, port), make_handler(engine, cfg))
    server.engine = engine
    logger.info("serving on %s:%d (max_batch=%d)", host, port, max_batch)
    return server


def build_server(argv=None) -> ThreadingHTTPServer:
    """The command line's server: parse the flags, restore the checkpoint,
    quantize and pack the LLaMA weights as asked, start the engine and
    bind the HTTP server (not yet serving)."""
    import argparse
    from macaw_llm_tpu_torch.config import Config
    from macaw_llm_tpu_torch.run_inference import restore_params
    from macaw_llm_tpu_torch.train.checkpoint import load_config

    p = argparse.ArgumentParser(description="Macaw serving (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-timeout-ms", type=float, default=20.0)
    p.add_argument("--max-new-tokens", type=int, default=128)
    eng_group = p.add_mutually_exclusive_group()
    eng_group.add_argument("--static", action="store_true",
                           help="static request batcher (no streaming) "
                                "instead of the default continuous "
                                "batching engine")
    eng_group.add_argument("--continuous", action="store_true",
                           help="(default) slot-based continuous batching")
    p.add_argument("--kv-cache-dtype", default=None,
                   choices=[None, "int8"],
                   help="int8-quantized KV cache: half the decode "
                        "attention memory read")
    p.add_argument("--align-cache", default="int8",
                   choices=["int8", "bf16", "off"],
                   help="precomputed alignment K/V projections (int8 "
                        "halves the cache memory; off recomputes per "
                        "prefill)")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="int8 weight-only LLM")
    p.add_argument("--no-pack", action="store_true",
                   help="keep the unpacked wq/wk/wv and gate/up layout "
                        "(the packed qkv/gateup streams take one matvec "
                        "each in decode)")
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default: the GPU)")
    args = p.parse_args(argv)

    cfg = load_config(args.checkpoint) or Config()
    params = restore_params(args.checkpoint, cfg, device=args.device)
    from macaw_llm_tpu_torch.utils.quantize import (pack_llama_for_decode,
                                                    quantize_llama)
    with torch.no_grad():
        if args.quantize == "int8":
            params["llm"] = quantize_llama(params["llm"])
        if not args.no_pack:
            params["llm"] = pack_llama_for_decode(params["llm"])
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    return serve(params, cfg.model, tokenizer, host=args.host,
                 port=args.port, max_batch=args.max_batch,
                 batch_timeout_ms=args.batch_timeout_ms,
                 max_new_tokens=args.max_new_tokens,
                 continuous=not args.static, align_cache=args.align_cache,
                 kv_cache_dtype=args.kv_cache_dtype, device=args.device)


def main(argv=None):
    from macaw_llm_tpu_torch.utils.logging import setup_logging
    setup_logging()
    server = build_server(argv)
    try:
        server.serve_forever()
    finally:
        server.engine.stop()
        server.server_close()


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

class ContinuousEngine:
    """Slot-based continuous batching: requests are admitted into free KV-
    cache slots as they arrive (single-request fused prefill scattered into
    the slot), while ONE decode step per iteration advances every active
    slot: new arrivals never wait for the current batch to finish, unlike
    the static batcher above. Per-slot cache positions use the decoder's
    per-row cache lengths.

      * prefill runs on a dedicated admission thread and, on the GPU, on
        its own CUDA stream, so a multi-hundred-ms fused prefill neither
        stalls the decode loop nor sits in the decode stream's queue; the
        decode thread only performs the cheap cache scatter when a
        prefilled request lands in a free slot, after making its stream
        wait on the prefill's event
      * token readback is pipelined: each step's tokens are copied into a
        pinned host buffer without blocking and processed two steps later,
        overlapping the transfer with compute (a finished slot may burn up
        to two extra masked steps: bounded waste, never wrong output)
      * per-slot temperature: greedy and sampling requests share the
        batch without contaminating each other
    """

    supports_streaming = True

    def __init__(self, params: dict, cfg: ModelConfig, tokenizer, *,
                 slots: int = 8, prompt_bucket: int = 256,
                 max_new_tokens: int = 128, align_cache: str = "bf16",
                 kv_cache_dtype: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.params, self.align_cache = _init_align_cache(params, cfg,
                                                          align_cache)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.slots = slots
        # prompt_bucket is the MAXIMUM prompt length; each request prefills
        # at the smallest bucket that fits it, so short prompts never pay
        # the long-prompt prefill
        self.prompt_bucket = prompt_bucket
        self.buckets = tuple(b for b in PROMPT_BUCKETS
                             if b < prompt_bucket) + (prompt_bucket,)
        self.max_new = max_new_tokens
        self.total_len = prompt_bucket + cfg.total_prefix_len + max_new_tokens
        self.kv_cache_dtype = kv_cache_dtype
        self._compute = getattr(torch, cfg.dtype)
        self._cache_dtype = self._compute if kv_cache_dtype is None \
            else kv_cache_dtype

        cache = llama.KVCache.create(cfg.llm, slots, self.total_len,
                                     self._cache_dtype, self.device)
        # the device state, updated in place by admission and by each step
        self.cache = {"k": cache.k, "v": cache.v}
        if cache.k_scale is not None:
            self.cache["ks"] = cache.k_scale
            self.cache["vs"] = cache.v_scale
        self.lengths = torch.zeros((slots,), dtype=torch.int64,
                                   device=self.device)
        self.toks = torch.zeros((slots,), dtype=torch.int64,
                                device=self.device)

        # host-side slot state
        self._reqs: List[Optional[Request]] = [None] * slots
        self._generated: List[List[int]] = [[] for _ in range(slots)]
        self._budget = np.zeros(slots, np.int64)
        self._temps = np.zeros(slots, np.float32)
        # device-resident copies of the per-slot control vectors, uploaded
        # again only when admission or finish changes them
        self._active_dev = None
        self._temps_dev = None
        self._sampling = False
        self._ctl_dirty = True
        self._slot_gen = [0] * slots    # guards pipelined readback after
                                        # a slot is recycled
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._admit_q: "queue.Queue[tuple]" = queue.Queue(maxsize=slots)
        self._stop = threading.Event()
        # one generator per thread that samples
        seed = _seed_from_clock()
        self._gen_admit = torch.Generator(device=self.device)
        self._gen_admit.manual_seed(seed)
        self._gen_step = torch.Generator(device=self.device)
        self._gen_step.manual_seed(seed + 1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._prefill_thread = threading.Thread(target=self._prefill_loop,
                                                daemon=True)
        self.stats = {"requests": 0, "steps": 0, "admitted": 0}
        self._zero_prefix = None   # computed lazily, once, on admission

        on_gpu = self.device.type == "cuda"
        self._admit_stream = torch.cuda.Stream(self.device) if on_gpu \
            else None
        self._decode_stream = torch.cuda.Stream(self.device) if on_gpu \
            else None
        # pinned host buffers of the token readback: at most READBACK_DEPTH
        # + 1 copies are pending at once, so a ring one larger never hands
        # out a buffer whose copy is still in flight
        self._host_toks = [torch.empty((slots,), dtype=torch.int64,
                                       pin_memory=True)
                           for _ in range(READBACK_DEPTH + 2)] if on_gpu \
            else None

    # -------------------- lifecycle / API --------------------

    def start(self):
        if self.device.type == "cuda":
            # the weights, the alignment cache and the slot cache were made
            # on the default stream: both engine streams start after them
            torch.cuda.synchronize(self.device)
        self._prefill_thread.start()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._prefill_thread.join(timeout=60)
        self._thread.join(timeout=60)

    def generate_sync(self, req: Request, timeout: float = 600.0) -> dict:
        self.queue.put(req)
        if not req._done.wait(timeout):
            raise TimeoutError("generation timed out")
        return req._result

    def _on_stream(self, stream):
        return torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()

    # -------------------- admission (own thread, own stream) ------------

    def _prefill_body(self, fused: fusion.FusedBatch, temp: float):
        """Prompt pass of one request into a cache slice of its own.
        Returns ({"k", "v"[, "ks", "vs"]} slices [L, S_max, ...], first
        token, valid length)."""
        llm = self.cfg.llm
        dev = self.device
        cache = llama.KVCache.create(llm, 1, self.total_len,
                                     self._cache_dtype, dev)
        mask = fused.attention_mask.to(torch.int32)
        s = mask.shape[1]
        full_mask = torch.cat(
            [mask, torch.ones((1, self.total_len - s), dtype=torch.int32,
                              device=dev)], dim=1)
        pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        # hidden states only; the logits are projected for the one sampled
        # position (the [1, S, V] fp32 prefill logits never exist)
        h = llama.forward_hidden(self.params["llm"], llm,
                                 fused.inputs_embeds, attention_mask=full_mask,
                                 positions=pos, kv_cache=cache)
        last = (mask * torch.arange(s, device=dev)[None, :]).amax(1)
        h_last = h[torch.arange(1, device=dev), last][:, None]
        first_logits = llama.logits_from_hidden(
            self.params["llm"], h_last, llama.valid_vocab(llm))[:, 0]
        first_tok = _sample(first_logits,
                            self._gen_admit if temp > 0 else None, temp)
        new = {"k": cache.k[:, 0], "v": cache.v[:, 0]}
        if cache.k_scale is not None:
            new["ks"] = cache.k_scale[:, 0]
            new["vs"] = cache.v_scale[:, 0]
        return new, first_tok[0], last[0] + 1

    def _prefill(self, ids, image, audio, video, mask, temp: float):
        fused = fusion.prepare_inputs(
            self.params, self.cfg, input_ids=ids, images=image, audios=audio,
            videos=video, attention_mask=mask, align_cache=self.align_cache)
        return self._prefill_body(fused, temp)

    def _make_zero_prefix(self) -> torch.Tensor:
        """The [image][audio][video] prefix for ABSENT media is a constant:
        text-only examples are trained and served with all-zero media
        tensors, so the tower + alignment output for zeros never changes.
        Encoded once; ``_prefill_text`` splices the cached block."""
        mcfg, dev = self.cfg, self.device
        vis = mcfg.vision
        fused = fusion.prepare_inputs(
            self.params, mcfg,
            input_ids=torch.full((1, 1), 1, dtype=torch.int64, device=dev),
            images=torch.zeros((1, vis.image_size, vis.image_size, 3),
                               dtype=torch.uint8, device=dev),
            audios=torch.zeros((1, mcfg.audio.n_audio_samples),
                               dtype=torch.float32, device=dev),
            videos=torch.zeros((1, mcfg.fusion.n_frames, vis.image_size,
                                vis.image_size, 3), dtype=torch.uint8,
                               device=dev),
            align_cache=self.align_cache)
        return fused.inputs_embeds[:, 1:]   # drop BOS: [1, P, H]

    def _prefill_text(self, ids, mask, temp: float):
        """Text-only request: splice the cached zero-media prefix instead
        of running CLIP twice, Whisper and the alignments on zeros.
        Token-exact against the full path (the same embeddings)."""
        if self._zero_prefix is None:
            self._zero_prefix = self._make_zero_prefix()
        prefix = self._zero_prefix
        text_emb = self.params["llm"]["embed_tokens"].to(self._compute)[ids]
        emb = torch.cat([text_emb[:, :1], prefix.to(self._compute),
                         text_emb[:, 1:]], dim=1)
        full_mask = torch.cat([mask.new_ones((1, prefix.shape[1])), mask],
                              dim=1)
        return self._prefill_body(fusion.FusedBatch(emb, full_mask, None),
                                  temp)

    def _prefill_loop(self):
        """Runs fused prefills off the decode thread; hands completed
        (req, cache slice, first token, length, event) tuples to the
        decode loop through a bounded queue."""
        while not self._stop.is_set():
            try:
                req = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                with torch.inference_mode(), \
                        self._on_stream(self._admit_stream):
                    item = self._run_prefill(req)
                while not self._stop.is_set():
                    try:
                        self._admit_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
            except Exception as e:  # noqa: BLE001: fail the request only
                logger.exception("prefill failed")
                req._result = {"error": str(e)}
                req._done.set()

    def _run_prefill(self, req: Request):
        mcfg, dev = self.cfg, self.device
        vis = mcfg.vision
        t = _prompt_tokens(self.tokenizer, req.prompt)[:self.prompt_bucket]
        # the smallest bucket that fits: a bounded set of prefill shapes
        bucket = next(b for b in self.buckets if len(t) <= b)
        ids = np.full((1, bucket), PAD_ID, np.int64)
        mask = np.zeros((1, bucket), np.int64)
        ids[0, :len(t)] = t
        mask[0, :len(t)] = 1
        ids, mask = torch.from_numpy(ids).to(dev), \
            torch.from_numpy(mask).to(dev)
        temp = float(req.temperature)
        if req.image is None and req.audio is None and req.video is None:
            new, tok, length = self._prefill_text(ids, mask, temp)
        else:
            image = req.image if req.image is not None else np.zeros(
                (vis.image_size, vis.image_size, 3), np.uint8)
            audio = req.audio if req.audio is not None else np.zeros(
                (mcfg.audio.n_audio_samples,), np.float32)
            video = req.video if req.video is not None else np.zeros(
                (mcfg.fusion.n_frames, vis.image_size, vis.image_size, 3),
                np.uint8)
            # np.array copies: a decoded frame may be a read-only buffer
            image, audio, video = (
                torch.from_numpy(np.array(x[None])).to(dev)
                for x in (image, audio, video))
            new, tok, length = self._prefill(ids, image, audio, video, mask,
                                             temp)
        event = None
        if self._admit_stream is not None:
            event = torch.cuda.Event()
            event.record(self._admit_stream)
        # host sync on the admission thread, NOT the decode loop
        return (req, new, int(tok), int(length), event)

    # -------------------- decode loop --------------------

    def _place(self, slot: int, item) -> None:
        """Scatter a prefilled request into a free slot (cheap: the
        expensive prefill already ran on the admission thread)."""
        req, new, tok, length, event = item
        if event is not None:
            self._decode_stream.wait_event(event)
        for key, nv in new.items():
            if event is not None:
                # allocated on the admission stream, read on this one: its
                # memory is not handed out again before this copy has run
                nv.record_stream(self._decode_stream)
            self.cache[key][:, slot] = nv
        self.lengths[slot] = length
        self.toks[slot] = tok
        self._reqs[slot] = req
        self._ctl_dirty = True
        self._generated[slot] = [tok]
        self._budget[slot] = min(req.max_new_tokens, self.max_new) - 1
        self._temps[slot] = req.temperature
        self._slot_gen[slot] += 1
        self.stats["admitted"] += 1
        if req.stream_cb is not None and tok != EOS_ID:
            req.stream_cb(tok)
        if tok == EOS_ID or self._budget[slot] <= 0:
            self._finish(slot)

    def _finish(self, slot: int):
        req = self._reqs[slot]
        gen = [t for t in self._generated[slot] if t != PAD_ID]
        if gen and gen[-1] == EOS_ID:
            gen = gen[:-1]
        req._result = {"text": _decode_text(self.tokenizer, gen),
                       "tokens": len(gen)}
        req._done.set()
        self._reqs[slot] = None
        self._ctl_dirty = True
        self._generated[slot] = []
        self.stats["requests"] += 1

    def _step(self) -> None:
        """One decode step of every slot, in place: the new K/V rows land
        at each slot's length; ``lengths`` and ``toks`` advance for the
        active slots only."""
        kv = llama.KVCache(k=self.cache["k"], v=self.cache["v"],
                           length=self.lengths,
                           k_scale=self.cache.get("ks"),
                           v_scale=self.cache.get("vs"))
        logits = llama.forward(self.params["llm"], self.cfg.llm,
                               input_ids=self.toks[:, None], kv_cache=kv,
                               dtype=self._compute)
        nxt = _sample(logits[:, 0],
                      self._gen_step if self._sampling else None,
                      self._temps_dev)
        self.lengths += self._active_dev.to(torch.int64)
        self.toks.copy_(torch.where(self._active_dev, nxt, self.toks))

    def _dispatch(self, active_slots: List[int]):
        """Upload the control vectors if admission or finish changed them,
        run one decode step and start its token readback. Returns the
        pending entry (host tokens, event, [(slot, slot generation)])."""
        if self._ctl_dirty or self._active_dev is None:
            active = np.zeros((self.slots,), bool)
            active[active_slots] = True
            self._active_dev = torch.from_numpy(active).to(self.device)
            self._temps_dev = torch.from_numpy(self._temps.copy()).to(
                self.device)
            self._sampling = bool((self._temps[active_slots] > 0).any())
            self._ctl_dirty = False
        self._step()
        host, event = self._read_tokens(self.stats["steps"])
        self.stats["steps"] += 1
        return host, event, [(s, self._slot_gen[s]) for s in active_slots]

    def _read_tokens(self, index: int):
        """Start the device-to-host copy of this step's tokens. Returns
        (host tensor, event or None)."""
        if self._host_toks is None:
            return self.toks.clone(), None
        buf = self._host_toks[index % len(self._host_toks)]
        buf.copy_(self.toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._decode_stream)
        return buf, event

    def _process_readback(self, pending) -> None:
        """Wait for a decode step's token copy and run finish/stream
        bookkeeping. ``pending`` carries per-slot generation counters so a
        slot recycled since dispatch is skipped."""
        host, event, items = pending
        if event is not None:
            event.synchronize()
        toks = host.numpy()
        for slot, gen_id in items:
            if self._slot_gen[slot] != gen_id or self._reqs[slot] is None:
                continue
            tok = int(toks[slot])
            self._generated[slot].append(tok)
            self._budget[slot] -= 1
            req = self._reqs[slot]
            if req.stream_cb is not None and tok != EOS_ID:
                req.stream_cb(tok)
            if tok == EOS_ID or self._budget[slot] <= 0:
                self._finish(slot)

    def _loop(self):
        try:
            with torch.inference_mode(), \
                    self._on_stream(self._decode_stream):
                self._decode_loop()
        except Exception as e:  # noqa: BLE001: fail the requests in flight
            logger.exception("decode loop failed")
            self._stop.set()
            waiting = [r for r in self._reqs if r is not None]
            for q in (self._admit_q, self.queue):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    waiting.append(item[0] if isinstance(item, tuple)
                                   else item)
            for r in waiting:
                r._result = {"error": f"decode loop failed: {e}"}
                r._done.set()
            raise

    def _decode_loop(self):
        # Decode/readback pipeline, depth 2: dispatch step N, then process
        # step N-2's tokens. Each step's device-to-host copy is started
        # without blocking right after its dispatch, so by the time step
        # N-2 is PROCESSED a full iteration of compute has passed and the
        # wait on its event returns at once. Cost of the depth: EOS and
        # budget are observed up to 2 steps late: a finished slot decodes
        # <= 2 zombie tokens whose pending entries are dropped by the
        # slot-generation check in _process_readback, and whose cache
        # writes land beyond the slot's final length (masked out of every
        # later attention window, overwritten on reuse; a position past
        # the buffer is written to its last row, which no live query
        # sees: llama.forward_hidden).
        pending = deque()  # (host tokens, event, [(slot, slot_gen)])
        while not self._stop.is_set():
            placed = False
            for slot in range(self.slots):
                if self._reqs[slot] is None:
                    try:
                        item = self._admit_q.get_nowait()
                    except queue.Empty:
                        break
                    self._place(slot, item)
                    placed = True
            active_slots = [i for i, r in enumerate(self._reqs)
                            if r is not None]
            if not active_slots:
                if pending:
                    self._process_readback(pending.popleft())
                elif not placed:
                    time.sleep(0.002)
                continue
            pending.append(self._dispatch(active_slots))
            while len(pending) > READBACK_DEPTH:
                self._process_readback(pending.popleft())
        while pending:
            self._process_readback(pending.popleft())


if __name__ == "__main__":
    main()
