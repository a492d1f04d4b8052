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

Tensor-parallel serving (``tp``: a group of ranks, one process each, every
one holding its block of the tree, ``parallel.tensor_parallel``): rank 0
leads. It alone runs HTTP and the request queue; before each iteration it
broadcasts that iteration's schedule (the admissions, with their prompts,
media, budgets and temperatures; a stop), and every rank then runs the
same prefills and decode steps, so the ranks issue their collectives in
one order. The leader's and the followers' slot bookkeeping is the same
code on the same tokens (the all-reduces give every rank the same bits,
and the generators share one seed). One thread a rank does admission and
decode in turn, with each step's tokens read back before the next. The
engine runs over a process group of its own (the same ranks), which only
it tears down.

Every rank reaches the same verdict on a failure:

* before any collective (the payload's prompt encoding, its media
  featurized, its length checks: ``ContinuousEngine._admission``,
  ``InferenceEngine._batch_inputs``) each rank all-reduces (MAX) a flag
  per request or batch, and every rank fails the requests that failed on
  any rank, leaves their slots free and serves the next;
* inside a sequence of collectives (an error in the middle of a prefill or
  a decode step, a follower whose slots differ from the leader's) the
  ranks cannot be brought back in step: the failing rank tears the
  engine's group down (``_tear_down``), so that its peers' pending
  collectives end at once, every rank's loop ends, and the leader fails
  every active and queued request and stops. The failing rank marks the
  teardown in the job's store and destroys its end of the group: on gloo
  that closes the connections its peers wait on. An NCCL communicator
  learns nothing from a peer's abort, so each rank's watcher
  (``_watch_group``) polls the store, marks the group torn down
  (``tensor_parallel.TORN_GROUPS``: no collective is issued over it
  again) and aborts its own end (``ncclCommAbort``): the collectives in
  flight end, and a value read back after the abort is dropped
  (``_check_group``) rather than served;
* the leader's own failure before it broadcasts a plan broadcasts the
  stop instead, so the followers end with it.

Where the reference compiles its prefill, admit and step functions and
donates the cache to them, this module runs eagerly: the cache, ``lengths``
and ``toks`` are preallocated tensors that admission and the decode step
update in place. On one card the continuous engine's decode step is the
exception: it is captured once as a CUDA graph and replayed
(``ContinuousEngine._capture_steps``).
"""

from __future__ import annotations

import base64
import contextlib
import ctypes
import dataclasses
import functools
import io
import itertools
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
from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
from macaw_llm_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          reduce_max)
from macaw_llm_tpu_torch.utils.profiling import SPANS

logger = logging.getLogger("macaw.serve")

PROMPT_BUCKETS = (32, 64, 128, 256)
READBACK_DEPTH = 2  # decode steps dispatched before a step's tokens are read
_GRAPH_WARMUP_STEPS = 2  # eager decode steps run before a step is captured


def _init_align_cache(params: dict, mcfg: ModelConfig, mode: str,
                      tp: Optional[TensorParallel] = None):
    """Engine-side alignment K/V cache setup (see
    ``fusion.precompute_align_cache``): serving never trains, so the
    weight-only projections are computed once at startup and the dead K/V
    in-projection rows are dropped. mode: "bf16" (exact, in the compute
    dtype), "int8" (half the memory, about 0.2% row error), or "off".
    ``tp``: ``params`` is this rank's block; so is the cache."""
    if mode == "off":
        return fusion.pack_towers(params), None
    with SPANS.span("setup.align_cache",
                    device=params["llm"]["embed_tokens"].device), \
            torch.inference_mode():
        cache = fusion.precompute_align_cache(params, mcfg,
                                              quantize=mode == "int8", tp=tp)
    return fusion.pack_towers(fusion.strip_align_kv(params)), cache


def _launch_counted() -> list:
    """The kernel wrappers that count their launches (``ops/kernels``)."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh
    return [mh.mh_attention, fa.flash_attention_with_lse,
            fa.flash_attention_combine, fa.flash_attention_dq,
            fa.flash_attention_dkv, fa.flash_attention_delta,
            mv.matvec_int8, mv.matvec_int8_pipelined]


@functools.lru_cache(maxsize=None)
def _cu_graph_launch():
    """The driver's ``cuGraphLaunch`` through a ``ctypes.PyDLL``: the call
    keeps the GIL."""
    fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def _launch_holding_gil(graph: "torch.cuda.CUDAGraph", stream) -> None:
    """Launch a captured graph that draws no random numbers on ``stream``,
    the GIL held throughout. ``CUDAGraph.replay`` releases the GIL and runs
    its generators' prologue as torch ops before the launch; a profiler
    stopping on another thread, which holds the GIL, then deadlocks with
    it (an H100, torch 2.11, CUDA 12.8: the stopping thread in the
    profiler's exit, the replaying thread in ``replay``, the card idle).
    With the GIL held, no launch overlaps a profiler's start or stop."""
    rc = _cu_graph_launch()(graph.raw_cuda_graph_exec(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cuGraphLaunch failed with CUDA error {rc}")


def _this_card(device: torch.device) -> torch.device:
    """``cuda`` as the card this process took (``torch.cuda.set_device``
    is the main thread's: an engine's threads start on card 0)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on_card(device: torch.device):
    """Run a thread's work on ``device``'s card (nothing on the CPU):
    ``broadcast_object_list`` and an NCCL abort act on the thread's
    current card."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _seed_from_clock() -> int:
    return int(time.time() * 1e3) % 2**31


def _share(tp: Optional[TensorParallel], obj):
    """``obj`` of the group's rank 0, on every rank (a pickled broadcast);
    ``obj`` itself without a group."""
    if tp is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    tpar.check_live(tp.group)
    src = 0 if tp.group is None else dist.get_global_rank(tp.group, 0)
    dist.broadcast_object_list(box, src=src, group=tp.group)
    return box[0]


def _shared_seed(tp: Optional[TensorParallel]) -> int:
    """A clock seed, the leader's on every rank of a group."""
    return _share(tp, _seed_from_clock())


_REQUEST_FIELDS = ("prompt", "image", "audio", "video", "max_new_tokens",
                   "temperature")


def _payload(req) -> dict:
    """What a follower needs of a request: its prompt, media and limits."""
    return {k: getattr(req, k) for k in _REQUEST_FIELDS}


def _own_group(tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """``tp`` over a new process group of the same ranks: the engine's
    own, which it may tear down without touching the job's groups.
    Collective: every process of the job builds its engine."""
    if tp is None:
        return None
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(tp.group or dist.group.WORLD)
    return dataclasses.replace(tp, group=dist.new_group(ranks))


def _failed_anywhere(tp: Optional[TensorParallel], failed: List[bool],
                     device) -> List[bool]:
    """Each flag set where it is set on any rank of the group (an
    all-reduce MAX; the flags themselves without a group)."""
    if tp is None or not failed:
        return failed
    flags = torch.tensor(failed, dtype=torch.int32, device=device)
    return [bool(f) for f in reduce_max(tp, flags).tolist()]


_WATCH_S = 0.1  # how often a rank's watcher reads the teardown mark


def _torn_key(tp: TensorParallel) -> str:
    """The job store's key that marks the engine's group torn down."""
    return f"macaw_serve/{tp.group.group_name}/torn_down"


def _store():
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _abort(group) -> None:
    """Abort this rank's end of an NCCL group: its collectives in flight
    end. gloo needs nothing here: its peers see the failing rank's
    connections close."""
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        group.abort()


def _watch_group(engine, tp: TensorParallel) -> None:
    """A rank's watcher, while its engine may issue collectives: once
    another rank has marked the group torn down (``_tear_down``), mark it
    here (``_check_group``; no further collective over it) and abort this
    rank's end of the group."""
    store, key = _store(), _torn_key(tp)
    while not engine._group_done.wait(_WATCH_S):
        if store.check([key]):
            tpar.TORN_GROUPS.add(tp.group)
            try:
                with _on_card(engine.device):
                    _abort(tp.group)
            except Exception:  # noqa: BLE001
                logger.exception("could not abort the engine's group")
            return


def _check_group(engine) -> None:
    """Raise once the engine's group was torn down on another rank: a value
    read back after an NCCL abort is not the collective's result."""
    tpar.check_live(engine.tp.group)


def _tear_down(engine) -> None:
    """After a failure inside the group's collectives: mark the engine's
    group (``_own_group``) torn down in the job's store, for the peers'
    watchers, abort and destroy this rank's end, and drop the engine's
    ``tp``: with no reference left, gloo closes the group's connections,
    and the peers' pending collectives raise at once instead of waiting
    out the group's timeout. Call it once the failed call's exception (and
    its frames) is gone."""
    import gc

    import torch.distributed as dist
    tp, engine.tp = engine.tp, None
    engine._group_done.set()  # this rank's watcher stops
    if engine._watcher is not None:  # after an abort it may be running
        engine._watcher.join()
    try:
        _store().set(_torn_key(tp), "1")
        if tp.group not in tpar.TORN_GROUPS:  # else the watcher aborted it
            _abort(tp.group)
        dist.destroy_process_group(tp.group)
    except Exception:  # noqa: BLE001
        logger.exception("could not tear the engine's group down")
    del tp
    gc.collect()


def _drain(q: "queue.Queue") -> list:
    """What is left in a queue, taken without waiting."""
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


_PEER_FAILED = "failed on another rank of the tensor group"


def _release_followers(tp: Optional[TensorParallel]) -> None:
    """On the leader's fatal error: broadcast the stop, so that the
    followers' loops end instead of waiting for a plan. A broadcast that
    fails too is logged; the leader's own error is the one raised."""
    if tp is None or not tp.leader:
        return
    try:
        _share(tp, None)
    except Exception:  # noqa: BLE001
        logger.exception("could not release the followers")


def _fail(requests, error: str) -> None:
    for r in requests:
        r._result = {"error": error}
        r._done.set()


def _emit(req, tok: int) -> None:
    """Stream one token to the request's callback. A callback that raises
    (a client gone) is dropped: the request runs on to its result, and the
    other requests never see the error."""
    if req.stream_cb is None or tok == EOS_ID:
        return
    try:
        req.stream_cb(tok)
    except Exception:  # noqa: BLE001
        logger.exception("stream callback failed; streaming stopped")
        req.stream_cb = None


class _Follower:
    """A follower rank's stand-in for the HTTP server: ``serve_forever``
    runs until the leader's engine stops."""

    def __init__(self, engine):
        self.engine = engine

    def serve_forever(self):
        self.engine.join()

    def server_close(self):
        pass


_REQUEST_IDS = itertools.count()


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
    # the spans' request id; the queue wait's start (the profiler's clock);
    # the moment the admission handed it to the decode loop (_Handoff)
    _id: int = field(default_factory=_REQUEST_IDS.__next__)
    _created_ns: int = field(default_factory=time.time_ns)
    _handed_ns: int = 0


class _Handoff(queue.Queue):
    """The admission thread's queue of prefilled requests: each is stamped
    as it enters, under the queue's lock, so the decode loop never takes
    one before its stamp."""

    def _put(self, item):
        item[0]._handed_ns = time.time_ns()
        super()._put(item)


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
                 kv_cache_dtype: Optional[str] = None, device="cuda",
                 tp: Optional[TensorParallel] = None):
        self.device = _this_card(resolve_device(device))
        self.tp = tp = _own_group(tp)
        self.params, self.align_cache = _init_align_cache(params, cfg,
                                                          align_cache, tp)
        self.kv_cache_dtype = kv_cache_dtype
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.max_new_tokens = max_new_tokens
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._group_done = threading.Event()  # no collective follows
        self._watcher = None if tp is None else threading.Thread(
            target=_watch_group, args=(self, tp), daemon=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(_shared_seed(tp))
        self.stats = {"requests": 0, "batches": 0, "tokens": 0}

    # -------------------- lifecycle --------------------

    def start(self):
        if self._watcher is not None:
            self._watcher.start()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def join(self):
        """Wait for the batching loop to end (a follower's: when the
        leader stops)."""
        self._thread.join()

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

    def _next_batch(self) -> Optional[List[Request]]:
        """The next batch's requests ([] when none came), None to stop;
        under a tensor group the leader's, on every rank."""
        if self.tp is not None and not self.tp.leader:
            plan = _share(self.tp, None)
            _check_group(self)
            return None if plan is None else [Request(**p) for p in plan]
        batch = None if self._stop.is_set() else self._collect()
        if self.tp is not None:
            _share(self.tp, None if batch is None
                   else [_payload(r) for r in batch])
        return batch

    def _loop(self):
        try:
            with _on_card(self.device):
                self._run_batches()
        finally:
            self._group_done.set()

    def _run_batches(self):
        """The batching loop. Under a tensor group, a batch that fails
        inside its collectives, a collective of the schedule that fails,
        or a teardown on another rank found between two of them
        (``_check_group``) ends the loop here: the group is torn down and
        the batch in hand and the queue are failed."""
        self._batch = []
        try:
            self._batches()
            return
        except Exception as e:  # noqa: BLE001: fail what is waiting
            logger.exception("batch loop failed")
            error = f"batch failed: {e}"
        # the failed call's frames are gone: the group can be torn down
        self._stop.set()
        if self.tp is not None:
            _tear_down(self)
        _fail(self._batch + _drain(self.queue), error)

    def _batches(self):
        while True:
            self._batch = []
            batch = self._next_batch()
            if batch is None:
                return
            self._batch = batch
            if not batch:
                continue
            inputs, error = None, None
            try:
                with torch.inference_mode():
                    inputs = self._batch_inputs(batch)
            except Exception as e:  # noqa: BLE001: fail the batch only
                logger.exception("batch failed")
                error = str(e)
            failed = _failed_anywhere(self.tp, [error is not None],
                                      self.device)[0]
            if self.tp is not None:
                _check_group(self)
            if failed:
                _fail(batch, error or _PEER_FAILED)
                continue
            try:
                with torch.inference_mode():
                    self._run_batch(batch, inputs)
            except Exception as e:  # noqa: BLE001
                if self.tp is not None:
                    # inside the batch's collectives: the ranks are out of
                    # step, and _run_batches tears the group down
                    raise
                logger.exception("batch failed")
                _fail(batch, str(e))  # one device: the batch only

    def _bucket(self, n: int) -> int:
        for b in PROMPT_BUCKETS:
            if n <= b:
                return b
        return PROMPT_BUCKETS[-1]

    def _batch_inputs(self, batch: List[Request]) -> dict:
        """The host side of a batch, before any collective: the prompts
        tokenized into one bucket, the media featurized on the device, the
        temperatures and budgets."""
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
        images, audios, videos = fusion.featurize(
            mcfg, torch.from_numpy(images).to(dev),
            torch.from_numpy(audios).to(dev),
            torch.from_numpy(videos).to(dev))
        # per-request semantics: each row keeps its own temperature
        # (greedy rows stay greedy when batched with sampling rows) and
        # its own token budget
        temps = np.zeros((b,), np.float32)
        budgets = np.ones((b,), np.int64)
        for i, r in enumerate(batch):
            temps[i] = r.temperature
            budgets[i] = max(1, min(r.max_new_tokens, self.max_new_tokens))
        return dict(t0=t0, ids=torch.from_numpy(ids).to(dev),
                    mask=torch.from_numpy(mask).to(dev), images=images,
                    audios=audios, videos=videos, temps=temps,
                    budgets=budgets)

    def _run_batch(self, batch: List[Request], x: dict):
        """Prefill and decode one batch (``x``: its ``_batch_inputs``) and
        answer its requests."""
        mcfg, dev = self.cfg, self.device
        n_real = len(batch)
        fused = fusion.prepare_inputs(
            self.params, mcfg, input_ids=x["ids"], images=x["images"],
            audios=x["audios"], videos=x["videos"],
            attention_mask=x["mask"], align_cache=self.align_cache,
            tp=self.tp)
        temps = x["temps"]
        out = generate(self.params["llm"], mcfg.llm,
                       inputs_embeds=fused.inputs_embeds,
                       attention_mask=fused.attention_mask,
                       max_new_tokens=self.max_new_tokens,
                       eos_id=EOS_ID, pad_id=PAD_ID,
                       temperature=torch.from_numpy(temps).to(dev),
                       budgets=torch.from_numpy(x["budgets"]).to(dev),
                       cache_dtype=self.kv_cache_dtype,
                       generator=self._gen if (temps > 0).any() else None,
                       device=dev, tp=self.tp)
        toks = out.tokens.cpu().numpy()
        if self.tp is not None:
            _check_group(self)
        dt = time.perf_counter() - x["t0"]

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
          device="cuda",
          tp: Optional[TensorParallel] = None) -> ThreadingHTTPServer:
    """Start an engine and return the HTTP server bound to it (the caller
    runs ``serve_forever``; ``server.engine`` is the engine). Under a
    tensor group only the leader binds the server; a follower gets a
    stand-in whose ``serve_forever`` follows the leader's engine until it
    stops."""
    if continuous:
        engine = ContinuousEngine(params, cfg, tokenizer, slots=max_batch,
                                  max_new_tokens=max_new_tokens,
                                  align_cache=align_cache,
                                  kv_cache_dtype=kv_cache_dtype,
                                  device=device, tp=tp)
    else:
        engine = InferenceEngine(params, cfg, tokenizer,
                                 max_batch=max_batch,
                                 batch_timeout_ms=batch_timeout_ms,
                                 max_new_tokens=max_new_tokens,
                                 align_cache=align_cache,
                                 kv_cache_dtype=kv_cache_dtype,
                                 device=device, tp=tp)
    engine.start()
    if tp is not None and not tp.leader:
        return _Follower(engine)
    server = ThreadingHTTPServer((host, port), make_handler(engine, cfg))
    server.engine = engine
    logger.info("serving on %s:%d (max_batch=%d)", host, port, max_batch)
    return server


def build_server(argv=None) -> ThreadingHTTPServer:
    """The command line's server: parse the flags, restore the checkpoint,
    quantize and pack the LLaMA weights as asked, start the engine and
    bind the HTTP server (not yet serving). A run config whose mesh has
    ``tensor = t > 1`` serves tensor-parallel over ``t`` processes
    (torchrun, or the reference's environment): rank 0 binds the server,
    the others follow it."""
    import argparse
    from macaw_llm_tpu_torch.config import Config
    from macaw_llm_tpu_torch.run_inference import (restore_params,
                                                   serving_group)
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
    tp = serving_group(cfg, args.device)
    params = restore_params(args.checkpoint, cfg, device=args.device, tp=tp)
    from macaw_llm_tpu_torch.utils.quantize import (pack_llama_for_decode,
                                                    quantize_llama)
    with torch.no_grad():
        if args.quantize == "int8":
            params["llm"] = quantize_llama(params["llm"], tp)
        if not args.no_pack:
            params["llm"] = pack_llama_for_decode(params["llm"])
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    return serve(params, cfg.model, tokenizer, host=args.host,
                 port=args.port, max_batch=args.max_batch,
                 batch_timeout_ms=args.batch_timeout_ms,
                 max_new_tokens=args.max_new_tokens,
                 continuous=not args.static, align_cache=args.align_cache,
                 kv_cache_dtype=args.kv_cache_dtype, device=args.device,
                 tp=tp)


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
      * on one card the decode step is replayed from a CUDA graph captured
        at ``start`` (one greedy, one sampling), so a step costs the host
        one launch instead of the forward's hundreds; it reads the cache,
        ``lengths``, ``toks`` and the control vectors in place

    Under a tensor group (``tp``) one thread a rank runs the leader's
    schedule instead (``_tp_loop``; the module docstring).
    """

    supports_streaming = True

    def __init__(self, params: dict, cfg: ModelConfig, tokenizer, *,
                 slots: int = 8, prompt_bucket: int = 256,
                 max_new_tokens: int = 128, align_cache: str = "bf16",
                 kv_cache_dtype: Optional[str] = None, device="cuda",
                 tp: Optional[TensorParallel] = None):
        self.device = _this_card(resolve_device(device))
        self.tp = tp = _own_group(tp)
        self._tp_admitted: List[Request] = []
        self._tp_in_step = False  # between a plan's broadcast and its end
        self.params, self.align_cache = _init_align_cache(params, cfg,
                                                          align_cache, tp)
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
                                     self._cache_dtype, self.device, tp)
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
        # device-resident copies of the per-slot control vectors, written
        # in place by admission and finish (a captured step reads them at
        # these addresses)
        self._active_dev = torch.zeros((slots,), dtype=torch.bool,
                                       device=self.device)
        self._temps_dev = torch.zeros((slots,), dtype=torch.float32,
                                      device=self.device)
        self._sampling = False
        # sampling (bool) -> (the captured decode step, [(kernel wrapper,
        # launches a replay makes)])
        self._graphs = {}
        self._slot_gen = [0] * slots    # guards pipelined readback after
                                        # a slot is recycled
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._admit_q: "queue.Queue[tuple]" = _Handoff(maxsize=slots)
        self._stop = threading.Event()
        self._group_done = threading.Event()  # no collective follows
        self._watcher = None if tp is None else threading.Thread(
            target=_watch_group, args=(self, tp), daemon=True)
        # one generator per thread that samples
        seed = _shared_seed(tp)
        self._gen_admit = torch.Generator(device=self.device)
        self._gen_admit.manual_seed(seed)
        self._gen_step = torch.Generator(device=self.device)
        self._gen_step.manual_seed(seed + 1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._prefill_thread = threading.Thread(target=self._prefill_loop,
                                                daemon=True)
        self.stats = {"requests": 0, "steps": 0, "admitted": 0,
                      "graph_replays": 0}
        self._zero_prefix = None   # computed lazily, once, on admission

        on_gpu = self.device.type == "cuda"
        # under a tensor group admission runs on the decode thread's stream
        self._admit_stream = torch.cuda.Stream(self.device) \
            if on_gpu and tp is None else None
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
            SPANS.settle()  # the set-up's device times
            if self.tp is None:
                self._capture_steps()
        if self.tp is None:
            self._prefill_thread.start()
        else:
            self._watcher.start()
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._prefill_thread.is_alive():
            self._prefill_thread.join(timeout=60)
        self._thread.join(timeout=60)

    def join(self):
        """Wait for the decode loop to end (a follower's: when the leader
        stops)."""
        self._thread.join()

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
        token, valid length), the two read back on this thread."""
        with SPANS.span("admit.prefill", device=self.device):
            llm = self.cfg.llm
            dev = self.device
            cache = llama.KVCache.create(llm, 1, self.total_len,
                                         self._cache_dtype, dev, self.tp)
            mask = fused.attention_mask.to(torch.int32)
            s = mask.shape[1]
            full_mask = torch.cat(
                [mask, torch.ones((1, self.total_len - s),
                                  dtype=torch.int32, device=dev)], dim=1)
            pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
            # hidden states only; the logits are projected for the one
            # sampled position (the [1, S, V] fp32 prefill logits never
            # exist)
            h = llama.forward_hidden(self.params["llm"], llm,
                                     fused.inputs_embeds,
                                     attention_mask=full_mask, positions=pos,
                                     kv_cache=cache, tp=self.tp)
            last = (mask * torch.arange(s, device=dev)[None, :]).amax(1)
            h_last = h[torch.arange(1, device=dev), last][:, None]
            first_logits = llama.logits_from_hidden(
                self.params["llm"], h_last, llama.valid_vocab(llm),
                tp=self.tp)[:, 0]
            first_tok = _sample(first_logits,
                                self._gen_admit if temp > 0 else None, temp)
            new = {"k": cache.k[:, 0], "v": cache.v[:, 0]}
            if cache.k_scale is not None:
                new["ks"] = cache.k_scale[:, 0]
                new["vs"] = cache.v_scale[:, 0]
            # host sync on the admission thread, NOT the decode loop
            return new, int(first_tok[0]), int(last[0] + 1)

    def _prefill(self, ids, image, audio, video, mask, temp: float):
        fused = fusion.prepare_inputs(
            self.params, self.cfg, input_ids=ids, images=image, audios=audio,
            videos=video, attention_mask=mask, align_cache=self.align_cache,
            tp=self.tp)
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
            align_cache=self.align_cache, tp=self.tp)
        return fused.inputs_embeds[:, 1:]   # drop BOS: [1, P, H]

    def _prefill_text(self, ids, mask, temp: float):
        """Text-only request: splice the cached zero-media prefix instead
        of running CLIP twice, Whisper and the alignments on zeros.
        Token-exact against the full path (the same embeddings)."""
        if self._zero_prefix is None:
            self._zero_prefix = self._make_zero_prefix()
        prefix = self._zero_prefix
        text_emb = llama.embed(self.params["llm"], ids, self._compute,
                               self.tp)
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
            got = time.time_ns()
            SPANS.add("request.queue_wait", req._created_ns, got, req._id)
            try:
                with torch.inference_mode(), \
                        self._on_stream(self._admit_stream), \
                        SPANS.span("admit", req._id, self.device, got) as adm:
                    item = self._run_prefill(req)
                    SPANS.settle()  # the prefill's read-back synchronized
                    with SPANS.span("admit.handoff") as handoff:
                        while not self._stop.is_set():
                            try:
                                self._admit_q.put(item, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if req._handed_ns:
                            handoff.end_at(req._handed_ns)
                            adm.end_at(req._handed_ns)
            except Exception as e:  # noqa: BLE001: fail the request only
                logger.exception("prefill failed")
                req._result = {"error": str(e)}
                req._done.set()

    def _run_prefill(self, req: Request):
        return self._prefill_ready(req, self._admission(req))

    def _admission(self, req: Request) -> dict:
        """The host side of an admission, before any collective: the
        prompt encoded into the smallest bucket that fits, the media (or
        None for a text-only request) featurized on the device."""
        mcfg, dev = self.cfg, self.device
        vis = mcfg.vision
        with SPANS.child("encode"):
            t = _prompt_tokens(self.tokenizer,
                               req.prompt)[:self.prompt_bucket]
            # the smallest bucket that fits: a bounded set of prefill shapes
            bucket = next(b for b in self.buckets if len(t) <= b)
            ids = np.full((1, bucket), PAD_ID, np.int64)
            mask = np.zeros((1, bucket), np.int64)
            ids[0, :len(t)] = t
            mask[0, :len(t)] = 1
        media = None
        if not (req.image is None and req.audio is None
                and req.video is None):
            image = req.image if req.image is not None else np.zeros(
                (vis.image_size, vis.image_size, 3), np.uint8)
            audio = req.audio if req.audio is not None else np.zeros(
                (mcfg.audio.n_audio_samples,), np.float32)
            video = req.video if req.video is not None else np.zeros(
                (mcfg.fusion.n_frames, vis.image_size, vis.image_size, 3),
                np.uint8)
            # np.array copies: a decoded frame may be a read-only buffer
            with SPANS.child("featurize"):
                media = fusion.featurize(mcfg, *(
                    torch.from_numpy(np.array(x[None])).to(dev)
                    for x in (image, audio, video)))
        return dict(ids=torch.from_numpy(ids).to(dev),
                    mask=torch.from_numpy(mask).to(dev), media=media,
                    temp=float(req.temperature))

    def _prefill_ready(self, req: Request, adm: dict):
        """The prefill of an admission (``_admission``): the collectives
        of a tensor group. Returns (req, cache slices, first token, valid
        length, event or None)."""
        ids, mask, temp = adm["ids"], adm["mask"], adm["temp"]
        if adm["media"] is None:
            new, tok, length = self._prefill_text(ids, mask, temp)
        else:
            new, tok, length = self._prefill(ids, *adm["media"], mask, temp)
        event = None
        if self._admit_stream is not None:
            event = torch.cuda.Event()
            event.record(self._admit_stream)
        return (req, new, tok, length, event)

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
        # fill_ takes the number as a kernel argument; an assignment would
        # copy it from the host and wait for the decode stream to drain
        self.lengths[slot].fill_(length)
        self.toks[slot].fill_(tok)
        self._active_dev[slot].fill_(True)
        self._temps_dev[slot].fill_(req.temperature)
        self._reqs[slot] = req
        self._generated[slot] = [tok]
        self._budget[slot] = min(req.max_new_tokens, self.max_new) - 1
        self._temps[slot] = req.temperature
        self._slot_gen[slot] += 1
        self.stats["admitted"] += 1
        if req._handed_ns:  # handed over by the admission thread
            SPANS.add("request.place_wait", req._handed_ns, time.time_ns(),
                      req._id)
        _emit(req, tok)
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
        self._active_dev[slot].fill_(False)
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
                               dtype=self._compute, tp=self.tp)
        nxt = _sample(logits[:, 0],
                      self._gen_step if self._sampling else None,
                      self._temps_dev)
        self.lengths += self._active_dev.to(torch.int64)
        self.toks.copy_(torch.where(self._active_dev, nxt, self.toks))

    def _capture_steps(self) -> None:
        """Capture ``_step`` as CUDA graphs on the decode stream, before
        the engine's threads start: the greedy step, and the sampling step
        with the step generator registered to its graph. Every slot is
        inactive, so the eager warm-up steps write only what any step
        writes for an inactive slot; they count in ``steps`` like any
        step, and the generator's state is put back after them. The
        capture launches nothing: the kernel wrappers' counts it raised
        are taken back, and each replay adds them (``_dispatch``)."""
        counted = _launch_counted()
        pool = None
        with torch.inference_mode(), torch.cuda.stream(self._decode_stream), \
                SPANS.span("setup.decode_graph", device=self.device):
            state = self._gen_step.get_state()
            for sampling in (False, True):
                self._sampling = sampling
                for _ in range(_GRAPH_WARMUP_STEPS):
                    self._step()
                    self.stats["steps"] += 1
                self._gen_step.set_state(state)
                graph = torch.cuda.CUDAGraph()
                if sampling:
                    graph.register_generator_state(self._gen_step)
                before = [fn.launches for fn in counted]
                with torch.cuda.graph(graph, pool=pool,
                                      stream=self._decode_stream,
                                      capture_error_mode="thread_local"):
                    self._step()
                launched = [(fn, fn.launches - n)
                            for fn, n in zip(counted, before)
                            if fn.launches != n]
                for fn, n in zip(counted, before):
                    fn.launches = n
                pool = graph.pool()
                self._graphs[sampling] = (graph, launched)
            self._sampling = False
        torch.cuda.synchronize(self.device)
        SPANS.settle()

    def _dispatch(self, active_slots: List[int]):
        """Run one decode step (its graph's replay where one was captured:
        the greedy one by ``_launch_holding_gil``, the sampling one by
        torch if an active slot samples) and start its token readback.
        Returns the pending entry (host tokens, event, [(slot, slot
        generation)])."""
        self._sampling = bool((self._temps[active_slots] > 0).any())
        captured = self._graphs.get(self._sampling)
        if captured is None:
            self._step()
        else:
            graph, launched = captured
            if self._sampling:
                graph.replay()
            else:
                _launch_holding_gil(graph, self._decode_stream)
            # counted after the launch, as the wrappers count theirs
            for fn, n in launched:
                fn.launches += n
            self.stats["graph_replays"] += 1
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
        if self.tp is not None:
            _check_group(self)
        toks = host.numpy()
        for slot, gen_id in items:
            if self._slot_gen[slot] != gen_id or self._reqs[slot] is None:
                continue
            tok = int(toks[slot])
            self._generated[slot].append(tok)
            self._budget[slot] -= 1
            req = self._reqs[slot]
            _emit(req, tok)
            if tok == EOS_ID or self._budget[slot] <= 0:
                self._finish(slot)

    def _loop(self):
        try:
            with _on_card(self.device):
                self._run_loop()
        finally:
            self._group_done.set()

    def _run_loop(self):
        try:
            with torch.inference_mode(), \
                    self._on_stream(self._decode_stream):
                if self.tp is None:
                    self._decode_loop()
                else:
                    self._tp_loop()
            return
        except Exception as e:  # noqa: BLE001: fail the requests in flight
            logger.exception("decode loop failed")
            error = f"decode loop failed: {e}"
        # the failed call's frames are gone: the group can be torn down
        self._stop.set()
        if self.tp is not None and (self._tp_in_step
                                    or self.tp.group in tpar.TORN_GROUPS):
            _tear_down(self)
        else:
            _release_followers(self.tp)
        waiting = [r for r in self._reqs if r is not None]
        placed = {id(r) for r in waiting}
        waiting += [r for r in self._tp_admitted if not r._done.is_set()
                    and id(r) not in placed]
        waiting += [item[0] for item in _drain(self._admit_q)]
        _fail(waiting + _drain(self.queue), error)

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
        # The spans decode.place, .launch, .readback and .sleep tile the
        # loop: each phase's end stamp is the next one's start.
        pending = deque()  # (host tokens, event, [(slot, slot_gen)])
        lap, t = SPANS.lap, time.time_ns()
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
            t = lap("decode.place", t)
            if not active_slots:
                if pending:
                    self._process_readback(pending.popleft())
                    t = lap("decode.readback", t)
                elif not placed:
                    time.sleep(0.002)
                    t = lap("decode.sleep", t)
                continue
            pending.append(self._dispatch(active_slots))
            t = lap("decode.launch", t)
            while len(pending) > READBACK_DEPTH:
                self._process_readback(pending.popleft())
                t = lap("decode.readback", t)
        while pending:
            self._process_readback(pending.popleft())
            t = lap("decode.readback", t)

    # -------------------- tensor-parallel schedule --------------------

    def _tp_plan(self) -> Optional[dict]:
        """The leader's next iteration: requests from the queue into the
        free slots (waiting up to 0.1 s for one while no slot is
        active), with the slots active before them; None once stopped."""
        if self._stop.is_set():
            return None
        active = [i for i, r in enumerate(self._reqs) if r is not None]
        free = [i for i, r in enumerate(self._reqs) if r is None]
        wait = 0.1 if not active else 0.0
        self._tp_admitted = []
        while len(self._tp_admitted) < len(free):
            try:
                req = self.queue.get(timeout=wait) if wait \
                    else self.queue.get_nowait()
            except queue.Empty:
                break
            self._tp_admitted.append(req)
            wait = 0.0
        return {"active": active,
                "admit": [(slot, _payload(req)) for slot, req in
                          zip(free, self._tp_admitted)]}

    def _tp_loop(self):
        """Every rank, one thread: take the leader's plan, admit its
        requests (prefill on this thread), run one decode step of the
        active slots and read its tokens back before the next plan. Each
        rank's bookkeeping follows the same tokens, so the slots stay the
        same on every rank; a rank that finds otherwise raises. An
        admission that fails before the prefill's collectives
        (``_admission``) on any rank fails its request on every rank and
        leaves the slot free; an error after the plan's broadcast ends the
        loop (``_loop`` tears the group down: the module docstring)."""
        while True:
            self._tp_in_step = False
            plan = _share(self.tp, self._tp_plan() if self.tp.leader
                          else None)
            _check_group(self)
            if plan is None:
                return
            self._tp_in_step = True
            active = [i for i, r in enumerate(self._reqs) if r is not None]
            if active != plan["active"]:
                raise RuntimeError(f"rank {self.tp.rank}: active slots "
                                   f"{active}, the leader's "
                                   f"{plan['active']}")
            if not self.tp.leader:
                self._tp_admitted = [Request(**payload)
                                     for _, payload in plan["admit"]]
            admissions, errors = [], []
            for req in self._tp_admitted:
                try:
                    admissions.append(self._admission(req))
                    errors.append(None)
                except Exception as e:  # noqa: BLE001: fail the request
                    logger.exception("admission failed")
                    admissions.append(None)
                    errors.append(str(e))
            failed = _failed_anywhere(self.tp, [e is not None
                                                for e in errors],
                                      self.device)
            _check_group(self)
            for (slot, _), req, adm, error, bad in zip(
                    plan["admit"], self._tp_admitted, admissions, errors,
                    failed):
                if bad:
                    _fail([req], error or _PEER_FAILED)
                    continue
                item = self._prefill_ready(req, adm)
                _check_group(self)
                self._place(slot, item)
            active = [i for i, r in enumerate(self._reqs) if r is not None]
            if active:
                self._process_readback(self._dispatch(active))


if __name__ == "__main__":
    main()
