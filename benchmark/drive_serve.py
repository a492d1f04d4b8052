"""A serving cell: requests sent open loop at the rate the traffic mix
fixes, to the program's continuous-batching engine (``ContinuousEngine``),
one measured window, then the comparison with the reference.

Set-up: weights drawn on the card from the seed, the serving form made by
the program (int8 weights packed for decode; the engine makes its int8
alignment cache and int8 KV cache), one warm-up request per prompt bucket
with the cell's media, then the sender starts and runs for the mix's
``ramp_s`` before the window opens. Request ``i`` is due at its arrival
(``ServeTraffic.arrival``) over the rate after the sender starts, whatever
the engine is doing, and its time to first token counts from when it was
due. The window closes after ``seconds``; the sender stops and the engine
stops. Requests in flight or waiting at the close are neither counted as
failed nor compared. A traced run traces the window's last
``trace.TRACE_S`` seconds and reads the trace after the window closes.
"""

from __future__ import annotations

import gc
import statistics
import threading
import time

import numpy as np
import torch

from . import program, weights, work
from .reference import check as ref_check
from .trace import TRACE_S
from .traffic import ServeTraffic, text_ids


# served tokens the comparison samples, at the least
CHECK_TOKENS = 256


def percentile(xs, p):
    """The value at rank round(p (n - 1)) of the sorted sample."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * (len(xs) - 1) + 0.5))]


class _Done(threading.Event):
    """The request's completion event, which also records the end."""

    def __init__(self, on_set):
        super().__init__()
        self._on_set = on_set

    def set(self):
        super().set()
        self._on_set()


class OpenLoop:
    """One sender thread: request ``first + k`` is sent at its arrival
    after request ``first``'s, over ``rate``; every streamed token is
    stamped."""

    def __init__(self, engine, traffic: ServeTraffic, tok, rate: float,
                 first_index: int = 0):
        self.engine, self.traffic, self.tok = engine, traffic, tok
        self.rate, self.first = rate, first_index
        self.records, self.closed = [], threading.Event()
        self._thread = threading.Thread(target=self._send_all, daemon=True)

    def start(self) -> None:
        self.start_t = time.perf_counter()
        self._thread.start()

    def close(self) -> None:
        self.closed.set()
        self._thread.join(timeout=30)

    def _send_all(self) -> None:
        k, base = 0, self.traffic.arrival(self.first)
        while not self.closed.is_set():
            due = self.start_t + \
                (self.traffic.arrival(self.first + k) - base) / self.rate
            wait = due - time.perf_counter()
            if wait > 0 and self.closed.wait(wait):
                return
            self.send(self.first + k, due)
            k += 1

    def send(self, i: int, due: float) -> dict:
        r = self.traffic.request(i)
        rec = {"index": i, "n_ids": len(r["ids"]), "media": r["media"],
               "budget": r["max_new"], "toks": [], "done": None,
               "error": None, "sent": due}
        image = audio = video = None
        if r["media"] is not None:
            image, audio, video = self.traffic.media(r["media"])
        holder = {}
        req = program.request(
            prompt=self.tok.prompt(i, r["ids"]), image=image, audio=audio,
            video=video, max_new_tokens=r["max_new"], temperature=0.0,
            stream_cb=lambda t, rec=rec: rec["toks"].append(
                (time.perf_counter(), int(t))),
            _done=_Done(lambda: self._finished(rec, holder["req"])))
        holder["req"] = req
        rec["lag"] = time.perf_counter() - due
        self.records.append(rec)
        self.engine.queue.put(req)
        return rec

    def _finished(self, rec: dict, req) -> None:
        rec["done"] = time.perf_counter()
        result = req._result or {}
        if "error" in result:
            rec["error"] = str(result["error"])
        self.tok.ids.pop(rec["index"], None)


class Window:
    """What a serving window produced, for the metric readers."""

    kind = "serve"

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1

    def first_tokens(self, t0=None, t1=None) -> list:
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        return [r for r in self.records if r["toks"]
                and t0 <= r["toks"][0][0] <= t1]

    def itl_gaps(self) -> list:
        return [b[0] - a[0] for r in self.records
                for a, b in zip(r["toks"], r["toks"][1:])
                if a[0] >= self.t0 and b[0] <= self.t1]

    def model_flops(self, prefill: bool = True, decode: bool = True):
        """Model FLOPs of the prefills whose first token came in the
        window (the media's towers, alignment and splice when the request
        carries media) and of every token decoded in it."""
        s, total = self.sizes, 0.0
        for r in self.records:
            fused = s.prefix_len + r["n_ids"] - 1
            for j, (t, _) in enumerate(r["toks"]):
                if not self.in_window(t):
                    continue
                if j == 0 and prefill:
                    total += work.llm_prefill_flops(s, fused)
                    if r["media"] is not None:
                        total += work.media_flops(s, 1)
                elif j > 0 and decode:
                    total += work.llm_decode_flops(s, fused + j)
        return total


def _warm(engine, tok, traffic: ServeTraffic, spec: dict) -> None:
    """One request per prompt bucket, at the bucket's length, with the
    mix's media, all at once."""
    buckets = [b for b in (32, 64, 128, 256) if b < spec["prompt_bucket"]]
    buckets.append(spec["prompt_bucket"])
    reqs = []
    for j, b in enumerate(buckets):
        rng = np.random.default_rng([traffic.seed, 6, j])
        ids = [1] + text_ids(rng, b - 1, traffic.cfg["vocab_size"]).tolist()
        media = traffic.media(0) if traffic.media_pool else (None,) * 3
        reqs.append(program.request(prompt=tok.prompt(-1 - j, ids),
                                    image=media[0], audio=media[1],
                                    video=media[2], max_new_tokens=4))
    for r in reqs:
        engine.queue.put(r)
    for r in reqs:
        if not r._done.wait(600) or "error" in (r._result or {}):
            raise RuntimeError(f"warm-up request failed: {r._result}")


def build(cfg: dict, spec: dict, seed: int, device, trace: bool = False):
    """Set-up up to the first request: (engine, traffic, tokenizer)."""
    if trace:  # the profiler's first start is slow: pay it here
        from .trace import DeviceTrace
        t = DeviceTrace()
        t.start()
        t.stop()
    traffic = ServeTraffic(spec, cfg, seed)
    tok = program.Tokenizer()
    params = program.serving_params(weights.make_tree(cfg, seed, device))
    engine = program.engine(params, program.model_config(cfg), tok, spec,
                            cfg["serving"], device)
    del params
    engine.start()
    try:
        _warm(engine, tok, traffic, spec)
    except BaseException:
        engine.stop()
        raise
    return engine, traffic, tok


def run(cfg: dict, spec: dict, w: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, limits: dict,
        control: bool = False) -> dict:
    sizes = work.Sizes.of(cfg)
    engine, traffic, tok = build(cfg, spec, seed, device, trace)
    try:
        loop = OpenLoop(engine, traffic, tok, spec["arrival"]["rate_per_s"])
        loop.start()
        time.sleep(spec["ramp_s"])
        dev_trace, tw = None, {}
        t0 = time.perf_counter()
        stats0 = dict(engine.stats)
        if trace:
            from .trace import DeviceTrace
            time.sleep(max(0.0, seconds - TRACE_S))
            dev_trace = DeviceTrace()
            dev_trace.start(program.launches)
            tw = {"trace_t0": time.perf_counter(),
                  "trace_stats0": dict(engine.stats)}
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        stats1 = dict(engine.stats)
        loop.close()
        if dev_trace is not None:
            tw["trace_stats1"] = dict(engine.stats)
            tw["trace_t1"] = time.perf_counter()
            dev_trace.stop()
    finally:
        engine.stop()
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    records = list(loop.records)
    del engine, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    win = Window(records=records, t0=t0, t1=t1, seconds=t1 - t0,
                 sizes=sizes, cfg=cfg, spec=spec,
                 steps=stats1["steps"] - stats0["steps"],
                 slots=spec["slots"], trace=dev_trace, **tw)
    sent = [r for r in records if t0 <= r["sent"] <= t1]
    failed = sum(1 for r in sent if r["error"] is not None)
    firsts = win.first_tokens()
    gaps = win.itl_gaps()
    served = sum(1 for r in records for t, _ in r["toks"] if t0 <= t <= t1)
    if not firsts or not gaps:
        raise RuntimeError(f"no tokens in the window: {len(firsts)} first "
                           f"tokens, {len(gaps)} gaps, {failed} failed")
    ttfts = [r["toks"][0][0] - r["sent"] for r in firsts]
    e2e = {"setup_s": setup_s,
           "ttft_p95_ms": percentile(ttfts, 0.95) * 1e3,
           "itl_p95_ms": percentile(gaps, 0.95) * 1e3,
           "served_tokens_per_s": served / (t1 - t0)}
    win.e2e = e2e
    checks, checked = compare(cfg, spec, limits, traffic, records, t0, t1,
                              seed, device, 4 if control else None)
    info = {"requests_in_window": len(firsts), "sent_in_window": len(sent),
            "ttft_median_ms": statistics.median(ttfts) * 1e3,
            "itl_median_ms": statistics.median(gaps) * 1e3,
            "send_lag_max_ms": max(r["lag"] for r in sent) * 1e3
            if sent else None,
            "steps": win.steps, **checked}
    return {"attempted": len(sent), "failed": failed, "e2e": e2e,
            "window": win, "peak": peak, "checks": checks, "info": info}


def sweep(cfg: dict, spec: dict, seed: int, device, rates, seconds: float):
    """The capacity sweep: one engine, the mix sent open loop at each rate
    for ``seconds``; yields per rate the arrivals, the requests admitted
    (first token) in the period, those still waiting for one at its end,
    and TTFT in the period's first and second halves."""
    engine, traffic, tok = build(cfg, spec, seed, device)
    first = 0
    try:
        for rate in rates:
            loop = OpenLoop(engine, traffic, tok, rate, first)
            loop.start()
            time.sleep(seconds)
            t1 = time.perf_counter()
            loop.close()
            recs = list(loop.records)
            first += len(recs) + 1
            mid = loop.start_t + seconds / 2
            half = [[r["toks"][0][0] - r["sent"] for r in recs
                     if r["toks"] and r["toks"][0][0] <= t1
                     and (r["sent"] < mid) == (k == 0)] for k in (0, 1)]
            started = sum(1 for r in recs if r["toks"]
                          and r["toks"][0][0] <= t1)
            itl = [b[0] - a[0] for r in recs
                   for a, b in zip(r["toks"], r["toks"][1:]) if b[0] <= t1]
            yield {"rate": rate, "sent": len(recs), "admitted": started,
                   "waiting_at_end": len(recs) - started,
                   "ttft_p50_ms": [statistics.median(h) * 1e3 if h else None
                                   for h in half],
                   "ttft_p95_ms": [percentile(h, 0.95) * 1e3 if h else None
                                   for h in half],
                   "itl_p50_ms": statistics.median(itl) * 1e3 if itl
                   else None,
                   "itl_p95_ms": percentile(itl, 0.95) * 1e3 if itl
                   else None}
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline and \
                    any(r["done"] is None for r in recs):
                time.sleep(0.2)
    finally:
        engine.stop()


def sample(records: list, t0: float, t1: float, seed: int,
           most: int) -> list:
    """Finished requests drawn from the seed: the longest, then others in
    a random order until ``CHECK_TOKENS`` served tokens or ``most``
    requests."""
    done = [r for r in records if r["error"] is None and r["done"]
            and r["toks"] and t0 <= r["done"] <= t1]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["toks"]), -r["index"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 5]).permutation(len(rest))
    out, total = [longest], len(longest["toks"])
    for k in order:
        if total >= CHECK_TOKENS or len(out) >= most:
            break
        out.append(rest[k])
        total += len(rest[k]["toks"])
    return out


def reference_samples(traffic: ServeTraffic, chosen: list) -> list:
    out = []
    for r in chosen:
        req = traffic.request(r["index"])
        out.append({"ids": req["ids"], "media": traffic.media(req["media"]),
                    "served": [t for _, t in r["toks"]]})
    return out


def compare(cfg, spec, lim, traffic, records, t0, t1, seed, device,
            control_bits=None) -> tuple:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, over the sampled requests: (checks,
    what was checked)."""
    chosen = sample(records, t0, t1, seed, spec["check_requests"])
    if not chosen:
        return ({"widest_gap": {"value": float("inf"),
                                "limit": lim["widest_gap"]}},
                {"checked_requests": 0, "checked_tokens": 0})
    tree = weights.make_tree(cfg, seed, device)
    res = ref_check.serve_gaps(tree, cfg, reference_samples(traffic, chosen),
                               device, control_bits)
    del tree
    checked = {"checked_requests": len(chosen),
               "checked_tokens": sum(len(r["gaps"]) for r in res)}
    if control_bits:
        checked["control_widest_gap"] = max(max(r["control_gaps"])
                                            for r in res)
    return ({"widest_gap": {"value": max(max(r["gaps"]) for r in res),
                            "limit": lim["widest_gap"]}}, checked)
