"""Port parity of the serving layer against the JAX package on the CPU in
fp32 at the tiny config: the same requests through the JAX engines and the
port's give the same token lists; the ``zero_prefix`` fast path, the
zombie-token guard of the pipelined readback, and the HTTP front.

Three JAX engine instances in all (continuous with the float cache,
continuous with int8 KV, static), each made once: their compiles take most
of this file's time."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import serve as jserve
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import serve as tserve
from macaw_llm_tpu_torch.models import fusion as tfusion


class Tok:
    """Deterministic stand-in tokenizer (no hash seed)."""

    def encode(self, text):
        return [1] + [7 + (sum(map(ord, w)) * 131 + len(w)) % 31000
                      for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def model():
    """Weights made by the port and handed to JAX. A sharper LM head and
    attention than the 0.02 init: greedy ties cannot flip, and the answer
    depends on the prompt and the media."""
    tcfg = tconfig.tiny_model_config()
    jcfg = jconfig.Config(model=jconfig.tiny_model_config(),
                          mesh=jconfig.MeshConfig(1, 1, 1))
    tp = tfusion.init_params(0, tcfg, dtype=torch.float32, device="cpu")
    tp["llm"]["lm_head"] = tp["llm"]["lm_head"] * 10.0
    for name in ("wq", "wk", "wv", "wo"):
        tp["llm"]["layers"]["attn"][name] = \
            tp["llm"]["layers"]["attn"][name] * 8.0
    tp["llm"]["embed_tokens"] = tp["llm"]["embed_tokens"] * 20.0
    return jcfg, tcfg, _to_jax(tp), tp


def _requests(cfg, module):
    """Six greedy requests: text-only and with media, budgets 1 and 4."""
    size = cfg.vision.image_size
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
    audio = (rng.randn(480000) * 0.1).astype(np.float32)
    video = rng.randint(0, 255, (cfg.fusion.n_frames, size, size, 3)
                        ).astype(np.uint8)
    R = module.Request
    return [R(prompt="first question here", max_new_tokens=4),
            R(prompt="what is in this picture and sound", image=image,
              audio=audio, max_new_tokens=4),
            R(prompt="third thing entirely", max_new_tokens=1),
            R(prompt="describe the clip", video=video, max_new_tokens=4),
            R(prompt="one token about the image", image=image,
              max_new_tokens=1),
            R(prompt="a longer question about many different things "
                     "that goes on for a while", max_new_tokens=4)]


def _run(engine, requests, timeout=900):
    """Submit all requests at once; the results in request order."""
    results = [None] * len(requests)

    def worker(i):
        results[i] = engine.generate_sync(requests[i], timeout=timeout)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return results


@pytest.mark.parametrize("kv", [None, "int8"])
def test_continuous_engine_tokens_equal_jax(model, kv):
    """More requests than slots, so slots are recycled while readbacks are
    pending; both engines stream every token they return."""
    jcfg, tcfg, jp, tp = model
    kw = dict(slots=2, prompt_bucket=32, max_new_tokens=4, kv_cache_dtype=kv)
    jeng = jserve.ContinuousEngine(jp, jcfg, Tok(), **kw)
    teng = tserve.ContinuousEngine(tp, tcfg, Tok(), device="cpu", **kw)
    if kv == "int8":
        assert teng.cache["k"].dtype == torch.int8 and "ks" in teng.cache
    out = {}
    for name, eng, module in (("jax", jeng, jserve), ("port", teng, tserve)):
        reqs = _requests(tcfg, module)
        streamed = [[] for _ in reqs]
        for r, sink in zip(reqs, streamed):
            r.stream_cb = sink.append
        eng.start()
        try:
            results = _run(eng, reqs)
        finally:
            eng.stop()
        assert all(r is not None and "text" in r for r in results), results
        assert eng.stats["requests"] == len(reqs)
        assert eng.stats["admitted"] == len(reqs)
        for res, sink in zip(results, streamed):
            assert Tok().decode(sink) == res["text"]
        out[name] = [(r["text"], r["tokens"]) for r in results]
    assert out["port"] == out["jax"]
    assert [n for _, n in out["port"]] == [4, 4, 1, 4, 1, 4]
    # the answers depend on the request, so the comparison can tell them
    # apart
    assert len({text for text, _ in out["port"]}) >= 4


def test_inference_engine_batched_call_equals_jax(model):
    """The static batcher: three requests ride one batch (per-row budgets,
    one with media) and give the JAX engine's tokens."""
    jcfg, tcfg, jp, tp = model
    kw = dict(max_batch=4, batch_timeout_ms=1500, max_new_tokens=4)
    jeng = jserve.InferenceEngine(jp, jcfg, Tok(), **kw)
    teng = tserve.InferenceEngine(tp, tcfg, Tok(), device="cpu", **kw)
    out = {}
    for name, eng, module in (("jax", jeng, jserve), ("port", teng, tserve)):
        reqs = _requests(tcfg, module)[:3]
        eng.start()
        try:
            results = _run(eng, reqs)
        finally:
            eng.stop()
        assert all(r is not None and "text" in r for r in results), results
        out[name] = [(r["text"], r["tokens"]) for r in results]
        if name == "port":
            assert eng.stats == {"requests": 3, "batches": 1,
                                 "tokens": sum(n for _, n in out[name])}
            assert all(r["batch_size"] == 3 for r in results)
    assert out["port"] == out["jax"]


@pytest.fixture(scope="module")
def engine(model):
    """A port engine that is not started: its methods are driven by hand."""
    _, tcfg, _, tp = model
    return tserve.ContinuousEngine(tp, tcfg, Tok(), slots=2, prompt_bucket=32,
                                   max_new_tokens=4, kv_cache_dtype="int8",
                                   align_cache="int8", device="cpu")


def test_zero_prefix_admission_is_token_exact(engine):
    """A text-only request spliced from the cached zero-media prefix against
    the same request sent through the towers with all-zero media: the same
    first token and length, the same cache slice."""
    cfg = engine.cfg
    size = cfg.vision.image_size
    zeros = dict(image=np.zeros((size, size, 3), np.uint8),
                 audio=np.zeros((480000,), np.float32),
                 video=np.zeros((cfg.fusion.n_frames, size, size, 3),
                                np.uint8))
    with torch.inference_mode():
        fast = engine._run_prefill(tserve.Request(prompt="text only ask"))
        full = engine._run_prefill(tserve.Request(prompt="text only ask",
                                                  **zeros))
    assert engine._zero_prefix is not None
    assert fast[2:4] == full[2:4]  # first token, length
    for key in ("k", "v"):
        assert torch.equal(fast[1][key], full[1][key])
    for key in ("ks", "vs"):
        np.testing.assert_allclose(fast[1][key].numpy(),
                                   full[1][key].numpy(), rtol=0, atol=1e-6)


def test_recycled_slot_drops_zombie_token(engine):
    """Depth-2 readback by hand: request A (budget 2) finishes when its
    step is processed, two steps late; by then slot 0 has decoded a zombie
    step. B takes the slot; A's zombie entry, still pending, must not reach
    B. B's tokens equal B's served alone."""
    with torch.inference_mode():
        a = tserve.Request(prompt="first question here", max_new_tokens=2)
        b = tserve.Request(prompt="a different ask", max_new_tokens=3)
        alone = tserve.Request(prompt="a different ask", max_new_tokens=3)
        engine._place(1, engine._run_prefill(alone))
        while engine._reqs[1] is not None:
            engine._process_readback(engine._dispatch([1]))
        engine._place(0, engine._run_prefill(a))
        step1 = engine._dispatch([0])   # A's second token
        zombie = engine._dispatch([0])  # dispatched before step1 is read
        engine._process_readback(step1)
        assert a._done.is_set() and engine._reqs[0] is None
        lengths_before = engine.lengths.clone()
        engine._place(0, engine._run_prefill(b))
        first = list(engine._generated[0])
        engine._process_readback(zombie)
        assert engine._generated[0] == first  # dropped
        while engine._reqs[0] is not None:
            engine._process_readback(engine._dispatch([0]))
    assert b._result == alone._result and b._result["tokens"] == 3
    assert a._result["tokens"] == 2
    # the zombie step advanced A's length past its final one: harmless
    assert int(lengths_before[0]) >= 2


def test_step_leaves_inactive_slots_unchanged(engine):
    with torch.inference_mode():
        req = tserve.Request(prompt="third thing entirely", max_new_tokens=4)
        engine._place(1, engine._run_prefill(req))
        before = (int(engine.lengths[0]), int(engine.toks[0]))
        engine._process_readback(engine._dispatch([1]))
        assert (int(engine.lengths[0]), int(engine.toks[0])) == before
        while engine._reqs[1] is not None:
            engine._process_readback(engine._dispatch([1]))
    assert req._result["tokens"] == 4


def test_control_buffers_keep_their_storage_and_the_cpu_steps_eagerly(
        engine):
    """A captured step reads the active mask and the temperatures at fixed
    addresses: ``_place`` and ``_finish`` write a slot's entries in place,
    and ``_dispatch`` leaves them. The CPU engine captures no graph and
    replays no step."""
    ptrs = (engine._active_dev.data_ptr(), engine._temps_dev.data_ptr())

    def controls():
        assert (engine._active_dev.data_ptr(),
                engine._temps_dev.data_ptr()) == ptrs
        return engine._active_dev.tolist(), engine._temps_dev[1].item()

    stats0 = dict(engine.stats)
    with torch.inference_mode():
        engine._gen_step.manual_seed(0)
        hot = tserve.Request(prompt="first question here", max_new_tokens=3,
                             temperature=0.7)
        engine._place(1, engine._run_prefill(hot))
        assert controls() == ([False, True], pytest.approx(0.7))
        pending = engine._dispatch([1])
        assert engine._sampling
        while engine._reqs[1] is not None:
            assert controls() == ([False, True], pytest.approx(0.7))
            engine._process_readback(pending)
            pending = engine._dispatch([1]) if engine._reqs[1] is not None \
                else None
        assert controls()[0] == [False, False]  # _finish
    assert hot._result["tokens"] == 3
    steps = engine.stats["steps"] - stats0["steps"]
    assert steps == 2  # the first token is the prefill's
    assert engine.stats["graph_replays"] == 0 and not engine._graphs


def test_sampled_request_leaves_greedy_neighbour_alone(model):
    _, tcfg, _, tp = model
    eng = tserve.ContinuousEngine(tp, tcfg, Tok(), slots=2, prompt_bucket=32,
                                  max_new_tokens=4, device="cpu")
    eng.start()
    try:
        solo = eng.generate_sync(tserve.Request(prompt="fixed greedy probe",
                                                max_new_tokens=4), 300)
        both = _run(eng, [tserve.Request(prompt="fixed greedy probe",
                                         max_new_tokens=4),
                          tserve.Request(prompt="other prompt",
                                         max_new_tokens=4, temperature=2.0)])
    finally:
        eng.stop()
    assert both[0] == solo and both[1]["tokens"] == 4


def test_many_requests_over_few_slots(model):
    """40 concurrent requests over 3 slots with a short thread switch
    interval: none is lost, each gets its own budget, and every answer is
    what the same request gets when served alone."""
    import sys
    _, tcfg, _, tp = model
    eng = tserve.ContinuousEngine(tp, tcfg, Tok(), slots=3, prompt_bucket=32,
                                  max_new_tokens=5, kv_cache_dtype="int8",
                                  device="cpu")
    prompts = [f"question number {i % 4} about things" for i in range(40)]

    def reqs():
        return [tserve.Request(prompt=p, max_new_tokens=1 + i % 5)
                for i, p in enumerate(prompts)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        alone = [eng.generate_sync(tserve.Request(prompt=p,
                                                  max_new_tokens=5), 120)
                 for p in prompts[:4]]
        results = _run(eng, reqs(), timeout=300)
    finally:
        sys.setswitchinterval(interval)
        eng.stop()
    assert not eng._thread.is_alive() and not eng._prefill_thread.is_alive()
    assert eng.stats["requests"] == eng.stats["admitted"] == 44
    # a started CPU engine captures nothing: every step ran eagerly
    assert eng.stats["steps"] > 0
    assert eng.stats["graph_replays"] == 0 and not eng._graphs
    for i, r in enumerate(results):
        want = alone[i % 4]["text"].split()[:1 + i % 5]
        assert r == {"text": " ".join(want), "tokens": len(want)}, (i, r)


def test_engines_refuse_cpu_by_default(model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tcfg, _, tp = model
    for cls in (tserve.ContinuousEngine, tserve.InferenceEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(tp, tcfg, Tok())


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(port, payload, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def http_server(model):
    _, tcfg, _, tp = model
    server = tserve.serve(tp, tcfg, Tok(), host="127.0.0.1", port=0,
                          max_batch=2, max_new_tokens=4, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, server.server_address[1]
    server.shutdown()
    server.engine.stop()
    server.server_close()


def test_http_healthz_and_generate(http_server):
    server, port = http_server
    assert isinstance(server.engine, tserve.ContinuousEngine)
    with _post(port, {"prompt": "hi there", "max_new_tokens": 3}) as r:
        out = json.loads(r.read())
    assert out["tokens"] == 3 and len(out["text"].split()) == 3
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["requests"] >= 1
    assert {"steps", "admitted"} <= set(health)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=30)
    assert err.value.code == 404


def test_http_streamed_generate(http_server):
    """Chunked transfer: one JSON line per token, then the result; the
    streamed tokens are the result's."""
    _, port = http_server
    with _post(port, {"prompt": "stream these tokens", "max_new_tokens": 4,
                      "stream": True}) as r:
        assert r.headers["Content-Type"] == "application/jsonl"
        lines = [json.loads(line) for line in r.read().decode().splitlines()
                 if line.strip()]
    assert lines[-1]["done"] is True and lines[-1]["tokens"] == 4
    toks = [line["token"] for line in lines[:-1]]
    assert Tok().decode(toks) == lines[-1]["text"]
    with _post(port, {"prompt": "stream these tokens",
                      "max_new_tokens": 4}) as r:
        assert json.loads(r.read())["text"] == lines[-1]["text"]


def test_http_media_round_trip(http_server, tmp_path):
    """base64 PNG frames (fewer than n_frames: padded by repeating the
    last), a PNG image and a WAV file reach the model."""
    server, port = http_server
    cfg = server.engine.cfg
    size = cfg.vision.image_size
    frames = [_png(np.full((size, size, 3), 40 * (i + 1), np.uint8))
              for i in range(2)]
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)  # resampled to 16 kHz
        w.writeframes((np.sin(np.arange(4000) / 20.0) * 20000).astype(
            np.int16).tobytes())
    payload = {"prompt": "describe the clip", "video_b64": frames,
               "image_b64": _png(np.full((size, size, 3), 7, np.uint8)),
               "audio_b64": base64.b64encode(path.read_bytes()).decode(),
               "max_new_tokens": 3}
    with _post(port, payload) as r:
        out = json.loads(r.read())
    assert out["tokens"] == 3
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, {"prompt": "broken image",
                     "image_b64": "bm90IGFuIGltYWdl"})
    assert err.value.code == 400


def test_decode_media_matches_jax(model, tmp_path):
    """``_decode_media`` resamples any frame count to n_frames with the
    last frame pinned and loads the WAV as the JAX package does."""
    jcfg, tcfg, _, _ = model
    size = tcfg.vision.image_size
    frames = [_png(np.full((size, size, 3), i * 18, np.uint8))
              for i in range(14)]
    path = tmp_path / "b.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((np.random.RandomState(1).randn(3000, 2) * 3000
                       ).astype(np.int16).tobytes())
    payload = {"video_b64": frames, "image_b64": frames[3],
               "audio_b64": base64.b64encode(path.read_bytes()).decode()}
    ref = jserve._decode_media(payload, jcfg)
    got = tserve._decode_media(payload, tcfg)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (tcfg.fusion.n_frames, size, size, 3)
    assert got[2][-1, 0, 0, 0] == 13 * 18 and got[1].shape == (480000,)


def test_streaming_refused_on_static_engine(model):
    _, tcfg, _, tp = model
    server = tserve.serve(tp, tcfg, Tok(), host="127.0.0.1", port=0,
                          max_batch=2, batch_timeout_ms=10, max_new_tokens=3,
                          continuous=False, device="cpu")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"prompt": "hi", "stream": True})
        assert err.value.code == 400
        assert "continuous" in json.loads(err.value.read())["error"]
        with _post(port, {"prompt": "hi", "max_new_tokens": 2}) as r:
            out = json.loads(r.read())
        assert out["tokens"] == 2 and out["batch_size"] == 1
    finally:
        server.shutdown()
        server.engine.stop()
        server.server_close()


def test_templates_and_frame_sampling_match_jax():
    from macaw_llm_tpu.data import templates as jt
    from macaw_llm_tpu.image.preprocess import sample_frame_indices as jsf
    from macaw_llm_tpu_torch.data import templates as tt
    from macaw_llm_tpu_torch.image.preprocess import sample_frame_indices
    for args in (("do it",), ("do it", "with this")):
        assert tt.format_prompt(*args) == jt.format_prompt(*args)
    assert tt.format_full("a", "b", "c") == jt.format_full("a", "b", "c")
    for stored, sampled in ((120, 6), (14, 6), (6, 6), (7, 3)):
        np.testing.assert_array_equal(sample_frame_indices(stored, sampled),
                                      jsf(stored, sampled))
