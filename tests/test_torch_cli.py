"""The port's command lines against the JAX package's, on the CPU at the
tiny config.

* ``run_train``: the port (``--device cpu``) and JAX (8 simulated devices,
  fsdp=8) train the same weights (the port's ``load_pretrained`` patched
  to the bridged JAX init) on the same synthetic batches (the port's
  per-device batch is 8x JAX's, so the global batches match), alignment
  dropout off: step losses and eval metrics within 1e-3 relative.
* ``run_inference``: generations from the port's checkpoint equal JAX's
  from its trained state.
* resume: a run stopped by SIGTERM after step 2 and started again with
  the same command ends in the same bits as a run that never stopped.
* ``--stream``, ``serve.main`` (port 0, one request) and one
  ``run_preprocess build`` against JAX's output.
"""

import dataclasses
import json
import os
import signal
import threading
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import eval as jeval
from macaw_llm_tpu import run_preprocess as jpre
from macaw_llm_tpu import run_train as jrun_train
from macaw_llm_tpu import serve as jserve
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.train.state import merge_params as jmerge
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import run_inference as trun_inference
from macaw_llm_tpu_torch import run_preprocess as tpre
from macaw_llm_tpu_torch import run_train as trun_train
from macaw_llm_tpu_torch import serve as tserve
from macaw_llm_tpu_torch.train.state import merge_params as tmerge
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy
from tests.test_data import FakeTokenizer
from tests.test_torch_checkpoint import assert_states_equal

REL = 1e-3


class MiniTok:
    """Stand-in tokenizer (the same ids in every process)."""

    pad_token_id = 32006

    def encode(self, text):
        return [1] + [16 + zlib.crc32(w.encode()) % 31000
                      for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def add_special_tokens(self, d):
        return 0

    def save_pretrained(self, path):
        pass


@pytest.fixture
def fake_tokenizer(monkeypatch):
    monkeypatch.setattr("transformers.AutoTokenizer.from_pretrained",
                        staticmethod(lambda *_a, **_k: MiniTok()))


def _train_cfgs():
    """The JAX run config and the port's: the same model and schedule,
    global batch 16 (1 x 8 devices x 2 accumulation steps in JAX, 8 x 1 x
    2 in the port)."""
    def cfg(mod, **mesh_and_batch):
        m = mod.tiny_model_config()
        m = dataclasses.replace(m, fusion=dataclasses.replace(
            m.fusion, align_dropout=0.0))
        return mod.Config(
            model=m, mesh=mod.MeshConfig(**mesh_and_batch.pop("mesh")),
            train=mod.TrainConfig(grad_accum_steps=2, save_steps=2,
                                  log_steps=1, eval_batches=2,
                                  **mesh_and_batch))
    return (cfg(jconfig, mesh=dict(fsdp=8), per_device_batch_size=1),
            cfg(tconfig, mesh={}, per_device_batch_size=8))


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, ref, what):
    assert abs(got - ref) <= REL * abs(ref) + 1e-9, (what, got, ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs, 2 steps and a final eval, from the same weights."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 simulated JAX devices of tests/conftest.py")
    root = tmp_path_factory.mktemp("cli")
    jcfg, tcfg = _train_cfgs()
    out = {}
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        path = root / f"{name}.json"
        path.write_text(cfg.to_json())
        out[name] = (str(path), str(root / f"{name}_out"))
    args = ["--synthetic", "--no-media", "--steps", "2", "--do-eval"]
    jstate = jrun_train.main(["--config", out["jax"][0], "--output-dir",
                              out["jax"][1]] + args)

    def bridged(cfg, a):
        p = jfusion.init_params(jax.random.PRNGKey(cfg.train.seed),
                                jcfg.model)
        # the JAX tree also holds encode_video_simple's temporal attention,
        # which the training forward never reads (zero gradient, no weight
        # decay: JAX leaves it unchanged) and the port does not have
        p["fusion"] = {k: v for k, v in p["fusion"].items()
                       if not k.startswith("temporal_")}
        return params_from_numpy(jax.tree.map(np.asarray, p))

    mp = pytest.MonkeyPatch()
    mp.setattr(trun_train, "load_pretrained", bridged)
    try:
        tstate = trun_train.main(["--config", out["torch"][0],
                                  "--output-dir", out["torch"][1],
                                  "--device", "cpu"] + args)
    finally:
        mp.undo()
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, tstate=tstate,
                jdir=out["jax"][1], tdir=out["torch"][1], root=root)


def test_train_losses_match_jax(runs):
    jm = [r for r in _metrics(runs["jdir"]) if "loss" in r]
    tm = [r for r in _metrics(runs["tdir"]) if "loss" in r]
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [1, 2]
    for j, t in zip(jm, tm):
        _close(t["loss"], j["loss"], f"loss at step {j['step']}")
        _close(t["grad_norm"], j["grad_norm"], f"grad_norm {j['step']}")
        _close(t["lr"], j["lr"], f"lr {j['step']}")
        assert t["loader_wait_s"] >= 0
    assert runs["tstate"].step == int(runs["jstate"].step) == 2


def test_eval_metrics_match_jax(runs):
    je = [r for r in _metrics(runs["jdir"]) if "eval_loss" in r]
    te = [r for r in _metrics(runs["tdir"]) if "eval_loss" in r]
    assert len(je) == len(te) == 1
    _close(te[0]["eval_loss"], je[0]["eval_loss"], "eval_loss")
    _close(te[0]["eval_token_accuracy"], je[0]["eval_token_accuracy"],
           "eval_token_accuracy")
    ck = [r for r in _metrics(runs["tdir"]) if "ckpt_bytes" in r]
    assert len(ck) == 1 and ck[0]["step"] == 2 and ck[0]["ckpt_bytes"] > 0
    assert os.path.isfile(os.path.join(runs["tdir"], "step_2", "state.pt"))


def test_restored_generation_matches_jax(runs, fake_tokenizer, tmp_path):
    """``run_inference.main`` on the port's checkpoint against JAX's
    ``batch_inference_generation`` on JAX's trained state, both with the
    bf16 alignment cache (exact in the fp32 compute dtype)."""
    val = [{"instruction": f"question {i} about the picture",
            "response": "yes", "image": "None", "video": "None",
            "audio": "None"} for i in range(2)]
    val_path = tmp_path / "toy_val_inference.json"
    val_path.write_text(json.dumps(val))
    jparams = jmerge(runs["jstate"].trainable, runs["jstate"].frozen)
    jparams, jcache = jserve._init_align_cache(jparams, runs["jcfg"].model,
                                               "bf16")
    jres = jeval.batch_inference_generation(
        jparams, runs["jcfg"], MiniTok(), val, None, batch_size=2,
        max_new_tokens=4, align_cache=jcache)
    tres = trun_inference.main([
        "--checkpoint", runs["tdir"], "--dataset", "toy", "--val-json",
        str(val_path), "--tokenizer", "x", "--batch-size", "2",
        "--max-new-tokens", "4", "--output-dir", str(tmp_path / "eval"),
        "--device", "cpu"])
    assert [r["generation"] for r in tres] == \
        [r["generation"] for r in jres]
    assert all(len(r["generation"].split()) >= 1 for r in tres)
    with open(tmp_path / "eval" / "toy_eval_outputs.json") as f:
        assert json.load(f) == tres


def test_restored_params_are_the_trained_state(runs):
    params = trun_inference.restore_params(runs["tdir"], runs["tcfg"],
                                           device="cpu")
    s = runs["tstate"]
    got = _leaves(params)
    ref = _leaves(tmerge(s.trainable, s.frozen))
    assert sorted(got) == sorted(ref)
    for k, x in ref.items():
        assert got[k].dtype == x.dtype and torch.equal(got[k], x), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _resume_cfg(tmp_path):
    """Tiny model with alignment dropout on and zero media: a resume must
    restore the dropout generator to match."""
    cfg = tconfig.Config(
        model=tconfig.tiny_model_config(),
        train=tconfig.TrainConfig(per_device_batch_size=2,
                                  grad_accum_steps=2, save_steps=1000,
                                  log_steps=1))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_resume_after_sigterm_equals_uninterrupted_run(tmp_path):
    cfg = _resume_cfg(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)

    def args(out):
        return ["--config", cfg, "--synthetic", "--steps", "4",
                "--output-dir", str(tmp_path / out), "--device", "cpu"]

    straight = trun_train.main(args("straight"))

    def preempt(step, state, metrics):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)

    stopped = trun_train.main(args("stopped"), on_step=preempt)
    assert stopped.step == 2
    assert os.listdir(tmp_path / "stopped").count("step_2") == 1
    resumed = trun_train.main(args("stopped"))
    assert resumed.step == 4
    assert_states_equal(resumed, straight)
    losses = {name: {r["step"]: r["loss"] for r in _metrics(
        tmp_path / name) if "loss" in r} for name in ("straight", "stopped")}
    assert losses["stopped"] == losses["straight"]
    assert sorted(losses["stopped"]) == [1, 2, 3, 4]
    assert signal.getsignal(signal.SIGTERM) is handler  # restored


def test_weight_flags_and_speculative_name_their_roadmap_items(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP A3"):
        trun_train.main(["--tiny", "--synthetic", "--steps", "1",
                         "--device", "cpu", "--llama-weights", "x",
                         "--output-dir", str(tmp_path)])
    from macaw_llm_tpu_torch.eval import batch_inference_generation
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        batch_inference_generation({}, tconfig.Config(), MiniTok(), [],
                                   speculative=2, device="cpu")
    with pytest.raises(SystemExit):
        trun_inference.parse_args(["--checkpoint", "x"])  # no --tokenizer


def test_train_streaming_mode(tmp_path, monkeypatch):
    monkeypatch.setattr("transformers.AutoTokenizer.from_pretrained",
                        staticmethod(lambda *_a, **_k: FakeTokenizer()))
    rows = tmp_path / "rows.jsonl"
    rows.write_text("\n".join(
        json.dumps({"instruction": f"q {i}", "output": f"a {i}"})
        for i in range(64)) + "\n")
    cfg = tconfig.Config(model=tconfig.tiny_model_config(),
                         train=tconfig.TrainConfig(
                             per_device_batch_size=2, grad_accum_steps=2,
                             save_steps=0, log_steps=1))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    out = str(tmp_path / "out")
    base = ["--config", str(cfg_path), "--stream", str(rows),
            "--output-dir", out, "--no-media", "--device", "cpu"]
    state = trun_train.main(base + ["--steps", "2", "--tokenizer", "fake"])
    assert state.step == 2
    assert [r["step"] for r in _metrics(out)] == [1, 2]
    assert not any(n.startswith("step_") for n in os.listdir(out))
    with pytest.raises(SystemExit, match="--steps"):
        trun_train.main(base + ["--tokenizer", "fake"])
    with pytest.raises(SystemExit, match="--tokenizer"):
        trun_train.main(base + ["--steps", "1"])


def test_serve_main_answers_a_request(runs, fake_tokenizer):
    server = tserve.build_server([
        "--checkpoint", runs["tdir"], "--tokenizer", "x", "--host",
        "127.0.0.1", "--port", "0", "--max-batch", "2",
        "--max-new-tokens", "4", "--quantize", "int8", "--kv-cache-dtype",
        "int8", "--device", "cpu"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": "hello there",
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["tokens"] == 3 and len(out["text"].split()) == 3
        assert isinstance(server.engine, tserve.ContinuousEngine)
        assert server.engine.params["llm"]["layers"]["attn"]["qkv"][
            "q"].dtype == torch.int8
    finally:
        server.shutdown()
        server.engine.stop()
        server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_run_preprocess_build_matches_jax(tmp_path, fake_tokenizer):
    vqa = tmp_path / "vqa.json"
    vqa.write_text(json.dumps([
        {"instruction": f"what is {k}", "output": "a cat",
         "image": f"COCO_train2014_{k}.jpg"} for k in range(4)]))
    alpaca = tmp_path / "alpaca.json"
    alpaca.write_text(json.dumps([
        {"instruction": f"say {k}", "input": "x" if k % 2 else "",
         "output": "ok"} for k in range(5)]))
    avsd = tmp_path / "avsd.json"
    avsd.write_text(json.dumps([
        {"video": "v1", "turns": [{"question": "q", "answer": "a"}]}]))
    outs = {}
    for name, mod in (("jax", jpre), ("torch", tpre)):
        out = tmp_path / f"{name}.npz"
        names = tmp_path / f"{name}_names.json"
        assert mod.main(["build", "--tokenizer", "x", "--vqa", str(vqa),
                         "--alpaca", str(alpaca), "--avsd", str(avsd),
                         "--out", str(out), "--names-out", str(names),
                         "--max-len", "96", "--per-part", "3"]) == 0
        outs[name] = (dict(np.load(out)), json.loads(names.read_text()))
    (ja, jn), (ta, tn) = outs["jax"], outs["torch"]
    assert tn == jn
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])
    assert len(ta["input_ids"]) == 7
