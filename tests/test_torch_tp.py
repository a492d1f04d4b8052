"""Tensor-parallel inference of the port (``parallel.tensor_parallel``)
over ``gloo`` processes on the CPU, against the JAX package's GSPMD run of
the same numpy-made weights sharded by its partition rules on the 8
simulated devices (``tests/conftest.py``), and against the port's one
device. One spawn per tensor size (2 and 4; ``parallel.dryrun.spawn``,
task ``tp``), several cases in each; the children import torch and the
port only.

Bars: logits within 1e-3 of max |logit| (the BASELINE.json bar, fp32);
tokens identical, and the same on every rank. The tiny config has 4 LLaMA
and 4 alignment heads (one a rank at t = 4) and 2 tower heads (cut at
t = 2, whole at t = 4)."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import serve as jserve
from macaw_llm_tpu.generate import generate as jgenerate
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.models import llama as jllama
from macaw_llm_tpu.parallel import sharding as jsharding
from macaw_llm_tpu.parallel.mesh import create_mesh as jcreate_mesh
from macaw_llm_tpu.utils import quantize as jqz
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import generate as tgen
from macaw_llm_tpu_torch import run_inference as trun_inference
from macaw_llm_tpu_torch import serve as tserve
from macaw_llm_tpu_torch.data.templates import format_prompt
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.parallel.dryrun import _WordTokenizer, spawn
from macaw_llm_tpu_torch.parallel.sharding import tree_paths
from macaw_llm_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          tp_params)
from macaw_llm_tpu_torch.prefill import prefill as tprefill
from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
from macaw_llm_tpu_torch.train.trainer import Trainer
from macaw_llm_tpu_torch.utils import quantize as tqz
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy

REL = 1e-3
PAD_TO = 32008  # divisible by 2, 4 and 8: a vocab-parallel embedding

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8 simulated JAX devices")


def _model(mod, **llm):
    m = mod.tiny_model_config()
    return dataclasses.replace(m, use_flash=True, tower_flash=True,
                               llm=dataclasses.replace(m.llm, **llm))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _weights(cfg, seed=0):
    """Port-made fp32 weights, sharpened as in test_torch_serve (greedy
    ties cannot flip), every bias and bias_k/bias_v nonzero (a row-parallel
    bias added on every rank would count t times)."""
    p = tfusion.init_params(seed, cfg, dtype=torch.float32, device="cpu")
    p["llm"]["lm_head"] = p["llm"]["lm_head"] * 10.0
    for name in ("wq", "wk", "wv", "wo"):
        p["llm"]["layers"]["attn"][name] = \
            p["llm"]["layers"]["attn"][name] * 8.0
    p["llm"]["embed_tokens"] = p["llm"]["embed_tokens"] * 20.0
    gen = torch.Generator().manual_seed(seed + 11)

    def nonzero(path, x):
        if re.search(r"(/b|_b|bias_[kv])$", path):
            return torch.randn(x.shape, generator=gen) * 0.05
        return x
    return _tree_map(nonzero, p)


def _tree_map(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def _jax_sharded(tree_j, t):
    mesh = jcreate_mesh(jconfig.MeshConfig(data=1, fsdp=8 // t, tensor=t))
    return jsharding.shard_params(tree_j, mesh)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(16, 32000, (b, s)).astype(np.int64)
    ids[:, 0] = 1
    mask = np.ones((b, s), np.int64)
    mask[-1, -3:] = 0
    vis = cfg.vision
    return {
        "input_ids": ids, "attention_mask": mask,
        "images": rng.randint(0, 255, (b, vis.image_size, vis.image_size,
                                       3)).astype(np.uint8),
        "audios": (rng.randn(b, 480000) * 0.1).astype(np.float32),
        "videos": rng.randint(0, 255, (b, cfg.fusion.n_frames,
                                       vis.image_size, vis.image_size,
                                       3)).astype(np.uint8),
    }


def _requests(cfg):
    """Eight engine requests: two with media, two sampled, budgets 1-5."""
    size = cfg.vision.image_size
    rng = np.random.RandomState(3)
    image = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
    audio = (rng.randn(480000) * 0.1).astype(np.float32)
    video = rng.randint(0, 255, (cfg.fusion.n_frames, size, size, 3)
                        ).astype(np.uint8)
    rows = [("first question here", {}, 4, 0.0),
            ("what is in this picture and sound",
             {"image": image, "audio": audio}, 5, 0.0),
            ("third thing entirely", {}, 1, 0.0),
            ("describe the clip", {"video": video}, 4, 0.0),
            ("a sampled answer please", {}, 5, 0.9),
            ("another sampled one with more words", {}, 4, 1.2),
            ("a longer question about many different things", {}, 5, 0.0),
            ("last one", {}, 3, 0.0)]
    return [dict(dict(prompt=p, image=None, audio=None, video=None,
                      max_new_tokens=n, temperature=t), **m)
            for p, m, n, t in rows]


def _requests_with_a_bad_audio(cfg):
    """Five requests of ``_requests``'s kind; the second's audio is 7
    samples, which fail its prefill (the mel frames' padding)."""
    rows = _requests(cfg)
    bad = dict(rows[0], prompt="a broken recording",
               audio=np.zeros((7,), np.float32), max_new_tokens=3)
    return [rows[0], bad, rows[1], rows[6], rows[7]]


def _embeds_case(h, seed=0, b=2, s=6):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(b, s, h) * 0.02).astype(np.float32))


# ---------------------------------------------------------------------------
# the spawns: one a tensor size


def _save(d, name, obj):
    path = os.path.join(d, f"{name}.pt")
    torch.save(obj, path)
    return path


def _tokenizer_dir(root: str, texts) -> str:
    """A word-level tokenizer saved as transformers writes one (no
    download): every id of the tiny vocab decodes, the prompts' words
    encode to fixed ids."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    words = sorted({w for t in texts for w in re.findall(r"\w+|[^\w\s]+", t)})
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({w: 16 + (i * 977) % 31000 for i, w in enumerate(words)})
    used = set(vocab.values())
    vocab.update({f"w{i}": i for i in range(32007) if i not in used})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                   bos_token="<s>", eos_token="</s>")
    path = os.path.join(root, "tokenizer")
    fast.save_pretrained(path)
    return path


def _checkpoint(root: str, name: str, params, tensor: int) -> str:
    """A port checkpoint of ``params`` whose run config asks for a serving
    tensor group of ``tensor`` ranks."""
    cfg = tconfig.Config(model=_model(tconfig),
                         mesh=tconfig.MeshConfig(fsdp=1, tensor=tensor))
    tr = Trainer(cfg.model, cfg.train, total_steps=1, device="cpu")
    out = os.path.join(root, name)
    ckpt = CheckpointManager(out, save_steps=1)
    ckpt.save(tr.init_state(params), cfg, force=True)
    ckpt.wait()
    return out


VAL = [{"instruction": f"question {i} about the picture and the sound",
        "response": "yes", "image": "None", "video": "None",
        "audio": "None"} for i in range(3)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    cfg = _model(tconfig)
    cfg_pad = _model(tconfig, vocab_pad_to=PAD_TO)
    w = _weights(cfg)
    w_pad = _weights(cfg_pad, seed=1)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        16, 32000, (2, 12)))
    batch = _batch(cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # 8 x (32 + the prefix) rows: past the W8A8 gate of 256
    wbatch = {k: torch.from_numpy(v)
              for k, v in _batch(cfg, b=8, s=32, seed=4).items()}
    emb = _embeds_case(cfg.llm.hidden_size)
    prompt_ids = torch.from_numpy(np.random.RandomState(5).randint(
        16, 200, (2, 10)))
    prompt_ids[1, -2:] = 0
    spec_emb = tllama.embed(w["llm"], prompt_ids)
    spec_mask = (prompt_ids != 0).long()
    tok_dir = _tokenizer_dir(root, [format_prompt(v["instruction"])
                                    for v in VAL])
    val_path = os.path.join(root, "toy_val_inference.json")
    with open(val_path, "w") as f:
        json.dump(VAL, f)
    files = dict(
        params=_save(root, "params", w), params_pad=_save(root, "pad", w_pad),
        ids=_save(root, "ids", {"input_ids": ids}),
        emb=_save(root, "emb", {"inputs_embeds": emb}),
        spec=_save(root, "spec", {"inputs_embeds": spec_emb,
                                  "attention_mask": spec_mask,
                                  "prompt_ids": prompt_ids}),
        batch=_save(root, "batch", tbatch),
        wbatch=_save(root, "wbatch", wbatch),
        requests=_save(root, "requests", _requests(cfg)),
        requests_fail=_save(root, "requests_fail",
                            _requests_with_a_bad_audio(cfg)))
    ckpt = {t: _checkpoint(root, f"ckpt{t}", w, t) for t in (1, 2)}
    # the reference's sequence-sharding test: its weights and ids
    jseq = jfusion.init_params(jax.random.PRNGKey(3),
                               jconfig.tiny_model_config())
    files["seq_params"] = _save(root, "seq_params", params_from_numpy(
        jax.tree.map(np.asarray, jseq)))
    seq_ids = np.random.RandomState(0).randint(16, 32000, (2, 16))
    for n in SEQ_LENS:
        files[f"seq{n}"] = _save(root, f"seq{n}", {
            "input_ids": torch.from_numpy(seq_ids[:, :n]),
            "shard_sequence": True})
    return dict(root=root, cfg=cfg, cfg_pad=cfg_pad, w=w, w_pad=w_pad,
                ids=ids, batch=batch, tbatch=tbatch, wbatch=wbatch, emb=emb,
                prompt_ids=prompt_ids, spec_emb=spec_emb,
                spec_mask=spec_mask, files=files, tok_dir=tok_dir,
                val_path=val_path, ckpt=ckpt, jseq=jseq, seq_ids=seq_ids)


SEQ_LENS = (16, 15)  # 15: a length that neither 2 nor 4 divides
GEN_KW = dict(max_new_tokens=8, eos_id=2, pad_id=0)
ENGINE_KW = dict(slots=4, prompt_bucket=32, max_new_tokens=5,
                 kv_cache_dtype="int8", align_cache="int8")
STATIC_KW = dict(max_batch=8, max_new_tokens=5, align_cache="bf16")
VARIANTS = {
    # name: (case fields beside the inputs, one-device call)
    "greedy": ({}, {}),
    "int8_kv": ({"kw": dict(GEN_KW, cache_dtype="int8")}, {}),
    "int8_packed": ({"int8": "whole", "pack": True}, {}),
    "sampled": ({"seed": 7, "kw": dict(GEN_KW, temperature=0.8,
                                       top_k=50)}, {}),
    "beam": ({"fn": "beam_search", "kw": dict(GEN_KW, num_beams=3)}, {}),
    "speculative": ({"fn": "generate_speculative",
                     "kw": dict(GEN_KW, draft_len=3)}, {}),
}


def _cases(s: dict, t: int) -> list:
    f = s["files"]
    model = dataclasses.asdict(s["cfg"])
    pad = dict(params=f["params_pad"],
               model=dataclasses.asdict(s["cfg_pad"]))
    cases = [
        dict(name="forward", kind="forward", inputs=f["ids"]),
        *[dict(name=f"shard_sequence{n}", kind="forward", inputs=f[f"seq{n}"],
               params=f["seq_params"],
               model=dataclasses.asdict(tconfig.tiny_model_config()))
          for n in SEQ_LENS],
        dict(name="forward_pad", kind="forward", inputs=f["ids"], **pad),
        dict(name="forward_int8_whole", kind="forward", inputs=f["ids"],
             int8="whole"),
        dict(name="forward_int8_block", kind="forward", inputs=f["ids"],
             int8="block"),
        dict(name="generate_pad", kind="generate", inputs=f["emb"],
             kw=GEN_KW, **pad),
        dict(name="prefill_bf16", kind="prefill", inputs=f["batch"],
             align_cache="bf16"),
    ]
    for name, (fields, _) in VARIANTS.items():
        inputs = f["spec"] if name == "speculative" else f["emb"]
        cases.append(dict(dict(kind="generate", kw=GEN_KW), name=name,
                          inputs=inputs, **fields))
    if t == 2:
        cases += [
            dict(name="prefill_int8", kind="prefill", inputs=f["batch"],
                 align_cache="int8", int8="whole", pack=True),
            dict(name="prefill_last", kind="prefill_entry",
                 inputs=f["wbatch"], align_cache="int8", int8="whole",
                 pack=True),
            dict(name="engine", kind="engine", requests=f["requests"],
                 seed=123, int8="whole", pack=True, kw=ENGINE_KW),
            dict(name="static", kind="engine", requests=f["requests"],
                 seed=321, static=True, kw=STATIC_KW),
            dict(name="http", kind="http", kw=dict(max_batch=2,
                                                   max_new_tokens=3),
                 request={"prompt": "hello there", "max_new_tokens": 3}),
            dict(name="run_inference", kind="run_inference", argv=[
                "--checkpoint", s["ckpt"][2], "--dataset", "toy",
                "--val-json", s["val_path"], "--tokenizer", s["tok_dir"],
                "--batch-size", "2", "--max-new-tokens", "4",
                "--align-cache", "int8",
                "--output-dir", os.path.join(s["root"], "eval_tp"),
                "--device", "cpu"]),
            # faults: a prefill that raises, a client gone mid-stream, a
            # batch that raises, and last the leader's fatal error
            dict(name="engine_fail", kind="engine",
                 requests=f["requests_fail"], seed=123, int8="whole",
                 pack=True, kw=ENGINE_KW, stream_fail=[2]),
            dict(name="static_fail", kind="engine",
                 requests=f["requests_fail"], seed=321, static=True,
                 kw=dict(STATIC_KW, max_batch=2)),
            # a follower's faults: an admission that fails there before
            # any collective, then (last: it tears the engines' group
            # down) a prefill that fails there inside its collectives
            dict(name="engine_follower_admission", kind="engine",
                 requests=f["requests"], seed=123, int8="whole", pack=True,
                 kw=ENGINE_KW, follower_fail=[FOLLOWER_FAILS]),
            dict(name="engine_fatal", kind="engine", requests=f["requests"],
                 seed=123, int8="whole", pack=True, kw=ENGINE_KW,
                 fail_plan_at=3),
            dict(name="engine_follower_prefill", kind="engine",
                 requests=f["requests"], seed=123, int8="whole", pack=True,
                 kw=ENGINE_KW, follower_fail_prefill_at=3),
            dict(name="static_follower_prefill", kind="engine",
                 requests=f["requests"], seed=321, static=True,
                 kw=dict(STATIC_KW, max_batch=2),
                 follower_fail_prefill_at=2),
            # the same, the leader lagging after the failure flags' sum:
            # it finds the teardown between two collectives
            dict(name="static_follower_lagged", kind="engine",
                 requests=f["requests"], seed=321, static=True,
                 kw=dict(STATIC_KW, max_batch=2),
                 follower_fail_prefill_at=2, leader_lag_s=1.0),
        ]
    return [dict(c, model=c.get("model", model)) for c in cases]


def _spawn(s, t):
    return spawn(t, "tp", {"model": dataclasses.asdict(s["cfg"]),
                           "params": s["files"]["params"],
                           "cases": _cases(s, t)},
                 os.path.join(s["root"], f"job{t}"))


@pytest.fixture(scope="module")
def tp2(setup):
    return _spawn(setup, 2)


@pytest.fixture(scope="module")
def tp4(setup):
    return _spawn(setup, 4)


@pytest.fixture(params=[2, 4], ids=["t2", "t4"])
def run(request, setup):
    return request.param, request.getfixturevalue(f"tp{request.param}")


# ---------------------------------------------------------------------------
# 1. a rank's blocks


@pytest.mark.parametrize("t", [2, 4])
def test_shard_shapes_equal_jax_on_the_tensor_dim(setup, t):
    """LLaMA and tower leaves: a cut module's leaves have JAX's shard
    shape on the serving mesh (tensor only); an attention whose heads
    ``t`` does not divide (the towers' 2 at t = 4) stays whole, where JAX
    cuts inside a head. The alignment's in-projection is cut by heads in thirds
    (ROADMAP C), its bias_k/bias_v with them, its out-projection on its
    input."""
    cfg, w = setup["cfg"], setup["w"]
    mesh = jcreate_mesh(jconfig.MeshConfig(dcn=1, data=1, fsdp=1, tensor=t),
                        jax.devices()[:t])
    tp = TensorParallel.of(cfg, t, 1)
    local = dict(tree_paths(tp_params(w, tp)))
    towers_cut = t == 2
    assert ("clip_attn" in tp.cuts) == towers_cut
    assert ("whisper_attn" in tp.cuts) == towers_cut
    assert {"llm_attn", "llm_mlp", "align"} <= tp.cuts
    assert "vocab" not in tp.cuts  # 32007 rows
    checked = 0
    for path, x in tree_paths(w):
        if "_align/" in path:
            continue  # below
        shape = tuple(x.shape)
        spec = jsharding.spec_for(path, shape, mesh)
        want = tuple(NamedSharding(mesh, spec).shard_shape(shape))
        tower = re.match(r"(image|video|audio)_encoder/layers/", path)
        if path.startswith("fusion/") or (
                tower and "/attn/" in path and not towers_cut):
            want = shape  # no Megatron partner; or a head would be cut
        elif tower and re.search(r"/(q|k|v|fc1)/b$", path):
            want = shape[:-1] + (shape[-1] // t,)  # with its columns
        assert tuple(local[path].shape) == want, path
        checked += want != shape
    assert checked == (37 if towers_cut else 16)
    e = cfg.llm.hidden_size
    for mod in ("image", "audio", "video"):
        a = f"fusion/{mod}_align/"
        assert local[a + "in_proj_w"].shape == (3 * e // t, e)
        assert local[a + "bias_k"].shape == (e // t,)
        assert local[a + "out_proj_w"].shape == (e, e // t)
        assert local[a + "out_proj_b"].shape == (e,)
        whole = w["fusion"][f"{mod}_align"]["in_proj_w"].reshape(3, e, e)
        np.testing.assert_array_equal(
            local[a + "in_proj_w"].numpy(),
            whole[:, e // t:2 * e // t].reshape(-1, e).numpy())


def test_packed_blocks_are_the_ranks_columns(setup):
    """Pack after cutting: a rank's packed qkv is [its q | its k | its v]
    of the unpacked weights, gateup [its gate | its up]; int8 scales go
    with their columns (column-parallel) or stay whole (row-parallel wo
    and down); the towers' packed qkv likewise; a packed tree is
    refused."""
    cfg, w = setup["cfg"], setup["w"]
    t, r = 2, 1
    tp = TensorParallel.of(cfg, t, r)
    whole_q = dict(w, llm=tqz.quantize_llama(w["llm"]))
    blk = tp_params(whole_q, tp)
    packed = tqz.pack_llama_for_decode(blk["llm"])
    attn, mlp = w["llm"]["layers"]["attn"], w["llm"]["layers"]["mlp"]
    wq = whole_q["llm"]["layers"]["attn"]

    def cols(x, n):
        return x[..., r * n // t:(r + 1) * n // t]
    h = cfg.llm.hidden_size
    q = packed["layers"]["attn"]["qkv"]
    want = torch.cat([cols(wq[k]["q"], h) for k in ("wq", "wk", "wv")], -1)
    assert torch.equal(q["q"], want)
    assert torch.equal(q["s"], torch.cat([cols(wq[k]["s"], h)
                                          for k in ("wq", "wk", "wv")], -1))
    i = cfg.llm.intermediate_size
    wm = whole_q["llm"]["layers"]["mlp"]
    assert torch.equal(packed["layers"]["mlp"]["gateup"]["q"], torch.cat(
        [cols(wm["gate"]["q"], i), cols(wm["up"]["q"], i)], -1))
    for name, d, group in (("wo", h, "attn"), ("down", i, "mlp")):
        rec = blk["llm"]["layers"][group][name]
        whole_rec = whole_q["llm"]["layers"][group][name]
        assert torch.equal(rec["s"], whole_rec["s"])
        assert torch.equal(rec["q"], whole_rec["q"][
            :, r * d // t:(r + 1) * d // t])
    plain = tp_params(w, tp)
    assert torch.equal(plain["llm"]["layers"]["attn"]["wq"],
                       cols(attn["wq"], h))
    assert torch.equal(plain["llm"]["layers"]["mlp"]["down"],
                       mlp["down"][:, r * i // t:(r + 1) * i // t])
    towers = tfusion.pack_towers(plain)
    e = cfg.vision.hidden_size
    ta = w["image_encoder"]["layers"]["attn"]
    assert torch.equal(
        towers["image_encoder"]["layers"]["attn"]["qkv"]["w"],
        torch.cat([cols(ta[k]["w"], e) for k in "qkv"], -1))
    assert torch.equal(
        towers["image_encoder"]["layers"]["attn"]["qkv"]["b"],
        torch.cat([cols(ta[k]["b"], e) for k in "qkv"], -1))
    with pytest.raises(ValueError, match="packed"):
        tp_params(dict(w, llm=tqz.pack_llama_for_decode(w["llm"])), tp)


def test_row_parallel_biases_stay_whole(setup):
    """The row-parallel biases (o, fc2, out_proj) are whole on every rank
    and added once, after the all-reduce (the prefill parity below runs
    with every bias nonzero); the column-parallel ones are cut."""
    cfg, w = setup["cfg"], setup["w"]
    blk = dict(tree_paths(tp_params(w, TensorParallel.of(cfg, 2, 0))))
    for path, x in tree_paths(w):
        if re.search(r"(attn/o/b|fc2/b|out_proj_b)$", path):
            assert blk[path].shape == x.shape and torch.equal(blk[path], x)
        elif re.search(r"encoder/layers/(attn/[qkv]|mlp/fc1)/b$", path):
            assert blk[path].shape[-1] == x.shape[-1] // 2, path


# ---------------------------------------------------------------------------
# 2. LLaMA logits against JAX's sharded forward


@pytest.mark.parametrize("n", SEQ_LENS)
def test_shard_sequence_same_output_as_jax(setup, run, n):
    """The reference's ``test_shard_sequence_same_output``: the LLaMA over
    the sequence cut between layers over the tensor group (Megatron
    sequence parallelism; 15 positions pad to a multiple of t) against
    JAX's unsharded forward of the same weights, rtol 2e-4."""
    _, res = run
    ref, _ = jax.jit(lambda p, i: jllama.forward(
        p, jconfig.tiny_model_config().llm, input_ids=i))(
        setup["jseq"]["llm"], jnp.asarray(setup["seq_ids"][:, :n]))
    for rank in res:
        np.testing.assert_allclose(rank[f"shard_sequence{n}"].numpy(),
                                   np.asarray(ref), rtol=2e-4, atol=1e-5)


def test_llama_logits_match_jax_sharded(setup, run):
    t, res = run
    jparams = _jax_sharded(_to_jax(setup["w"]), t)["llm"]
    ref, _ = jax.jit(lambda p, i: jllama.forward(
        p, _model(jconfig).llm, input_ids=i))(
        jparams, jnp.asarray(setup["ids"].numpy()))
    for rank in res:
        assert _rel(rank["forward"], ref) <= REL
    assert torch.equal(res[0]["forward"], res[-1]["forward"])


def test_vocab_parallel_logits_match_jax_sharded(setup, run):
    """``vocab_pad_to``: the embedding a masked lookup and an all-reduce,
    the logits all-gathered before the padded columns are masked."""
    t, res = run
    jcfg = _model(jconfig, vocab_pad_to=PAD_TO)
    jparams = _jax_sharded(_to_jax(setup["w_pad"]), t)["llm"]
    ref, _ = jax.jit(lambda p, i: jllama.forward(p, jcfg.llm, input_ids=i))(
        jparams, jnp.asarray(setup["ids"].numpy()))
    ref = np.asarray(ref)
    got = res[0]["forward_pad"].numpy()
    assert got.shape[-1] == PAD_TO
    valid = slice(0, jcfg.llm.vocab_size)
    assert _rel(got[..., valid], ref[..., valid]) <= REL
    assert np.all(got[..., jcfg.llm.vocab_size:] <= -1e30)


def test_int8_blocks_quantized_either_way_give_the_same_logits(run):
    """Quantizing the whole tree and cutting it, or cutting it and
    quantizing each block (row-parallel scales over the ranks), give the
    same records and so the same logits, bit for bit."""
    _, res = run
    for rank in res:
        assert torch.equal(rank["forward_int8_whole"],
                           rank["forward_int8_block"])


# ---------------------------------------------------------------------------
# 3. generation


def test_greedy_tokens_equal_jax_sharded(setup, run):
    """The setup of JAX's ``test_tp_sharded_generate_matches_single_device``
    on these weights."""
    t, res = run
    jparams = _jax_sharded(_to_jax(setup["w"]), t)["llm"]
    ref = jgenerate(jparams, _model(jconfig).llm,
                    inputs_embeds=jnp.asarray(setup["emb"].numpy()),
                    **GEN_KW)
    for rank in res:
        np.testing.assert_array_equal(rank["greedy"].numpy(),
                                      np.asarray(ref.tokens))


def test_vocab_parallel_greedy_tokens_equal_jax_sharded(setup, run):
    t, res = run
    jparams = _jax_sharded(_to_jax(setup["w_pad"]), t)["llm"]
    ref = jgenerate(jparams, _model(jconfig, vocab_pad_to=PAD_TO).llm,
                    inputs_embeds=jnp.asarray(setup["emb"].numpy()),
                    **GEN_KW)
    for rank in res:
        np.testing.assert_array_equal(rank["generate_pad"].numpy(),
                                      np.asarray(ref.tokens))


def _one_device(setup, name):
    fields, _ = VARIANTS[name]
    cfg, w = setup["cfg"], setup["w"]
    llm = w["llm"]
    if fields.get("int8"):
        llm = tqz.pack_llama_for_decode(tqz.quantize_llama(llm))
    kw = dict(fields.get("kw", GEN_KW))
    if name == "speculative":
        kw.update(inputs_embeds=setup["spec_emb"],
                  attention_mask=setup["spec_mask"],
                  prompt_ids=setup["prompt_ids"])
    else:
        kw["inputs_embeds"] = setup["emb"]
    if "seed" in fields:
        kw["generator"] = torch.Generator().manual_seed(fields["seed"])
    fn = getattr(tgen, fields.get("fn", "generate"))
    return fn(llm, cfg.llm, device="cpu", **kw).tokens


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "greedy"])
def test_decode_variants_equal_the_one_device_port(setup, run, name):
    """int8 KV, int8 packed weights (the matvec route on the ranks'
    shard shapes), sampled (one seed on every rank), beam search and
    speculative decode: the one-device port's tokens on every rank."""
    _, res = run
    ref = _one_device(setup, name)
    for rank in res:
        assert torch.equal(rank[name], ref), (name, rank[name], ref)


def test_tp_collectives(run):
    """Without ``vocab_pad_to`` the TP path issues all-reduces only (the
    all-gather is the vocab-parallel logits')."""
    t, res = run
    for rank in res:
        assert rank["collectives"].get("all_reduce", 0) > 0
        assert rank["collectives_by_case"]["greedy"].get("all_gather", 0) \
            == 0
        assert rank["collectives_by_case"]["generate_pad"]["all_gather"] > 0
        assert rank["cuts"] == sorted(TensorParallel.of(
            _model(tconfig), t, 0).cuts)


# ---------------------------------------------------------------------------
# 4. the fused prefill


def _jax_fused(setup, t, int8: bool):
    jcfg = _model(jconfig)
    jp = _to_jax(setup["w"])
    jcache = None
    mode = "int8" if int8 else "bf16"
    jp, jcache = jserve._init_align_cache(jp, jcfg, mode)
    if int8:
        jp = dict(jp, llm=jqz.quantize_llama(jp["llm"]))
    jp = _jax_sharded(jp, t)
    b = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    @jax.jit
    def run(params, batch, cache):
        fused = jfusion.prepare_inputs(
            params, jcfg, input_ids=batch["input_ids"],
            images=batch["images"], audios=batch["audios"],
            videos=batch["videos"], attention_mask=batch["attention_mask"],
            align_cache=cache)
        logits, _ = jllama.forward(params["llm"], jcfg.llm,
                                   inputs_embeds=fused.inputs_embeds,
                                   attention_mask=fused.attention_mask)
        return logits
    return np.asarray(run(jp, b, jcache))


def test_fused_prefill_matches_jax_sharded(setup, run):
    """Towers (cut at t = 2, whole at t = 4), the alignment over the bf16
    cache (cut by heads), the splice and the LLaMA; every position."""
    t, res = run
    ref = _jax_fused(setup, t, int8=False)
    for rank in res:
        assert _rel(rank["prefill_bf16"], ref) <= REL


def test_fused_prefill_int8_matches_jax_sharded(setup, tp2):
    """t = 2 with the int8 alignment cache (whole-row scales over the
    ranks) and int8 LLaMA weights, packed towers; and ``prefill.prefill``
    (the last positions) against the one-device port."""
    ref = _jax_fused(setup, 2, int8=True)
    for rank in tp2:
        assert _rel(rank["prefill_int8"], ref) <= REL


def test_prefill_entry_point_matches_one_device(setup, tp2):
    """``prefill.prefill`` of each rank's block against the one device,
    past the W8A8 gate: the row-parallel wo and down quantize their input
    with the whole row's scale and sum in fp32, so the ranks' int8
    activations are the one device's and only the fp32 sums' order
    differs."""
    cfg = setup["cfg"]
    w = dict(setup["w"], llm=tqz.quantize_llama(setup["w"]["llm"]))
    w, cache = tserve._init_align_cache(w, cfg, "int8")
    w = dict(w, llm=tqz.pack_llama_for_decode(w["llm"]))
    ref = tprefill(w, cfg, setup["wbatch"], cache, device="cpu")
    for rank in tp2:
        assert _rel(rank["prefill_last"], ref) <= 1e-5


# ---------------------------------------------------------------------------
# 5-6. run_inference, the engine and the server


def test_run_inference_over_two_processes_equals_one_device(setup, tp2):
    one = trun_inference.main([
        "--checkpoint", setup["ckpt"][1], "--dataset", "toy", "--val-json",
        setup["val_path"], "--tokenizer", setup["tok_dir"], "--batch-size",
        "2", "--max-new-tokens", "4", "--align-cache", "int8",
        "--output-dir", os.path.join(setup["root"], "eval_one"),
        "--device", "cpu"])
    assert all(r["generation"] for r in one)
    for rank in tp2:
        assert rank["run_inference"] == one
    with open(os.path.join(setup["root"], "eval_tp",
                           "toy_eval_outputs.json")) as f:
        assert json.load(f) == one


def _one_device_engine(setup, rows, fail=()):
    """The one-device engine (int8 packed weights, ENGINE_KW, seed 123)
    driven through the leader's schedule by hand: every request queued
    first, then each iteration admits into the free slots (a prefill that
    raises, or one of a prompt in ``fail``, fails its request and leaves
    its slot free), steps, and reads the tokens back. Returns the engine
    and the results."""
    cfg, w = setup["cfg"], setup["w"]
    w = dict(w, llm=tqz.pack_llama_for_decode(tqz.quantize_llama(w["llm"])))
    mp = pytest.MonkeyPatch()
    mp.setattr(tserve, "_seed_from_clock", lambda: 123)
    try:
        eng = tserve.ContinuousEngine(w, cfg, _WordTokenizer(),
                                      device="cpu", **ENGINE_KW)
    finally:
        mp.undo()
    reqs = [tserve.Request(**r) for r in rows]
    todo = list(reqs)
    with torch.inference_mode():
        while todo or any(r is not None for r in eng._reqs):
            for slot in [i for i, r in enumerate(eng._reqs) if r is None]:
                if not todo:
                    break
                req = todo.pop(0)
                try:
                    if req.prompt in fail:
                        raise RuntimeError("failed")
                    item = eng._run_prefill(req)
                except RuntimeError as e:
                    req._result = {"error": str(e)}
                    continue
                eng._place(slot, item)
            active = [i for i, r in enumerate(eng._reqs) if r is not None]
            if active:
                eng._process_readback(eng._dispatch(active))
    return eng, [r._result for r in reqs]


def test_continuous_engine_equals_the_one_device_engine(setup, tp2):
    """The t = 2 engine (leader's schedule, int8 weights, int8 KV, int8
    alignment cache) against the one-device engine driven through the same
    schedule by hand."""
    eng, ref = _one_device_engine(setup, _requests(setup["cfg"]))
    lead, follow = tp2[0]["engine"], tp2[1]["engine"]
    assert lead["results"] == ref
    assert sum(r["tokens"] for r in ref) >= 20
    # the follower's bookkeeping ran on its own tokens: the same steps,
    # the same last tokens and lengths in every slot
    assert follow["results"] is None and follow["stats"] == lead["stats"]
    assert torch.equal(follow["toks"], lead["toks"])
    assert torch.equal(follow["lengths"], lead["lengths"])
    assert torch.equal(lead["toks"], eng.toks)


def test_static_engine_equals_the_one_device_engine(setup, tp2):
    """``InferenceEngine`` at t = 2: the leader's batch (all 8 requests,
    queued before it starts) broadcast and run on both ranks, against the
    one-device engine's batch of the same requests and seed."""
    cfg = setup["cfg"]
    mp = pytest.MonkeyPatch()
    mp.setattr(tserve, "_seed_from_clock", lambda: 321)
    try:
        eng = tserve.InferenceEngine(setup["w"], cfg, _WordTokenizer(),
                                     device="cpu", **STATIC_KW)
    finally:
        mp.undo()
    reqs = [tserve.Request(**r) for r in _requests(cfg)]
    with torch.inference_mode():
        eng._run_batch(reqs, eng._batch_inputs(reqs))
    strip = ("latency_ms",)
    ref = [{k: v for k, v in r._result.items() if k not in strip}
           for r in reqs]
    got = [{k: v for k, v in r.items() if k not in strip}
           for r in tp2[0]["static"]["results"]]
    assert got == ref and all(r["batch_size"] == 8 for r in got)
    assert tp2[1]["static"]["stats"] == tp2[0]["static"]["stats"]


def test_a_failed_prefill_or_stream_fails_its_request_only(setup, tp2):
    """Under the leader's schedule a prefill that raises (the same payload
    on every rank) fails its request, and a stream callback that raises
    stops that request's stream; both engines serve the other requests as
    one device does, and the ranks stay in step."""
    rows = _requests_with_a_bad_audio(setup["cfg"])
    eng, ref = _one_device_engine(setup, rows)
    lead, follow = tp2[0]["engine_fail"], tp2[1]["engine_fail"]
    assert set(ref[1]) == {"error"} and "Padding size" in ref[1]["error"]
    assert lead["results"] == ref
    assert follow["stats"] == lead["stats"]
    assert torch.equal(follow["toks"], lead["toks"])
    assert torch.equal(lead["toks"], eng.toks)
    # InferenceEngine, 2 a batch: the bad request fails its batch only
    mp = pytest.MonkeyPatch()
    mp.setattr(tserve, "_seed_from_clock", lambda: 321)
    try:
        one = tserve.InferenceEngine(setup["w"], setup["cfg"],
                                     _WordTokenizer(), device="cpu",
                                     **dict(STATIC_KW, max_batch=2))
    finally:
        mp.undo()
    reqs = [tserve.Request(**r) for r in rows]
    with torch.inference_mode():
        for batch in (reqs[2:4], reqs[4:]):
            one._run_batch(batch, one._batch_inputs(batch))
    strip = ("latency_ms",)
    got = tp2[0]["static_fail"]["results"]
    assert all(set(r) == {"error"} for r in got[:2])
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in got[2:]] == [
        {k: v for k, v in r._result.items() if k not in strip}
        for r in reqs[2:]]
    assert tp2[1]["static_fail"]["stats"] == tp2[0]["static_fail"]["stats"]


def test_a_fatal_leader_error_releases_the_followers(tp2):
    """The leader's loop fails (its third plan raises): every request not
    finished by then fails, and the follower, sent the stop, ends its loop
    (its task returns) instead of waiting for a plan."""
    lead, follow = tp2[0]["engine_fatal"], tp2[1]["engine_fatal"]
    err = {"error": "decode loop failed: the leader's plan failed"}
    done = tp2[0]["engine"]["results"]  # the same engine without the fault
    assert all(r in (err, ok) for r, ok in zip(lead["results"], done))
    assert sum(r == err for r in lead["results"]) >= 5
    assert follow["results"] is None
    assert follow["stats"] == lead["stats"]


FOLLOWER_FAILS = "third thing entirely"  # the prompt of request 2


def test_a_followers_failed_admission_fails_it_on_every_rank(setup, tp2):
    """An admission that fails on the follower alone, before any
    collective: the ranks' flags agree that it failed, the leader returns
    an error for it, leaves its slot free, and serves every other request
    as the one-device engine does when that request fails; the ranks stay
    in step."""
    rows = _requests(setup["cfg"])
    eng, ref = _one_device_engine(setup, rows, fail={FOLLOWER_FAILS})
    lead, follow = (r["engine_follower_admission"] for r in tp2)
    bad = [r["prompt"] for r in rows].index(FOLLOWER_FAILS)
    assert lead["results"][bad] == {
        "error": "failed on another rank of the tensor group"}
    assert [r for i, r in enumerate(lead["results"]) if i != bad] == \
        [r for i, r in enumerate(ref) if i != bad]
    assert follow["stats"] == lead["stats"]
    assert torch.equal(follow["toks"], lead["toks"])
    assert torch.equal(lead["toks"], eng.toks)


def test_a_followers_failure_inside_a_prefill_stops_the_group(tp2):
    """The follower's third prefill raises after the prefill's first
    collectives: it tears the engines' group down, so the leader's pending
    all-reduce raises at once; both loops end well inside the group's
    timeout, and the leader answers every request: the ones placed, the
    one failing, the rest of its plan and the queue, each with an
    error."""
    from macaw_llm_tpu_torch.parallel.mesh import TIMEOUT
    lead, follow = (r["engine_follower_prefill"] for r in tp2)
    done = tp2[0]["engine"]["results"]  # the same engine without the fault
    errors = [r for r in lead["results"] if "error" in r]
    assert all(r in ([ok] + errors) for r, ok in zip(lead["results"], done))
    assert len(errors) >= 6, lead["results"]
    assert all(r["error"].startswith("decode loop failed") for r in errors)
    for rank in (lead, follow):
        assert rank["seconds"] < TIMEOUT.total_seconds() / 10, rank


def test_a_followers_failure_inside_a_batch_stops_the_static_group(setup,
                                                                  tp2):
    """``InferenceEngine``, 2 a batch: the follower's second batch raises
    inside the batch's collectives; the leader's first batch is the
    one-device engine's, every later request fails, and both loops end
    well inside the group's timeout."""
    from macaw_llm_tpu_torch.parallel.mesh import TIMEOUT
    lead, follow = (r["static_follower_prefill"] for r in tp2)
    mp = pytest.MonkeyPatch()
    mp.setattr(tserve, "_seed_from_clock", lambda: 321)
    try:
        one = tserve.InferenceEngine(setup["w"], setup["cfg"],
                                     _WordTokenizer(), device="cpu",
                                     **dict(STATIC_KW, max_batch=2))
    finally:
        mp.undo()
    reqs = [tserve.Request(**r) for r in _requests(setup["cfg"])[:2]]
    with torch.inference_mode():
        one._run_batch(reqs, one._batch_inputs(reqs))
    strip = ("latency_ms",)
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in lead["results"][:2]] == [
        {k: v for k, v in r._result.items() if k not in strip}
        for r in reqs]
    assert all(r["error"].startswith("batch failed")
               for r in lead["results"][2:]), lead["results"]
    for rank in (lead, follow):
        assert rank["seconds"] < TIMEOUT.total_seconds() / 10, rank


def test_a_teardown_found_between_collectives_fails_the_static_batch(tp2):
    """The follower's second batch raises inside its collectives while the
    leader lags after that batch's failure flags are summed: the leader's
    watcher marks the group torn down first, so its check between the
    flags and the batch raises outside the batch's own handler. The loop
    still tears its end down and fails the batch in hand and the queue;
    the first batch is served and both loops end well inside the group's
    timeout."""
    from macaw_llm_tpu_torch.parallel.mesh import TIMEOUT
    lead, follow = (r["static_follower_lagged"] for r in tp2)
    served = tp2[0]["static_follower_prefill"]["results"][:2]
    strip = ("latency_ms",)
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in lead["results"][:2]] == [
        {k: v for k, v in r.items() if k not in strip} for r in served]
    errors = lead["results"][2:]
    assert errors and all(r["error"].startswith("batch failed")
                          for r in errors), lead["results"]
    assert any("torn down on another rank" in r["error"] for r in errors)
    for rank in (lead, follow):
        assert rank["seconds"] < TIMEOUT.total_seconds() / 10, rank


def test_http_serves_from_rank_0_only(tp2):
    out = tp2[0]["http"]
    assert out["tokens"] == 3 and len(out["text"].split()) == 3
    assert tp2[1]["http"] == {"follower": "_Follower"}


# ---------------------------------------------------------------------------
# 7. validation


def test_serving_validates_a_tensor_group_of_the_worlds_size():
    cfg = tconfig.Config(model=tconfig.tiny_model_config(),
                         mesh=tconfig.MeshConfig(fsdp=4, tensor=2))
    cfg.validate(world_size=2, serving=True)
    with pytest.raises(ValueError, match="2 processes"):
        cfg.validate(world_size=1, serving=True)
    # sequence sharding is a layout of the cache-free forward: a serving
    # tensor group accepts it
    dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, shard_sequence=True)).validate(world_size=2,
                                                  serving=True)


def test_row_parallel_int8_keeps_the_int8_block_for_its_backward(tmp_path):
    """Under a tensor group the QLoRA base's row-parallel products (wo,
    down) save the int8 block for their backward, not a dequantized copy,
    as the one-device ``_Int8Matmul`` does, and give its gradient."""
    import torch.distributed as dist
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    q, s = tqz.quantize_tensor(w)
    x = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        saved, grads = [], []
        for tp in (None, TensorParallel(1, 0)):
            xg = x.clone().requires_grad_()
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append((tp, t)) or t, lambda t: t):
                y = tqz.matmul(xg, {"q": q, "s": s}, torch.float32, tp=tp)
            y.square().sum().backward()
            grads.append(xg.grad)
    finally:
        dist.destroy_process_group()
    kept = [t for tp, t in saved if tp is not None and t.shape == q.shape]
    assert kept and all(t.dtype == torch.int8 for t in kept), kept
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)


def test_a_rank_learns_of_a_teardown_from_the_store(tmp_path):
    """The teardown mark: ``_tear_down`` sets it in the job's store and
    destroys its end of the group; another engine's watcher on the same
    group reads it within its poll and marks the group torn down (on NCCL
    it also aborts its end), after which ``_check_group`` and every
    collective over the group raise instead of issuing; a watcher whose
    engine issues no more collectives ends."""
    import threading
    import time
    import types

    import torch.distributed as dist

    from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        tp = TensorParallel(1, 0, dist.new_group([0]))

        def engine():
            return types.SimpleNamespace(tp=tp, _watcher=None,
                                         device=torch.device("cpu"),
                                         _group_done=threading.Event())
        peer, failing, idle = engine(), engine(), engine()
        watchers = [threading.Thread(target=tserve._watch_group,
                                     args=(e, tp)) for e in (peer, idle)]
        for w in watchers:
            w.start()
        tserve._check_group(peer)  # nothing torn down yet
        assert tpar.reduce_max(tp, torch.ones(2)).tolist() == [1.0, 1.0]
        idle._group_done.set()
        watchers[1].join(5.0)
        assert not watchers[1].is_alive()
        assert tp.group not in tpar.TORN_GROUPS
        tserve._tear_down(failing)
        assert failing.tp is None and failing._group_done.is_set()
        deadline = time.monotonic() + 5.0
        while tp.group not in tpar.TORN_GROUPS \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        watchers[0].join(5.0)
        assert not watchers[0].is_alive()
        for call in (lambda: tserve._check_group(peer),
                     lambda: tpar.reduce_max(tp, torch.ones(2)),
                     lambda: tserve._share(tp, {"plan": 1})):
            with pytest.raises(RuntimeError, match="torn down on another"):
                call()
        assert tp.group not in dist.distributed_c10d._world.pg_map
    finally:
        dist.destroy_process_group()


def test_engines_pin_their_threads_to_the_processs_card(monkeypatch):
    """``cuda`` names the card this process took: the engines' threads
    (their loops, the teardown watcher) run there, not on card 0, which
    every new thread starts on."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert tserve._this_card(torch.device("cuda")) == torch.device("cuda", 1)
    assert tserve._this_card(torch.device("cuda", 0)) == torch.device(
        "cuda", 0)
    assert tserve._this_card(torch.device("cpu")) == torch.device("cpu")
