"""The port's Trainer over a mesh of ``gloo`` processes on the CPU against
the JAX Trainer on the same global batch (tiny config, fp32, dropout off,
the same numpy-made weights): one spawn per mesh shape, several runs and
checks in each (``parallel.dryrun.spawn``; the children import torch and
the port only).

Bar: the losses and gradient norms within 1e-3 of JAX's, and every
trainable leaf's total update (p_last - p0) within 1e-3 of the leaf's
largest update plus 4 fp32 ulps of its largest value
(``test_torch_train.py``'s bar). Each rank's shards have the shapes of
JAX's ``NamedSharding.shard_shape`` for the parameters and for Adam's
moments; checkpoints move between two ranks and one device bit for bit;
the loaders give each process JAX's rows; ``run_train`` over two
processes matches JAX's ``run_train`` on eight simulated devices step by
step; the 4-process dry run trains."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import run_train as jrun_train
from macaw_llm_tpu.data import loader as jloader
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.parallel import sharding as jsharding
from macaw_llm_tpu.parallel.mesh import create_mesh as jcreate_mesh
from macaw_llm_tpu.train import trainer as jtrainer
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import run_train as trun_train
from macaw_llm_tpu_torch.data import loader as tloader
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.parallel.dryrun import spawn
from macaw_llm_tpu_torch.parallel.sharding import tree_paths
from macaw_llm_tpu_torch.train import lora as tlora
from macaw_llm_tpu_torch.train import trainer as ttrainer
from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
from macaw_llm_tpu_torch.utils.hf_import import pad_vocab
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy

REL = 1e-3

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8 simulated JAX devices")


def _model(mod, vocab_pad_to=None, **kw):
    m = mod.tiny_model_config()
    return dataclasses.replace(m, use_flash=True, tower_flash=True,
                               llm=dataclasses.replace(
                                   m.llm, vocab_pad_to=vocab_pad_to),
                               fusion=dataclasses.replace(
                                   m.fusion, align_dropout=0.0), **kw)


def _train_kw(lora: bool, accum: int, **kw):
    # adam_eps 1e-4: see test_torch_train._trainers (noise-sized gradients)
    out = dict(learning_rate=1e-2, warmup_ratio=0.1, grad_accum_steps=accum,
               lora_rank=4 if lora else 0, quantize_base=lora, adam_eps=1e-4)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def weights():
    """Port-made fp32 weights (lm_head x 10 so that the loss moves), with
    LoRA adapters whose B is not zero."""
    tp = tfusion.init_params(0, _model(tconfig), dtype=torch.float32,
                             device="cpu")
    tp["llm"]["lm_head"] = tp["llm"]["lm_head"] * 10.0
    lo = tlora.init_lora(torch.Generator().manual_seed(1), _model(tconfig).llm,
                         4)
    for k, seed in (("qb", 2), ("vb", 3)):
        lo[k] = torch.randn(lo[k].shape, generator=torch.Generator()
                            .manual_seed(seed)) * 0.05
    tp["llm"]["layers"]["lora"] = lo
    return tp


def _params(weights, lora: bool, pad=None) -> dict:
    """The weights of a full or LoRA run, the vocab padded with zero rows
    to ``pad`` (``vocab_pad_to``)."""
    llm = weights["llm"]
    if pad is not None:
        llm = pad_vocab(llm, pad)
    if not lora:
        llm = dict(llm, layers={k: v for k, v in llm["layers"].items()
                                if k != "lora"})
    return dict(weights, llm=llm)


def _batch(seed: int, a: int = 1, b: int = 4, s: int = 12,
           media: bool = True) -> dict:
    """A whole batch [A, B, ...]: rows hold different numbers of valid
    targets (the last one padded, the second with most labels ignored)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(16, 32000, (a, b, s)).astype(np.int64)
    ids[:, :, 0] = 1
    labels = ids.copy()
    labels[:, :, :3] = -100
    labels[:, 1, 4:] = -100
    mask = np.ones((a, b, s), np.int64)
    if media:
        mask[:, -1, -2:] = 0
        labels[:, -1, -2:] = -100
    out = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    if media:
        out["images"] = rng.randint(0, 255, (a, b, 32, 32, 3)).astype(
            np.uint8)
    return out


def _jax_run(weights, lora, accum, batches, evals=(), pad=None):
    """The JAX Trainer (one-device mesh) over ``batches``: per step loss
    and gradient norm, the trainable leaves before and after, eval."""
    jcfg = jconfig.Config(
        model=_model(jconfig, pad), train=jconfig.TrainConfig(
            **_train_kw(lora, accum)),
        mesh=jconfig.MeshConfig(data=1, fsdp=1, tensor=1))
    tr = jtrainer.Trainer(jcfg, jcreate_mesh(jcfg.mesh, jax.devices()[:1]),
                          total_steps=10)
    st = tr.init_state(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                    _params(weights, lora, pad)))
    p0 = {k: np.array(v) for k, v in tree_paths(st.trainable)}
    losses, norms = [], []
    for b in batches:
        st, m = tr.train_step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    p1 = {k: np.array(v) for k, v in tree_paths(st.trainable)}
    ev = tr.evaluate(st, [{k: jnp.asarray(v) for k, v in b.items()}
                          for b in evals]) if evals else None
    return dict(loss=losses, grad_norm=norms, p0=p0, p1=p1, eval=ev)


def _close(got, ref, what, rel=REL, atol=1e-9):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + atol, (what, err,
                                                   np.abs(ref).max())


def _matches_jax(res: dict, ref: dict, what: str) -> None:
    _close(res["loss"], ref["loss"], f"{what} loss")
    _close(res["grad_norm"], ref["grad_norm"], f"{what} grad norm")
    got = dict(tree_paths(res["trainable"]))
    assert sorted(got) == sorted(ref["p0"]), what
    for k, p0 in ref["p0"].items():
        upd = ref["p1"][k].astype(np.float64) - p0
        mine = got[k].double().numpy() - p0
        ulp = np.finfo(np.float32).eps * np.abs(p0).max()
        _close(mine, upd, f"{what} {k}", atol=4 * ulp)


def _save(tmp, name, obj) -> str:
    path = str(tmp / f"{name}.pt")
    torch.save(obj, path)
    return path


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _run(tmp, weights, lora, accum, batches, model=None, evals=(), **kw):
    model = model or _model(tconfig)
    pad = model.llm.vocab_pad_to
    return dict(model=dataclasses.asdict(model),
                train=dataclasses.asdict(tconfig.TrainConfig(
                    **_train_kw(lora, accum, **kw))),
                params=_save(tmp, f"params_{lora}_{pad}",
                             _params(weights, lora, pad)),
                batches=_save(tmp, f"batches_{lora}_{accum}_{id(batches)}",
                              [_tensors(b) for b in batches]),
                eval=_save(tmp, "eval", [_tensors(b) for b in evals])
                if evals else None)


def _shard_shapes_match_jax(res: list, shape, weights, lora,
                            pad=None) -> None:
    """Each rank's shard shapes against JAX's ``shard_shape`` of the whole
    leaf (taken from a one-device state of the same run)."""
    tr = ttrainer.Trainer(_model(tconfig, pad), tconfig.TrainConfig(
        **_train_kw(lora, 1)), 10, device="cpu")
    whole = tr.init_state(_params(weights, lora, pad))
    c, d, f, t = shape
    jmesh = jcreate_mesh(jconfig.MeshConfig(dcn=c, data=d, fsdp=f, tensor=t),
                         jax.devices()[:c * d * f * t])
    trees = {"trainable": whole.trainable, "frozen": whole.frozen,
             "mu": whole.trainable, "nu": whole.trainable}
    for kind, tree in trees.items():
        for path, x in tree_paths(tree):
            spec = jsharding.spec_for(path, tuple(x.shape), jmesh)
            want = list(NamedSharding(jmesh, spec).shard_shape(
                tuple(x.shape)))
            for r, rank in enumerate(res):
                assert rank["shapes"][kind][path] == want, (kind, path, r)


# extra keys that are ModelConfig fields (vocab_pad_to: LlamaConfig's)
MODEL_KW = ("remat", "remat_policy", "shard_sequence", "vocab_pad_to")
PAD_TO = 32008  # a vocab that 2 divides: vocab-parallel under tensor 2
MESH_RUNS = {
    # mesh: (lora, accum, text only with the ring, extra TrainConfig or
    # ModelConfig fields)
    (1, 2, 2, 1): [(False, 1, False, {}), (True, 2, False, {}),
                   (False, 1, False, {"remat": True})],
    # tensor 2 computes Megatron-style (fsdp 2 cuts its storage further)
    (1, 1, 2, 2): [(True, 1, False, {}),
                   (False, 1, False, {"offload_optimizer": True})],
    (1, 1, 1, 2): [(False, 1, False, {"vocab_pad_to": PAD_TO}),
                   (True, 1, False, {}),
                   (False, 2, False, {"vocab_pad_to": PAD_TO,
                                      "shard_sequence": True,
                                      "remat": True}),
                   (False, 1, False, {"vocab_pad_to": PAD_TO, "remat": True,
                                      "remat_policy": "dots"})],
    (1, 1, 2, 2, "ring"): [(False, 1, True, {}), (True, 2, True, {})],
}


def _ref_key(lora, accum, text, extra):
    return lora, accum, text, extra.get("vocab_pad_to")


@pytest.fixture(scope="module")
def jax_refs(weights):
    """JAX's runs: 2 steps each, full and LoRA, media and text-only, the
    vocab whole or padded (sequence parallelism and remat change no
    number: their runs are held against the same reference)."""
    refs = {}
    for lora, accum, text, pad in {_ref_key(*run) for runs in
                                   MESH_RUNS.values() for run in runs}:
        batches = [_batch(10 + i, a=accum, media=not text) for i in range(2)]
        evals = [{k: v[0] for k, v in _batch(30).items()}]
        refs[lora, accum, text, pad] = dict(
            batches=batches, evals=evals,
            **_jax_run(weights, lora, accum, batches,
                       evals if not (lora or text) else (), pad))
    return refs


@pytest.mark.parametrize("key", list(MESH_RUNS), ids=lambda k: "x".join(
    map(str, k)))
def test_mesh_trainer_matches_jax(key, weights, jax_refs, tmp_path):
    """The runs of one mesh shape in one spawn: the Trainer's losses,
    gradient norms and updates against JAX's, shard shapes against JAX's,
    the collectives issued, eval over the mesh (the full-FT runs), offload
    against JAX as without it, and under remat the layers gathered again
    in the recompute."""
    shape, ring = key[:4], key[4:] == ("ring",)
    runs, refs = [], []
    for lora, accum, text, extra in MESH_RUNS[key]:
        ref = jax_refs[_ref_key(lora, accum, text, extra)]
        model_kw = {k: v for k, v in extra.items() if k in MODEL_KW}
        train_kw = {k: v for k, v in extra.items() if k not in MODEL_KW}
        model = _model(tconfig, ring_attention=ring, **model_kw)
        evals = ref["eval"] is not None and not (
            set(model_kw) - {"vocab_pad_to"}) and ref["evals"]
        runs.append(_run(tmp_path, weights, lora, accum, ref["batches"],
                         model=model, evals=evals or (), **train_kw))
        runs[-1]["count_llama"] = shape == (1, 1, 1, 2)
        refs.append(ref)
    res = [r["runs"] for r in spawn(int(np.prod(shape)), "train",
                                    {"mesh": shape, "runs": runs},
                                    str(tmp_path / "job"))]
    for i, (ref, (lora, accum, text, extra)) in enumerate(
            zip(refs, MESH_RUNS[key])):
        what = f"{key} lora={lora} accum={accum} {extra}"
        rank0 = res[0][i]
        _matches_jax(rank0, ref, what)
        for rank in res[1:]:  # every rank reports the same global numbers
            assert rank[i]["loss"] == rank0["loss"], what
            assert rank[i]["grad_norm"] == rank0["grad_norm"], what
        _shard_shapes_match_jax([r[i] for r in res], shape, weights, lora,
                                extra.get("vocab_pad_to"))
        issued = rank0["collectives"]
        assert issued["all_reduce"] > 0, what
        assert issued.get("send_recv", 0) > 0 if ring else \
            "send_recv" not in issued, what
        if "eval" in rank0:
            for name in ("eval_loss", "eval_token_accuracy"):
                _close(rank0["eval"][name], ref["eval"][name], name)
        if extra.get("remat") and shape[2] > 1:
            # the recompute gathers each layer's fsdp shards again
            plain = res[0][0]["collectives"]["all_gather"]
            assert issued["all_gather"] > plain, (issued, plain)
        if shape[3] > 1 and not ring:
            _megatron_blocks_and_collectives([r[i] for r in res], shape,
                                             lora, extra)


def _megatron_blocks_and_collectives(res: list, shape, lora: bool,
                                     extra: dict) -> None:
    """Under a tensor axis of t without the ring every rank reads its
    column block of wq ([D, D / t], never the whole leaf), of LoRA's B
    and A whole; over a tensor-only mesh one LLaMA forward and backward
    make, per layer, Megatron's collectives: g's all-reduce after the
    attention and the MLP, f's in the backward (and LoRA's middles'), or
    under sequence parallelism an all-gather before and a reduce-scatter
    after each module (and the reverse in the backward), plus the
    sequence's split and final gather."""
    m = tconfig.tiny_model_config().llm
    d, n_layers, t = m.hidden_size, m.num_layers, shape[3]
    for rank in res:
        got = rank["gathered"]
        wq = got["llm/layers/attn/wq/q" if lora else "llm/layers/attn/wq"]
        assert wq == [d, d // t], got
        if lora:
            assert got["llm/layers/lora/qb"] == [4, d // t], got
            assert got["llm/layers/lora/qa"] == [d, 4], got
        if shape != (1, 1, 1, 2):
            continue
        counts = rank["llama_collectives"]
        per = 2 * n_layers
        if extra.get("shard_sequence"):
            assert counts["forward"] == {"all_gather": per + 1,
                                         "reduce_scatter": per}, counts
            assert counts["total"] == {"all_gather": 2 * per + 2,
                                       "reduce_scatter": 2 * per}, counts
        else:
            assert counts["forward"] == {"all_reduce": per}, counts
            assert counts["total"] == {
                "all_reduce": (3 if lora else 2) * per}, counts


def test_checkpoints_move_between_two_ranks_and_one_device(weights,
                                                           tmp_path):
    """A one-device checkpoint restores on a 2-rank mesh bit for bit (the
    gathered restored state equals the saved one), trains a step there and
    is saved by rank 0; that checkpoint restores on one device bit for bit
    against the mesh's gathered state."""
    cfg = tconfig.Config(model=_model(tconfig), train=tconfig.TrainConfig(
        **_train_kw(False, 1)))
    one = ttrainer.Trainer(cfg.model, cfg.train, 10, device="cpu")
    st = one.init_state(_params(weights, False))
    st, _ = one.train_step(st, _tensors(_batch(40)))
    ckpt_a = tmp_path / "one"
    CheckpointManager(str(ckpt_a), save_steps=1).save(st, cfg, force=True)
    CheckpointManager(str(ckpt_a)).wait()
    run = _run(tmp_path, weights, False, 1, [_batch(41)])
    run.update(restore=str(ckpt_a), save=str(tmp_path / "mesh"))
    res = spawn(2, "train", {"mesh": (1, 1, 2, 1), "runs": [run]},
                str(tmp_path / "job"))[0]["runs"][0]
    restored = res["restored"]
    assert restored["step"] == 1
    for name, tree in (("trainable", st.trainable), ("mu", st.opt_state.mu),
                       ("nu", st.opt_state.nu)):
        got = dict(tree_paths(restored[name]))
        for path, x in tree_paths(tree):
            assert torch.equal(got[path], x), (name, path)
    assert res["last_save"]["mode"] == "gathered"
    back = CheckpointManager(str(tmp_path / "mesh")).restore(
        one.init_state(_params(weights, False)))
    assert back.step == res["step"] == 2
    for name, tree in (("trainable", back.trainable),
                       ("mu", back.opt_state.mu), ("nu", back.opt_state.nu)):
        got = dict(tree_paths(res[name]))
        for path, x in tree_paths(tree):
            assert torch.equal(got[path], x), (name, path)


def test_gathered_checkpoint_restores_onto_four_ranks_from_a_map(weights,
                                                                 tmp_path):
    """A checkpoint gathered from a (1, 1, 4, 1) mesh restores onto the
    same mesh through the file's memory map: every rank holds its block
    of each saved leaf and moment bit for bit, and the restored state
    gathers to the saved one."""
    from macaw_llm_tpu_torch.parallel.sharding import at_path
    from macaw_llm_tpu_torch.train.checkpoint import STATE_FILE
    save = tmp_path / "mesh"
    batches, none = [_batch(42)], []  # alive: _run names files by id
    first = _run(tmp_path, weights, False, 1, batches)
    first.update(save=str(save))
    again = _run(tmp_path, weights, False, 1, none)
    again.update(restore=str(save))
    ranks = spawn(4, "train", {"mesh": (1, 1, 4, 1),
                               "runs": [first, again]},
                  str(tmp_path / "job"))
    saved = torch.load(save / "step_1" / STATE_FILE, weights_only=True)
    assert ranks[0]["runs"][0]["last_save"]["mode"] == "gathered"
    for rank, res in enumerate(ranks):
        got = res["runs"][1]
        assert got["restored"]["step"] == 1
        for name, tree in (("trainable", saved["trainable"]),
                           ("mu", saved["opt"]["mu"]),
                           ("nu", saved["opt"]["nu"])):
            shards = dict(tree_paths(got["restored_shards"][name]))
            whole = dict(tree_paths(got["restored"][name]))
            for path, x in tree_paths(tree):
                assert torch.equal(whole[path], x), (rank, name, path)
                block = x
                for d, axis in enumerate(at_path(got["specs"], path)):
                    if axis == "fsdp":
                        m = x.shape[d] // 4
                        block = block.narrow(d, rank * m, m)
                assert torch.equal(shards[path], block), (rank, name, path)


@pytest.mark.parametrize("count", [2, 4])
def test_loaders_give_each_process_jaxs_rows(count):
    from macaw_llm_tpu.run_train import synthetic_dataset as jsynth
    ds = jsynth(jconfig.Config(model=jconfig.tiny_model_config()), n=40)
    tds = trun_train.synthetic_dataset(
        tconfig.Config(model=tconfig.tiny_model_config()), n=40)
    for i in range(count):
        jl = jloader.BatchLoader(ds, None, global_batch=4, accum=2, seed=3,
                                 process_index=i, process_count=count)
        tl = tloader.BatchLoader(tds, None, global_batch=4, accum=2, seed=3,
                                 process_index=i, process_count=count)
        assert tl.steps_per_epoch == jl.steps_per_epoch == 40 // (4 * count)
        for jb, tb in zip(jl.epoch(1, skip=1), tl.epoch(1, skip=1)):
            for k in jb:
                np.testing.assert_array_equal(np.asarray(tb[k]), jb[k])


def test_stream_rows_split_like_jax(tmp_path):
    rows = [{"prompt": f"p{i}", "output": f"o{i}"} for i in range(11)]
    paths = []
    for part in (rows[:4], rows[4:]):
        paths.append(str(tmp_path / f"{len(paths)}.jsonl"))
        with open(paths[-1], "w") as f:
            f.write("\n".join(json.dumps(r) for r in part) + "\n\n")
    for i in range(3):
        assert list(tloader.stream_jsonl(paths, i, 3)) == \
            list(jloader.stream_jsonl(paths, i, 3))


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "loss" in line]


def test_run_train_over_two_processes_matches_jax(tmp_path):
    """``run_train`` over two gloo processes (mesh fsdp=2, 4 rows a
    process, 2 accumulation steps) against JAX's ``run_train`` on 8
    simulated devices (1 row a device), the same global batch of 16 and
    the same weights: every step's loss, gradient norm and learning rate;
    rank 0 alone writes metrics.jsonl and the checkpoint."""
    def cfg(mod, per_device, mesh):
        m = dataclasses.replace(mod.tiny_model_config(), fusion=dataclasses
                                .replace(mod.tiny_model_config().fusion,
                                         align_dropout=0.0))
        return mod.Config(model=m, mesh=mod.MeshConfig(**mesh),
                          train=mod.TrainConfig(
                              per_device_batch_size=per_device,
                              grad_accum_steps=2, save_steps=2, log_steps=1))
    args = ["--synthetic", "--no-media", "--steps", "2"]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jpath.write_text(cfg(jconfig, 1, dict(fsdp=8)).to_json())
    tpath.write_text(cfg(tconfig, 4, dict(fsdp=2)).to_json())
    jrun_train.main(["--config", str(jpath), "--output-dir",
                     str(tmp_path / "jax_out")] + args)
    jp = jfusion.init_params(jax.random.PRNGKey(1),
                             jconfig.Config.from_json(jpath.read_text()).model)
    params = _save(tmp_path, "params",
                   params_from_numpy(jax.tree.map(np.asarray, jp)))
    out = str(tmp_path / "torch_out")
    res = spawn(2, "run_train", {"params": params, "argv": [
        "--config", str(tpath), "--output-dir", out, "--device", "cpu"]
        + args}, str(tmp_path / "job"))
    assert [r["step"] for r in res] == [2, 2]
    jm, tm = _metrics(tmp_path / "jax_out"), _metrics(out)
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [1, 2]
    for j, t in zip(jm, tm):
        for k in ("loss", "grad_norm", "lr"):
            _close(t[k], j[k], f"{k} at step {j['step']}")
    assert os.path.isfile(os.path.join(out, "step_2", "state.pt"))


def test_dryrun_over_four_processes(tmp_path):
    res = spawn(4, "dryrun", {}, str(tmp_path))
    losses = {r["loss"] for r in res}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    # fsdp 2 x tensor 2: wq [L, 64, 64] cut to [L, 32, 32]
    assert all(r["shapes"]["llm/layers/attn/wq"] == [2, 32, 32] for r in res)
    assert "RANK 3 mesh" in res[3]["log"]
