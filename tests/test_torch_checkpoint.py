"""The port's checkpoints (its own format: the JAX package writes Orbax):
save/restore bit for bit (fp32 masters, bf16 Adam moments, int8 base
records, the dropout generator), a Trainer resumed from a checkpoint
equal bit for bit to an uninterrupted run, retention and the save cadence,
half-written steps never listed, the fenced fallback (forced through a
patched memory query), and snapshot copies that a later in-place step
cannot reach."""

import dataclasses
import os
import threading

import pytest
import torch

from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.train import checkpoint as ckpt_mod
from macaw_llm_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  load_config)
from macaw_llm_tpu_torch.train.lora import init_lora
from macaw_llm_tpu_torch.train.trainer import Trainer


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def assert_states_equal(a, b):
    """Same step, optimizer count and generator state; every leaf the same
    dtype, shape and bits."""
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    for name, x, y in (("trainable", a.trainable, b.trainable),
                       ("frozen", a.frozen, b.frozen),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        lx, ly = _leaves(x), _leaves(y)
        assert sorted(lx) == sorted(ly), name
        for k in lx:
            assert lx[k].dtype == ly[k].dtype, (name, k)
            assert torch.equal(lx[k], ly[k]), (name, k)


def _setup(lora: bool):
    """Tiny model on the CPU with alignment dropout on (so the generator
    state matters); QLoRA: int8 base records in the frozen tree, fp32
    adapters, bf16 Adam m; full: fp32 masters, bf16 grads and Adam m."""
    mcfg = tconfig.tiny_model_config()
    mcfg = dataclasses.replace(mcfg, fusion=dataclasses.replace(
        mcfg.fusion, align_dropout=0.1))
    if lora:
        tcfg = tconfig.TrainConfig(lora_rank=4, quantize_base=True,
                                   grad_accum_steps=1, mu_dtype="bfloat16")
    else:
        tcfg = tconfig.TrainConfig(grad_accum_steps=1, grad_dtype="bfloat16",
                                   mu_dtype="bfloat16")
    trainer = Trainer(mcfg, tcfg, total_steps=10, device="cpu")

    def fresh():
        params = fusion.init_params(0, mcfg, dtype=torch.float32,
                                    device="cpu")
        if lora:
            params["llm"]["layers"]["lora"] = init_lora(
                torch.Generator().manual_seed(1), mcfg.llm, 4)
        return trainer.init_state(params)

    return mcfg, trainer, fresh


def _batches(mcfg, n):
    gen = torch.Generator().manual_seed(7)
    vis = mcfg.vision
    out = []
    for _ in range(n):
        ids = torch.randint(16, 32000, (1, 2, 12), generator=gen)
        ids[..., 0] = 1
        labels = ids.clone()
        labels[..., :3] = -100
        out.append({
            "input_ids": ids, "labels": labels,
            "attention_mask": torch.ones_like(ids),
            "images": torch.randint(0, 255, (1, 2, vis.image_size,
                                             vis.image_size, 3),
                                    generator=gen).to(torch.uint8),
            "audios": torch.randn(1, 2, 480000, generator=gen) * 0.1,
            "videos": torch.randint(0, 255, (1, 2, mcfg.fusion.n_frames,
                                             vis.image_size, vis.image_size,
                                             3), generator=gen
                                    ).to(torch.uint8)})
    return out


@pytest.fixture(scope="module", params=["qlora", "full"])
def trained(request):
    """Two steps taken, so the moments and the generator have moved."""
    mcfg, trainer, fresh = _setup(request.param == "qlora")
    batches = _batches(mcfg, 4)
    state = fresh()
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    return mcfg, trainer, fresh, batches, state


def test_save_restore_is_bitwise(trained, tmp_path):
    mcfg, trainer, fresh, _, state = trained
    mgr = CheckpointManager(str(tmp_path))
    cfg = tconfig.Config(model=mcfg, train=trainer.tcfg)
    assert mgr.save(state, cfg, force=True)
    mgr.wait()
    assert mgr.latest_step() == 2 and mgr.last_save["mode"] == "snapshot"
    assert mgr.last_save["bytes"] > 0 and mgr.last_save["write_s"] >= 0
    restored = CheckpointManager(str(tmp_path)).restore(fresh())
    assert_states_equal(restored, state)
    dtypes = {t.dtype for t in _leaves(restored.frozen).values()}
    dtypes |= {t.dtype for t in _leaves(restored.opt_state.mu).values()}
    assert torch.bfloat16 in dtypes
    if trainer.tcfg.quantize_base:
        assert torch.int8 in dtypes
    assert load_config(str(tmp_path)) == cfg


def test_resumed_trainer_equals_uninterrupted_run(trained, tmp_path):
    """Steps 3-4 from the checkpoint of step 2 give the same bits as steps
    3-4 of the run that never stopped (the dropout generator included)."""
    mcfg, trainer, fresh, batches, state = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, force=True)
    mgr.wait()
    resumed = mgr.restore(fresh())
    straight = mgr.restore(fresh())  # a copy of the state at step 2
    losses = {}
    for name, s in (("resumed", resumed), ("straight", straight)):
        losses[name] = []
        for b in batches[2:]:
            s, m = trainer.train_step(s, b)
            losses[name].append(float(m["loss"]))
    assert losses["resumed"] == losses["straight"]
    assert_states_equal(resumed, straight)
    # and the step-2 state itself was not the fresh one: dropout drew
    assert not torch.equal(state.rng.get_state(), fresh().rng.get_state())


def test_retention_and_cadence(tmp_path):
    mcfg, trainer, fresh = _setup(lora=True)
    state = fresh()
    mgr = CheckpointManager(str(tmp_path), save_steps=2, max_to_keep=2)
    saved = []
    for step in range(1, 8):
        state.step = step
        saved.append(mgr.save(state))
    mgr.wait()
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6]
    assert not mgr.save(state)                  # 7: not a multiple of 2
    assert mgr.save(state, force=True)          # forced
    assert not mgr.save(state, force=True)      # never twice for one step
    mgr.wait()
    assert mgr.all_steps() == [6, 7]
    assert sorted(os.listdir(tmp_path)) == ["step_6", "step_7"]


def test_half_written_steps_are_never_listed(tmp_path, monkeypatch):
    mcfg, trainer, fresh = _setup(lora=True)
    state = fresh()
    mgr = CheckpointManager(str(tmp_path))
    state.step = 3
    mgr.save(state, force=True)
    mgr.wait()
    # a crashed write: the temp dir exists, the step dir has no file
    os.makedirs(tmp_path / ".tmp-step_9")
    (tmp_path / ".tmp-step_9" / "state.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "step_8")
    assert mgr.latest_step() == 3

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", fail)
    state.step = 5
    assert mgr.save(state, force=True)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert mgr.latest_step() == 3
    assert os.path.isdir(tmp_path / ".tmp-step_5")
    monkeypatch.undo()
    assert mgr.save(state, force=True)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
    assert_states_equal(mgr.restore(fresh()), state)


def test_fenced_fallback_when_device_memory_is_short(tmp_path, monkeypatch):
    """Free memory below 1.1x the resident mutable bytes: the save copies
    to the host before returning, and restores bit for bit. Tensors on
    the host are not resident: with the real residency test nothing
    counts, and the save keeps the snapshot path however little is
    free."""
    mcfg, trainer, fresh = _setup(lora=False)
    state = fresh()
    monkeypatch.setattr(ckpt_mod, "_free_device_bytes", lambda device: 0)
    mgr = CheckpointManager(str(tmp_path / "host"))
    mgr.save(state, force=True)
    mgr.wait()
    assert mgr.last_save["mode"] == "snapshot"

    monkeypatch.setattr(ckpt_mod, "_device_resident", lambda t: True)
    mgr = CheckpointManager(str(tmp_path / "fenced"))
    mgr.save(state, force=True)
    mgr.wait()
    assert mgr.last_save["mode"] == "fenced"
    assert_states_equal(mgr.restore(fresh()), state)

    monkeypatch.setattr(ckpt_mod, "_free_device_bytes",
                        lambda device: 10 ** 12)
    mgr = CheckpointManager(str(tmp_path / "roomy"))
    mgr.save(state, force=True)
    mgr.wait()
    assert mgr.last_save["mode"] == "snapshot"
    mgr = CheckpointManager(str(tmp_path / "off"), snapshot=False)
    mgr.save(state, force=True)
    mgr.wait()
    assert mgr.last_save["mode"] == "fenced"


@pytest.mark.parametrize("snapshot", [True, False])
def test_write_never_reads_what_the_next_step_writes(tmp_path, monkeypatch,
                                                     snapshot):
    """The disk write is held until the state has been changed in place
    (as the next train_step does): the checkpoint still holds the state
    as it was at save()."""
    mcfg, trainer, fresh = _setup(lora=False)
    state = fresh()
    before = {k: v.clone() for k, v in _leaves(state.trainable).items()}
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, f):
        assert release.wait(60)
        real_save(obj, f)

    monkeypatch.setattr(ckpt_mod.torch, "save", held_save)
    mgr = CheckpointManager(str(tmp_path), snapshot=snapshot)
    mgr.save(state, force=True)
    with torch.no_grad():
        for t in _leaves(state.trainable).values():
            t.add_(1.0)
        for t in _leaves(state.opt_state.nu).values():
            t.add_(1.0)
    release.set()
    mgr.wait()
    restored = mgr.restore(fresh())
    for k, v in _leaves(restored.trainable).items():
        assert torch.equal(v, before[k]), k
    for v in _leaves(restored.opt_state.nu).values():
        assert not v.any()


def test_restore_refuses_another_layout(tmp_path):
    _, _, fresh_full = _setup(lora=False)
    _, _, fresh_lora = _setup(lora=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(fresh_full(), force=True)
    mgr.wait()
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore(fresh_lora())
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        fresh_full()) is None
