"""The port's ``Config`` tree against the JAX package's: the same fields,
defaults and JSON, so a run config written by either package loads in the
other with the same values; the same geometry checks; the parallel options
accepted; and values whose paths the port has not ported refused by
``validate`` with the ROADMAP item named."""

import dataclasses
import json
import os

import pytest

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("LlamaConfig", "ClipVisionConfig", "WhisperConfig",
           "FusionConfig", "ModelConfig", "MeshConfig", "TrainConfig",
           "DataConfig", "Config")


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_jax(name):
    def fields(mod):
        return [(f.name, f.default,
                 None if f.default_factory is dataclasses.MISSING
                 else f.default_factory.__name__)
                for f in dataclasses.fields(getattr(mod, name))]
    assert fields(tconfig) == fields(jconfig)


def _jax_configs():
    with open(os.path.join(ROOT, "bench_artifacts",
                           "train_1b_chip.json")) as f:
        chip_1b = jconfig.Config.from_json(f.read())
    return {
        "default": jconfig.Config(),
        "tiny": jconfig.Config(model=jconfig.tiny_model_config(),
                               mesh=jconfig.MeshConfig(fsdp=8),
                               train=jconfig.TrainConfig(
                                   per_device_batch_size=1, save_steps=2,
                                   lora_rank=8, quantize_base=True)),
        "macaw_1b": jconfig.Config(model=jconfig.macaw_1b()),
        "macaw_7b": jconfig.Config(model=jconfig.macaw_7b()),
        "train_1b_chip.json": chip_1b,
    }


@pytest.mark.parametrize("name", sorted(_jax_configs()))
def test_json_round_trip_through_the_port(name):
    """JAX to_json -> port from_json -> port to_json -> JAX from_json gives
    the JAX config back, and the two JSON texts are the same."""
    jcfg = _jax_configs()[name]
    text = jcfg.to_json()
    tcfg = tconfig.Config.from_json(text)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.to_json() == text
    assert jconfig.Config.from_json(tcfg.to_json()) == jcfg


def test_committed_1b_run_config_loads_with_defaults_filled():
    """The committed 1b run file predates some fields: both packages fill
    them with the same defaults."""
    path = os.path.join(ROOT, "bench_artifacts", "train_1b_chip.json")
    with open(path) as f:
        text = f.read()
    tcfg = tconfig.Config.from_json(text)
    assert "offload_optimizer" not in json.loads(text)["train"]
    assert tcfg.to_dict() == jconfig.Config.from_json(text).to_dict()
    assert tcfg.model.llm.hidden_size == 2048 and tcfg.model.remat
    assert tcfg.train.grad_dtype == tcfg.train.mu_dtype == "bfloat16"
    tcfg.validate()


@pytest.mark.parametrize("name", ["tiny_model_config", "macaw_1b",
                                  "macaw_7b"])
def test_profiles_match_jax(name):
    t = getattr(tconfig, name)()
    j = getattr(jconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.image_prefix_len, t.video_prefix_len, t.audio_prefix_len,
            t.total_prefix_len) == (j.image_prefix_len, j.video_prefix_len,
                                    j.audio_prefix_len, j.total_prefix_len)
    t.validate()


@pytest.mark.parametrize("mesh,n", [
    (dict(), 1), (dict(), 8), (dict(data=2), 8), (dict(fsdp=8), 8),
    (dict(dcn=2, fsdp=-1, tensor=2), 8), (dict(fsdp=1), 1)])
def test_mesh_resolved_matches_jax(mesh, n):
    assert tconfig.MeshConfig(**mesh).resolved(n) == \
        jconfig.MeshConfig(**mesh).resolved(n)


@pytest.mark.parametrize("mesh", [dict(fsdp=2), dict(data=3, fsdp=-1)])
def test_mesh_mismatch_raises_in_both(mesh):
    with pytest.raises(AssertionError):
        jconfig.MeshConfig(**mesh).resolved(4 if "data" not in mesh else 8)
    with pytest.raises(ValueError):
        tconfig.MeshConfig(**mesh).resolved(4 if "data" not in mesh else 8)


@pytest.mark.parametrize("llm,fusion", [
    (dict(hidden_size=66, num_heads=4), {}),          # heads do not divide
    (dict(vocab_pad_to=100), {}),                     # pad below the vocab
    ({}, dict(attention_heads=3)),                    # align heads
])
def test_geometry_errors_raise_in_both(llm, fusion):
    def make(mod):
        base = mod.tiny_model_config()
        return dataclasses.replace(
            base, llm=dataclasses.replace(base.llm, **llm),
            fusion=dataclasses.replace(base.fusion, **fusion))
    with pytest.raises(AssertionError):
        make(jconfig).validate()
    with pytest.raises(ValueError):
        make(tconfig).validate()


def _sequence_sharded():
    m = tconfig.tiny_model_config()
    sharded = dataclasses.replace(m, shard_sequence=True)
    return {
        # training (sequence parallelism over the tensor axis) and a
        # serving tensor group both accept it, as the reference does
        "shard_sequence": (tconfig.Config(model=sharded), {}),
        "serving tensor=2": (tconfig.Config(
            model=sharded, mesh=tconfig.MeshConfig(fsdp=1, tensor=2)),
            {"serving": True, "world_size": 2}),
    }


@pytest.mark.parametrize("name", sorted(_sequence_sharded()))
def test_shard_sequence_validates_in_both(name):
    cfg, kw = _sequence_sharded()[name]
    cfg.validate(**kw)
    jcfg = jconfig.Config.from_json(cfg.to_json())
    assert jcfg.model.shard_sequence
    jcfg.model.validate()


def _parallel():
    m = tconfig.tiny_model_config()
    return {
        "ring_attention": (tconfig.Config(model=dataclasses.replace(
            m, ring_attention=True)), 1),
        "offload_optimizer": (tconfig.Config(
            model=m, train=tconfig.TrainConfig(offload_optimizer=True)), 1),
        "mesh fsdp=8": (tconfig.Config(
            model=m, mesh=tconfig.MeshConfig(fsdp=8)), 8),
        "mesh data=2": (tconfig.Config(
            model=m, mesh=tconfig.MeshConfig(data=2, fsdp=1)), 2),
    }


@pytest.mark.parametrize("name", sorted(_parallel()))
def test_parallel_options_validate_and_build_a_trainer(name):
    """Ring attention, optimizer offload and meshes are ported: ``validate``
    accepts them for a world of the mesh's size (and refuses another size
    for a fixed mesh), and a Trainer builds its state. A mesh of more than
    one rank is laid over torch's in-process fake process group (its
    collectives do nothing; building the state issues none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.parallel import mesh as tmesh
    from macaw_llm_tpu_torch.train.trainer import Trainer
    cfg, world = _parallel()[name]
    cfg.validate(world_size=world)
    if world > 1:
        with pytest.raises(ValueError):
            cfg.validate(world_size=world + 1)
    mesh = None
    if world > 1:
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
    try:
        if world > 1:
            mesh = init_device_mesh("cpu", cfg.mesh.resolved(world),
                                    mesh_dim_names=tmesh.AXES)
            tmesh._make_groups(mesh)
            # the reference's batch_sharding and replicated as placements
            from torch.distributed.tensor import Replicate, Shard
            assert tmesh.batch_sharding(mesh) == [Shard(0)] * 3 + [
                Replicate()]
            assert tmesh.replicated(mesh) == [Replicate()] * 4
        tr = Trainer(cfg.model, cfg.train, 10, device="cpu", mesh=mesh)
        state = tr.init_state(fusion.init_params(0, cfg.model, device="cpu"))
        wq = state.trainable["llm"]["layers"]["attn"]["wq"]
        h = cfg.model.llm.hidden_size
        assert tuple(wq.shape) == (
            cfg.model.llm.num_layers, h // cfg.mesh.resolved(world)[2], h)
        if cfg.train.offload_optimizer:  # host moments (none pinned here)
            assert state.opt_state.mu["llm"]["norm"].device.type == "cpu"
    finally:
        if world > 1:
            dist.destroy_process_group()


@pytest.mark.parametrize("name", ["remat_policy=dots", "encoder_layerdrop"])
def test_options_of_the_reference_validate(name):
    """The remat policy "dots" and Whisper LayerDrop are ported: validate
    accepts them, as the reference package's config does."""
    m = tconfig.tiny_model_config()
    model = {"remat_policy=dots": dataclasses.replace(
                 m, remat=True, remat_policy="dots"),
             "encoder_layerdrop": dataclasses.replace(
                 m, audio=dataclasses.replace(m.audio,
                                              encoder_layerdrop=0.1))}[name]
    tconfig.Config(model=model).validate()


def test_defaults_validate():
    tconfig.Config().validate()
    tconfig.Config(model=tconfig.tiny_model_config()).validate()
