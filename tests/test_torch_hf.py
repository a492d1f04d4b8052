"""HF weight import and export of the port against the JAX package's
(``utils/hf_import.py``, ``utils/hf_export.py``) and against
``transformers``' own forward, on random-init HF models built from small
configs in code (nothing is downloaded), fp32 on the CPU.

Bounds: imported leaves equal to JAX's (both pass every value through
fp32); logits and encoder outputs within 1e-3 of max |ref| of JAX's and of
``transformers``'; ``run_train --llama-weights`` step-1 loss within 1e-3
relative of JAX ``run_train``'s on the same weights and batches.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import run_train as jrun_train
from macaw_llm_tpu.models import clip as jclip
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.models import llama as jllama
from macaw_llm_tpu.models import whisper as jwhisper
from macaw_llm_tpu.utils import hf_export as jexport
from macaw_llm_tpu.utils import hf_import as jimport
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import run_train as trun_train
from macaw_llm_tpu_torch.models import clip as tclip
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.models import whisper as twhisper
from macaw_llm_tpu_torch.utils import hf_export as texport
from macaw_llm_tpu_torch.utils import hf_import as timport
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy
from macaw_llm_tpu_torch.utils.safetensors_io import (load_checkpoint_dir,
                                                      save_safetensors)

TOL = 1e-3
HF_VOCAB = 32000  # the reference's LLaMA vocab before its 7 new tokens


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()
                if tree.dtype == torch.bfloat16 else tree.numpy()}
    return {prefix: np.asarray(tree)}


def _assert_same_tree(port, ref):
    a, b = _leaves(port), _leaves(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np_sd(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _hf_llama(cfg, vocab: int, seed: int = 0):
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_base,
        tie_word_embeddings=False, attn_implementation="eager"))
    return hf.eval()


def _hf_clip(vis, seed: int = 1):
    torch.manual_seed(seed)
    hf = transformers.CLIPModel(transformers.CLIPConfig(
        vision_config=dict(hidden_size=vis.hidden_size,
                           intermediate_size=vis.intermediate_size,
                           num_hidden_layers=vis.num_layers,
                           num_attention_heads=vis.num_heads,
                           image_size=vis.image_size,
                           patch_size=vis.patch_size,
                           layer_norm_eps=vis.layer_norm_eps),
        text_config=dict(hidden_size=16, intermediate_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         vocab_size=64, max_position_embeddings=16),
        projection_dim=vis.projection_dim))
    return hf.eval()


def _hf_whisper(aud, seed: int = 2):
    torch.manual_seed(seed)
    hf = transformers.WhisperModel(transformers.WhisperConfig(
        num_mel_bins=aud.num_mel_bins, d_model=aud.d_model,
        encoder_layers=aud.encoder_layers,
        encoder_attention_heads=aud.encoder_attention_heads,
        encoder_ffn_dim=aud.encoder_ffn_dim,
        max_source_positions=aud.max_source_positions,
        decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=32,
        vocab_size=64, max_target_positions=16, pad_token_id=1,
        bos_token_id=2, eos_token_id=2, decoder_start_token_id=3))
    return hf.eval()


@pytest.fixture(scope="module")
def cfgs():
    return jconfig.tiny_model_config(), tconfig.tiny_model_config()


def test_llama_import_matches_jax_and_transformers(cfgs):
    jcfg, tcfg = cfgs
    hf = _hf_llama(tcfg.llm, vocab=tcfg.llm.vocab_size)
    sd = _np_sd(hf)
    jp = jimport.import_llama(sd, jcfg.llm)
    tp = timport.import_llama(sd, tcfg.llm)
    _assert_same_tree(tp, jp)
    # a torch state dict of tensors gives the same tree
    _assert_same_tree(timport.import_llama(hf.state_dict(), tcfg.llm), jp)
    ids = np.random.RandomState(0).randint(3, 32000, (2, 12))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = tllama.forward(tp, tcfg.llm,
                             input_ids=torch.from_numpy(ids)).numpy()
    jl, _ = jllama.forward(jp, jcfg.llm, input_ids=jnp.asarray(ids))
    assert _rel(got, ref) <= TOL
    assert _rel(got, jl) <= TOL
    assert _rel(jl, ref) <= TOL


def test_resize_and_pad_vocab_match_jax(cfgs):
    jcfg, tcfg = cfgs
    sd = _np_sd(_hf_llama(tcfg.llm, vocab=HF_VOCAB))
    jp = jimport.import_llama(sd, jcfg.llm)
    tp = timport.import_llama(sd, tcfg.llm)
    jr = jimport.resize_token_embeddings(jp, 32007)
    tr = timport.resize_token_embeddings(tp, 32007)
    assert tr["embed_tokens"].shape == (32007, tcfg.llm.hidden_size)
    assert tr["lm_head"].shape == (tcfg.llm.hidden_size, 32007)
    for key in ("embed_tokens", "lm_head"):
        np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]),
                                   rtol=0, atol=1e-7)
    # the new rows are each the mean of the old ones
    np.testing.assert_allclose(
        tr["embed_tokens"][HF_VOCAB:].numpy(),
        np.broadcast_to(sd["model.embed_tokens.weight"].mean(0),
                        (7, tcfg.llm.hidden_size)), atol=1e-7)
    assert timport.resize_token_embeddings(tr, 32007) is tr
    jpad = jimport.pad_vocab(jr, 32128)
    tpad = timport.pad_vocab(tr, 32128)
    for key in ("embed_tokens", "lm_head"):
        np.testing.assert_allclose(tpad[key].numpy(), np.asarray(jpad[key]),
                                   rtol=0, atol=1e-7)
    assert not tpad["embed_tokens"][32007:].any()
    assert not tpad["lm_head"][:, 32007:].any()
    with pytest.raises(ValueError):
        timport.pad_vocab(tpad, 32000)


def test_clip_import_matches_jax_and_transformers(cfgs):
    jcfg, tcfg = cfgs
    hf = _hf_clip(tcfg.vision)
    sd = _np_sd(hf)
    jp = jimport.import_clip_vision(sd, jcfg.vision)
    tp = timport.import_clip_vision(sd, tcfg.vision)
    _assert_same_tree(tp, jp)
    px = np.random.RandomState(1).randn(3, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        out = hf.vision_model(pixel_values=torch.from_numpy(px))
        ref = hf.visual_projection(out.last_hidden_state)[:, 1:].numpy()
        ref_pooled = hf.get_image_features(
            pixel_values=torch.from_numpy(px)).numpy()
        got = tclip.encode_patches(tp, tcfg.vision,
                                   torch.from_numpy(px)).numpy()
        got_pooled = tclip.encode_pooled(tp, tcfg.vision,
                                         torch.from_numpy(px)).numpy()
    jgot = jclip.encode_patches(jp, jcfg.vision, jnp.asarray(px))
    assert _rel(got, ref) <= TOL
    assert _rel(got, jgot) <= TOL
    assert _rel(got_pooled, ref_pooled) <= TOL


def test_whisper_import_matches_jax_and_transformers(cfgs):
    jcfg, tcfg = cfgs
    hf = _hf_whisper(tcfg.audio)
    sd = _np_sd(hf)
    jp = jimport.import_whisper_encoder(sd, jcfg.audio)
    tp = timport.import_whisper_encoder(sd, tcfg.audio)
    _assert_same_tree(tp, jp)
    assert not tp["layers"]["attn"]["k"]["b"].any()  # k_proj has no bias
    # the keys of WhisperForConditionalGeneration ("model." first)
    nested = timport.import_whisper_encoder(
        {"model." + k: v for k, v in sd.items()}, tcfg.audio)
    _assert_same_tree(nested, jp)
    mel = (np.random.RandomState(2).randn(2, 80, 3000) * 0.3).astype(
        np.float32)
    with torch.no_grad():
        ref = hf.encoder(torch.from_numpy(mel)).last_hidden_state.numpy()
        got = twhisper.encode(tp, tcfg.audio, torch.from_numpy(mel)).numpy()
    jgot = jwhisper.encode(jp, jcfg.audio, jnp.asarray(mel))
    assert _rel(got, ref) <= TOL
    assert _rel(got, jgot) <= TOL


def test_export_matches_jax_and_import_inverts_it(cfgs, tmp_path):
    jcfg, tcfg = cfgs
    tp = tfusion.init_params(3, tcfg, dtype=torch.float32, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    for port, ref in ((texport.export_llama(tp["llm"], tcfg.llm),
                       jexport.export_llama(jp["llm"], jcfg.llm)),
                      (texport.export_fusion_modules(tp, tcfg),
                       jexport.export_fusion_modules(jp, jcfg))):
        assert sorted(port) == sorted(ref)
        for k in port:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    sd = texport.export_llama(tp["llm"], tcfg.llm)
    _assert_same_tree(timport.import_llama(sd, tcfg.llm), tp["llm"])
    # pytorch_model.bin through save_torch and the loader's fallback
    texport.save_torch(sd, str(tmp_path / "pytorch_model.bin"))
    back = load_checkpoint_dir(str(tmp_path))
    _assert_same_tree(timport.import_llama(back, tcfg.llm), tp["llm"])
    # bf16 on another dtype: the same values rounded once
    half = timport.import_llama(sd, tcfg.llm, dtype=torch.bfloat16)
    assert half["lm_head"].dtype == torch.bfloat16
    assert torch.equal(half["lm_head"], tp["llm"]["lm_head"].bfloat16())


def test_import_mm_llms_matches_jax(cfgs):
    jcfg, tcfg = cfgs
    tp = tfusion.init_params(4, tcfg, dtype=torch.float32, device="cpu")
    sd = dict(texport.export_fusion_modules(tp, tcfg))
    sd.update(texport.export_llama(tp["llm"], tcfg.llm, prefix="llm."))
    clip_sd = _np_sd(_hf_clip(tcfg.vision))
    for tower in ("image_encoder.", "video_encoder."):
        sd.update({tower + k: v for k, v in clip_sd.items()})
    sd.update({"audio_encoder." + k: v for k, v in
               _np_sd(_hf_whisper(tcfg.audio)).items()})
    port = timport.import_mm_llms(sd, tcfg)
    _assert_same_tree(port, jimport.import_mm_llms(sd, jcfg))
    _assert_same_tree(port["llm"], tp["llm"])
    _assert_same_tree(port["fusion"], tp["fusion"])
    assert sorted(_leaves(port)) == sorted(_leaves(tp))


def _write_sharded(sd: dict, path) -> None:
    """``sd`` as a two-shard safetensors checkpoint with its index."""
    os.makedirs(path)
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[:len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for name, part in shards.items():
        save_safetensors({k: sd[k] for k in part}, os.path.join(path, name))
        weight_map.update({k: name for k in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def _first_loss(out_dir) -> float:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return next(json.loads(line)["loss"] for line in f
                    if "loss" in json.loads(line))


def test_run_train_llama_weights_matches_jax(tmp_path, monkeypatch):
    """``--llama-weights`` from a safetensors directory and from a sharded
    index: the step-1 loss of the port's run_train equals JAX's run_train
    on the same HF LLaMA (32000 rows, resized to 32007) and the same
    other weights (the port's init patched to JAX's, bridged)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 simulated JAX devices of tests/conftest.py")
    from tests.test_torch_cli import _train_cfgs

    def one_step(cfg):  # no accumulation, no checkpoint
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, grad_accum_steps=1, save_steps=0))

    jcfg, tcfg = map(one_step, _train_cfgs())
    sd = _np_sd(_hf_llama(tcfg.model.llm, vocab=HF_VOCAB, seed=5))
    single = tmp_path / "single"
    single.mkdir()
    save_safetensors(sd, str(single / "model.safetensors"))
    _write_sharded(sd, tmp_path / "sharded")
    args = ["--synthetic", "--no-media", "--steps", "1"]
    paths = {}
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(cfg.to_json())
    jrun_train.main(["--config", str(paths["jax"]), "--output-dir",
                     str(tmp_path / "jax_out"), "--llama-weights",
                     str(single)] + args)

    def bridged_init(seed, cfg, dtype=torch.float32, device="cpu"):
        p = jfusion.init_params(jax.random.PRNGKey(seed), jcfg.model)
        return params_from_numpy(jax.tree.map(np.asarray, p), device, dtype)

    monkeypatch.setattr(tfusion, "init_params", bridged_init)
    ref = _first_loss(tmp_path / "jax_out")
    for src in ("single", "sharded"):
        state = trun_train.main(
            ["--config", str(paths["torch"]), "--output-dir",
             str(tmp_path / f"torch_{src}"), "--llama-weights",
             str(tmp_path / src), "--device", "cpu"] + args)
        assert state.step == 1
        got = _first_loss(tmp_path / f"torch_{src}")
        assert abs(got - ref) <= TOL * abs(ref), (src, got, ref)


def test_load_pretrained_fills_the_towers_from_their_flags(tmp_path):
    """--clip-weights fills both CLIP towers and --whisper-weights the
    audio tower, in the run's param dtype; the rest stays the seeded
    init."""
    tcfg = tconfig.Config(model=dataclasses.replace(
        tconfig.tiny_model_config(), param_dtype="bfloat16"))
    clip_dir, whisper_dir = tmp_path / "clip", tmp_path / "whisper"
    clip_dir.mkdir()
    whisper_dir.mkdir()
    clip_sd = _np_sd(_hf_clip(tcfg.model.vision))
    whisper_sd = _np_sd(_hf_whisper(tcfg.model.audio))
    save_safetensors(clip_sd, str(clip_dir / "model.safetensors"))
    save_safetensors(whisper_sd, str(whisper_dir / "model.safetensors"))
    args = trun_train.parse_args(["--clip-weights", str(clip_dir),
                                  "--whisper-weights", str(whisper_dir),
                                  "--device", "cpu"])
    p = trun_train.load_pretrained(tcfg, args)
    want_clip = timport.import_clip_vision(clip_sd, tcfg.model.vision,
                                           dtype=torch.bfloat16)
    _assert_same_tree(p["image_encoder"], want_clip)
    _assert_same_tree(p["video_encoder"], want_clip)
    _assert_same_tree(p["audio_encoder"], timport.import_whisper_encoder(
        whisper_sd, tcfg.model.audio, dtype=torch.bfloat16))
    seeded = tfusion.init_params(tcfg.train.seed, tcfg.model,
                                 dtype=torch.bfloat16, device="cpu")
    _assert_same_tree(p["llm"], seeded["llm"])
    _assert_same_tree(p["fusion"], seeded["fusion"])
