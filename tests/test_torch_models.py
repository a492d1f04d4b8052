"""Port parity of the models and the serving path against the JAX package
on the tiny config with ``use_flash=True, tower_flash=True`` (so the JAX
side runs the Pallas kernels in interpret mode), fp32 on the CPU.

Bounds: towers and LLaMA prefill max abs <= 1e-4; fused prefill logits
<= 1e-3 of max|logit| (the BASELINE.md bar); W8A8 the bounds of
tests/test_quantize.py (relative error < 0.05, argmax agreement > 0.9);
greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu.models import clip as jclip
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.models import llama as jllama
from macaw_llm_tpu.models import whisper as jwhisper
from macaw_llm_tpu.utils import quantize as jqz
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch.models import clip as tclip
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.models import whisper as twhisper
from macaw_llm_tpu_torch.utils import quantize as tqz
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy


def _cfgs():
    jcfg = dataclasses.replace(jconfig.tiny_model_config(), use_flash=True,
                               tower_flash=True)
    tcfg = dataclasses.replace(tconfig.tiny_model_config(), use_flash=True,
                               tower_flash=True)
    return jcfg, tcfg


def _to_jax(tree):
    """The port's tensor tree as the JAX package's tree (same layout)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def model():
    """Weights made by the port (fast on one core) and handed to JAX;
    the other direction, params_from_numpy, is exercised below and in
    test_torch_ops / test_torch_attention."""
    jcfg, tcfg = _cfgs()
    tp = tfusion.init_params(0, tcfg, dtype=torch.float32, device="cpu")
    # a sharper LM head than the 0.02 init: greedy ties cannot flip
    tp["llm"]["lm_head"] = tp["llm"]["lm_head"] * 10.0
    jp = _to_jax(tp)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _max_err(port, ref):
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(16, 32000, (b, s)).astype(np.int64)
    ids[:, 0] = 1
    mask = np.ones((b, s), np.int64)
    mask[-1, -3:] = 0  # right padding on the last row
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


def test_clip_encode_patches(model):
    jcfg, tcfg, jp, tp = model
    px = (np.random.RandomState(1).randn(3, 3, 32, 32)).astype(np.float32)
    ref = jclip.encode_patches(jp["image_encoder"], jcfg.vision,
                               jnp.asarray(px), use_flash=True)
    got = tclip.encode_patches(tp["image_encoder"], tcfg.vision,
                               torch.from_numpy(px), use_flash=True)
    assert got.shape == (3, 4, 16)
    assert _max_err(got, ref) <= 1e-4


def test_whisper_encode_flash(model):
    jcfg, tcfg, jp, tp = model
    mel = (np.random.RandomState(2).randn(2, 80, 3000) * 0.5).astype(
        np.float32)
    ref = jwhisper.encode(jp["audio_encoder"], jcfg.audio, jnp.asarray(mel),
                          use_flash=True)
    got = twhisper.encode(tp["audio_encoder"], tcfg.audio,
                          torch.from_numpy(mel), use_flash=True)
    assert got.shape == (2, 1500, 32)
    assert _max_err(got, ref) <= 1e-4


@pytest.mark.parametrize("use_flash", [True, False])
def test_llama_prefill(model, use_flash):
    """No-cache forward_hidden: the mh_attention dispatch (use_flash) and
    the einsum-mask path, with a padded row."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(3)
    emb = (rng.randn(2, 21, 64) * 0.5).astype(np.float32)
    mask = np.ones((2, 21), np.int64)
    mask[1, -5:] = 0
    ref, _ = jllama.forward_hidden(jp["llm"], jcfg.llm, jnp.asarray(emb),
                                   jnp.asarray(mask), use_flash=use_flash)
    got = tllama.forward_hidden(tp["llm"], tcfg.llm, torch.from_numpy(emb),
                                torch.from_numpy(mask), use_flash=use_flash)
    assert _max_err(got, ref) <= 1e-4


def _jax_prefill(jp, jcfg, batch, align_cache):
    @jax.jit
    def run(params, batch, cache):
        fused = jfusion.prepare_inputs(
            params, jcfg, input_ids=batch["input_ids"],
            images=batch["images"], audios=batch["audios"],
            videos=batch["videos"], attention_mask=batch["attention_mask"],
            align_cache=cache)
        h, _ = jllama.forward_hidden(params["llm"], jcfg.llm,
                                     fused.inputs_embeds,
                                     fused.attention_mask, use_flash=True)
        return (jllama.logits_from_hidden(params["llm"], h[:, -1:])[:, 0],
                fused.inputs_embeds)
    return run(jp, {k: jnp.asarray(v) for k, v in batch.items()},
               align_cache)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_prefill(model, int8):
    """prepare_inputs + prefill logits. float weights without an align
    cache (every alignment on the flash kernel's plain version); int8
    LLaMA weights with the int8 align cache (the einsum alignment), in the
    serving order: cache first, then quantize, strip, pack."""
    from macaw_llm_tpu_torch.prefill import prefill
    jcfg, tcfg, jp, tp = model
    batch = _batch(jcfg)
    jcache = tcache = None
    if int8:
        jcache = jfusion.precompute_align_cache(jp, jcfg, quantize=True)
        tcache = tfusion.precompute_align_cache(tp, tcfg, quantize=True)
        for mod in ("image", "audio", "video"):
            for kv in ("k", "v"):
                np.testing.assert_array_equal(
                    tcache[mod][kv][0].numpy(),
                    np.asarray(jcache[mod][kv][0]))
        jp = dict(jp, llm=jqz.quantize_llama(jp["llm"]))
        jp = jfusion.pack_towers(jfusion.strip_align_kv(jp))
        tp = dict(tp, llm=tqz.quantize_llama(tp["llm"]))
        tp = tfusion.pack_towers(tfusion.strip_align_kv(tp))
    ref_logits, ref_emb = _jax_prefill(jp, jcfg, batch, jcache)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fused = tfusion.prepare_inputs(
        tp, tcfg, input_ids=tbatch["input_ids"], images=tbatch["images"],
        audios=tbatch["audios"], videos=tbatch["videos"],
        attention_mask=tbatch["attention_mask"], align_cache=tcache)
    assert fused.inputs_embeds.shape == (2, 16 + tcfg.total_prefix_len, 64)
    assert _max_err(fused.inputs_embeds, ref_emb) <= 1e-4
    logits = prefill(tp, tcfg, tbatch, tcache, device="cpu")
    ref_logits = np.asarray(ref_logits)
    rel = float(np.abs(logits.numpy() - ref_logits).max()
                / np.abs(ref_logits).max())
    assert rel <= 1e-3, rel


def test_w8a8_prefill_bounds(model):
    """W8A8 LLaMA prefill (>= 256 rows) against the JAX W8A8 path and
    against weight-only int8, with the tests/test_quantize.py bounds."""
    jcfg, tcfg, jp, tp = model
    ids = np.random.RandomState(4).randint(5, 32000, (8, 40))
    jq = jqz.quantize_llama(jp["llm"])
    tq = tqz.quantize_llama(tp["llm"])
    emb = np.array(jllama.embed(jq, jnp.asarray(ids)))
    jqz.set_activation_quant(True)
    try:
        ref, _ = jllama.forward_hidden(jq, jcfg.llm, jnp.asarray(emb))
        ref = jllama.logits_from_hidden(jq, ref)
    finally:
        jqz.set_activation_quant(False)
    got = tllama.logits_from_hidden(tq, tllama.forward_hidden(
        tq, tcfg.llm, torch.from_numpy(emb), activation_quant=True))
    weight_only = tllama.forward(tq, tcfg.llm,
                                 inputs_embeds=torch.from_numpy(emb))
    ref = np.asarray(ref)
    for other in (ref, weight_only.numpy()):
        rel = float(np.abs(got.numpy() - other).max() / np.abs(other).max())
        assert rel < 0.05, rel
        agree = float((got.numpy().argmax(-1) == other.argmax(-1)).mean())
        assert agree > 0.9, agree


def test_greedy_generate_tokens_equal():
    """Greedy decode over int8 packed weights: the port's matvec plain
    version against the JAX Pallas matvec (interpret mode), with a
    right-padded prompt row, a per-row budget and EOS stopping. Widths are
    128-multiples and the vocab is padded to 32128 here: the JAX Pallas
    matvec needs N divisible by its 128-wide column tiles (it takes no
    32007-wide lm_head); the padded columns are masked in both packages."""
    from macaw_llm_tpu.generate import generate as jgenerate
    from macaw_llm_tpu_torch.generate import generate as tgenerate
    widths = dict(hidden_size=128, intermediate_size=256, num_heads=4,
                  num_layers=2, vocab_pad_to=32128)
    jllm = jconfig.LlamaConfig(**widths)
    tllm = tconfig.LlamaConfig(**widths)
    tp = tllama.init_params(torch.Generator().manual_seed(6), tllm)
    tp["lm_head"] = tp["lm_head"] * 10.0
    jp = _to_jax(tp)
    jq = jqz.pack_llama_for_decode(jqz.quantize_llama(jp))
    tq = tqz.pack_llama_for_decode(tqz.quantize_llama(tp))
    rng = np.random.RandomState(5)
    emb = (rng.randn(3, 12, 128) * 0.5).astype(np.float32)
    mask = np.ones((3, 12), np.int32)
    mask[1, -4:] = 0
    budgets = np.array([8, 5, 8], np.int32)
    args = dict(max_new_tokens=8, pad_id=0)
    free = tgenerate(tq, tllm, inputs_embeds=torch.from_numpy(emb),
                     attention_mask=torch.from_numpy(mask), device="cpu",
                     **args)
    # EOS: row 0's third token; it stops row 0 there (and any other row
    # that emits it), with PAD after
    args["eos_id"] = eos = int(free.tokens[0, 2])
    jqz.set_decode_kernel("pallas")
    try:
        ref = jgenerate(jq, jllm, inputs_embeds=jnp.asarray(emb),
                        attention_mask=jnp.asarray(mask),
                        budgets=jnp.asarray(budgets), **args)
    finally:
        jqz.set_decode_kernel("xla")
    got = tgenerate(tq, tllm, inputs_embeds=torch.from_numpy(emb),
                    attention_mask=torch.from_numpy(mask),
                    budgets=torch.from_numpy(budgets), device="cpu", **args)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert got.num_steps == int(ref.num_steps)
    tokens = got.tokens.numpy()
    assert tokens[0, 2] == eos and not tokens[0, 3:].any()
    assert not tokens[1, 5:].any()  # budget 5


def test_entry_points_refuse_cpu_by_default(model):
    """Without a GPU the entry points raise unless device='cpu' is asked
    for (this test's CPU-only host has none)."""
    from macaw_llm_tpu_torch.generate import generate as tgenerate
    from macaw_llm_tpu_torch.prefill import prefill
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tcfg, _, tp = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfusion.init_params(0, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgenerate(tp["llm"], tcfg.llm, inputs_embeds=torch.zeros(1, 3, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill(tp, tcfg, {"input_ids": torch.zeros(1, 3)})
    small = tfusion.init_params(0, tcfg, dtype=torch.float32, device="cpu")
    assert small["llm"]["embed_tokens"].shape == (32007, 64)
