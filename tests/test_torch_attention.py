"""Port parity of ``macaw_llm_tpu_torch.ops.attention`` against
``macaw_llm_tpu.ops.attention`` (fp32, CPU, max abs error <= 1e-5), and the
idempotent tower packing of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.ops import attention as ja
from macaw_llm_tpu_torch.ops import attention as ta
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy

TOL = 1e-5


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


def _rand(seed, *shape, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_dot_product_attention_masked_rows_uniform():
    """Additive mask clamped at float32 min: a fully masked row gets
    uniform probabilities, in both packages."""
    from macaw_llm_tpu.ops import combine_masks, causal_mask, padding_mask
    q, k, v = (_rand(i, 2, 9, 3, 8) for i in range(3))
    am = np.ones((2, 9), np.int32)
    am[1, :4] = 0
    jm = combine_masks(causal_mask(9, 9), padding_mask(jnp.asarray(am), 9))
    ref = ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jm)
    got = ta.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(np.array(jm)))
    _close(got, ref)
    np.testing.assert_allclose(got[1, 0].numpy(), v[1].mean(0), atol=TOL)


@pytest.mark.parametrize("seq,use_flash,packed", [
    (11, False, False), (11, True, True),      # CLIP-like: einsum path
    (1030, True, True), (1030, True, False),   # Whisper-like: flash path
])
def test_mha_apply(seq, use_flash, packed):
    jp = ja.mha_init(jax.random.PRNGKey(0), 32, 2)
    jp = jax.tree.map(lambda a: a + 0.01, jp)  # nonzero biases
    if packed:
        jp = ja.pack_mha(jp)
    x = _rand(4, 2, seq, 32)
    ref = ja.mha_apply(jp, 2, jnp.asarray(x), use_flash=use_flash)
    got = ta.mha_apply(params_from_numpy(_np(jp)), 2, torch.from_numpy(x),
                       use_flash=use_flash)
    _close(got, ref)


def test_pack_mha_and_pack_towers_idempotent():
    """Packing twice is packing once (the JAX pack_mha raises on a packed
    tree), and the packed stream equals JAX's."""
    from macaw_llm_tpu_torch.config import tiny_model_config
    from macaw_llm_tpu_torch.models import fusion as tfusion
    tp = tfusion.init_params(1, tiny_model_config(), dtype=torch.float32,
                             device="cpu")
    once = tfusion.pack_towers(tp)
    twice = tfusion.pack_towers(once)
    for tower in ("image_encoder", "video_encoder", "audio_encoder"):
        attn = twice[tower]["layers"]["attn"]
        assert set(attn) == {"qkv", "o"}
        assert attn is once[tower]["layers"]["attn"]
        unpacked = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                tp[tower]["layers"]["attn"])
        ref = ja.pack_mha(unpacked)
        _close(attn["qkv"]["w"], ref["qkv"]["w"], 0)
        _close(attn["qkv"]["b"], ref["qkv"]["b"], 0)


@pytest.mark.parametrize("use_flash", [False, True])
def test_torch_mha_apply(use_flash):
    jp = ja.torch_mha_init(jax.random.PRNGKey(2), 32, 2)
    x = _rand(5, 2, 13, 32)
    ref = ja.torch_mha_apply(jp, 2, *(jnp.asarray(x),) * 3,
                             use_flash=use_flash)
    got = ta.torch_mha_apply(params_from_numpy(_np(jp)), 2,
                             *(torch.from_numpy(x),) * 3,
                             use_flash=use_flash)
    _close(got, ref)


def _align_case():
    jp = ja.torch_mha_init(jax.random.PRNGKey(3), 64, 4)
    jp["in_proj_b"] = jp["in_proj_b"] + 0.02
    memory = _rand(6, 300, 64)
    feats = _rand(7, 3, 5, 64)
    return jp, params_from_numpy(_np(jp)), memory, feats


def test_shared_kv_project():
    jp, tp, memory, _ = _align_case()
    jk, jv = ja.shared_kv_project(jp, jnp.asarray(memory))
    tk, tv = ta.shared_kv_project(tp, torch.from_numpy(memory))
    assert tk.shape == (302, 64)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("int8", [False, True])
def test_shared_kv_einsum(int8):
    from macaw_llm_tpu.models.fusion import _quant_rows
    jp, tp, memory, feats = _align_case()
    jk, jv = ja.shared_kv_project(jp, jnp.asarray(memory))
    if int8:
        jcache = (_quant_rows(jk), _quant_rows(jv))
    else:
        jcache = ((jk, None), (jv, None))
    ref = ja.torch_mha_apply_shared_kv_einsum(jp, 4, jnp.asarray(feats),
                                              jcache)
    got = ta.torch_mha_apply_shared_kv_einsum(
        tp, 4, torch.from_numpy(feats), params_from_numpy(_np(jcache)))
    _close(got, ref)


@pytest.mark.parametrize("cached", [False, True])
def test_shared_kv_flash(cached):
    """The alignment fold (heads on the batch axis, batch x queries on the
    sequence axis) through the flash kernel's plain version."""
    jp, tp, memory, feats = _align_case()
    jkv = ja.shared_kv_project(jp, jnp.asarray(memory)) if cached else None
    ref = ja.torch_mha_apply_shared_kv_flash(
        jp, 4, jnp.asarray(feats), jnp.asarray(memory), kv_cache=jkv)
    got = ta.torch_mha_apply_shared_kv_flash(
        tp, 4, torch.from_numpy(feats), torch.from_numpy(memory),
        kv_cache=None if jkv is None else params_from_numpy(_np(jkv)))
    _close(got, ref)
