"""Port parity: the PyTorch ops (``macaw_llm_tpu_torch.ops``, ``audio.mel``,
``image.preprocess``, ``utils.quantize``) against their JAX counterparts on
the same numpy inputs, fp32 on the CPU, max abs error <= 1e-5 unless a
bound says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.audio import mel as jmel
from macaw_llm_tpu.image import preprocess as jprep
from macaw_llm_tpu import ops as jops
from macaw_llm_tpu.utils import quantize as jqz
from macaw_llm_tpu_torch.audio import mel as tmel
from macaw_llm_tpu_torch.image import preprocess as tprep
from macaw_llm_tpu_torch.ops import activations as tact
from macaw_llm_tpu_torch.ops import linear as tlin
from macaw_llm_tpu_torch.ops import masks as tmasks
from macaw_llm_tpu_torch.ops import norms as tnorms
from macaw_llm_tpu_torch.ops import rope as trope
from macaw_llm_tpu_torch.utils import quantize as tqz

TOL = 1e-5


def _close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, err


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def test_norms():
    x, w, b = _rand(0, 3, 5, 64), _rand(1, 64), _rand(2, 64)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jops.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b)),
           jops.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh",
                                  "quick_gelu", "relu"])
def test_activations(name):
    from macaw_llm_tpu.ops.activations import get_activation
    x = _rand(3, 4, 33, scale=3.0)
    _close(tact.get_activation(name)(torch.from_numpy(x)),
           get_activation(name)(jnp.asarray(x)))


def test_rope():
    pos = np.random.RandomState(4).randint(0, 400, (2, 7))
    q, k = _rand(5, 2, 7, 4, 16), _rand(6, 2, 7, 4, 16)
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), 16)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16)
    _close(tc, jc)
    _close(ts, js)
    jq, jk = jops.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              tc, ts)
    _close(tq, jq)
    _close(tk, jk)


def test_masks():
    am = np.ones((2, 6), np.int32)
    am[1, :2] = 0
    _close(tmasks.causal_mask(4, 6), jops.causal_mask(4, 6), 0.0)
    _close(tmasks.padding_mask(torch.from_numpy(am), 4),
           jops.padding_mask(jnp.asarray(am), 4), 0.0)
    _close(tmasks.combine_masks(tmasks.causal_mask(6, 6),
                                tmasks.padding_mask(torch.from_numpy(am), 6)),
           jops.combine_masks(jops.causal_mask(6, 6),
                              jops.padding_mask(jnp.asarray(am), 6)), 0.0)


def test_dense_plain_and_int8_record():
    x, w, b = _rand(7, 2, 3, 32), _rand(8, 32, 24, scale=0.1), _rand(9, 24)
    _close(tlin.dense(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b)),
           jops.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    jq, js = jqz.quantize_tensor(jnp.asarray(w))
    tq, ts = tqz.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js)
    _close(tlin.dense(torch.from_numpy(x), {"q": tq, "s": ts}),
           jops.dense(jnp.asarray(x), {"q": jq, "s": js}))


def test_quantize_stacked_and_pack():
    from macaw_llm_tpu.config import tiny_model_config
    from macaw_llm_tpu.models import llama as jllama
    from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy
    jp = jllama.init_params(jax.random.PRNGKey(3), tiny_model_config().llm)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jq = jqz.pack_llama_for_decode(jqz.quantize_llama(jp))
    tq = tqz.pack_llama_for_decode(tqz.quantize_llama(tp))
    for grp, name in (("attn", "qkv"), ("attn", "wo"), ("mlp", "gateup"),
                      ("mlp", "down")):
        np.testing.assert_array_equal(
            tq["layers"][grp][name]["q"].numpy(),
            np.asarray(jq["layers"][grp][name]["q"]))
        _close(tq["layers"][grp][name]["s"], jq["layers"][grp][name]["s"])
    _close(tqz.dequantize(tq["lm_head"]["q"], tq["lm_head"]["s"],
                          torch.float32),
           jqz.dequantize(jq["lm_head"]["q"], jq["lm_head"]["s"],
                          jnp.float32))


def test_w8a8_matmul_bounds():
    """The bounds of tests/test_quantize.py::test_w8a8_matmul_bounded_error,
    plus agreement with the JAX W8A8 path."""
    x, w = _rand(10, 512, 64), _rand(11, 64, 96, scale=0.05)
    q, s = tqz.quantize_tensor(torch.from_numpy(w))
    got = tqz.matmul(torch.from_numpy(x), {"q": q, "s": s}, torch.float32,
                     activation_quant=True)
    ref = x @ w
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    assert err < 0.05, err
    g = got.numpy().ravel()
    cos = float(g @ ref.ravel() / (np.linalg.norm(g) * np.linalg.norm(ref)))
    assert cos > 0.999, cos
    jqv, jsv = jqz.quantize_tensor(jnp.asarray(w))
    jqz.set_activation_quant(True)
    try:
        jgot = jqz.matmul(jnp.asarray(x), {"q": jqv, "s": jsv}, jnp.float32)
    finally:
        jqz.set_activation_quant(False)
    _close(got, jgot, 1e-4)
    # fewer than 256 rows: weight-only, as in the JAX package
    few = tqz.matmul(torch.from_numpy(x[:8]), {"q": q, "s": s},
                     torch.float32, activation_quant=True)
    _close(few, jqz.matmul(jnp.asarray(x[:8]), {"q": jqv, "s": jsv},
                           jnp.float32))


def test_log_mel_spectrogram():
    audio = _rand(12, 2, jmel.N_SAMPLES, scale=0.1)
    ref = jmel.log_mel_spectrogram(jnp.asarray(audio))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio))
    assert got.shape == (2, 80, 3000)
    _close(got, ref)


@pytest.mark.parametrize("h,w,size", [(224, 224, 224), (40, 48, 32),
                                      (64, 50, 32), (20, 28, 32)])
def test_preprocess_bicubic(h, w, size):
    """jax.image.resize bicubic+antialias: identity, downscale on both axes
    (non-square), and upscale."""
    img = np.random.RandomState(13).randint(0, 256, (2, h, w, 3)).astype(
        np.uint8)
    ref = jprep.preprocess(jnp.asarray(img), size=size)
    got = tprep.preprocess(torch.from_numpy(img), size=size)
    _close(got, ref)
