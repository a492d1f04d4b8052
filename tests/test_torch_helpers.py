"""Port parity of the public helpers (``audio.mel.pad_or_trim``,
``image.preprocess.preprocess_batch_numpy``, ``utils.quantize.
maybe_dequant``, ``ops.attention.mha_init`` / ``torch_mha_init``) against
their JAX counterparts on the same numpy inputs, fp32 on the CPU, max abs
error <= 1e-5 (the bar of ``test_torch_ops.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu.audio import mel as jmel
from macaw_llm_tpu.image import preprocess as jprep
from macaw_llm_tpu.ops import attention as jattn
from macaw_llm_tpu.utils import quantize as jqz
from macaw_llm_tpu_torch.audio import mel as tmel
from macaw_llm_tpu_torch.image import preprocess as tprep
from macaw_llm_tpu_torch.ops import attention as tattn
from macaw_llm_tpu_torch.utils import quantize as tqz
from macaw_llm_tpu_torch.utils.jax_bridge import params_from_numpy

TOL = 1e-5


def _close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert float(np.abs(port - ref).max()) <= tol


def test_pad_or_trim():
    """``tests/test_mel.py``'s cases, on the port."""
    short = torch.ones((1000,))
    assert tmel.pad_or_trim(short).shape == (tmel.N_SAMPLES,)
    assert float(tmel.pad_or_trim(short)[999]) == 1.0
    assert float(tmel.pad_or_trim(short)[1000]) == 0.0
    long = torch.ones((tmel.N_SAMPLES + 5,))
    assert tmel.pad_or_trim(long).shape == (tmel.N_SAMPLES,)


@pytest.mark.parametrize("shape,length", [((3, 1000), None),
                                          ((2, 700), 512), ((512,), 512)])
def test_pad_or_trim_matches_jax(shape, length):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    kw = {} if length is None else {"length": length}
    got = tmel.pad_or_trim(torch.from_numpy(x), **kw)
    ref = jmel.pad_or_trim(jnp.asarray(x), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_preprocess_batch_numpy_matches_jax():
    """Ragged sizes (each image resized and cropped on its own), stacked on
    the host."""
    rng = np.random.RandomState(13)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((40, 48), (64, 50), (20, 28))]
    got = tprep.preprocess_batch_numpy(images, size=32, device="cpu")
    ref = jprep.preprocess_batch_numpy(images, size=32)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maybe_dequant_matches_jax(dtype):
    """An int8 record dequantized, a plain weight cast: the same bits."""
    w = np.random.RandomState(1).randn(3, 16, 8).astype(np.float32)
    q, s = tqz.quantize_tensor(torch.from_numpy(w))
    jrec = {"q": jnp.asarray(q.numpy()), "s": jnp.asarray(s.numpy())}
    for port, ref in (({"q": q, "s": s}, jrec),
                      (torch.from_numpy(w), jnp.asarray(w))):
        got = tqz.maybe_dequant(port, getattr(torch, dtype))
        want = jqz.maybe_dequant(ref, getattr(jnp, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


@pytest.mark.parametrize("bias", [True, False])
def test_mha_init_shapes_and_forward_match_jax(bias):
    """The same leaves and shapes as the reference's init, drawn on the
    generator's device and placed on ``device``; the reference's weights
    through the port's ``mha_apply`` give its output."""
    e, n = 32, 4
    got = tattn.mha_init(torch.Generator().manual_seed(0), e, n, bias=bias,
                         device="cpu")
    ref = jattn.mha_init(jax.random.PRNGKey(0), e, n, bias=bias)
    assert _shapes({k: {kk: vv.numpy() for kk, vv in v.items()}
                    for k, v in got.items()}) == _shapes(ref)
    assert float(got["q"]["w"].std()) == pytest.approx(0.02, rel=0.2)
    x = np.random.RandomState(2).randn(2, 5, e).astype(np.float32)
    want = jattn.mha_apply(ref, n, jnp.asarray(x))
    out = tattn.mha_apply(params_from_numpy(jax.tree.map(np.asarray, ref)),
                          n, torch.from_numpy(x))
    _close(out, want)


@pytest.mark.parametrize("add_bias_kv", [True, False])
def test_torch_mha_init_shapes_and_forward_match_jax(add_bias_kv):
    """torch.nn.MultiheadAttention's leaves at the reference's shapes (the
    in-projection's xavier bound, the out-projection's sqrt(3 / E)); the
    reference's weights through the port's ``torch_mha_apply`` give its
    output."""
    e, n = 32, 4
    got = tattn.torch_mha_init(torch.Generator().manual_seed(0), e, n,
                               add_bias_kv=add_bias_kv)
    ref = jattn.torch_mha_init(jax.random.PRNGKey(0), e, n,
                               add_bias_kv=add_bias_kv)
    assert _shapes({k: v.numpy() for k, v in got.items()}) == _shapes(ref)
    assert float(got["in_proj_w"].abs().max()) <= (6.0 / (4 * e)) ** 0.5
    assert float(got["out_proj_w"].abs().max()) <= (3.0 / e) ** 0.5
    rng = np.random.RandomState(3)
    q, kv = (rng.randn(2, s, e).astype(np.float32) for s in (4, 6))
    want = jattn.torch_mha_apply(ref, n, jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv))
    t = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    out = tattn.torch_mha_apply(t, n, torch.from_numpy(q),
                                torch.from_numpy(kv), torch.from_numpy(kv))
    _close(out, want)



def test_preprocess_batch_numpy_defaults_to_the_card(monkeypatch):
    """Like the command lines, the helper runs on the card unless the CPU
    is asked for: with no GPU its default device refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    image = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.preprocess_batch_numpy([image], size=8)
