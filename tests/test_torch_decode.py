"""Port parity of the rest of decode against the JAX package on the CPU in
fp32: the pipelined matvec's plain version and the row-count route, the
int8 KV cache (``_quant_kv``, ``dot_product_attention_quant``), per-row
cache lengths, sampling, ``generate`` with an int8 cache,
``generate_from_ids`` and ``beam_search``.

Inputs come from a numpy seed and go through the JAX function and its
counterpart. Bounds: 1e-3 unless stated (most are far below); int8 rows
exact, their scales 1e-6; tokens equal. Sampling is held to the
distribution, not to ``jax.random.categorical``'s bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu import generate as jgen
from macaw_llm_tpu.models import llama as jllama
from macaw_llm_tpu.ops import attention as jattn
from macaw_llm_tpu.ops.pallas import matvec as jmv
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import generate as tgen
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.ops import attention as tattn
from macaw_llm_tpu_torch.ops.kernels import matvec as tmv
from macaw_llm_tpu_torch.utils import quantize as tqz
from macaw_llm_tpu_torch.utils.jax_bridge import (kv_cache_from_numpy,
                                                  params_from_numpy)

TOL = 1e-3


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _llm(num_kv_heads=None):
    widths = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=num_kv_heads)
    jcfg = jconfig.LlamaConfig(**widths)
    tcfg = tconfig.LlamaConfig(**widths)
    tp = tllama.init_params(torch.Generator().manual_seed(3), tcfg)
    # a sharper LM head than the 0.02 init: greedy ties cannot flip
    tp["lm_head"] = tp["lm_head"] * 10.0
    return jcfg, tcfg, _to_jax(tp), tp


@pytest.fixture(scope="module")
def llm():
    return _llm()


# ---------------------------------------------------------------------------
# B6's plain version and the row-count route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_matvec_pipelined_plain_matches_pallas(depth):
    """bf16 activations; the Pallas kernel (interpret mode) scales the fp32
    sum, the plain version rounds the bf16 product first: the bf16 bar of
    tests/test_matvec_kernel.py."""
    rng = np.random.RandomState(depth)
    k, n, b = 256, 1024, 16
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = (rng.randn(b, k) * 0.1).astype(np.float32)
    scale = np.abs(w).max(0, keepdims=True) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    ref = jmv.matvec_int8_pipelined(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
        block_n=128, depth=depth)
    before = tmv.matvec_int8_pipelined.launches
    got = tmv.matvec_int8_pipelined(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
        torch.from_numpy(scale), depth=depth)
    assert got.dtype == torch.bfloat16
    assert tmv.matvec_int8_pipelined.launches == before  # no kernel ran
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1.6e-2,
                               atol=1e-5)


def test_matvec_pipelined_rejects_bad_arguments():
    x, q, s = torch.ones(9, 16), torch.ones(16, 8, dtype=torch.int8), \
        torch.ones(8)
    with pytest.raises(ValueError):
        tmv.matvec_int8_pipelined(x, q, s, depth=0)
    with pytest.raises(ValueError):
        tmv.matvec_int8_pipelined(x, q[:8], s)


def test_pipelined_grid_covers_k():
    """Every K range is a whole number of 32-row chunks, the ranges cover
    K, and the grid stays within one resident wave at the 7b shapes, for
    the 16-byte and the byte copy path and 2 or 3 resident blocks."""
    for k, n in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                 (4096, 32007), (352, 250), (64, 64), (1000, 520),
                 (4096, 200000)):
        for vec in (True, False):
            for resident in (2, 3):
                splits, rps = tmv.pipelined_splits(k, n, vec, resident)
                assert rps % 32 == 0 and splits >= 1
                assert splits * rps >= k > (splits - 1) * rps
                if n <= 32007:
                    assert -(-n // 256) * splits <= resident * 132
    # the grids measured best on the H100 (3 resident blocks, 132 SMs)
    assert tmv.pipelined_splits(4096, 12288) == (8, 512)
    assert tmv.pipelined_splits(4096, 4096) == (16, 256)
    assert tmv.pipelined_splits(4096, 22016) == (3, 1376)
    assert tmv.pipelined_splits(11008, 4096) == (16, 704)
    assert tmv.pipelined_splits(4096, 32007, vec=False) == (3, 1376)


@pytest.mark.parametrize("rows,expect", [(1, "matvec_int8"),
                                         (8, "matvec_int8"),
                                         (9, "matvec_int8_pipelined"),
                                         (32, "matvec_int8_pipelined")])
def test_matmul_routes_by_row_count(rows, expect, monkeypatch):
    """Single-row int8 matmuls: up to 8 rows to B5's wrapper, 9 to 32 to
    B6's; the result is the JAX weight-only matmul either way."""
    from macaw_llm_tpu.utils import quantize as jqz
    calls = []
    for name in ("matvec_int8", "matvec_int8_pipelined"):
        real = getattr(tmv, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(tqz, name, spy)
    rng = np.random.RandomState(rows)
    w = (rng.randn(64, 48) * 0.05).astype(np.float32)
    x = rng.randn(rows, 1, 64).astype(np.float32)
    jq, js = jqz.quantize_tensor(jnp.asarray(w))
    ref = jqz.matmul(jnp.asarray(x), {"q": jq, "s": js}, jnp.float32)
    q, s = tqz.quantize_tensor(torch.from_numpy(w))
    got = tqz.matmul(torch.from_numpy(x), {"q": q, "s": s}, torch.float32)
    assert calls == [expect]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def test_quant_kv_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector: scale 0, rows 0
    jq, js = jllama._quant_kv(jnp.asarray(x))
    tq, ts = tllama._quant_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_quant(masked):
    rng = np.random.RandomState(1)
    b, sq, sk, n, d = 2, 3, 9, 4, 16
    q = rng.randn(b, sq, n, d).astype(np.float32)
    kq = rng.randint(-127, 128, (b, sk, n, d)).astype(np.int8)
    vq = rng.randint(-127, 128, (b, sk, n, d)).astype(np.int8)
    ks = (rng.rand(b, sk, n) * 0.02).astype(np.float32)
    vs = (rng.rand(b, sk, n) * 0.02).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.rand(b, 1, sq, sk) < 0.4,
                        np.finfo(np.float32).min, 0.0).astype(np.float32)
        mask[0, 0, 1] = np.finfo(np.float32).min  # a fully masked query
    ref = jattn.dot_product_attention_quant(
        jnp.asarray(q), jnp.asarray(kq, jnp.float32),
        jnp.asarray(vq, jnp.float32), jnp.asarray(ks), jnp.asarray(vs),
        None if mask is None else jnp.asarray(mask))
    got = tattn.dot_product_attention_quant(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(ks), torch.from_numpy(vs),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def _jax_prefilled_cache(jcfg, jp, emb, cache_dtype, total):
    cache = jllama.KVCache.create(jcfg, emb.shape[0], total, cache_dtype)
    _, cache = jllama.forward_hidden(jp, jcfg, jnp.asarray(emb),
                                     kv_cache=cache)
    return cache


def _port_cache(jcache, length):
    np_ = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return kv_cache_from_numpy(np_(jcache.k), np_(jcache.v), length,
                               np_(jcache.k_scale), np_(jcache.v_scale))


@pytest.mark.parametrize("cache_dtype,kv_heads,s", [
    ("int8", None, 1), ("int8", 2, 1), ("int8", None, 3),
    (jnp.float32, None, 1), (jnp.float32, 2, 3)])
def test_decode_step_with_per_row_lengths(cache_dtype, kv_heads, s):
    """A JAX cache (prefilled over 6 positions) handed over by the bridge,
    then one forward of ``s`` tokens per row with the per-row lengths [6,
    4, 5]: logits, the updated cache (int8 rows exact) and the returned
    lengths. Rows 1 and 2 overwrite positions the prefill had filled, as a
    slot of the engine does with its prompt padding."""
    jcfg, tcfg, jp, tp = _llm(kv_heads)
    rng = np.random.RandomState(4)
    b, total = 3, 12
    emb = (rng.randn(b, 6, 64) * 0.5).astype(np.float32)
    step = (rng.randn(b, s, 64) * 0.5).astype(np.float32)
    lengths = np.array([6, 4, 5], np.int32)
    jcache = _jax_prefilled_cache(jcfg, jp, emb, cache_dtype, total)
    tcache = _port_cache(jcache, lengths)
    if cache_dtype == "int8":
        assert tcache.k.dtype == torch.int8 and tcache.k_scale is not None
    ref, jnew = jllama.forward(
        jp, jcfg, inputs_embeds=jnp.asarray(step),
        kv_cache=jcache._replace(length=jnp.asarray(lengths)))
    got = tllama.forward(tp, tcfg, inputs_embeds=torch.from_numpy(step),
                         kv_cache=tcache)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jnew.length))
    if cache_dtype == "int8":
        np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jnew.k))
        np.testing.assert_array_equal(tcache.v.numpy(), np.asarray(jnew.v))
        np.testing.assert_allclose(tcache.k_scale.numpy(),
                                   np.asarray(jnew.k_scale), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tcache.v_scale.numpy(),
                                   np.asarray(jnew.v_scale), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jnew.k),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jnew.v),
                                   rtol=0, atol=1e-5)


def test_per_row_write_past_the_buffer_is_clamped():
    """A slot that has finished may still be stepped with a length at or
    past the buffer: the write goes to the last position and every other
    row's logits are what they are without that row."""
    _, tcfg, _, tp = _llm()
    rng = np.random.RandomState(5)
    total = 8
    cache = tllama.KVCache.create(tcfg, 2, total, "int8")
    emb = torch.from_numpy((rng.randn(2, 4, 64) * 0.5).astype(np.float32))
    tllama.forward_hidden(tp, tcfg, emb, kv_cache=cache)
    step = torch.from_numpy((rng.randn(2, 1, 64) * 0.5).astype(np.float32))
    alone = tllama.KVCache(k=cache.k[:, :1].clone(), v=cache.v[:, :1].clone(),
                           length=torch.tensor([4]),
                           k_scale=cache.k_scale[:, :1].clone(),
                           v_scale=cache.v_scale[:, :1].clone())
    ref = tllama.forward(tp, tcfg, inputs_embeds=step[:1], kv_cache=alone)
    cache.length = torch.tensor([4, total + 1])
    got = tllama.forward(tp, tcfg, inputs_embeds=step, kv_cache=cache)
    assert torch.equal(cache.length, torch.tensor([5, total + 2]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# generate, sampling, beam search
# ---------------------------------------------------------------------------

def _prompt(seed=6, b=3, s=10):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(b, s, 64) * 0.5).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, -3:] = 0  # right padding
    return emb, mask


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_generate_tokens_equal(llm, cache_dtype):
    jcfg, tcfg, jp, tp = llm
    emb, mask = _prompt()
    budgets = np.array([7, 7, 4], np.int32)
    free = tgen.generate(tp, tcfg, inputs_embeds=torch.from_numpy(emb),
                         attention_mask=torch.from_numpy(mask),
                         max_new_tokens=7, pad_id=0, eos_id=-1,
                         cache_dtype=cache_dtype, device="cpu")
    args = dict(max_new_tokens=7, pad_id=0, eos_id=int(free.tokens[0, 3]),
                cache_dtype=cache_dtype)
    ref = jgen.generate(jp, jcfg, inputs_embeds=jnp.asarray(emb),
                        attention_mask=jnp.asarray(mask),
                        budgets=jnp.asarray(budgets), **args)
    got = tgen.generate(tp, tcfg, inputs_embeds=torch.from_numpy(emb),
                        attention_mask=torch.from_numpy(mask),
                        budgets=torch.from_numpy(budgets), device="cpu",
                        **args)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert got.num_steps == int(ref.num_steps)
    assert not got.tokens[0, 4:].any() and not got.tokens[2, 4:].any()


def test_generate_from_ids_tokens_equal(llm):
    jcfg, tcfg, jp, tp = llm
    ids = np.random.RandomState(7).randint(5, 32000, (2, 9))
    ref = jgen.generate_from_ids(jp, jcfg, input_ids=jnp.asarray(ids),
                                 max_new_tokens=5)
    got = tgen.generate_from_ids(tp, tcfg, input_ids=torch.from_numpy(ids),
                                 max_new_tokens=5, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_sample_greedy_rows_and_top_k():
    """Rows at temperature 0 equal greedy when batched with sampling rows;
    top_k = 1 at temperature 1 equals greedy, in both packages; no
    generator means greedy everywhere."""
    rng = np.random.RandomState(8)
    logits = rng.randn(6, 50).astype(np.float32) * 3.0
    greedy = logits.argmax(-1)
    temps = np.array([0.0, 1.0, 0.0, 2.0, 0.0, 0.7], np.float32)
    gen = torch.Generator().manual_seed(0)
    got = tgen._sample(torch.from_numpy(logits), gen,
                       torch.from_numpy(temps)).numpy()
    ref = np.asarray(jgen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                  jnp.asarray(temps), 0))
    for out in (got, ref):
        np.testing.assert_array_equal(out[temps == 0], greedy[temps == 0])
    got1 = tgen._sample(torch.from_numpy(logits), gen, 1.0, top_k=1).numpy()
    ref1 = np.asarray(jgen._sample(jnp.asarray(logits),
                                   jax.random.PRNGKey(1), 1.0, 1))
    np.testing.assert_array_equal(got1, greedy)
    np.testing.assert_array_equal(ref1, greedy)
    none = tgen._sample(torch.from_numpy(logits), None, 5.0).numpy()
    np.testing.assert_array_equal(none, greedy)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.5, 0), (1.5, 3)])
def test_sample_frequencies(temperature, top_k):
    """4000 draws from one row of logits: each token's count within 4
    sigma of its softmax probability (after temperature and top_k); both
    packages are held to the same distribution."""
    n = 4000
    logits = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0, 1.5],
                      np.float32)
    scaled = logits / temperature
    if top_k:
        scaled = np.where(scaled < np.sort(scaled)[-top_k], -np.inf, scaled)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    rows = np.tile(logits, (n, 1))
    got = tgen._sample(torch.from_numpy(rows),
                       torch.Generator().manual_seed(11), temperature,
                       top_k).numpy()
    ref = np.asarray(jgen._sample(jnp.asarray(rows), jax.random.PRNGKey(11),
                                  temperature, top_k))
    for draws in (got, ref):
        counts = np.bincount(draws, minlength=len(logits))
        sigma = np.sqrt(n * p * (1 - p))
        assert (np.abs(counts - n * p) <= 4 * sigma + 1e-9).all(), counts
        assert not counts[p == 0].any()


def test_sampled_generate(llm):
    """Sampled decode: rows at temperature 0 give the greedy tokens, the
    same generator seed gives the same tokens, another seed other ones,
    and every token is a real vocab entry."""
    _, tcfg, _, tp = llm
    emb, mask = _prompt(seed=9, b=4)
    kw = dict(inputs_embeds=torch.from_numpy(emb),
              attention_mask=torch.from_numpy(mask), max_new_tokens=6,
              eos_id=-1, device="cpu")
    greedy = tgen.generate(tp, tcfg, **kw).tokens
    temps = torch.tensor([0.0, 1.0, 0.0, 1.0])

    def run(seed):
        return tgen.generate(tp, tcfg, temperature=temps, top_k=20,
                             generator=torch.Generator().manual_seed(seed),
                             cache_dtype="int8", **kw).tokens

    a, b, c = run(0), run(0), run(1)
    greedy8 = tgen.generate(tp, tcfg, cache_dtype="int8", **kw).tokens
    assert torch.equal(a, b)
    assert torch.equal(a[[0, 2]], greedy8[[0, 2]])
    assert not torch.equal(a[[1, 3]], c[[1, 3]])
    assert not torch.equal(a[[1, 3]], greedy8[[1, 3]])
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    assert greedy.shape == a.shape


@pytest.mark.parametrize("length_penalty", [1.0, 0.0])
def test_beam_search_tokens_equal(llm, length_penalty):
    jcfg, tcfg, jp, tp = llm
    emb, mask = _prompt(seed=10, b=2, s=8)
    free = tgen.beam_search(tp, tcfg, inputs_embeds=torch.from_numpy(emb),
                            attention_mask=torch.from_numpy(mask),
                            num_beams=4, max_new_tokens=6, eos_id=-1,
                            pad_id=0, device="cpu")
    # EOS: the best beam's third token of row 0, so beams finish early
    args = dict(num_beams=4, max_new_tokens=6, pad_id=0,
                eos_id=int(free.tokens[0, 2]), length_penalty=length_penalty)
    ref = jgen.beam_search(jp, jcfg, inputs_embeds=jnp.asarray(emb),
                           attention_mask=jnp.asarray(mask), **args)
    got = tgen.beam_search(tp, tcfg, inputs_embeds=torch.from_numpy(emb),
                           attention_mask=torch.from_numpy(mask),
                           device="cpu", **args)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert got.num_steps == int(ref.num_steps)


def test_bridge_carries_packed_int8_records(llm):
    """int8 records packed for decode (qkv, gateup) cross the bridge as
    they are: quantize + pack in JAX, hand over, and the port's own
    quantize + pack gives the same rows and scales."""
    from macaw_llm_tpu.utils import quantize as jqz
    _, _, jp, tp = llm
    jq = jqz.pack_llama_for_decode(jqz.quantize_llama(jp))
    over = params_from_numpy(jax.tree.map(np.asarray, jq))
    own = tqz.pack_llama_for_decode(tqz.quantize_llama(tp))
    for group, name in (("attn", "qkv"), ("mlp", "gateup"), ("mlp", "down")):
        a, b = over["layers"][group][name], own["layers"][group][name]
        assert a["q"].dtype == torch.int8 and a["s"].dtype == torch.float32
        assert torch.equal(a["q"], b["q"])
        np.testing.assert_allclose(a["s"].numpy(), b["s"].numpy(), rtol=1e-6)
