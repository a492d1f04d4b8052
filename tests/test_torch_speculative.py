"""Speculative decoding of the port (``generate_speculative``,
``_ngram_propose``) against the JAX package's and against the port's own
greedy ``generate``, on the tiny LLaMA in fp32 on the CPU, the same weights
on both sides (made by the port, handed to JAX).

Tokens must be identical: to JAX's speculative tokens, to the port's
greedy tokens, and the verify rounds (``num_steps``) to JAX's. Row 1 of
the prompt batch is right-padded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaw_llm_tpu import generate as jgen
from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import generate as tgen
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.utils import quantize as tqz

PAD = 32006


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def setup():
    cfg = tconfig.tiny_model_config().llm
    jcfg = jconfig.tiny_model_config().llm
    gen = torch.Generator().manual_seed(0)
    tp = tllama.init_params(gen, cfg, torch.float32)
    rng = np.random.RandomState(0)
    b, s = 3, 24
    ids = rng.randint(16, 200, (b, s)).astype(np.int64)
    ids[:, 0] = 1
    # a repeated span, so that the n-gram drafter finds matches
    ids[2, 12:20] = ids[2, 2:10]
    mask = np.ones((b, s), np.int64)
    mask[1, -5:] = 0
    ids[1, -5:] = PAD
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    emb = tllama.embed(tp, t_ids)
    jp = _to_jax(tp)
    return dict(cfg=cfg, jcfg=jcfg, tp=tp, jp=jp, ids=t_ids, mask=t_mask,
                emb=emb, jemb=jnp.asarray(emb.numpy()),
                jids=jnp.asarray(ids, jnp.int32),
                jmask=jnp.asarray(mask, jnp.int32))


def _greedy(st, n, eos=-1, **kw):
    return tgen.generate(st["tp"], st["cfg"], inputs_embeds=st["emb"],
                         attention_mask=st["mask"], max_new_tokens=n,
                         eos_id=eos, device="cpu", **kw)


def _spec(st, n, eos=-1, **kw):
    port = tgen.generate_speculative(
        st["tp"], st["cfg"], inputs_embeds=st["emb"], prompt_ids=st["ids"],
        attention_mask=st["mask"], max_new_tokens=n, eos_id=eos,
        device="cpu", **kw)
    if "oracle_tokens" in kw:
        kw = dict(kw, oracle_tokens=jnp.asarray(kw["oracle_tokens"].numpy()))
    ref = jgen.generate_speculative(
        st["jp"], st["jcfg"], inputs_embeds=st["jemb"],
        prompt_ids=st["jids"], attention_mask=st["jmask"],
        max_new_tokens=n, eos_id=eos, **kw)
    return port, ref


@pytest.mark.parametrize("hist,length,k,want", [
    # the suffix [5, 6] recurs at 0-1: propose what followed it
    ([5, 6, 7, 8, 9, 5, 6, PAD, PAD, PAD], 7, 3, [7, 8, 9]),
    # no earlier occurrence: PAD
    ([3, 4, 5, 6, PAD, PAD], 4, 2, [PAD, PAD]),
    # the continuation runs past the valid history: PAD there
    ([1, 2, 9, 1, 2, PAD, PAD, PAD], 5, 4, [9, 1, 2, PAD]),
])
def test_ngram_propose_cases(hist, length, k, want):
    out = tgen._ngram_propose(torch.tensor([hist]), torch.tensor([length]),
                              k, 2, PAD)
    assert out.tolist() == [want]
    ref = jgen._ngram_propose(jnp.asarray([hist], jnp.int32),
                              jnp.asarray([length]), draft_len=k, ngram=2,
                              pad_id=PAD)
    assert np.asarray(ref).tolist() == [want]


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_propose_matches_jax_on_random_histories(ngram):
    rng = np.random.RandomState(ngram)
    hist = rng.randint(0, 6, (16, 40))
    lengths = rng.randint(0, 41, 16)
    hist[np.arange(40)[None, :] >= lengths[:, None]] = PAD
    out = tgen._ngram_propose(torch.from_numpy(hist),
                              torch.from_numpy(lengths), 5, ngram, PAD)
    ref = jgen._ngram_propose(jnp.asarray(hist, jnp.int32),
                              jnp.asarray(lengths), draft_len=5,
                              ngram=ngram, pad_id=PAD)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_speculative_ngram_matches_jax_and_greedy(setup):
    n = 16
    greedy = _greedy(setup, n)
    port, ref = _spec(setup, n, draft_len=4, ngram=2)
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    assert torch.equal(port.tokens, greedy.tokens)
    assert port.num_steps == int(ref.num_steps) <= n - 1


def test_speculative_partly_wrong_drafts(setup):
    """Drafts right in some places and wrong in others (the greedy tokens
    with every third one replaced): some rounds accept a prefix of their
    drafts, and the tokens are still the greedy ones."""
    n = 16
    greedy = _greedy(setup, n)
    oracle = greedy.tokens.clone()
    oracle[:, ::3] = (oracle[:, ::3] + 1) % 32000
    port, ref = _spec(setup, n, draft_len=4, proposer="oracle",
                      oracle_tokens=oracle)
    assert torch.equal(port.tokens, greedy.tokens)
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    assert port.num_steps == int(ref.num_steps)
    assert -(-(n - 1) // 5) < port.num_steps < n - 1


def test_speculative_oracle_compresses_rounds(setup):
    n = 16
    greedy = _greedy(setup, n)
    port, ref = _spec(setup, n, draft_len=3, proposer="oracle",
                      oracle_tokens=greedy.tokens)
    assert torch.equal(port.tokens, greedy.tokens)
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    # acceptance 1: every round emits draft_len + 1 tokens
    assert port.num_steps == int(ref.num_steps) == -(-n // 4)


def test_speculative_int8_cache_matches(setup):
    n = 12
    greedy = _greedy(setup, n, cache_dtype="int8")
    port, ref = _spec(setup, n, draft_len=4, cache_dtype="int8")
    assert torch.equal(port.tokens, greedy.tokens)
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    assert port.num_steps == int(ref.num_steps)


def test_speculative_eos_stops_a_row(setup):
    n = 12
    free = _greedy(setup, n)
    eos = int(free.tokens[0, 4])  # row 0 emits it at step 5 at the latest
    greedy = _greedy(setup, n, eos=eos)
    port, ref = _spec(setup, n, eos=eos, draft_len=4)
    assert torch.equal(port.tokens, greedy.tokens)
    np.testing.assert_array_equal(port.tokens.numpy(), np.asarray(ref.tokens))
    assert port.num_steps == int(ref.num_steps)
    row = port.tokens[0]
    first = int((row == eos).nonzero()[0, 0])
    assert first <= 4 and (row[first + 1:] == PAD).all()


def test_verify_projections_take_the_matvec_kernels(setup, monkeypatch):
    """With int8 packed weights every verify round sends its 4 x 5 = 20
    flattened rows through ``matvec_int8_pipelined`` (4 projections a
    layer and the lm_head), and a 1-row batch's 5 rows through
    ``matvec_int8``; the tokens equal greedy decode on the same weights."""
    cfg = setup["cfg"]
    qp = tqz.pack_llama_for_decode(tqz.quantize_llama(setup["tp"]))
    calls = {"matvec_int8": 0, "matvec_int8_pipelined": 0}

    def spy(name, fn):
        def wrapped(x, *a, **k):
            calls[name] += 1
            calls[name + "_rows"] = x.shape[0]
            return fn(x, *a, **k)
        return wrapped

    for name in ("matvec_int8", "matvec_int8_pipelined"):
        monkeypatch.setattr(tqz, name, spy(name, getattr(tqz, name)))
    ids = torch.cat([setup["ids"], setup["ids"][:1]])
    mask = torch.cat([setup["mask"], setup["mask"][:1]])
    emb = tllama.embed(qp, ids)
    n = 10
    per_round = 4 * cfg.num_layers + 1
    for b, name in ((4, "matvec_int8_pipelined"), (1, "matvec_int8")):
        kw = dict(inputs_embeds=emb[:b], attention_mask=mask[:b],
                  max_new_tokens=n, eos_id=-1, device="cpu")
        greedy = tgen.generate(qp, cfg, **kw)
        for key in list(calls):
            calls[key] = 0
        out = tgen.generate_speculative(qp, cfg, prompt_ids=ids[:b],
                                        draft_len=4, **kw)
        # and the prefill's first-token logits: one single-row call of
        # matvec_int8 (b rows)
        first = {"matvec_int8": 1, "matvec_int8_pipelined": 0}
        assert calls[name] == per_round * out.num_steps + first[name], calls
        assert calls[name + "_rows"] == b * 5
        other = "matvec_int8" if b == 4 else "matvec_int8_pipelined"
        assert calls[other] == first[other], calls
        assert torch.equal(out.tokens, greedy.tokens)


def test_decode_rows_route_equals_the_flattened_call():
    """qz.matmul(decode_rows=True) on [B, k + 1, K] is the kernel's call on
    the [B * (k + 1), K] rows (the plain version here), within 1e-5 of the
    weight-only dequant path; above 32 rows it keeps the dequant route."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(64, 96).astype(np.float32) * 0.05)
    q, s = tqz.quantize_tensor(w)
    rec = {"q": q, "s": s}
    for b, k1 in ((1, 4), (1, 5), (2, 4), (4, 5), (8, 5)):
        x = torch.from_numpy(rng.randn(b, k1, 64).astype(np.float32))
        got = tqz.matmul(x, rec, torch.float32, decode_rows=True)
        flat = tqz.matvec_int8(x.reshape(-1, 64), q, s) if b * k1 <= 8 \
            else tqz.matvec_int8_pipelined(x.reshape(-1, 64), q, s)
        assert torch.equal(got, flat.reshape(b, k1, 96))
        dense = tqz.matmul(x, rec, torch.float32)
        assert (got - dense).abs().max() <= 1e-5 * dense.abs().max()
    x = torch.from_numpy(rng.randn(9, 4, 64).astype(np.float32))
    assert torch.equal(tqz.matmul(x, rec, torch.float32, decode_rows=True),
                       tqz.matmul(x, rec, torch.float32))


def test_batch_inference_speculative_equals_greedy():
    from macaw_llm_tpu_torch.eval import batch_inference_generation
    from tests.test_torch_cli import MiniTok
    m = tconfig.tiny_model_config()
    cfg = tconfig.Config(model=m, data=dataclasses.replace(
        tconfig.DataConfig(), max_text_len=24))
    params = tfusion.init_params(0, m, dtype=torch.float32, device="cpu")
    params["llm"]["lm_head"] = params["llm"]["lm_head"] * 10.0
    examples = [{"instruction": f"say what clip {i} shows " * (1 + i % 2),
                 "response": "", "image": "None", "video": "None",
                 "audio": "None"} for i in range(3)]
    out = {k: batch_inference_generation(params, cfg, MiniTok(), examples,
                                         batch_size=3, max_new_tokens=8,
                                         speculative=k, device="cpu")
           for k in (0, 3)}
    assert [r["generation"] for r in out[3]] == \
        [r["generation"] for r in out[0]]
