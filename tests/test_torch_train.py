"""Port parity of the training path against the JAX package, fp32 on the
CPU, tiny config (use_flash and tower_flash on, so JAX runs its Pallas
kernels in interpret mode), the same numpy-made weights and batches.

Bounds: losses, gradients and per-step updates within 1e-3 of the
reference's max |value| (the ROADMAP bar) unless a case says otherwise;
schedules within 1e-6 of the peak rate (optax computes them in fp32). Dropout
cannot match jax.random bit for bit: the parity cases run with dropout off
(``align_dropout=0``) and dropout has cases of its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.models import llama as jllama
from macaw_llm_tpu.train import lora as jlora
from macaw_llm_tpu.train import state as jstate
from macaw_llm_tpu.train import trainer as jtrainer
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.ops import attention as tattn
from macaw_llm_tpu_torch.train import lora as tlora
from macaw_llm_tpu_torch.train import state as tstate
from macaw_llm_tpu_torch.train import trainer as ttrainer

REL = 1e-3


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, ref, rel=REL, what="", atol=1e-12):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + atol, (what, err,
                                                   np.abs(ref).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfgs(**fusion_kw):
    fk = dict(align_dropout=0.0, **fusion_kw)
    jcfg = jconfig.tiny_model_config()
    tcfg = tconfig.tiny_model_config()
    jcfg = dataclasses.replace(jcfg, use_flash=True, tower_flash=True,
                               fusion=dataclasses.replace(jcfg.fusion, **fk))
    tcfg = dataclasses.replace(tcfg, use_flash=True, tower_flash=True,
                               fusion=dataclasses.replace(tcfg.fusion, **fk))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """Port-made fp32 weights with LoRA adapters (both B nonzero, so the
    adapters move the loss and every A gets a gradient), and the same tree
    for JAX."""
    _, tcfg = _cfgs()
    tp = tfusion.init_params(0, tcfg, dtype=torch.float32, device="cpu")
    tp["llm"]["lm_head"] = tp["llm"]["lm_head"] * 10.0
    lo = tlora.init_lora(torch.Generator().manual_seed(1), tcfg.llm, 4)
    lo["qb"] = torch.randn(lo["qb"].shape, generator=torch.Generator()
                           .manual_seed(2)) * 0.05
    lo["vb"] = torch.randn(lo["vb"].shape, generator=torch.Generator()
                           .manual_seed(3)) * 0.05
    tp["llm"]["layers"]["lora"] = lo
    return tp


def _batch(cfg, a=1, b=2, s=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(16, 32000, (a, b, s)).astype(np.int64)
    ids[:, :, 0] = 1
    labels = ids.copy()
    labels[:, :, :3] = -100
    mask = np.ones((a, b, s), np.int64)
    mask[:, -1, -2:] = 0
    labels[:, -1, -2:] = -100
    vis = cfg.vision
    return {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "images": rng.randint(0, 255, (a, b, vis.image_size, vis.image_size,
                                       3)).astype(np.uint8),
        "audios": (rng.randn(a, b, 480000) * 0.1).astype(np.float32),
        "videos": rng.randint(0, 255, (a, b, cfg.fusion.n_frames,
                                       vis.image_size, vis.image_size,
                                       3)).astype(np.uint8),
    }


# ----------------------------------------------------------- state, LoRA

@pytest.mark.parametrize("freeze,lora", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_split_merge_params(weights, freeze, lora):
    tp = weights
    jp = _to_jax(tp)
    if not lora:
        tp = dict(tp, llm={k: v for k, v in tp["llm"].items()})
        tp["llm"]["layers"] = {k: v for k, v in tp["llm"]["layers"].items()
                               if k != "lora"}
        jp = _to_jax(tp)
    jt, jf = jstate.split_params(jp, freeze, lora=lora)
    tt, tf = tstate.split_params(tp, freeze, lora=lora)
    for got, ref in ((tt, jt), (tf, jf)):
        g, r = _leaves(got), _leaves(ref)
        assert sorted(g) == sorted(r)
        for k in g:
            np.testing.assert_array_equal(_np(g[k]), _np(r[k]))
    merged = _leaves(tstate.merge_params(tt, tf))
    assert sorted(merged) == sorted(_leaves(tp))
    if not lora:  # create_train_state splits by freeze_encoders alone
        st = ttrainer.create_train_state(
            tp, tconfig.TrainConfig(freeze_encoders=freeze), 10)
        assert sorted(_leaves(st.trainable)) == sorted(_leaves(tt))
        assert sorted(_leaves(st.opt_state.mu)) == sorted(_leaves(tt))


def test_lora_delta_and_merge(weights):
    lo = weights["llm"]["layers"]["lora"]
    x = np.random.RandomState(3).randn(2, 5, 64).astype(np.float32)
    ref = jlora.lora_delta(jnp.asarray(x), jnp.asarray(lo["qa"][0].numpy()),
                           jnp.asarray(lo["qb"][0].numpy()), 4.0)
    got = tlora.lora_delta(torch.from_numpy(x), lo["qa"][0], lo["qb"][0], 4.0)
    _close(got, ref, 1e-6)
    jm = jlora.merge_lora(_to_jax(weights["llm"]), 4, 16.0)
    tm = tlora.merge_lora(weights["llm"], 4, 16.0)
    assert "lora" not in tm["layers"]
    for name in ("wq", "wv", "wk"):
        _close(tm["layers"]["attn"][name], jm["layers"]["attn"][name], 1e-6)
    a = tlora.init_lora(torch.Generator().manual_seed(0),
                        tconfig.LlamaConfig(hidden_size=96, num_heads=4,
                                            num_layers=3), 8)
    assert a["qa"].shape == (3, 96, 8) and not a["qb"].any()
    assert a["va"].abs().max() <= (6.0 / 96) ** 0.5


# ------------------------------------------------- schedule and optimizer

@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_optax(kind):
    cfg = tconfig.TrainConfig(learning_rate=2e-4, warmup_ratio=0.1,
                              lr_schedule=kind)
    jcfg = jconfig.TrainConfig(learning_rate=2e-4, warmup_ratio=0.1,
                               lr_schedule=kind)
    ref = jtrainer.make_lr_schedule(jcfg, 50)
    got = ttrainer.make_lr_schedule(cfg, 50)
    assert got(0) == 0.0
    for step in range(60):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=0,
                                   atol=1e-6 * 2e-4)


@pytest.mark.parametrize("max_norm,wd,bf16", [(1e3, 0.0, False),
                                             (0.05, 0.01, False),
                                             (1e3, 0.01, True)])
def test_adamw_clip_matches_optax(max_norm, wd, bf16):
    """Three steps on a toy tree, the clip inactive (max_norm 1e3) and
    active (0.05, which every step's gradient norm exceeds); and with bf16
    gradients and a bf16 Adam m over fp32 masters, where optax rounds its
    scalar constants to bf16 (its global norm is then a bf16 sum, 2^-8)."""
    kw = dict(learning_rate=1e-2, warmup_ratio=0.1, max_grad_norm=max_norm,
              weight_decay=wd, mu_dtype="bfloat16" if bf16 else "float32")
    tx_ref = jtrainer.make_optimizer(jconfig.TrainConfig(**kw), 10)
    tx = ttrainer.make_optimizer(tconfig.TrainConfig(**kw), 10)
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    jst, tst = tx_ref.init(jp), tx.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         params)
        jg = jax.tree.map(jnp.asarray, g)
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {"c": torch.from_numpy(g["b"]["c"])}}
        if bf16:
            jg = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jg)
            tg = {"a": tg["a"].bfloat16(), "b": {"c": tg["b"]["c"].bfloat16()}}
        upd, jst = tx_ref.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        norm = tx.update(tp, tg, tst)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=2.0 ** -8 if bf16 else 1e-6)
        for k in ("a", "b/c"):
            path = k.split("/")
            got = tp[path[0]] if len(path) == 1 else tp["b"]["c"]
            ref = jp[path[0]] if len(path) == 1 else jp["b"]["c"]
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)
    assert tst.count == 3


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("chunk", [0, 5])
def test_clm_loss_value_and_grad(weights, chunk):
    """clm_loss over full logits, and clm_loss_chunked from the hidden
    states (chunks of 5 over 13 positions: a ragged last chunk), against
    the JAX losses: value and gradient with respect to the hidden states."""
    llm = weights["llm"]
    rng = np.random.RandomState(5)
    h = (rng.randn(2, 13, 64) * 0.5).astype(np.float32)
    labels = rng.randint(0, 32007, (2, 13))
    labels[0, :4] = -100
    labels[1, -1] = -100
    jw = _to_jax({"lm_head": llm["lm_head"]})

    if chunk:
        def jloss(hh):
            return jllama.clm_loss_chunked(jw, hh, jnp.asarray(labels),
                                           chunk=chunk)
    else:
        def jloss(hh):
            return jllama.clm_loss(jllama.logits_from_hidden(jw, hh),
                                   jnp.asarray(labels))
    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    tl = torch.from_numpy(labels)
    if chunk:
        loss = tllama.clm_loss_chunked({"lm_head": llm["lm_head"]}, th, tl,
                                       chunk=chunk)
    else:
        loss = tllama.clm_loss(tllama.logits_from_hidden(
            {"lm_head": llm["lm_head"]}, th), tl)
    loss.backward()
    _close(loss, ref, 1e-5)
    _close(th.grad, ref_g)


# ----------------------------------------------------------------- dropout

def _heads(seed, b=2, sq=5, sk=300, n=2, d=8, shared=False):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, sq, n, d).astype(np.float32))
    kshape = (sk, n, d) if shared else (b, sk, n, d)
    k = torch.from_numpy(rng.randn(*kshape).astype(np.float32))
    v = torch.from_numpy(rng.randn(*kshape).astype(np.float32))
    return q, k, v


def _plain(q, k, v, scale):
    if k.dim() == 3:
        k, v = k[None].expand(q.shape[0], -1, -1, -1), \
            v[None].expand(q.shape[0], -1, -1, -1)
    return tattn.dot_product_attention(q, k, v, scale=scale)


@pytest.mark.parametrize("shared", [False, True])
def test_dropout_rate0_equals_attention(shared):
    q, k, v = _heads(6, shared=shared)
    got = tattn.dropout_attention_chunked(
        q, k, v, scale=0.3, rate=0.0, rng=torch.Generator().manual_seed(0),
        chunk=128)
    _close(got, _plain(q, k, v, 0.3), 1e-5)


def test_dropout_unbiased_over_seeds():
    """E[dropout output] = the attention output: the mean over 400 seeds is
    within 4 standard errors of it, elementwise."""
    q, k, v = _heads(7, sk=40)
    ref = _plain(q, k, v, 0.3)
    gen = torch.Generator().manual_seed(1)
    outs = torch.stack([tattn.dropout_attention_chunked(
        q, k, v, scale=0.3, rate=0.2, rng=gen, chunk=16)
        for _ in range(400)])
    err = (outs.mean(0) - ref).abs()
    sem = outs.std(0) / 400 ** 0.5
    assert (err <= 4 * sem + 1e-6).all()
    assert outs.std(0).max() > 0  # it does drop


def test_dropout_chunked_equals_unchunked(monkeypatch):
    """Under the same masks (one [B, N, Sq, Sk] mask, sliced per chunk),
    three ragged chunks give the one-chunk result."""
    q, k, v = _heads(8, sk=70)
    full = torch.rand(2, 2, 5, 70, generator=torch.Generator()
                      .manual_seed(3)) >= 0.3

    def keep(seed, start, shape, rate, device):
        return full[..., start:start + shape[-1]]

    monkeypatch.setattr(tattn, "_dropout_keep", keep)
    outs = [tattn.dropout_attention_chunked(
        q, k, v, scale=0.3, rate=0.3, rng=torch.Generator().manual_seed(0),
        chunk=c) for c in (70, 32)]
    _close(outs[1], outs[0], 1e-5)
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k) * 0.3, -1)
    ref = torch.einsum("bnqk,bknd->bqnd", torch.where(full, p, 0.0) / 0.7, v)
    _close(outs[0], ref, 1e-5)


def test_dropout_backward_reuses_masks():
    """Each chunk's mask is drawn again in the backward: the chunked
    gradient equals autograd through the same masks applied to one
    softmax."""
    q, k, v = (t.requires_grad_() for t in _heads(9, sk=50))
    masks = {}
    real = tattn._dropout_keep

    def keep(seed, start, shape, rate, device):
        m = real(seed, start, shape, rate, device)
        masks.setdefault(start, m)
        assert torch.equal(m, masks[start])
        return m

    tattn_keep, tattn._dropout_keep = tattn._dropout_keep, keep
    try:
        out = tattn.dropout_attention_chunked(
            q, k, v, scale=0.3, rate=0.25,
            rng=torch.Generator().manual_seed(5), chunk=16)
        g = torch.autograd.grad(out.square().sum(), (q, k, v))
    finally:
        tattn._dropout_keep = tattn_keep
    full = torch.cat([masks[s] for s in sorted(masks)], -1)
    q2, k2, v2 = (t.detach().requires_grad_() for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q2, k2) * 0.3, -1)
    ref = torch.einsum("bnqk,bknd->bqnd", torch.where(full, p, 0.0) / 0.75,
                       v2)
    g_ref = torch.autograd.grad(ref.square().sum(), (q2, k2, v2))
    for a, r in zip(g, g_ref):
        _close(a, r, 1e-5)


# ---------------------------------------------------- model and train step

def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_fusion_forward_loss(weights, loss_chunk):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    batch = {k: v[0] for k, v in _batch(jcfg).items()}
    if loss_chunk:
        # the chunked loss reads only the LLaMA hidden states: image and
        # text suffice, and the first case covers audio and video
        del batch["audios"], batch["videos"]
    tp = weights
    ref, _ = jax.jit(lambda p, b: jfusion.forward(
        p, jcfg, input_ids=b["input_ids"], images=b["images"],
        audios=b.get("audios"), videos=b.get("videos"),
        attention_mask=b["attention_mask"], labels=b["labels"],
        lora_scale=4.0))(_to_jax(tp), _jax_batch(batch))
    tb = _torch_batch(batch)
    loss, logits = tfusion.forward(
        tp, tcfg, input_ids=tb["input_ids"], images=tb["images"],
        audios=tb.get("audios"), videos=tb.get("videos"),
        attention_mask=tb["attention_mask"], labels=tb["labels"],
        lora_scale=4.0)
    assert (logits is None) == (loss_chunk > 0)
    _close(loss, ref, 1e-5)


def _trainers(weights, lora: bool, accum: int, **train_kw):
    """The JAX Trainer (one-device mesh) and the port's, both initialized
    from the same weights: QLoRA (int8 base, int8 align cache) or a full
    fine-tune of LLaMA + fusion, frozen towers, dropout off; ``train_kw``
    sets further TrainConfig fields on both."""
    from macaw_llm_tpu.parallel.mesh import create_mesh
    jcfg, tcfg = _cfgs()
    # adam_eps 1e-4: Adam's update m / (sqrt(v) + eps) normalizes an
    # element's gradient, rounding noise (~1e-9 absolute here) included;
    # the default 1e-8 would turn noise-sized gradients (the attention
    # K-bias rows, whose exact gradient is 0: softmax is invariant to
    # them) into updates of random sign
    kw = dict(learning_rate=1e-2, warmup_ratio=0.1, grad_accum_steps=accum,
              lora_rank=4 if lora else 0, quantize_base=lora, adam_eps=1e-4)
    kw.update(train_kw)
    jt = jconfig.TrainConfig(**kw)
    tt = tconfig.TrainConfig(**kw)
    tp = dict(weights)
    if not lora:
        tp["llm"] = dict(tp["llm"], layers={
            k: v for k, v in tp["llm"]["layers"].items() if k != "lora"})
    full = jconfig.Config(model=jcfg, train=jt,
                          mesh=jconfig.MeshConfig(data=1, fsdp=1, tensor=1))
    jtr = jtrainer.Trainer(full, create_mesh(full.mesh, jax.devices()[:1]),
                           total_steps=10)
    jst = jtr.init_state(_to_jax(tp))
    ttr = ttrainer.Trainer(tcfg, tt, total_steps=10, device="cpu")
    tst = ttr.init_state(tp)
    return jtr, jst, ttr, tst


def _steps_match_jax(weights, lora, accum, train_kw, media, steps, rel,
                     norm_rel):
    """``steps`` optimizer steps (the first at learning rate 0) of the JAX
    Trainer and the port's: the loss of every step within 1e-5, the
    gradients' global norm within ``norm_rel`` and, after the last step,
    every trainable leaf's total update (p_last - p0) within ``rel`` of the
    largest update of the leaf plus 4 fp32 ulps of its largest value (an
    fp32 leaf cannot resolve a smaller update). Without ``media`` the batch
    holds image and text only: audio and video (Whisper over 1500 frames,
    6 CLIP frames) double the JAX compile, and one case covers them."""
    jtr, jst, ttr, tst = _trainers(weights, lora, accum, **train_kw)
    j0 = {k: np.array(v) for k, v in _leaves(jst.trainable).items()}
    t0 = {k: v.clone() for k, v in _leaves(tst.trainable).items()}
    assert sorted(j0) == sorted(t0)
    for step in range(steps):
        batch = _batch(ttr.mcfg, a=accum, seed=10 + step)
        if not media:
            del batch["audios"], batch["videos"]
        jst, jm = jtr.train_step(jst, _jax_batch(batch))
        tst, tm = ttr.train_step(tst, _torch_batch(batch))
        _close(tm["loss"], jm["loss"], 1e-5, f"loss step {step}")
        _close(tm["grad_norm"], jm["grad_norm"], norm_rel, "grad norm")
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    jl, tl = _leaves(jst.trainable), _leaves(tst.trainable)
    for k in j0:
        ref = np.asarray(jl[k]).astype(np.float64) - j0[k]
        got = (tl[k] - t0[k]).double().numpy()
        if np.abs(ref).max() == 0:  # leaves the loss does not reach
            assert not got.any(), k
        else:
            ulp = np.finfo(np.float32).eps * np.abs(j0[k]).max()
            _close(got, ref, rel, k, atol=4 * ulp)
    assert tst.step == steps and tst.opt_state.count == steps
    return tst


# (lora, accum, further TrainConfig fields, audio and video in the batch):
# QLoRA at A = 1 is bench.py's 7b configuration; the others turn on the
# remaining options of the port's TrainConfig
TRAIN_CASES = [
    (True, 1, {}, True),
    (True, 2, {"align_cache": "bf16", "pack_frozen_towers": True}, False),
    (False, 1, {"frozen_dtype": "param"}, False),
    (False, 2, {}, False),
]


@pytest.mark.parametrize("lora,accum,train_kw,media", TRAIN_CASES,
                         ids=["True-1", "True-2", "False-1", "False-2"])
def test_train_steps_match_jax(weights, lora, accum, train_kw, media):
    """Three steps, fp32 gradients, the ROADMAP bar (1e-3)."""
    _steps_match_jax(weights, lora, accum, train_kw, media, steps=3,
                     rel=REL, norm_rel=1e-4)


def test_bf16_grads_match_jax(weights):
    """bench.py's 1b full fine-tune: bf16 gradients and bf16 Adam m, A = 2.

    Both round each gradient element to bf16 after summing its
    contributions in their own order, so an element may differ by one bf16
    ulp (2^-8 of it). Two steps, the second the first at a nonzero rate:
    there m = 0.1 g1 + 0.09 g0 and the update is m_hat / sqrt(v_hat), where
    sqrt(v_hat) >= |g| / sqrt(2), so one ulp in g1 or g0 moves the update
    by at most 0.75 x 2^-8 of its scale; those two and m's own bf16
    rounding stay below 2^-6. A third step is not compared: at this rate
    the tiny model's next gradients amplify such differences many times.
    JAX's global norm is a bf16 sum (2^-8)."""
    tst = _steps_match_jax(weights, False, 2,
                           {"grad_dtype": "bfloat16", "mu_dtype": "bfloat16"},
                           False, steps=2, rel=2.0 ** -6, norm_rel=2.0 ** -8)
    assert tst.opt_state.mu["llm"]["lm_head"].dtype == torch.bfloat16
    assert tst.opt_state.nu["llm"]["lm_head"].dtype == torch.float32


def test_remat_gives_the_same_grads(weights):
    _, tcfg = _cfgs()
    batch = _torch_batch({k: v[0] for k, v in _batch(tcfg).items()})
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, loss_chunk=8)
        tr, fr = tstate.split_params(weights, True, lora=True)
        diff = {"fusion": {k: {n: t.detach().requires_grad_()
                               for n, t in v.items()}
                           for k, v in tr["fusion"].items()
                           if k.endswith("align")},
                "lora": {n: t.detach().requires_grad_()
                         for n, t in tr["llm"]["layers"]["lora"].items()}}
        p = tstate.merge_params(
            {"fusion": dict(tr["fusion"], **diff["fusion"]),
             "llm": {"layers": {"lora": diff["lora"]}}}, fr)
        loss, _ = tfusion.forward(
            p, cfg, input_ids=batch["input_ids"], images=batch["images"],
            audios=batch["audios"], videos=batch["videos"],
            attention_mask=batch["attention_mask"], labels=batch["labels"],
            lora_scale=4.0)
        loss.backward()
        grads.append(_leaves(diff))
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k].grad, grads[0][k].grad,
                                   rtol=1e-5, atol=1e-7)
        assert grads[0][k].grad.abs().max() > 0, k


@pytest.mark.parametrize("lora", [True, False], ids=["qlora", "full"])
def test_train_step_leaves_the_callers_tree_unchanged(weights, lora):
    """``init_state`` + two ``train_step`` never write the tensors they were
    given (on their own device ``.to`` returns them, and AdamW updates the
    trainable leaves in place); the JAX Trainer never changes its input."""
    _, tcfg = _cfgs()
    tp = dict(weights)
    if not lora:
        tp["llm"] = dict(tp["llm"], layers={
            k: v for k, v in tp["llm"]["layers"].items() if k != "lora"})
    before = {k: v.clone() for k, v in _leaves(tp).items()}
    tt = tconfig.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0,
                             lora_rank=4 if lora else 0, quantize_base=lora)
    tr = ttrainer.Trainer(tcfg, tt, total_steps=10, device="cpu")
    state = tr.init_state(tp)
    for seed in (7, 8):  # the first step runs at learning rate 0
        batch = _batch(tcfg, seed=seed)
        del batch["audios"], batch["videos"]
        state, _ = tr.train_step(state, _torch_batch(batch))
    assert any(not torch.equal(v, before[k])  # the step did train
               for k, v in _leaves(state.trainable).items())
    after = _leaves(tp)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def _check_align_kv_training(weights, align_cache):
    """Two QLoRA Trainer steps with dropout on: with a cache the align
    in-proj K/V rows and bias_k/bias_v get exactly zero gradient and do not
    move; with ``align_cache="off"`` they train. The Q rows and out-proj
    train in both."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, fusion=dataclasses.replace(
        tcfg.fusion, align_dropout=0.1))
    tt = tconfig.TrainConfig(learning_rate=1e-2, warmup_ratio=0.1,
                             lora_rank=4, quantize_base=True,
                             align_cache=align_cache)
    tr = ttrainer.Trainer(tcfg, tt, total_steps=10, device="cpu")
    st = tr.init_state(weights)
    assert (tr.align_cache is None) == (align_cache == "off")
    e = tcfg.llm.hidden_size
    before = {m: {k: v.clone() for k, v in st.trainable["fusion"][m].items()}
              for m in ("image_align", "audio_align", "video_align")}
    for step in range(2):
        batch = _torch_batch(_batch(tcfg, seed=20 + step))
        st, metrics = tr.train_step(st, batch)
        assert np.isfinite(float(metrics["loss"]))
    frozen = align_cache != "off"
    for m, p0 in before.items():
        p = st.trainable["fusion"][m]
        for got, ref in ((p["in_proj_w"][e:], p0["in_proj_w"][e:]),
                         (p["in_proj_b"][e:], p0["in_proj_b"][e:]),
                         (p["bias_k"], p0["bias_k"]),
                         (p["bias_v"], p0["bias_v"])):
            assert torch.equal(got, ref) == frozen, m
        assert not torch.equal(p["in_proj_w"][:e], p0["in_proj_w"][:e])
        assert not torch.equal(p["out_proj_w"], p0["out_proj_w"])
        assert st.opt_state.nu["fusion"][m]["in_proj_w"][e:].any() != frozen


def test_align_cache_freezes_align_kv_under_lora(weights):
    """The port's counterpart of test_align_cache::test_cache_freezes_
    align_kv, through the Trainer."""
    _check_align_kv_training(weights, "int8")


def test_align_cache_off_trains_align_kv(weights):
    _check_align_kv_training(weights, "off")


def test_evaluate_token_accuracy(weights):
    """Eval: the mean loss equals the forward's and the token accuracy is
    the argmax agreement over the valid shifted labels."""
    _, tcfg = _cfgs()
    tr = ttrainer.Trainer(tcfg, tconfig.TrainConfig(lora_rank=4),
                          total_steps=10, device="cpu")
    st = tr.init_state(weights)
    batch = _torch_batch({k: v[0] for k, v in _batch(tcfg).items()})
    out = tr.evaluate(st, [batch])
    loss, logits = tfusion.forward(
        tstate.merge_params(st.trainable, st.frozen), tcfg,
        input_ids=batch["input_ids"], images=batch["images"],
        audios=batch["audios"], videos=batch["videos"],
        attention_mask=batch["attention_mask"], labels=batch["labels"],
        lora_scale=tr.lora_scale)
    assert out["eval_loss"] == pytest.approx(float(loss), rel=1e-6)
    assert 0.0 <= out["eval_token_accuracy"] <= 1.0


def test_jax_train_state_carries_over(weights):
    """utils.jax_bridge: a JAX QLoRA TrainState's trainable and frozen trees
    (int8 records, bf16 frozen leaves, fp32 adapters) become the port's
    TrainState with the same leaves and dtypes."""
    from macaw_llm_tpu_torch.utils.jax_bridge import train_state_from_numpy
    jtr, jst, ttr, _ = _trainers(weights, True, 1)
    st = train_state_from_numpy(jax.tree.map(np.asarray, jst.trainable),
                                jax.tree.map(np.asarray, jst.frozen), ttr.tx)
    for got, ref in ((st.trainable, jst.trainable), (st.frozen, jst.frozen)):
        g, r = _leaves(got), _leaves(ref)
        assert sorted(g) == sorted(r)
        for k in g:
            assert str(g[k].dtype).split(".")[-1] == str(r[k].dtype), k
            np.testing.assert_array_equal(g[k].float().numpy(),
                                          np.asarray(r[k]).astype(np.float32))
    lora = st.trainable["llm"]["layers"]["lora"]
    assert lora["qa"].dtype == torch.float32
    assert st.frozen["llm"]["layers"]["attn"]["wq"]["q"].dtype == torch.int8
    assert st.opt_state.count == 0 and not st.opt_state.mu["llm"][
        "layers"]["lora"]["qb"].any()
