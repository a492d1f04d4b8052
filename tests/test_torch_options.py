"""The options the first slices of the port left out, against the JAX
package on the tiny configs in fp32 on the CPU, the same weights on both
sides (made by the port, handed to JAX):

* ``encode_video_simple`` and ``prepare_inputs(video_mode="simple")``:
  within 1e-3 of max |ref|;
* Whisper LayerDrop: rate 0 is the identity, rate 1 keeps only the conv
  front end and the final LayerNorm, and a given keep vector gives JAX's
  output and gradients (1e-3);
* ``remat_policy="dots"``: gradients equal to "nothing" and to no remat
  (1e-5), the matmuls not run again in the backward, and a Trainer step
  equal to JAX's Trainer with "dots";
* ``quantize_towers`` with activation quant: the records equal JAX's, the
  tower outputs within the W8A8 bounds of ``tests/test_quantize.py``
  (relative error < 0.05, cosine > 0.995);
* ``utils/profiling.py``: the timer and the trace write what they say.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu.models import clip as jclip
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.models import whisper as jwhisper
from macaw_llm_tpu.ops.attention import pack_mha as jpack_mha
from macaw_llm_tpu.utils import quantize as jqz
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch.models import clip as tclip
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.models import llama as tllama
from macaw_llm_tpu_torch.models import whisper as twhisper
from macaw_llm_tpu_torch.ops.attention import pack_mha as tpack_mha
from macaw_llm_tpu_torch.utils import profiling
from macaw_llm_tpu_torch.utils import quantize as tqz

TOL = 1e-3


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def _rel(got, ref):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfig.tiny_model_config(), tconfig.tiny_model_config()
    tp = tfusion.init_params(0, tcfg, dtype=torch.float32, device="cpu")
    return jcfg, tcfg, tp, _to_jax(tp)


# ------------------------------------------------------------- video simple

def test_init_tree_has_jax_layout_and_the_same_other_weights(model):
    """The port's init tree has every leaf of JAX's, the temporal leaves
    drawn after all the others: a seed gives the other leaves the weights
    it gave them before these two existed."""
    jcfg, tcfg, tp, _ = model
    ref = jax.eval_shape(lambda: jfusion.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    shapes = {k: tuple(v.shape) for k, v in _leaves(tp).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _leaves(ref).items()}
    gen = torch.Generator().manual_seed(0)
    from macaw_llm_tpu_torch.models import clip, llama, whisper
    clip.init_params(gen, tcfg.vision)
    clip.init_params(gen, tcfg.vision)
    whisper.init_params(gen, tcfg.audio)
    assert torch.equal(llama.init_params(gen, tcfg.llm)["lm_head"],
                       tp["llm"]["lm_head"])
    for k, v in _leaves(tp["fusion"]).items():
        assert v.abs().max() > 0 or k.endswith("_b"), k


def test_encode_video_simple_matches_jax(model):
    jcfg, tcfg, tp, jp = model
    rng = np.random.RandomState(0)
    vids = rng.randn(2, tcfg.fusion.n_frames, 3, 32, 32).astype(np.float32)
    got = tfusion.encode_video_simple(tp, tcfg, torch.from_numpy(vids))
    ref = jfusion.encode_video_simple(jp, jcfg, jnp.asarray(vids))
    assert got.shape == (2, tcfg.fusion.n_frames,
                         tcfg.vision.projection_dim)
    assert _rel(got, ref) <= TOL


def test_prepare_inputs_video_simple_matches_jax(model):
    jcfg, tcfg, tp, jp = model
    rng = np.random.RandomState(1)
    b, s = 2, 10
    ids = rng.randint(16, 32000, (b, s))
    ids[:, 0] = 1
    vis = tcfg.vision
    media = {
        "images": rng.randint(0, 255, (b, vis.image_size, vis.image_size, 3)
                              ).astype(np.uint8),
        "audios": (rng.randn(b, 480000) * 0.1).astype(np.float32),
        "videos": rng.randint(0, 255, (b, tcfg.fusion.n_frames,
                                       vis.image_size, vis.image_size, 3)
                              ).astype(np.uint8)}
    got = tfusion.prepare_inputs(
        tp, tcfg, input_ids=torch.from_numpy(ids), video_mode="simple",
        **{k: torch.from_numpy(v) for k, v in media.items()})
    ref = jfusion.prepare_inputs(
        jp, jcfg, input_ids=jnp.asarray(ids), video_mode="simple",
        **{k: jnp.asarray(v) for k, v in media.items()})
    assert got.inputs_embeds.shape == ref.inputs_embeds.shape
    assert _rel(got.inputs_embeds, ref.inputs_embeds) <= TOL
    with pytest.raises(ValueError):
        tfusion.prepare_inputs(tp, tcfg, input_ids=torch.from_numpy(ids),
                               images=None, audios=None, videos=None,
                               video_mode="pooled")


def test_video_simple_shorter_than_the_conv_kernel_matches_jax(model):
    """At the 7b geometry the pooled video's F = 6 frames are fewer than
    the video conv kernel (36): the downsampler has no output position and
    the video block is its two boundary tokens, in both packages (with the
    alignment cache of the serving path: JAX's flash alignment takes no
    empty query block)."""
    jcfg, tcfg, tp, jp = model
    jcfg, tcfg = (dataclasses.replace(c, fusion=dataclasses.replace(
        c.fusion, video_conv_kernel=8)) for c in (jcfg, tcfg))
    rng = np.random.RandomState(2)
    ids = rng.randint(16, 32000, (2, 6))
    vids = rng.randn(2, 6, 3, 32, 32).astype(np.float32)
    fp = dict(tp["fusion"], conv=dict(tp["fusion"]["conv"], video={
        "w": torch.from_numpy(rng.randn(8, 16, 16).astype(np.float32)),
        "b": torch.zeros(16)}))
    tq = dict(tp, fusion=fp)
    got = tfusion.prepare_inputs(tq, tcfg, input_ids=torch.from_numpy(ids),
                                 images=None, audios=None,
                                 videos=torch.from_numpy(vids),
                                 video_mode="simple",
                                 align_cache=tfusion.precompute_align_cache(
                                     tq, tcfg, quantize=True))
    jq = _to_jax(tq)
    ref = jfusion.prepare_inputs(jq, jcfg,
                                 input_ids=jnp.asarray(ids), images=None,
                                 audios=None, videos=jnp.asarray(vids),
                                 video_mode="simple",
                                 align_cache=jfusion.precompute_align_cache(
                                     jq, jcfg, quantize=True))
    assert got.inputs_embeds.shape == ref.inputs_embeds.shape == (2, 8, 64)
    assert _rel(got.inputs_embeds, ref.inputs_embeds) <= TOL


# ---------------------------------------------------------------- LayerDrop

def _whisper(layers=4):
    def make(mod):
        return mod.WhisperConfig(d_model=32, encoder_layers=layers,
                                 encoder_attention_heads=2,
                                 encoder_ffn_dim=64,
                                 max_source_positions=64, num_mel_bins=16,
                                 encoder_layerdrop=0.5)
    jcfg, tcfg = make(jconfig), make(tconfig)
    tp = twhisper.init_params(torch.Generator().manual_seed(3), tcfg)
    # nonzero biases and norms, so that every leaf moves the output
    for k, v in _leaves(tp).items():
        v.add_(torch.randn(v.shape, generator=torch.Generator()
                           .manual_seed(len(k))) * 0.05)
    mel = np.random.RandomState(4).randn(2, 16, 128).astype(np.float32) * 0.3
    return jcfg, tcfg, tp, mel


def test_layerdrop_rate_0_is_the_identity(model):
    jcfg, tcfg, tp, _ = model
    mel = torch.from_numpy(np.random.RandomState(5).randn(
        1, 80, 3000).astype(np.float32))
    plain = tfusion.encode_audio(tp, tcfg, mel)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tfusion.encode_audio(tp, tcfg, mel, dropout_rng=gen),
                       plain)
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    keep_all = twhisper.encode(tp["audio_encoder"], tcfg.audio, mel,
                               layer_keep=[True, True])
    assert torch.equal(keep_all, plain)


def test_layerdrop_rate_1_keeps_the_front_end_only():
    jcfg, tcfg, tp, mel = _whisper()
    jcfg = dataclasses.replace(jcfg, encoder_layerdrop=1.0)
    tcfg = dataclasses.replace(tcfg, encoder_layerdrop=1.0)
    keep = twhisper.layerdrop_keep(torch.Generator().manual_seed(0), 4, 1.0)
    assert keep == [False] * 4
    got = twhisper.encode(tp, tcfg, torch.from_numpy(mel), layer_keep=keep)

    def none_of(tree):  # the same tower with an empty layer stack
        if isinstance(tree, dict):
            return {k: none_of(v) for k, v in tree.items()}
        return tree[:0]

    no_layers = dict(tp, layers=none_of(tp["layers"]))
    assert torch.equal(got, twhisper.encode(no_layers, tcfg,
                                            torch.from_numpy(mel)))
    ref = jwhisper.encode(_to_jax(tp), jcfg, jnp.asarray(mel),
                          dropout_rng=jax.random.PRNGKey(0))
    assert _rel(got, ref) <= TOL


def test_layerdrop_keep_vector_matches_jax_forward_and_grad():
    jcfg, tcfg, tp, mel = _whisper()
    key = jax.random.PRNGKey(7)
    keep = np.array(jax.random.bernoulli(key, 0.5, (4,)))
    assert 0 < keep.sum() < 4  # some layers kept, some dropped
    cot = np.random.RandomState(6).randn(2, 64, 32).astype(np.float32)

    def jloss(p):
        out = jwhisper.encode(p, jcfg, jnp.asarray(mel), dropout_rng=key)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(_to_jax(tp))
    tleaf = {k: v.detach().clone().requires_grad_()
             for k, v in _leaves(tp).items()}

    def tree(flat):
        out = {}
        for k, v in flat.items():
            node = out
            parts = k.strip("/").split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
        return out

    out = twhisper.encode(tree(tleaf), tcfg, torch.from_numpy(mel),
                          layer_keep=keep)
    assert _rel(out, jout) <= TOL
    (out * torch.from_numpy(cot)).sum().backward()
    jg = {k: np.asarray(v) for k, v in _leaves(jgrad).items()}
    for k, t in tleaf.items():
        if k.startswith("/layers"):
            dropped = np.asarray(jg[k])[~keep]
            assert not dropped.any() and not t.grad[~torch.from_numpy(
                keep)].any(), k
        # the k bias's exact gradient is 0 (softmax ignores a shift of a
        # query's logits): there both hold rounding noise, ~1e-9
        err = np.abs(t.grad.numpy() - jg[k]).max()
        assert err <= TOL * np.abs(jg[k]).max() + 1e-6, k


def test_layerdrop_in_the_fusion_draws_on_the_host(model):
    """The keep vector comes from the CPU generator: the same generator
    state gives the same dropped layers and the same output."""
    jcfg, tcfg, tp, _ = model
    cfg = dataclasses.replace(tcfg, audio=dataclasses.replace(
        tcfg.audio, encoder_layerdrop=0.5))
    mel = torch.from_numpy(np.random.RandomState(8).randn(
        1, 80, 3000).astype(np.float32))
    outs = [tfusion.encode_audio(tp, cfg, mel, dropout_rng=torch.Generator()
                                 .manual_seed(seed)) for seed in (3, 3)]
    assert torch.equal(outs[0], outs[1])
    keep = twhisper.layerdrop_keep(torch.Generator().manual_seed(3), 2, 0.5)
    assert torch.equal(outs[0], twhisper.encode(
        tp["audio_encoder"], cfg.audio, mel, layer_keep=keep))


# ------------------------------------------------------------ remat "dots"

class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_grads_equal_and_saves_the_matmuls(model):
    """Every stack (LLaMA, CLIP, Whisper) trained with remat "dots": the
    gradients equal "nothing" and no remat within 1e-5, and the backward
    runs no matmul again ("nothing" runs the forward's again)."""
    _, tcfg, tp, _ = model
    rng = np.random.RandomState(9)
    px = torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32))
    mel = torch.from_numpy(rng.randn(1, 80, 200).astype(np.float32) * 0.3)
    emb = torch.from_numpy(rng.randn(2, 12, 64).astype(np.float32))
    grads, backward_mm = {}, {}
    for policy in (False, "nothing", "dots"):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in
                  _leaves({"c": tp["image_encoder"], "w": tp["audio_encoder"],
                           "l": tp["llm"]}).items()}

        def sub(prefix):
            out = {}
            for k, v in leaves.items():
                if not k.startswith(prefix):
                    continue
                node = out
                parts = k[len(prefix):].strip("/").split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = v
            return out

        loss = (tclip.encode_patches(sub("/c"), tcfg.vision, px,
                                     remat=policy).square().mean()
                + twhisper.encode(sub("/w"), tcfg.audio, mel,
                                  remat=policy).square().mean()
                + tllama.forward_hidden(sub("/l"), tcfg.llm, emb,
                                        remat=policy).square().mean())
        with _CountMM() as count:
            loss.backward()
        backward_mm[policy] = count.mm
        grads[policy] = {k: v.grad for k, v in leaves.items()}
    for policy in ("nothing", "dots"):
        for k, g in grads[False].items():
            torch.testing.assert_close(grads[policy][k], g, rtol=1e-5,
                                       atol=1e-8)
    assert backward_mm["nothing"] > backward_mm[False]
    assert backward_mm["dots"] == backward_mm[False]


def test_remat_dots_over_the_int8_base(model):
    """QLoRA's path: the int8 weight-only matmul (its own autograd
    function) and W8A8 (``torch._int_mm``) inside a "dots" checkpoint give
    the input the gradient they give it without remat."""
    _, tcfg, tp, _ = model
    q = tqz.quantize_llama(tp["llm"])
    emb = torch.from_numpy(np.random.RandomState(10).randn(
        2, 160, 64).astype(np.float32))
    grads = {}
    for policy in (False, "dots"):
        x = emb.clone().requires_grad_()
        h = tllama.forward_hidden(q, tcfg.llm, x, remat=policy,
                                  activation_quant=True)
        h.square().mean().backward()
        grads[policy] = x.grad
    torch.testing.assert_close(grads["dots"], grads[False], rtol=1e-5,
                               atol=1e-8)


def test_remat_dots_trainer_step_matches_jax():
    """One Trainer case: a full fine-tune of LLaMA and the fusion under
    remat "dots", two steps against the JAX Trainer (the bar of
    tests/test_torch_train.py). The towers' remat is held by the test
    above: trainable towers add leaves whose exact gradient is 0 (the
    attention k biases), where the two Trainers' updates are rounding
    noise."""
    import tests.test_torch_train as tt
    orig = tt._cfgs

    def cfgs(**fusion_kw):
        return tuple(dataclasses.replace(c, remat=True, remat_policy="dots")
                     for c in orig(**fusion_kw))

    weights = tfusion.init_params(0, orig()[1], dtype=torch.float32,
                                  device="cpu")
    weights["llm"]["lm_head"] = weights["llm"]["lm_head"] * 10.0
    mp = pytest.MonkeyPatch()
    mp.setattr(tt, "_cfgs", cfgs)
    try:
        tt._steps_match_jax(weights, False, 1, {}, False, steps=2,
                            rel=tt.REL, norm_rel=1e-4)
    finally:
        mp.undo()


# ---------------------------------------------------------- quantize_towers

def _towers():
    def vis(mod):
        return mod.ClipVisionConfig(hidden_size=64, intermediate_size=128,
                                    num_layers=2, num_heads=4, image_size=32,
                                    patch_size=16, projection_dim=48)

    def aud(mod):
        return mod.WhisperConfig(d_model=64, encoder_layers=2,
                                 encoder_attention_heads=4,
                                 encoder_ffn_dim=128,
                                 max_source_positions=64, num_mel_bins=16)
    cp = tclip.init_params(torch.Generator().manual_seed(0), vis(tconfig))
    cp["layers"]["attn"] = tpack_mha(cp["layers"]["attn"])
    wp = twhisper.init_params(torch.Generator().manual_seed(1), aud(tconfig))
    wp["layers"]["attn"] = tpack_mha(wp["layers"]["attn"])
    return vis, aud, cp, wp


def test_quantize_towers_records_match_jax():
    """The same records: the scales within 2 fp32 ulps (XLA divides by 127
    as a multiply by its reciprocal), so an int8 value may sit one step
    off where w / s lands on a rounding tie; every other leaf is equal."""
    _, _, cp, wp = _towers()
    tree = {"image_encoder": cp, "audio_encoder": wp}
    got = tqz.quantize_towers(tree)
    ref = jqz.quantize_towers(_to_jax(tree))
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    for k in g:
        a, b = g[k].numpy(), np.asarray(r[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k.endswith("/q"):
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
        elif k.endswith("/s"):
            np.testing.assert_allclose(a, b, rtol=2.5e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, k)
    assert got["image_encoder"]["layers"]["attn"]["qkv"]["w"]["q"].dtype \
        == torch.int8
    assert got["image_encoder"]["visual_projection"]["q"].dtype == torch.int8
    assert got["audio_encoder"]["conv1"]["w"].dtype == torch.float32


def test_quantize_towers_w8a8_outputs(monkeypatch):
    vis, aud, cp, wp = _towers()
    calls = []
    real = tqz.w8a8_dot
    monkeypatch.setattr(tqz, "w8a8_dot",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(0)
    px = rng.randn(300, 3, 32, 32).astype(np.float32)
    mel = (rng.randn(8, 16, 128) * 0.3).astype(np.float32)
    q = tqz.quantize_towers({"image_encoder": cp, "audio_encoder": wp})
    jq = _to_jax(q)
    cases = (
        ("clip", lambda p, aq: tclip.encode_patches(
            p, vis(tconfig), torch.from_numpy(px), activation_quant=aq),
         lambda p: jclip.encode_patches(p, vis(jconfig), jnp.asarray(px)),
         cp, q["image_encoder"], jq["image_encoder"]),
        ("whisper", lambda p, aq: twhisper.encode(
            p, aud(tconfig), torch.from_numpy(mel), activation_quant=aq),
         lambda p: jwhisper.encode(p, aud(jconfig), jnp.asarray(mel)),
         wp, q["audio_encoder"], jq["audio_encoder"]))
    for name, port, jax_fn, plain, qp, jqp in cases:
        ref_fp32 = port(plain, False).numpy()
        calls.clear()
        got = port(qp, True).numpy()
        assert calls, name  # the projections took W8A8
        jqz.set_activation_quant(True)
        try:
            ref = np.asarray(jax_fn(jqp))
        finally:
            jqz.set_activation_quant(False)
        assert _rel(got, ref) < 0.05 and _cos(got, ref) > 0.995, name
        assert _cos(got, ref_fp32) > 0.995, name


# ---------------------------------------------------------------- profiling

def test_profiling_timer_and_trace(tmp_path):
    sink = {}
    with profiling.step_timer("step", sink):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert sink["step"] > 0
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("macaw_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "macaw_region" for e in events)
    assert any(e.key == "macaw_region" for e in prof.key_averages())
    with pytest.raises(NotImplementedError, match="trace"):
        profiling.start_profiler_server()
    profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
