"""The reference's side of the comparisons that decide ``correct``.

* Serving: the model in the serving form the configuration states (the
  LLM's matmul weights and head in int8 per output column, the KV cache
  int8 per position and head, the alignment's K/V rows int8 per row; the
  rest as drawn), computed in float32. Each sampled request's prompt and
  media are run through it with its served tokens after them, once
  (teacher forcing), and each served token's logit is read against the
  reference's best at its position. With ``control_bits`` the same
  positions are read for the token that the model with the LLM's matmul
  weights and head in that many bits puts first (the control).
* Training: the QLoRA form of the configuration (int8 base, int8
  alignment cache, LoRA on q and v, attention dropout with the keep masks
  the training step draws) trained for a few steps on the same batches,
  rows with media or text alone,
  with AdamW, returning each step's loss, each trainable leaf's first
  (clipped) gradient norm, its largest raw gradient norm, and its change
  after the steps.

Both run in float32 with TF32 off, layer by layer (serving) or in blocks
of rows (training), once the program's state is freed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from . import model as M


@contextlib.contextmanager
def exact_fp32():
    """float32 matmuls and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp32_embeddings(tree: dict) -> dict:
    """The tree with the token embedding in float32, converted once (the
    lookups, the alignment memory and the splice all read it)."""
    llm = dict(tree["llm"], embed_tokens=M.f32(tree["llm"]["embed_tokens"]))
    return dict(tree, llm=llm)


def _zero_media(cfg: dict):
    v, a = cfg["vision"], cfg["audio"]
    s = v["image_size"]
    n = a["sample_rate"] * a["chunk_length_s"]
    return (np.zeros((s, s, 3), np.uint8), np.zeros((n,), np.float32),
            np.zeros((cfg["fusion"]["n_frames"], s, s, 3), np.uint8))


@torch.no_grad()
def serve_gaps(tree: dict, cfg: dict, samples: list, device,
               control_bits: Optional[int] = None) -> list:
    """``samples``: dicts with ``ids`` (the prompt's valid ids, BOS
    first), ``media`` ((image, audio, video) numpy arrays, or None for a
    text-only request, which carries all-zero media) and ``served`` (the
    streamed token ids). Returns, per sample, a dict with ``gaps`` (the
    reference's best logit less the served token's, per served token) and,
    with ``control_bits``, ``control_gaps`` (the same for the control's
    first choice)."""
    form = cfg["serving"]
    bits = 8 if form["weights"] == "int8" else None
    kv_bits = 8 if form["kv_cache"] == "int8" else None
    tree = _fp32_embeddings(tree)
    with exact_fp32():
        kv = M.align_memory(tree, cache=form["align_cache"] == "int8")
        seqs, starts = [], []
        zero_feats = None
        for smp in samples:
            media = smp["media"]
            if media is None:
                if zero_feats is None:
                    zero_feats = _feats(tree, cfg, _zero_media(cfg), device)
                feats = zero_feats
            else:
                feats = _feats(tree, cfg, media, device)
            ids = torch.tensor([smp["ids"]], device=device)
            fused = M.fuse(tree, cfg, feats, kv, ids)
            served = torch.tensor([smp["served"][:-1]], dtype=torch.long,
                                  device=device)
            emb = tree["llm"]["embed_tokens"][served]
            seqs.append(torch.cat([fused, emb], 1))
            starts.append(fused.shape[1] - 1)
        del kv
        ref = _decode_stack(tree, cfg, seqs, bits, kv_bits)
        ctl = _decode_stack(tree, cfg, seqs, control_bits, kv_bits) \
            if control_bits else None
        out = []
        for i, smp in enumerate(samples):
            n = len(smp["served"])
            logits = _logits(tree, cfg, ref[i][0, starts[i]:starts[i] + n],
                             bits)
            tok = torch.tensor(smp["served"], device=device)
            best = logits.amax(-1)
            res = {"gaps": (best - logits.gather(1, tok[:, None])[:, 0]
                            ).tolist()}
            if ctl is not None:
                cl = _logits(tree, cfg, ctl[i][0, starts[i]:starts[i] + n],
                             control_bits)
                pick = cl.argmax(-1)
                res["control_gaps"] = (best - logits.gather(
                    1, pick[:, None])[:, 0]).tolist()
            out.append(res)
        return out


def _feats(tree, cfg, media, device):
    image, audio, video = media
    return M.media_features(
        tree, cfg, torch.from_numpy(np.asarray(image))[None].to(device),
        torch.from_numpy(np.asarray(audio, np.float32))[None].to(device),
        torch.from_numpy(np.asarray(video))[None].to(device))


def _decode_stack(tree, cfg, seqs, bits, kv_bits):
    llm = tree["llm"]
    hs = [s.clone() for s in seqs]
    for li in range(cfg["num_hidden_layers"]):
        lw = M.layer_weights(llm, li, bits)
        for i, h in enumerate(hs):
            s = h.shape[1]
            pos = torch.arange(s, device=h.device)[None]
            hs[i] = M.decoder_layer(cfg, lw, h, pos,
                                    M.causal([s], s, h.device),
                                    kv_bits=kv_bits)
        del lw
    return [M.rms_norm(h, llm["norm"], cfg["rms_norm_eps"]) for h in hs]


def _logits(tree, cfg, h, bits):
    w = tree["llm"]["lm_head"]
    w = M.quant_columns(w, bits) if bits else M.f32(w)
    return h @ w


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def dropout_seed(gen: torch.Generator) -> int:
    """The base of one attention's keep masks, drawn from the step's CPU
    generator as the training step draws it."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def keep_mask(seed: int, b: int, n: int, sq: int, sk: int, rate: float,
              device) -> torch.Tensor:
    """[b, n, sq, sk] keep-mask of one attention: per chunk of keys, a
    uniform draw from a generator seeded by (seed, chunk start), kept where
    it is at least ``rate``; chunks of about 64 MiB of fp32 logits, whole
    multiples of 128 keys. This is the training step's definition of its
    masks, which the comparison needs in order to drop the same
    probabilities."""
    chunk = max(128, (64 * 2 ** 20) // max(b * n * sq * 4, 1))
    chunk = min(sk, ((chunk + 127) // 128) * 128)
    parts = []
    for start in range(0, sk, chunk):
        g = torch.Generator(device=device)
        g.manual_seed((seed * 1000003 + start) % (2 ** 63))
        width = min(chunk, sk - start)
        parts.append(torch.rand((b, n, sq, width), generator=g,
                                device=device) >= rate)
    return torch.cat(parts, -1)


def lr_at(count: int, tcfg: dict) -> float:
    """Linear warmup from 0 over ``warmup_ratio`` of the steps (at least
    one), then cosine to 0."""
    total = tcfg["total_steps"]
    warm = max(1, int(tcfg["warmup_ratio"] * total))
    total = max(total, warm + 1)
    peak = tcfg["learning_rate"]
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))


def trainable_leaves(tree: dict) -> dict:
    """The QLoRA form's trainable leaves as float32 masters: every fusion
    leaf and the LoRA factors."""
    out = {f"fusion/{k}": v for k, v in _flat(tree["fusion"]).items()}
    out.update({f"llm/layers/lora/{k}": v
                for k, v in tree["llm"]["layers"]["lora"].items()})
    return {k: M.f32(v).clone().requires_grad_() for k, v in out.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: dict, prefix: str) -> dict:
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def train_steps(tree: dict, cfg: dict, tcfg: dict, batches: list,
                rng_seed: int, device, base_bits: int = 8,
                row_block: int = 1) -> dict:
    """The QLoRA form trained for ``len(batches)`` steps. ``batches``:
    dicts of ``input_ids`` [B, S], ``labels`` [B, S] and, for rows with
    media, ``images`` [B, H, W, 3] uint8, ``audios`` [B, samples] and
    ``videos`` [B, F, H, W, 3] uint8 (text-only rows have no prefix and
    draw no dropout masks); ``rng_seed`` seeds the CPU generator of the
    dropout masks.
    ``base_bits`` quantizes the frozen LLM's matmul weights and head per
    output column (8: the configuration's int8 base). The tree's bf16 LLM
    matmul weights are dropped once their fp32 copies exist."""
    with exact_fp32():
        return _train(tree, cfg, tcfg, batches, rng_seed, device, base_bits,
                      row_block)


def _train(tree, cfg, tcfg, batches, rng_seed, device, base_bits, row_block):
    tree = _fp32_embeddings(tree)
    llm = tree["llm"]
    L = cfg["num_hidden_layers"]
    base = [M.layer_weights(llm, i, base_bits) for i in range(L)]
    head = M.quant_columns(llm["lm_head"], base_bits)
    # the bf16 originals are not read again: free them beside the fp32 base
    for group, name in M.LAYER_KEYS:
        llm["layers"][group][name] = None
    llm["lm_head"] = None
    media = "images" in batches[0]
    kv = M.align_memory(tree, cache=True) if media else None
    params = trainable_leaves(tree)
    init = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator().manual_seed(int(rng_seed))
    rate = cfg["fusion"]["align_dropout"]
    heads = cfg["fusion"]["attention_heads"]
    scale = tcfg["lora_alpha"] / tcfg["lora_rank"]
    b1, b2, eps = tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"]
    losses, norms, first = [], [], {}
    raw_max = {k: 0.0 for k in params}
    v = cfg["vision"]
    n_patch = (v["image_size"] // v["patch_size"]) ** 2
    vq = cfg["fusion"]["n_frames"] * n_patch
    sq = {"image": _conv_len(cfg, "image", n_patch),
          "audio": _conv_len(cfg, "audio", cfg["audio"]["sample_rate"]
                             * cfg["audio"]["chunk_length_s"]
                             // cfg["audio"]["hop_length"] // 2),
          "video": _conv_len(cfg, "video", vq)}
    for step, batch in enumerate(batches):
        bsz = batch["input_ids"].shape[0]
        if media:
            seeds = [dropout_seed(gen) for _ in range(4)]
            vkeep_all = keep_mask(seeds[2], bsz, heads, vq, vq + 2, rate,
                                  device)
            keeps_all = {mod: keep_mask(sd, bsz, 2 * heads, sq[mod],
                                        kv[mod][0].shape[0], rate, device)
                         for mod, sd in (("image", seeds[0]),
                                         ("audio", seeds[1]),
                                         ("video", seeds[3]))}
        count = int((batch["labels"] != M.IGNORE).sum())
        total = 0.0
        for r0 in range(0, bsz, row_block):
            rows = slice(r0, r0 + row_block)
            ids = batch["input_ids"][rows]
            if media:
                t = dict(tree, fusion=_nest(params, "fusion/"))
                feats = M.media_features(t, cfg, batch["images"][rows],
                                         batch["audios"][rows],
                                         batch["videos"][rows],
                                         vkeep_all[rows], rate)
                keeps = {mod: m[rows] for mod, m in keeps_all.items()}
                h = M.fuse(t, cfg, feats, kv, ids, keeps, rate)
            else:
                h = llm["embed_tokens"][ids]
            s = h.shape[1]
            pos = torch.arange(s, device=device)[None].expand(h.shape[0], s)
            mask = M.causal([s] * h.shape[0], s, device)
            lora = _nest(params, "llm/layers/lora/")
            for i in range(L):
                li = {k: v[i] for k, v in lora.items()}
                h = M.decoder_layer(cfg, base[i], h, pos, mask, li, scale)
            h = M.rms_norm(h, llm["norm"], cfg["rms_norm_eps"])
            plen_fused = s - batch["input_ids"].shape[1]
            labels = torch.cat([torch.full(
                (h.shape[0], plen_fused), M.IGNORE, device=device),
                batch["labels"][rows]], 1)
            logits = h[:, :-1] @ head
            tgt = labels[:, 1:]
            ok = tgt != M.IGNORE
            logp = torch.log_softmax(logits, -1)
            nll = -logp.gather(-1, torch.where(ok, tgt, 0)[..., None])[..., 0]
            loss = torch.where(ok, nll, 0.0).sum() / count
            loss.backward()
            total += float(loss.detach())
            del h, logits, logp, nll, loss
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in params.items()}
        for k, g in grads.items():
            raw_max[k] = max(raw_max[k], float(g.norm()))
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        norms.append(float(norm))
        clip = tcfg["max_grad_norm"]
        if float(norm) >= clip:
            grads = {k: g * (clip / norm) for k, g in grads.items()}
        if step == 0:
            first = {k: float(g.norm()) for k, g in grads.items()}
        lr = lr_at(step, tcfg)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu[k].mul_(b1).add_((1 - b1) * g)
                nu[k].mul_(b2).add_((1 - b2) * g * g)
                mhat = mu[k] / (1 - b1 ** (step + 1))
                vhat = nu[k] / (1 - b2 ** (step + 1))
                p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
                p.grad = None
        losses.append(total)
    change = {k: float((params[k].detach() - init[k]).norm())
              for k in params}
    return {"loss": losses, "grad_norm": norms, "first_grad": first,
            "raw_grad_max": raw_max, "change": change}


def _conv_len(cfg: dict, mod: str, n: int) -> int:
    f = cfg["fusion"]
    k, s = f[f"{mod}_conv_kernel"], f[f"{mod}_conv_stride"]
    return (n - k) // s + 1
