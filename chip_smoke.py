"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Phases, in order (any failure raises and the script exits non-zero):
 1. build the CUDA kernels from ``macaw_llm_tpu_torch/csrc`` (nvcc, sm_90a);
 2. print the card's name and power limit (nvidia-smi);
 3. hold each forward kernel against its plain PyTorch version at the
    main-path shapes of the 7b profile and time kernel, plain version, the
    library call that computes the same function (where one exists) and
    the bound;
 3b. the same for the backward kernels (flash dq, flash dk/dv) at the 7b
    train shape and at the edge cases (ragged tail, a fully masked batch
    row, an LSE cotangent, head dims 64 and 256), after holding the flash
    forward that feeds them against its plain version in every case and
    timing it at the train shape;
 4. a 2-layer model at 7b widths (batch 2, seq 256) on the card with the
    kernels against the same weights on the CPU with the plain versions;
 4b. a 2-layer QLoRA train step at 7b widths (loss and the trainable
    leaves' gradients), card against CPU, at text 256 and text 1024;
 5. the full-width 7b fused prefill, batch 16, seq 256 (fused length 312),
    int8 W8A8 LLaMA, int8 alignment cache, packed towers;
 6. greedy decode of 4 requests, 16 new tokens, int8 packed weights, bf16
    KV cache;
 7. release the serving weights;
 8. the 7b QLoRA r=8 train step at full width and depth, batch 8, at text
    1024 (fused length 1080: 2 warm-up + 5 timed steps) and text 256
    (fused 312: 2 + 3): int8 frozen base, frozen towers and int8 alignment
    cache, remat, chunked loss, alignment dropout 0.1, AdamW with a cosine
    schedule over 1000 steps;
 9. one ``{"kernels": [...]}`` line, then the contract line
    ``{"ok": true, "device": {...}}`` last.

Weights are random, made on the card from a seed. Usage, from the root of
a checkout:  python3 chip_smoke.py [--profile]
(--profile adds torch.profiler tables of one prefill, of greedy decode
with 1 and 4 new tokens and of one train step at text 1024, written to
chiprun_out/.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Attention outputs, kernel vs plain, bf16 compared in fp32, each output
# row (one query, one head) against its own max |ref|: one bf16 ulp of the
# output (<= 2^-7 of the row max) plus the probabilities' bf16 rounding
# (<= 2^-8) stay below 2^-6.
ATTN_ROW_REL_TOL = 2.0 ** -6
LSE_TOL = 1e-3
MATVEC_REL_TOL = 1e-2
LOGITS_REL_TOL = 3e-2  # the BASELINE.md bf16 bar

# Backward kernels (B3 dq, B4 dk/dv) against the plain backward run in fp32
# on the same bf16 inputs, forward output and LSE, each row (one query or
# key, one head) against the row's own max |ref|. Both round ds = P(dP -
# delta) and P to bf16 before the products that use them; they differ in
# fp32 summation order, which can move a ds or P across a bf16 rounding
# boundary (one ulp, 2^-8 of that term), and in the kernel's bf16 output
# (half an ulp, 2^-9 of the row max). 2^-6 leaves room for a few such
# terms per row. A row whose exact gradient is 0 (the first query of a
# causal row sees one key, so its ds is 0 up to rounding) is measured
# against 2^-10 of the whole tensor's max |ref| instead.
BWD_ROW_REL_TOL = 2.0 ** -6
BWD_ROW_FLOOR = 2.0 ** -10

# The 2-layer train step, card (bf16, kernels) against CPU (bf16, plain
# versions), same weights and batch: the loss within the BASELINE.md bf16
# bar of phase 4 (3e-2, relative); each trainable leaf's gradient within
# twice that of the leaf's max |ref|, since it passes the bf16 roundings
# of the forward and then of the backward.
TRAIN_LOSS_REL_TOL = 3e-2
TRAIN_GRAD_REL_TOL = 6e-2
# a QLoRA train step's LLaMA FLOPs: forward plus the activation gradient
# through the frozen weights, 4 x N_llm per token (bench.py's reckoning)
LORA_FLOPS_PER_PARAM_TOKEN = 4


def log(*args) -> None:
    print(*args, flush=True)


def bound(flops: float, nbytes: float):
    """Least time (ms) for the work, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` (ms) over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def row_rel_err(out, ref) -> float:
    """Largest error of an attention output row measured against that
    row's own max |ref|; a row the reference leaves at zero must be 0."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale.clamp_min(1e-30)).max().item()


def tail_bias(torch, b: int, sk: int, tile: int):
    """Padding bias that keeps only the keys of the last K tile of
    ``tile`` keys (the ragged tail, masked by the kernel itself), so that
    those keys carry the whole output."""
    bias = torch.full((b, sk), torch.finfo(torch.float32).min,
                      device="cuda")
    bias[:, sk - (sk % tile or tile):] = 0.0
    return bias


def attn_pairs(sq, sk, causal) -> int:
    """(query, key) pairs the attention needs (causal: keys <= query)."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def attn_flops(b, sq, sk, n, d, causal) -> float:
    """FLOPs of QK^T and PV that the inputs need."""
    return 2 * 2 * b * n * d * attn_pairs(sq, sk, causal)


def grad_row_err(out, ref) -> float:
    """Largest gradient-row error against the row's own max |ref|, or
    against BWD_ROW_FLOOR of the tensor's max |ref| where that is larger."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(
        BWD_ROW_FLOOR * ref.float().abs().max().item())
    return (diff / scale.clamp_min(1e-30)).max().item()


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main-path shapes
# --------------------------------------------------------------------------

def check_attention(torch, mh, fa, gen):
    """mh_attention at the LLaMA prefill shape; flash_attention at the
    Whisper, video-long and video-alignment shapes (batch 16)."""
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    results = {}
    # B1: [16, 312, 32, 128], causal, zero padding bias (all-ones mask)
    b, s, n, d = 16, 312, 32, 128
    q, k, v = rn(b, s, n, d), rn(b, s, n, d), rn(b, s, n, d)
    bias = torch.zeros(b, s, device="cuda")
    out = mh.mh_attention(q, k, v, bias, causal=True)
    ref, _ = fa.attention_reference(q, k, v, bias, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    # the same inputs with only the keys of the last, partial 16-key tile
    # left valid
    tail = tail_bias(torch, b, s, 16)
    tail_rel = row_rel_err(mh.mh_attention(q, k, v, tail, causal=True),
                           fa.attention_reference(q, k, v, tail,
                                                  causal=True)[0])
    if not (rel <= ATTN_ROW_REL_TOL and tail_rel <= ATTN_ROW_REL_TOL):
        raise AssertionError(f"mh_attention row rel err {rel}, ragged tail "
                             f"{tail_rel}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cuda_ms(torch, lambda: mh.mh_attention(q, k, v, bias, causal=True),
                 20)
    plain = cuda_ms(torch, lambda: fa.attention_reference(
        q, k, v, bias, causal=True), 5)
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    nbytes = 4 * q.numel() * 2 + bias.numel() * 4
    bms, by = bound(attn_flops(b, s, s, n, d, True), nbytes)
    results["mh_attention"] = [dict(
        shape=[b, s, n, d], causal=True, max_abs_err=err, row_rel_err=rel,
        tail_row_rel_err=tail_rel, kernel_ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
        per_prefill=32)]
    del q, k, v, ref, out, qt, kt, vt, tail

    # B2: (Sq, Sk, N, D, launches per prefill)
    rows = []
    for name, sq, sk, n, d, per in (("whisper", 1500, 1500, 8, 64, 6),
                                    ("video_long", 1176, 1178, 8, 64, 1),
                                    ("video_align", 624, 32009, 1, 256, 1)):
        bb = 16
        q, k, v = rn(bb, sq, n, d), rn(bb, sk, n, d), rn(bb, sk, n, d)
        out, lse = fa.flash_attention_with_lse(q, k, v, None, causal=False)
        ref, ref_lse = fa.attention_reference(q, k, v, None, causal=False)
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        # only the ragged tail of the 64-key tiles left valid
        tail = tail_bias(torch, bb, sk, 64)
        t_out, t_lse = fa.flash_attention_with_lse(q, k, v, tail,
                                                   causal=False)
        t_ref, t_ref_lse = fa.attention_reference(q, k, v, tail,
                                                  causal=False)
        tail_rel = row_rel_err(t_out, t_ref)
        lse_err = max(lse_err, (t_lse - t_ref_lse).abs().max().item())
        del tail, t_out, t_lse, t_ref, t_ref_lse
        if not (rel <= ATTN_ROW_REL_TOL and tail_rel <= ATTN_ROW_REL_TOL
                and lse_err <= LSE_TOL):
            raise AssertionError(f"flash_attention {name}: row rel err "
                                 f"{rel}, ragged tail {tail_rel}, lse err "
                                 f"{lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(torch, lambda: fa.flash_attention_with_lse(
            q, k, v, None, causal=False), 10)
        plain = cuda_ms(torch, lambda: fa.attention_reference(
            q, k, v, None, causal=False), 3, warmup=1)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt), 10)
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + bb * sq * n * 4
        bms, by = bound(attn_flops(bb, sq, sk, n, d, False), nbytes)
        rows.append(dict(call=name, shape_q=[bb, sq, n, d],
                         shape_kv=[bb, sk, n, d], max_abs_err=err,
                         row_rel_err=rel, tail_row_rel_err=tail_rel,
                         lse_err=lse_err, kernel_ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by,
                         per_prefill=per))
        del q, k, v, out, lse, qt, kt, vt
        torch.cuda.empty_cache()
    results["flash_attention"] = rows
    return results


# --------------------------------------------------------------------------
# phase 3b: the backward kernels against the plain backward
# --------------------------------------------------------------------------

def check_backward(torch, fa, gen):
    """B3 and B4 at the 7b train shape (batch 8, fused length 1080, 32
    heads of 128, causal, all-ones mask) and at the edge cases. The forward
    (B2) that gives both sides their output and LSE is held against its
    plain version first in every case, and timed at the train shape."""
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    neg = torch.finfo(torch.float32).min
    # name, B, Sq, Sk, N, D, causal, bias kind, LSE cotangent
    cases = (("train", 8, 1080, 1080, 32, 128, True, "ones", False),
             ("train_tail", 8, 1080, 1080, 32, 128, True, "tail", False),
             ("masked_row", 8, 1080, 1080, 32, 128, True, "row0", False),
             ("lse_cotangent", 2, 1080, 1080, 8, 128, False, "ones", True),
             ("d64", 2, 300, 300, 4, 64, True, "row0", False),
             ("d256", 2, 260, 260, 2, 256, True, "tail", True))
    rows = {"flash_attention_dq": [], "flash_attention_dkv": [],
            "flash_attention": []}
    timing = None
    for name, b, sq, sk, n, d, causal, kind, lse_grad in cases:
        q, k, v, g = rn(b, sq, n, d), rn(b, sk, n, d), rn(b, sk, n, d), \
            rn(b, sq, n, d)
        bias = torch.zeros(b, sk, device="cuda")
        if kind == "tail":
            bias = tail_bias(torch, b, sk, 64)
        elif kind == "row0":
            bias[0] = neg
        g_lse = (torch.randn(b, sq, n, generator=gen, device="cuda")
                 if lse_grad else None)
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        ref_out, ref_lse = fa.attention_reference(q, k, v, bias,
                                                  causal=causal)
        fwd_rel = row_rel_err(out, ref_out)
        fwd_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref_out, ref_lse
        if not (fwd_rel <= ATTN_ROW_REL_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"flash forward at the backward case {name}:"
                                 f" row rel err {fwd_rel}, lse err {lse_err}")
        delta = fa.backward_delta(out, g, g_lse)
        kw = dict(causal=causal, scale=d ** -0.5)
        dq = fa.flash_attention_dq(q, k, v, bias, g, lse, delta, **kw)
        dk, dv = fa.flash_attention_dkv(q, k, v, bias, g, lse, delta, **kw)
        torch.cuda.synchronize()
        ref = fa.attention_backward_reference(q, k, v, bias, lse, g, delta,
                                              **kw)
        errs = {key: (grad_row_err(got, r),
                      (got.float() - r).abs().max().item())
                for key, got, r in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                                    ("dv", dv, ref[2]))}
        zero_ok = kind != "row0" or not (dq[0].any() or dk[0].any()
                                         or dv[0].any())
        bad = {key: e for key, e in errs.items() if not e[0] <=
               BWD_ROW_REL_TOL}
        if bad or not zero_ok:
            raise AssertionError(f"flash backward {name}: row errors {errs}, "
                                 f"masked row exactly zero: {zero_ok}")
        del ref
        case = dict(case=name, shape_q=[b, sq, n, d], shape_kv=[b, sk, n, d],
                    causal=causal, lse_cotangent=lse_grad,
                    masked_row_zero=zero_ok if kind == "row0" else None)
        rows["flash_attention_dq"].append(dict(
            case, row_rel_err=errs["dq"][0], max_abs_err=errs["dq"][1]))
        rows["flash_attention_dkv"].append(dict(
            case, row_rel_err=max(errs["dk"][0], errs["dv"][0]),
            max_abs_err=max(errs["dk"][1], errs["dv"][1])))
        fwd = dict(call=f"backward_case_{name}", shape_q=[b, sq, n, d],
                   shape_kv=[b, sk, n, d], causal=causal, max_abs_err=fwd_err,
                   row_rel_err=fwd_rel, lse_err=lse_err, per_prefill=0)
        if name == "train":
            pairs = attn_pairs(sq, sk, causal)
            # B2 at the train shape: 64 of its 70 launches per train step
            # (the 32 LLaMA layers' forward and remat recompute)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = cuda_ms(torch, lambda: fa.flash_attention_with_lse(
                q, k, v, bias, causal=True), 10)
            plain = cuda_ms(torch, lambda: fa.attention_reference(
                q, k, v, bias, causal=True), 3, warmup=1)
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10)
            bms, by = bound(attn_flops(b, sq, sk, n, d, True),
                            4 * q.numel() * 2 + bias.numel() * 4
                            + b * sq * n * 4)
            fwd.update(call="llama_train", kernel_ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bms, bound_by=by,
                       per_step=64)
            del qt, kt, vt
            nbytes_in = 4 * q.numel() * 2 + 2 * b * n * sq * 4
            ms_dq = cuda_ms(torch, lambda: fa.flash_attention_dq(
                q, k, v, bias, g, lse, delta, **kw), 10)
            ms_dkv = cuda_ms(torch, lambda: fa.flash_attention_dkv(
                q, k, v, bias, g, lse, delta, **kw), 10)
            plain = cuda_ms(torch, lambda: fa.attention_backward_reference(
                q, k, v, bias, lse, g, delta, **kw), 3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
            gt = g.transpose(1, 2)
            lib = cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), gt, retain_graph=True), 10)
            # dq: S, dP and dS K (3 products); dk/dv: S, P^T dO, dP and
            # dS^T Q (4): 2 * D FLOPs each per (query, key) pair and head
            b3 = bound(3 * 2 * b * n * d * pairs, nbytes_in + q.numel() * 2)
            b4 = bound(4 * 2 * b * n * d * pairs,
                       nbytes_in + 2 * k.numel() * 2)
            timing = {"flash_attention_dq": (ms_dq, b3),
                      "flash_attention_dkv": (ms_dkv, b4),
                      "plain_ms": plain, "library_ms": lib}
            del qt, kt, vt, lib_out, gt
        rows["flash_attention"].append(fwd)
        del q, k, v, g, out, lse, delta, dq, dk, dv, bias
        torch.cuda.empty_cache()
    results = {"flash_attention": rows.pop("flash_attention")}
    for kname, krows in rows.items():
        ms, (bms, by) = timing[kname]
        krows[0].update(kernel_ms=ms, plain_ms=timing["plain_ms"],
                        library_ms=timing["library_ms"], bound_ms=bms,
                        bound_by=by, per_step=32)
        results[kname] = krows
    return results


# one 7b decode step at batch 4: (name, K, N, launches per step)
DECODE_MATVECS = (("qkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
                  ("gateup", 4096, 22016, 32), ("down", 11008, 4096, 32),
                  ("lm_head", 4096, 32007, 1))


def library_int8_mm(torch, x, ws, s, ref, cycle):
    """The library yardstick of B5: ``torch._weight_int8pack_mm`` (x @
    w^T * scale, w int8 [N, K], scale in x's dtype), timed only. Returns
    (ms, rel err against the plain version, None), or (None, None, why)
    where the card's PyTorch has no CUDA version of it."""
    wts = [w.t().contiguous() for w in ws]
    sc = s.reshape(-1).to(x.dtype)
    try:
        out = torch._weight_int8pack_mm(x, wts[0], sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, (f"torch._weight_int8pack_mm on CUDA: "
                            f"{type(e).__name__}: {str(e).splitlines()[0]}")
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    index = {id(w): i for i, w in enumerate(ws)}
    ms = cuda_ms(torch, cycle(lambda w: torch._weight_int8pack_mm(
        x, wts[index[id(w)]], sc)), 8 * len(ws))
    return ms, rel, None


def check_matvec(torch, mv, gen, batch: int = 4):
    """matvec_int8 at every decode-step shape. Timing cycles through
    enough distinct weights (>= 128 MB) that no call finds its weight in
    the 50 MB L2, as in decode, where every layer streams its own."""
    rows = []
    for name, k, n, per in DECODE_MATVECS:
        copies = max(1, -(-(128 << 20) // (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen,
                            device="cuda").to(torch.int8)
              for _ in range(copies)]
        s = torch.rand(1, n, generator=gen, device="cuda") * 0.01
        x = torch.randn(batch, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = mv.matvec_int8(x, ws[0], s)
        ref = mv.matvec_reference(x, ws[0], s).float()
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not rel <= MATVEC_REL_TOL:
            raise AssertionError(f"matvec_int8 {name}: rel err {rel}")
        i = [0]

        def cycle(fn):
            def call():
                i[0] = (i[0] + 1) % copies
                return fn(ws[i[0]])
            return call

        ms = cuda_ms(torch, cycle(lambda w: mv.matvec_int8(x, w, s)),
                     8 * copies)
        plain = cuda_ms(torch, cycle(lambda w: mv.matvec_reference(x, w, s)),
                        4 * copies)
        lib, lib_err, lib_note = library_int8_mm(torch, x, ws, s, ref, cycle)
        nbytes = k * n + n * 4 + batch * k * 2 + batch * n * 2
        bms, by = bound(2 * batch * k * n, nbytes)
        rows.append(dict(call=name, shape=[batch, k, n], max_abs_err=err,
                         rel_err=rel, kernel_ms=ms, plain_ms=plain,
                         library_ms=lib, library_rel_err=lib_err,
                         library_note=lib_note, bound_ms=bms, bound_by=by,
                         per_step=per))
        del ws, ref, out
        torch.cuda.empty_cache()
    return {"matvec_int8": rows}


# --------------------------------------------------------------------------
# phases 4-6: the model
# --------------------------------------------------------------------------

def make_batch(torch, cfg, b: int, s: int, seed: int, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(16, 32000, (b, s), generator=gen, device=device)
    ids[:, 0] = 1
    vis = cfg.vision

    def frames(*shape):
        return torch.randint(0, 255, shape, generator=gen, device=device
                             ).to(torch.uint8)

    return {
        "input_ids": ids,
        "attention_mask": torch.ones((b, s), dtype=torch.int64,
                                     device=device),
        "images": frames(b, vis.image_size, vis.image_size, 3),
        "audios": torch.randn(b, 480000, generator=gen, device=device) * 0.1,
        "videos": frames(b, cfg.fusion.n_frames, vis.image_size,
                         vis.image_size, 3),
    }


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def reset_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def counts(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def small_model_parity(torch, cfg7, kernels):
    """2 LLaMA layers and 2 layers per tower at 7b widths, batch 2, seq 256:
    the card (kernels) against the CPU (plain versions), same bf16 weights
    and the same int8 alignment cache."""
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.prefill import prefill
    cfg = dataclasses.replace(
        cfg7, llm=dataclasses.replace(cfg7.llm, num_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_layers=2),
        audio=dataclasses.replace(cfg7.audio, encoder_layers=2))
    params = fusion.init_params(1, cfg, dtype=torch.bfloat16, device="cuda")
    cache = fusion.precompute_align_cache(params, cfg, quantize=True)
    params = fusion.pack_towers(fusion.strip_align_kv(params))
    batch = make_batch(torch, cfg, 2, 256, seed=2)
    reset_counts(kernels)
    gpu = prefill(params, cfg, batch, cache)
    torch.cuda.synchronize()
    launched = counts(kernels)
    if launched["mh_attention"] != 2 or launched["flash_attention"] != 3:
        raise AssertionError(f"2-layer model launches {launched}")
    t0 = time.perf_counter()
    cpu = prefill(to_device(params, "cpu"), cfg, to_device(batch, "cpu"),
                  to_device(cache, "cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    gpu = gpu.float().cpu()
    rel = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
    top2 = cpu.topk(2, dim=-1).values
    gap = ((top2[:, 0] - top2[:, 1]) / cpu.abs().max()).tolist()
    same = bool((gpu.argmax(-1) == cpu.argmax(-1)).all())
    result = dict(rel_err=rel, argmax_equal=same, cpu_top2_rel_gap=gap,
                  cpu_seconds=cpu_s, launches=launched)
    log(json.dumps({"small_model_parity": result}))
    if not (rel <= LOGITS_REL_TOL and same):
        raise AssertionError(f"2-layer model parity failed: {result}")
    return result


def build_7b(torch, cfg):
    """The serving tree in the reference benchmark's order: init (bf16) ->
    align cache (int8, from the bf16 embeddings) -> quantize LLaMA ->
    strip the align K/V rows -> pack the towers."""
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.utils import quantize as qz
    t0 = time.perf_counter()
    params = fusion.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    cache = fusion.precompute_align_cache(params, cfg, quantize=True)
    params["llm"] = qz.quantize_llama(params["llm"])
    params = fusion.pack_towers(fusion.strip_align_kv(params))
    torch.cuda.synchronize()
    return params, cache, time.perf_counter() - t0


def run_prefill(torch, params, cfg, cache, kernels, steps=10, warmup=3):
    from macaw_llm_tpu_torch.prefill import prefill
    b, s = 16, 256
    batch = make_batch(torch, cfg, b, s, seed=3)
    reset_counts(kernels)
    logits = prefill(params, cfg, batch, cache)
    torch.cuda.synchronize()
    launched = counts(kernels)
    expect = {"mh_attention": 32, "flash_attention": 8, "matvec_int8": 1,
              "flash_attention_dq": 0, "flash_attention_dkv": 0}
    if launched != expect:
        raise AssertionError(f"prefill launches {launched} != {expect}")
    if logits.shape != (b, cfg.llm.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {logits.shape} not finite")
    for _ in range(warmup):
        prefill(params, cfg, batch, cache)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        prefill(params, cfg, batch, cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    fused_len = s + cfg.total_prefix_len
    result = dict(batch=b, seq=s, fused_len=fused_len,
                  step_ms_median=step_ms, step_ms_min=min(times) * 1e3,
                  step_ms_max=max(times) * 1e3,
                  examples_per_s=b / (step_ms / 1e3),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches=launched)
    log(json.dumps({"prefill": result}))
    return result, batch


def run_generate(torch, params, cfg, cache, batch, kernels, new=16, b=4):
    from macaw_llm_tpu_torch.generate import generate
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.utils import quantize as qz
    params = dict(params, llm=qz.pack_llama_for_decode(params["llm"]))
    with torch.inference_mode():
        sub = {k: v[:b] for k, v in batch.items()}
        fused = fusion.prepare_inputs(
            params, cfg, input_ids=sub["input_ids"], images=sub["images"],
            audios=sub["audios"], videos=sub["videos"],
            attention_mask=sub["attention_mask"], align_cache=cache)

    def run(n=new):
        out = generate(params["llm"], cfg.llm,
                       inputs_embeds=fused.inputs_embeds,
                       attention_mask=fused.attention_mask,
                       max_new_tokens=n, eos_id=-1)
        torch.cuda.synchronize()
        return out

    reset_counts(kernels)
    out = run()
    launched = counts(kernels)
    per_step = 4 * cfg.llm.num_layers + 1
    expect = {"mh_attention": 0, "flash_attention": 0,
              "matvec_int8": 1 + (new - 1) * per_step,
              "flash_attention_dq": 0, "flash_attention_dkv": 0}
    if launched != expect:
        raise AssertionError(f"decode launches {launched} != {expect}")
    toks = out.tokens
    if toks.shape != (b, new) or out.num_steps != new or not bool(
            ((toks >= 0) & (toks < cfg.llm.vocab_size)).all()):
        raise AssertionError(f"decode tokens out of range: {toks}")
    t0 = time.perf_counter()
    again = run()
    seconds = time.perf_counter() - t0
    if not torch.equal(again.tokens, toks):
        raise AssertionError("greedy decode is not deterministic")
    t0 = time.perf_counter()
    run(1)  # the prompt pass and the first token alone
    first_s = time.perf_counter() - t0
    result = dict(requests=b, new_tokens=new,
                  prompt_len=fused.inputs_embeds.shape[1],
                  seconds=seconds, tokens_per_s=b * new / seconds,
                  first_token_s=first_s,
                  decode_step_ms=(seconds - first_s) / (new - 1) * 1e3,
                  matvec_per_step=per_step, launches=launched,
                  first_tokens=toks[:, :4].tolist())
    log(json.dumps({"decode": result}))
    return result, params, fused


def train_batch(torch, cfg, a: int, b: int, s: int, seed: int):
    """bench.py's train batch: random ids (BOS first), labels = ids with
    the first 8 ignored, an all-ones mask, uint8 frames, 30 s of audio;
    a leading grad-accumulation axis of ``a``."""
    one = [make_batch(torch, cfg, b, s, seed + i) for i in range(a)]
    batch = {k: torch.stack([x[k] for x in one]) for k in one[0]}
    labels = batch["input_ids"].clone()
    labels[..., :8] = -100
    batch["labels"] = labels
    return batch


def train_cfg(torch, cfg7, layers=None, dropout=0.1):
    """bench.py's 7b train profile: bf16 compute, remat, loss_chunk 256;
    ``layers`` cuts the depth of every stack."""
    cfg = dataclasses.replace(
        cfg7, dtype="bfloat16", remat=True, loss_chunk=256,
        fusion=dataclasses.replace(cfg7.fusion, align_dropout=dropout))
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, num_layers=layers),
            vision=dataclasses.replace(cfg.vision, num_layers=layers),
            audio=dataclasses.replace(cfg.audio, encoder_layers=layers))
    return cfg


def small_train_parity(torch, cfg7, kernels):
    """One QLoRA loss + backward of a 2-layer model at 7b widths (batch 1,
    dropout off, int8 base and align cache, remat, chunked loss): the card
    (kernels) against the CPU (plain versions), same bf16 weights and
    batch, at text 256 (fused 312: mh_attention, its plain backward) and
    text 1024 (fused 1080: flash forward, dq, dk/dv)."""
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.train.lora import init_lora
    from macaw_llm_tpu_torch.train.state import merge_params, split_params
    from macaw_llm_tpu_torch.utils import quantize as qz
    cfg = train_cfg(torch, cfg7, layers=2, dropout=0.0)
    params = fusion.init_params(5, cfg, dtype=torch.bfloat16, device="cuda")
    cache = fusion.precompute_align_cache(params, cfg, quantize=True)
    params["llm"] = qz.quantize_llama(params["llm"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    lora = init_lora(gen, cfg.llm, 8)
    # B nonzero, so that every adapter leaf takes a gradient
    for key in ("qb", "vb"):
        lora[key] = torch.randn(lora[key].shape, generator=gen,
                                device="cuda") * 0.01
    params["llm"]["layers"]["lora"] = lora
    trainable, frozen = split_params(params, True, lora=True)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items()
                    for x in leaves(v, f"{prefix}/{k}")]
        return [(prefix, tree)]

    def fresh(tree, device):
        """Leaves of their own on ``device`` that take a gradient."""
        if isinstance(tree, dict):
            return {k: fresh(v, device) for k, v in tree.items()}
        return tree.detach().to(device).requires_grad_()

    def loss_and_grads(device, batch):
        tr = fresh(trainable, device)
        loss, _ = fusion.forward(
            merge_params(tr, to_device(frozen, device)), cfg,
            input_ids=batch["input_ids"], images=batch["images"],
            audios=batch["audios"], videos=batch["videos"],
            attention_mask=batch["attention_mask"], labels=batch["labels"],
            lora_scale=2.0, align_cache=to_device(cache, device))
        loss.backward()
        # a leaf the loss does not reach (bias_k/bias_v behind the cache)
        # has no gradient: zeros, as the trainer takes it
        return loss.float().item(), {
            k: t.grad if t.grad is not None else torch.zeros_like(t)
            for k, t in leaves(tr)}

    # text, expected launches (2 layers: forward and remat recompute;
    # Whisper 2 layers; the video-long attention, which trains)
    expects = {256: {"mh_attention": 4, "flash_attention": 3,
                     "flash_attention_dq": 1, "flash_attention_dkv": 1,
                     "matvec_int8": 0},
               1024: {"mh_attention": 0, "flash_attention": 7,
                      "flash_attention_dq": 3, "flash_attention_dkv": 3,
                      "matvec_int8": 0}}
    results = {}
    for text, expect in expects.items():
        batch = {k: v[0] for k, v in
                 train_batch(torch, cfg, 1, 1, text, seed=7).items()}
        reset_counts(kernels)
        gpu_loss, gpu_grads = loss_and_grads("cuda", batch)
        torch.cuda.synchronize()
        launched = counts(kernels)
        if launched != expect:
            raise AssertionError(f"2-layer train step at text {text}: "
                                 f"launches {launched} != {expect}")
        t0 = time.perf_counter()
        cpu_loss, cpu_grads = loss_and_grads("cpu", to_device(batch, "cpu"))
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
        grad_rel, zero_leaves = {}, []
        for key, ref in cpu_grads.items():
            got = gpu_grads[key].float().cpu()
            ref = ref.float()
            scale = ref.abs().max().item()
            if scale == 0.0:  # the frozen-by-cache align K/V rows
                zero_leaves.append(key)
                if got.abs().max().item() != 0.0:
                    raise AssertionError(f"{key}: zero on the CPU, not on "
                                         "the card")
                continue
            grad_rel[key] = (got - ref).abs().max().item() / scale
        worst = max(grad_rel, key=grad_rel.get)
        result = dict(text=text, fused_len=batch["input_ids"].shape[1]
                      + cfg.total_prefix_len, gpu_loss=gpu_loss,
                      cpu_loss=cpu_loss, loss_rel_err=loss_rel,
                      max_grad_rel_err=grad_rel[worst], worst_leaf=worst,
                      grad_rel_err=grad_rel, leaves_zero_on_both=len(
                          zero_leaves), cpu_seconds=cpu_s, launches=launched)
        log(json.dumps({"small_train_parity": result}))
        if not (loss_rel <= TRAIN_LOSS_REL_TOL
                and grad_rel[worst] <= TRAIN_GRAD_REL_TOL):
            raise AssertionError(f"2-layer train parity at text {text} "
                                 f"failed: loss {loss_rel}, {worst} "
                                 f"{grad_rel[worst]}")
        results[text] = result
    return results


def run_train(torch, cfg7, kernels, card: str, do_profile: bool,
              out_dir: Path):
    """bench.py --mode train --profile 7b: QLoRA r=8 over the int8 base at
    full width and depth, batch 8, at text 1024 then 256."""
    from macaw_llm_tpu_torch.config import TrainConfig
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.train.lora import init_lora
    from macaw_llm_tpu_torch.train.trainer import Trainer
    cfg = train_cfg(torch, cfg7)
    tcfg = TrainConfig(grad_accum_steps=1, freeze_encoders=True, lora_rank=8,
                       quantize_base=True, grad_dtype="float32",
                       mu_dtype="float32")
    t0 = time.perf_counter()
    params = fusion.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    params["llm"]["layers"]["lora"] = init_lora(
        torch.Generator(device="cuda").manual_seed(1), cfg.llm, 8)
    trainer = Trainer(cfg, tcfg, total_steps=1000)
    state = trainer.init_state(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    n_llm = sum(t.numel() for t in (
        [x for x in _tensors(state.frozen["llm"])]
        + [x for x in _tensors(state.trainable["llm"])]))
    results = {}
    # text, warm-up steps, timed steps, expected launches per step
    plan = ((1024, 2, 5, {"mh_attention": 0, "flash_attention": 70,
                          "flash_attention_dq": 32,
                          "flash_attention_dkv": 32, "matvec_int8": 0}),
            (256, 2, 3, {"mh_attention": 64, "flash_attention": 6,
                         "flash_attention_dq": 0, "flash_attention_dkv": 0,
                         "matvec_int8": 0}))
    for text, warm, timed, expect in plan:
        b = 8
        batch = train_batch(torch, cfg, 1, b, text, seed=11)
        fused = text + cfg.total_prefix_len
        steps = []
        for i in range(warm + timed):
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            t1 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launched = counts(kernels)
            if launched != expect:
                raise AssertionError(f"train step at text {text}: launches "
                                     f"{launched} != {expect}")
            step = dict(text=text, step=i, warmup=i < warm, step_ms=dt * 1e3,
                        tokens_per_s=b * fused / dt,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                        loss=loss, grad_norm=float(metrics["grad_norm"]),
                        lr=metrics["lr"])
            log(json.dumps({"train_step": step}))
            steps.append(step)
        losses = [st["loss"] for st in steps]
        if not all(map(math.isfinite, losses)) or losses[-1] > 1.5 * losses[0]:
            raise AssertionError(f"train losses at text {text}: {losses}")
        times = [st["step_ms"] for st in steps[warm:]]
        step_ms = statistics.median(times)
        flop_share = (LORA_FLOPS_PER_PARAM_TOKEN * n_llm * b * fused
                      / (step_ms / 1e3) / PEAK_BF16_FLOPS)
        result = dict(text=text, batch=b, fused_len=fused,
                      step_ms_median=step_ms, step_ms_min=min(times),
                      step_ms_max=max(times),
                      tokens_per_s=b * fused / (step_ms / 1e3),
                      peak_mem_gb=max(st["peak_mem_gb"] for st in steps),
                      first_loss=losses[0], last_loss=losses[-1],
                      llm_flop_share_estimate=flop_share, n_llm=n_llm,
                      launches_per_step=expect, card=card)
        log(json.dumps({"train": result}))
        results[text] = result
        if do_profile and text == 1024:
            profile(torch, "train1024", lambda: trainer.train_step(
                state, batch), out_dir)
    log(json.dumps({"train_init_seconds": init_s}))
    return results


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    return [tree]


def profile(torch, name: str, fn, out_dir: Path) -> None:
    """torch.profiler table (device time by kernel) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(table)
    log(f"== profile {name}\n{table}")


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one prefill "
                         "and of decode (written to chiprun_out/)")
    args = ap.parse_args()
    out_dir = ROOT / "chiprun_out"
    if not (ROOT / "macaw_llm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from macaw_llm_tpu_torch.config import macaw_7b
    from macaw_llm_tpu_torch.ops.kernels import _build
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh

    t_start = time.perf_counter()
    # 1. build
    info = _build.build()
    log(f"kernel build: {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if line.startswith("==") or re.search(r"registers|spill", line):
            log("  " + line.strip())
    _build.library()

    # 2. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    device = torch.cuda.get_device_name(0)

    kernels = {"mh_attention": mh.mh_attention,
               "flash_attention": fa.flash_attention_with_lse,
               "flash_attention_dq": fa.flash_attention_dq,
               "flash_attention_dkv": fa.flash_attention_dkv,
               "matvec_int8": mv.matvec_int8}

    # 3. kernels vs plain at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_attention(torch, mh, fa, gen)
    checks.update(check_matvec(torch, mv, gen))
    # 3b. the backward kernels (and the forward at their inputs)
    bwd = check_backward(torch, fa, gen)
    checks["flash_attention"] += bwd.pop("flash_attention")
    checks.update(bwd)
    for name, rows in checks.items():
        for row in rows:
            log(json.dumps({"kernel_check": name, **row}))
    torch.cuda.empty_cache()

    # 4. 2-layer model at 7b widths: card vs CPU
    cfg = macaw_7b()
    small_model_parity(torch, cfg, kernels)
    torch.cuda.empty_cache()
    # 4b. 2-layer QLoRA train step at 7b widths: card vs CPU
    small_train_parity(torch, cfg, kernels)
    torch.cuda.empty_cache()

    # 5. full 7b prefill
    params, cache, build_s = build_7b(torch, cfg)
    log(json.dumps({"build_7b_seconds": build_s}))
    prefill_res, batch = run_prefill(torch, params, cfg, cache, kernels)
    main_launches = dict(prefill_res["launches"])
    if args.profile:
        from macaw_llm_tpu_torch.prefill import prefill
        profile(torch, "prefill", lambda: prefill(
            params, cfg, batch, cache), out_dir)

    # 6. greedy decode
    decode_res, params, fused = run_generate(torch, params, cfg, cache,
                                             batch, kernels)
    main_launches["matvec_int8"] = decode_res["launches"]["matvec_int8"]
    if args.profile:
        from macaw_llm_tpu_torch.generate import generate
        for n in (1, 4):  # the difference is three decode steps
            profile(torch, f"generate{n}", lambda: generate(
                params["llm"], cfg.llm, inputs_embeds=fused.inputs_embeds,
                attention_mask=fused.attention_mask, max_new_tokens=n,
                eos_id=-1), out_dir)

    # 7. release the serving weights
    del params, cache, batch, fused
    torch.cuda.empty_cache()

    # 8. the 7b QLoRA train step
    train_res = run_train(torch, cfg, kernels, card, args.profile, out_dir)
    train_launches = {name: n for text in (256, 1024) for name, n in
                      train_res[text]["launches_per_step"].items() if n}

    # 9. the kernels line: per prefill (B1, B2), per decode step (B5) or
    # per train step at text 1024 (B3, B4)
    sources = {
        "mh_attention": ("macaw_llm_tpu_torch/csrc/mh_attention.cu",
                         "macaw_llm_tpu/ops/pallas/mh_attention.py:147"),
        "flash_attention": ("macaw_llm_tpu_torch/csrc/flash_attention.cu",
                            "macaw_llm_tpu/ops/pallas/flash_attention.py:188"),
        "flash_attention_dq": (
            "macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:366"),
        "flash_attention_dkv": (
            "macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:413"),
        "matvec_int8": ("macaw_llm_tpu_torch/csrc/matvec.cu",
                        "macaw_llm_tpu/ops/pallas/matvec.py:79"),
    }
    entries = []
    for name, rows in checks.items():
        if name.startswith("flash_attention_d"):
            row = rows[0]  # the train shape, 32 launches per train step
            entries.append({
                "name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1],
                "launches": train_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["kernel_ms"] * row["per_step"],
                "plain_ms": row["plain_ms"] * row["per_step"],
                "bound_ms": row["bound_ms"] * row["per_step"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"] * row["per_step"],
                "work": "one 7b train step at text 1024 (plain and library: "
                        "the whole backward, dq, dk and dv together)",
                "train_step_launches": train_launches[name]})
            continue
        per = "per_step" if name == "matvec_int8" else "per_prefill"
        timed = [r for r in rows if r[per]]

        def total(key):
            return sum(r[key] * r[per] for r in timed)

        lib = None if timed[0]["library_ms"] is None else total("library_ms")
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(timed, key=lambda r: r["bound_ms"] * r[per]
                            )["bound_by"],
            "library_ms": lib,
            "work": ("one decode step" if name == "matvec_int8"
                     else "one prefill"),
            "train_step_launches": train_launches.get(name, 0),
        }
        train = [r for r in rows if r.get("call") == "llama_train"]
        if train:  # B2's 64 LLaMA launches of a train step at text 1024
            r = train[0]
            entry["train_step_llama"] = {
                key: r[key] * r["per_step"] for key in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
            entry["train_step_llama"].update(launches=r["per_step"],
                                             bound_by=r["bound_by"])
        entries.append(entry)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"card": card, "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
