"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Phases, in order (any failure raises and the script exits non-zero):
 1. build the CUDA kernels from ``macaw_llm_tpu_torch/csrc`` (nvcc, sm_90a);
 2. print the card's name and power limit (nvidia-smi);
 3. hold each forward kernel against its plain PyTorch version at the
    main-path shapes of the 7b profile (B2 also at the batch-1 shapes of an
    engine admission, where it splits the keys into chunks and launches
    its combine kernel, and with every key outside one chunk masked) and
    time kernel, plain version, the library call that computes the same
    function (where one exists) and the bound;
 3a. the int8 matvec (B5) against its plain version at the five 7b
    decode shapes and two ragged ones (N no multiple of 16, K no multiple
    of 64) at 4, 16 and 32 rows, bitwise on a rerun; timed at the 7b
    shapes by device time (a CUDA graph of the wrapper's launches, each
    call's weight one of >= 128 MB of distinct copies) beside the
    back-to-back event time, the plain version, the byte bound and, at 4
    rows, the library call;
 3c. the pipelined matvec (B6) at the same shapes, at 9, 16 and 32 rows and
    depths 1, 2, 4 and 8 (bitwise equal across depths and runs, within one
    bf16 ulp of B5), timed the same way at 16 and 32 rows at every depth,
    with B5, the fp32 FMA bound and the library call beside it;
 3b. the same for the backward kernels (delta, flash dq, flash dk/dv) at
    the 7b train shape and at the edge cases (ragged tail, a fully masked
    batch row, an LSE cotangent, head dims 64 and 256), after holding the
    flash forward that feeds them against its plain version in every case
    and timing it at the train shape; at the train shape the gradients
    must be the same bits on a rerun, and the whole CUDA backward (delta,
    dq, dk/dv) is timed beside SDPA's backward (phase 1 fails if ptxas
    reports a spill in a D = 128 backward kernel);
 4. a 2-layer model at 7b widths (batch 2, seq 256) on the card with the
    kernels against the same weights on the CPU with the plain versions;
 4b. a 2-layer QLoRA train step at 7b widths (loss and the trainable
    leaves' gradients), card against CPU, at text 256 and text 1024;
 4c. a 2-layer continuous-batching engine at 7b widths (16 slots, int8
    weights, int8 KV, int8 alignment cache): the same 6 greedy requests on
    the card and on the CPU;
 5. the full-width 7b fused prefill, batch 16, seq 256 (fused length 312),
    int8 W8A8 LLaMA, int8 alignment cache, packed towers;
 6. greedy decode of 4 requests, 16 new tokens, int8 packed weights, bf16
    KV cache; then one sampled call, one with the int8 KV cache, and a
    beam search of 2 requests x 4 beams x 8 tokens, each run twice;
 6b. the 7b continuous-batching engine (int8 packed weights, int8 KV, int8
    alignment cache, prompt bucket 64): one warm-up, then 64 concurrent
    streamed requests (56 text-only, 8 with image + audio + video, 2 of
    those sampled at temperature 0.8) of 64 tokens at 16 slots, then 64 of
    32 tokens at 32 slots; served and steady tokens/s, TTFT and ITL;
 7. release the serving weights;
 8. the 7b QLoRA r=8 train step at full width and depth, batch 8, at text
    1024 (fused length 1080: 2 warm-up + 5 timed steps) and text 256
    (fused 312: 2 + 3): int8 frozen base, frozen towers and int8 alignment
    cache, remat, chunked loss, alignment dropout 0.1, AdamW with a cosine
    schedule over 1000 steps;
 10. the 1b full fine-tune through the command-line entry points, on a
    copy of ``bench_artifacts/train_1b_chip.json`` (b8, text 256, fused
    312, fp32 masters, bf16 grads and Adam m, frozen bf16 towers, remat,
    chunked loss; synthetic zero-media batches): 10a ``run_train.main``,
    2 warm-up + 5 timed steps (launches asserted per step), --do-eval and
    the forced final save; 10b ``run_inference.restore_params`` of that
    checkpoint (bit for bit against the state in memory) and 8 x 16 greedy
    tokens from it, the same as from the state in memory; 10c at 2 layers
    a stack, 4 steps straight against 2 steps stopped by SIGTERM and a
    resume to 4 (the restored state bit for bit, steps 3-4's losses within
    1e-3); the checkpoints are deleted when the phase ends;
 11. one ``{"kernels": [...]}`` line, then the contract line
    ``{"ok": true, "device": {...}}`` last.

Weights are random, made on the card from a seed. Usage, from the root of
a checkout:  python3 chip_smoke.py [--profile]
(--profile adds torch.profiler tables of one prefill, of greedy decode
with 1 and 4 new tokens, of 20 engine decode steps at 16 slots (with the
device's idle share of a step), of one train step at text 1024 and of one
more (untimed) loop iteration of the 1b run, with its device busy time,
written to chiprun_out/.) Every line the script logs is also kept in
chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores: an FMA per weight and row
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
# delta = rowsum(dO * O) in fp32: the kernel and the plain version add the
# same D exact products in another order, within D * 2^-24 of the row's
# sum of |products|; 1e-5 of max |delta| covers D = 256.
DELTA_REL_TOL = 1e-5

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


LOG_FILE = None  # main() opens chiprun_out/chip_smoke.log


def log(*args) -> None:
    """Print a line, and keep it in the run's log file: a caller that shows
    only the end of the output still finds every line there."""
    print(*args, flush=True)
    if LOG_FILE is not None:
        print(*args, file=LOG_FILE, flush=True)


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


def kernel_resources(build_log: str) -> dict:
    """ptxas registers and spill bytes per attention or matvec kernel of an
    ``nvcc -Xptxas -v`` log, keyed by the kernel's name and template
    arguments (``flash_bwd_dq_wgmma<128>``, ``matvec_wgmma<32,1>``: rows,
    TMA path)."""
    res, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            k = re.search(r"((?:flash_bwd|flash_fwd|mh_attention|matvec)_"
                          r"[a-z_]+?)(?:I((?:L[ib]\d+E)+)E|E)", name)
            if k:
                args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
            res[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            res[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name]["registers"] = int(m.group(1))
            name = None
    return res


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

# B2's calls: name, B, Sq, Sk, N, D, launches per prefill (batch 16),
# launches per media admission of the engine (batch 1)
FLASH_CALLS = (("whisper", 16, 1500, 1500, 8, 64, 6, 0),
               ("video_long", 16, 1176, 1178, 8, 64, 1, 0),
               ("video_align", 16, 624, 32009, 1, 256, 1, 0),
               ("engine_whisper", 1, 1500, 1500, 8, 64, 0, 6),
               ("engine_video_long", 1, 1176, 1178, 8, 64, 0, 1))


def whisper(b):
    return (b, 1500, 1500, 8, 64, False)


def video_long(b):
    return (b, 1176, 1178, 8, 64, False)


def video_align(b):  # the alignment fold: heads as batch, 39 rows a sample
    return (16, 39 * b, 32009, 1, 256, False)


def llama(b, s):
    return (b, s, s, 32, 128, True)


def combines(torch, calls) -> int:
    """Combine launches of B2 over ``calls`` [(shape, count)] on this card:
    one for every call whose keys ``split_plan`` cuts into chunks."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(cnt for shape, cnt in calls
               if len(fa.split_plan(*shape, sms)) > 1)


def check_attention(torch, mh, fa, gen, sms: int):
    """mh_attention at the LLaMA prefill shape; flash_attention at the
    Whisper, video-long and video-alignment shapes (batch 16) and at the
    engine's batch-1 Whisper and video-long shapes, where it splits the
    keys and launches its combine kernel; the combine alone, timed at the
    video alignment, and held with every key outside one chunk masked."""
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
    # the same inputs with only the keys of the last, partial 64-key tile
    # (the kernel's tile width) left valid
    tail = tail_bias(torch, b, s, 64)
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

    rows, combine_rows = [], []
    for name, bb, sq, sk, n, d, per, per_adm in FLASH_CALLS:
        chunks = fa.split_plan(bb, sq, sk, n, d, False, sms)
        q, k, v = rn(bb, sq, n, d), rn(bb, sk, n, d), rn(bb, sk, n, d)
        c0 = fa.flash_attention_combine.launches
        out, lse = fa.flash_attention_with_lse(q, k, v, None, causal=False)
        torch.cuda.synchronize()
        if fa.flash_attention_combine.launches - c0 != (len(chunks) > 1):
            raise AssertionError(f"flash_attention {name}: {len(chunks)} "
                                 "chunks, combine launches "
                                 f"{fa.flash_attention_combine.launches - c0}")
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
        split_rel = None
        if len(chunks) > 1:  # the plain version of the split itself
            s_out, s_lse = fa.split_attention_reference(
                q, k, v, None, causal=False, chunks=chunks)
            split_rel = row_rel_err(out, s_out)
            lse_err = max(lse_err, (lse - s_lse).abs().max().item())
            del s_out, s_lse
        if not (rel <= ATTN_ROW_REL_TOL and tail_rel <= ATTN_ROW_REL_TOL
                and lse_err <= LSE_TOL
                and (split_rel or 0.0) <= ATTN_ROW_REL_TOL):
            raise AssertionError(f"flash_attention {name}: row rel err "
                                 f"{rel}, ragged tail {tail_rel}, split "
                                 f"plain {split_rel}, lse err {lse_err}")
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
                         shape_kv=[bb, sk, n, d], chunks=len(chunks),
                         max_abs_err=err, row_rel_err=rel,
                         tail_row_rel_err=tail_rel,
                         split_row_rel_err=split_rel,
                         lse_err=lse_err, kernel_ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by,
                         per_prefill=per, per_admission=per_adm))
        del qt, kt, vt
        if name == "video_align":
            combine_rows += check_combine(torch, fa, q, k, v, chunks)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    results["flash_attention"] = rows
    results["flash_attention_combine"] = combine_rows
    return results


def check_combine(torch, fa, q, k, v, chunks):
    """The combine kernel at the video alignment: every key outside one
    chunk masked (the other chunks' partials carry weight 0), against
    both plain versions; then the combine alone on that call's partials,
    against its plain version, timed with its byte bound."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    k0, k1 = chunks[len(chunks) // 2]
    bias = torch.full((b, sk), torch.finfo(torch.float32).min, device="cuda")
    bias[:, k0:k1] = 0.0
    out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=False)
    ref, ref_lse = fa.attention_reference(q, k, v, bias, causal=False)
    s_out, s_lse = fa.split_attention_reference(q, k, v, bias, causal=False,
                                                chunks=chunks)
    rel, split_rel = row_rel_err(out, ref), row_rel_err(out, s_out)
    lse_err = max((lse - ref_lse).abs().max().item(),
                  (lse - s_lse).abs().max().item())
    del ref, ref_lse, s_out, s_lse
    # the partials of the unmasked call, made by the plain per-chunk version
    parts = [fa.chunk_reference(q, k, v, None, causal=False, scale=d ** -0.5,
                                k0=c0, k1=c1) for c0, c1 in chunks]
    part_o = torch.stack([o for o, _ in parts]).contiguous()
    part_lse = torch.stack([x for _, x in parts]).contiguous()
    del parts
    got, got_lse = fa.flash_attention_combine(part_o, part_lse)
    want, want_lse = fa.combine_reference(part_o, part_lse, torch.bfloat16)
    c_rel = row_rel_err(got, want)
    c_err = (got.float() - want.float()).abs().max().item()
    c_lse = (got_lse - want_lse).abs().max().item()
    if not (rel <= ATTN_ROW_REL_TOL and split_rel <= ATTN_ROW_REL_TOL
            and lse_err <= LSE_TOL and c_rel <= ATTN_ROW_REL_TOL
            and c_lse <= LSE_TOL):
        raise AssertionError(
            f"flash_attention one live chunk: row rel err {rel}, split "
            f"plain {split_rel}, lse err {lse_err}; combine alone: row rel "
            f"err {c_rel}, lse err {c_lse}")
    ms = cuda_ms(torch, lambda: fa.flash_attention_combine(part_o,
                                                           part_lse), 20)
    plain = cuda_ms(torch, lambda: fa.combine_reference(
        part_o, part_lse, torch.bfloat16), 5)
    # reads every partial once, writes out (bf16) and lse; an exp and two
    # FMAs per chunk and column are far below the tensor-core line
    nbytes = part_o.numel() * 4 + part_lse.numel() * 4 \
        + b * sq * n * (d * 2 + 4)
    bms, by = bound(0.0, nbytes)
    del part_o, part_lse, out, lse, got, want, bias
    return [dict(call="video_align", chunks=len(chunks),
                 shape_q=[b, sq, n, d], shape_kv=[b, sk, n, d],
                 one_live_chunk=[k0, k1], row_rel_err=rel,
                 split_row_rel_err=split_rel, lse_err=lse_err,
                 combine_row_rel_err=c_rel, max_abs_err=c_err,
                 combine_lse_err=c_lse, kernel_ms=ms, plain_ms=plain,
                 library_ms=None, bound_ms=bms, bound_by=by, per_prefill=1,
                 per_admission=0)]


# --------------------------------------------------------------------------
# phase 3b: the backward kernels against the plain backward
# --------------------------------------------------------------------------

def check_backward(torch, fa, gen):
    """delta, B3 and B4 at the 7b train shape (batch 8, fused length 1080,
    32 heads of 128, causal, all-ones mask) and at the edge cases. The
    forward (B2) that gives both sides their output and LSE is held against
    its plain version first in every case, and timed at the train shape;
    at the train shape the three gradients must also be the same bits on a
    second run, and the whole CUDA backward (delta, B3, B4) is timed beside
    SDPA's backward."""
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
            "flash_attention_delta": [], "flash_attention": []}
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
        delta = fa.flash_attention_delta(out, g, g_lse)
        ref_delta = fa.backward_delta(out, g, g_lse)
        delta_err = (delta - ref_delta).abs().max().item()
        delta_rel = delta_err / ref_delta.abs().max().item()
        kw = dict(causal=causal, scale=d ** -0.5)

        def grads():
            dq = fa.flash_attention_dq(q, k, v, bias, g, lse, delta, **kw)
            dk, dv = fa.flash_attention_dkv(q, k, v, bias, g, lse, delta,
                                            **kw)
            return dq, dk, dv

        dq, dk, dv = grads()
        torch.cuda.synchronize()
        same = None
        if name == "train":  # no atomics, a fixed order of sums
            same = all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                         grads()))
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
        if bad or not zero_ok or same is False or \
                not delta_rel <= DELTA_REL_TOL:
            raise AssertionError(f"flash backward {name}: row errors {errs}, "
                                 f"masked row exactly zero: {zero_ok}, "
                                 f"bitwise equal on a second run: {same}, "
                                 f"delta rel err {delta_rel}")
        del ref, ref_delta
        case = dict(case=name, shape_q=[b, sq, n, d], shape_kv=[b, sk, n, d],
                    causal=causal, lse_cotangent=lse_grad,
                    masked_row_zero=zero_ok if kind == "row0" else None,
                    bitwise_equal_rerun=same)
        rows["flash_attention_dq"].append(dict(
            case, row_rel_err=errs["dq"][0], max_abs_err=errs["dq"][1]))
        rows["flash_attention_dkv"].append(dict(
            case, row_rel_err=max(errs["dk"][0], errs["dv"][0]),
            max_abs_err=max(errs["dk"][1], errs["dv"][1])))
        rows["flash_attention_delta"].append(dict(
            case, rel_err=delta_rel, max_abs_err=delta_err))
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
            ms_delta = cuda_ms(torch, lambda: fa.flash_attention_delta(
                out, g), 20)
            plain_delta = cuda_ms(torch, lambda: fa.backward_delta(out, g),
                                  10)
            ms_dq = cuda_ms(torch, lambda: fa.flash_attention_dq(
                q, k, v, bias, g, lse, delta, **kw), 20)
            ms_dkv = cuda_ms(torch, lambda: fa.flash_attention_dkv(
                q, k, v, bias, g, lse, delta, **kw), 20)

            def whole():  # what _FlashAttention.backward launches
                dl = fa.flash_attention_delta(out, g)
                fa.flash_attention_dq(q, k, v, bias, g, lse, dl, **kw)
                fa.flash_attention_dkv(q, k, v, bias, g, lse, dl, **kw)

            ms_whole = cuda_ms(torch, whole, 20)
            plain = cuda_ms(torch, lambda: fa.attention_backward_reference(
                q, k, v, bias, lse, g, delta, **kw), 3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
            gt = g.transpose(1, 2)
            lib = cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), gt, retain_graph=True), 20)
            # dq: S, dP and dS K (3 products); dk/dv: S, P^T dO, dP and
            # dS^T Q (4): 2 * D FLOPs each per (query, key) pair and head;
            # delta reads O and dO and writes one fp32 per row
            b3 = bound(3 * 2 * b * n * d * pairs, nbytes_in + q.numel() * 2)
            b4 = bound(4 * 2 * b * n * d * pairs,
                       nbytes_in + 2 * k.numel() * 2)
            bd = bound(2 * b * n * sq * d, 2 * out.numel() * 2
                       + b * n * sq * 4)
            timing = {"flash_attention_dq": (ms_dq, b3, plain, lib),
                      "flash_attention_dkv": (ms_dkv, b4, plain, lib),
                      "flash_attention_delta": (ms_delta, bd, plain_delta,
                                                None)}
            log(json.dumps({"backward_timing": dict(
                shape=[b, sq, n, d], causal=True, delta_ms=ms_delta,
                dq_ms=ms_dq, dkv_ms=ms_dkv, whole_cuda_backward_ms=ms_whole,
                sdpa_backward_ms=lib, plain_backward_ms=plain,
                plain_delta_ms=plain_delta,
                bound_ms=b3[0] + b4[0] + bd[0])}))
            del qt, kt, vt, lib_out, gt
        rows["flash_attention"].append(fwd)
        del q, k, v, g, out, lse, delta, dq, dk, dv, bias
        torch.cuda.empty_cache()
    results = {"flash_attention": rows.pop("flash_attention")}
    for kname, krows in rows.items():
        ms, (bms, by), plain, lib = timing[kname]
        krows[0].update(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                        bound_ms=bms, bound_by=by, per_step=32)
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


def graph_ms(torch, fn, n: int, replays: int = 5) -> float:
    """Device time (ms) per call of ``fn``: ``n`` calls captured in one
    CUDA graph, the graph replayed, CUDA events around the replays. Unlike
    ``cuda_ms`` over back-to-back wrapper calls, the host's issue time of a
    call (tens of us) does not enter: a call under about 60 us is timed
    here and not by its issue."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n)


# ragged shapes beside the 7b ones: N no multiple of 16 (the cp.async
# path), K no multiple of the kernel's 64-row k tile
RAGGED_MATVECS = (("ragged", 352, 250, 0), ("ragged_k", 1000, 520, 0))
MATVEC_ROWS = (4, 16, 32)  # generate's batch 4; the engine's 16 and 32


def matvec_weights(torch, gen, k: int, n: int, per: int):
    """Distinct int8 weights of >= 128 MB (one for a ragged shape), so that
    no timed call finds its weight in the 50 MB L2, as in decode, where
    every layer streams its own; their scale; a cycling call maker."""
    copies = max(1, -(-(128 << 20) // (k * n))) if per else 1
    ws = [torch.randint(-127, 128, (k, n), generator=gen,
                        device="cuda").to(torch.int8)
          for _ in range(copies)]
    s = torch.rand(1, n, generator=gen, device="cuda") * 0.01
    i = [0]

    def cycle(fn):
        def call():
            i[0] = (i[0] + 1) % copies
            return fn(ws[i[0]])
        return call
    return ws, s, cycle


def matvec_times(torch, mv, fn, x, ws, s, cycle, ref, library: bool):
    """A matvec's times at one shape and row count: device time per call
    (``kernel_ms``, a CUDA graph of 4 calls a weight copy, at least 8),
    the back-to-back event time that earlier rows report (``event_ms``),
    the plain version, the library call (where asked) and the byte
    bound."""
    b, k = x.shape
    n = ws[0].shape[1]
    iters = max(8, 4 * len(ws))
    row = {"kernel_ms": graph_ms(torch, cycle(fn), iters),
           "event_ms": cuda_ms(torch, cycle(fn), iters),
           "plain_ms": cuda_ms(torch, cycle(
               lambda w: mv.matvec_reference(x, w, s)), 2 * len(ws))}
    if library:
        lib, lib_err, lib_note = library_int8_mm(torch, x, ws, s, ref, cycle)
        row.update(library_ms=lib, library_rel_err=lib_err,
                   library_note=lib_note)
    bms, by = bound(2 * b * k * n, k * n + n * 4 + b * k * 2 + b * n * 2)
    row.update(bound_ms=bms, bound_by=by)
    return row


def check_matvec(torch, mv, gen):
    """matvec_int8 (B5) at every decode-step shape and two ragged ones, at
    4, 16 and 32 rows, against the plain version and bitwise on a rerun;
    timed at the 7b shapes (the library call at 4 rows, where ``generate``
    routes it)."""
    rows = []
    for name, k, n, per in DECODE_MATVECS + RAGGED_MATVECS:
        ws, s, cycle = matvec_weights(torch, gen, k, n, per)
        for b in MATVEC_ROWS:
            x = torch.randn(b, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            out = mv.matvec_int8(x, ws[0], s)
            again = mv.matvec_int8(x, ws[0], s)
            ref = mv.matvec_reference(x, ws[0], s).float()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            if not (rel <= MATVEC_REL_TOL and torch.equal(out, again)):
                raise AssertionError(f"matvec_int8 {name} at {b} rows: rel "
                                     f"err {rel}, rerun equal "
                                     f"{torch.equal(out, again)}")
            row = dict(call=name, shape=[b, k, n], max_abs_err=err,
                       rel_err=rel, per_step=per)
            if per:
                row.update(matvec_times(
                    torch, mv, lambda w: mv.matvec_int8(x, w, s), x, ws, s,
                    cycle, ref, library=b == 4))
            rows.append(row)
        del ws
        torch.cuda.empty_cache()
    return {"matvec_int8": rows}


# rows per engine step: (slots, depth) cases of B6; B5 beside it
PIPELINED_ROWS = (9, 16, 32)
PIPELINED_DEPTHS = (1, 2, 4, 8)
ULP_FLOOR = 2.0 ** -10


def check_matvec_pipelined(torch, mv, gen):
    """B6 at every decode-step shape and the ragged ones: each depth
    against the plain version at 9, 16 and 32 rows, bitwise equal across
    depths and on a second run, within one bf16 ulp of B5 at 16 rows (an
    output below 2^-10 of the largest, a sum that cancelled, is measured
    against that floor). Timed at 16 and 32 rows at every depth, with B5's
    device time beside it, cycling through >= 128 MB of distinct weights
    as ``check_matvec`` does."""
    rows = []
    for name, k, n, per in DECODE_MATVECS + RAGGED_MATVECS:
        ws, s, cycle = matvec_weights(torch, gen, k, n, per)
        for b in PIPELINED_ROWS:
            x = torch.randn(b, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            ref = mv.matvec_reference(x, ws[0], s).float()
            outs = [mv.matvec_int8_pipelined(x, ws[0], s, depth=d)
                    for d in PIPELINED_DEPTHS]
            again = mv.matvec_int8_pipelined(x, ws[0], s, depth=4)
            torch.cuda.synchronize()
            err = (outs[-1].float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            same = all(torch.equal(o, outs[0]) for o in outs) and \
                torch.equal(again, outs[0])
            if not (rel <= MATVEC_REL_TOL and same):
                raise AssertionError(
                    f"matvec_int8_pipelined {name} at {b} rows: rel err "
                    f"{rel}, bitwise equal across depths and runs: {same}")
            row = dict(call=name, shape=[b, k, n], max_abs_err=err,
                       rel_err=rel, bitwise_across_depths_and_runs=same,
                       per_step=per)
            if b == 16:
                b5 = mv.matvec_int8(x, ws[0], s).float()
                scale = b5.abs().clamp_min(ULP_FLOOR * b5.abs().max().item())
                ulp = ((outs[-1].float() - b5).abs() / scale).max().item()
                if not ulp <= 2.0 ** -7:
                    raise AssertionError(f"matvec_int8_pipelined {name}: "
                                         f"{ulp} from matvec_int8 (bar 2^-7)")
                row["rel_to_matvec_int8"] = ulp
            if per and b in (16, 32):
                row.update(matvec_times(
                    torch, mv,
                    lambda w: mv.matvec_int8_pipelined(x, w, s, depth=4),
                    x, ws, s, cycle, ref, library=True))
                iters = max(8, 4 * len(ws))
                for d in PIPELINED_DEPTHS:
                    row[f"kernel_ms_depth{d}"] = graph_ms(torch, cycle(
                        lambda w: mv.matvec_int8_pipelined(x, w, s, depth=d)),
                        iters)
                row["matvec_int8_ms"] = graph_ms(torch, cycle(
                    lambda w: mv.matvec_int8(x, w, s)), iters)
                row["fma_bound_ms"] = 2 * b * k * n / PEAK_FP32_FLOPS * 1e3
            rows.append(row)
        del ws
        torch.cuda.empty_cache()
    return {"matvec_int8_pipelined": rows}


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
    want_combine = combines(torch, ((whisper(2), 2), (video_long(2), 1)))
    if launched["mh_attention"] != 2 or launched["flash_attention"] != 3 \
            or launched["flash_attention_combine"] != want_combine:
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
    # the engine takes the tree before strip and pack (it builds its own
    # alignment cache); the two trees share every tensor they can
    full = params
    params = fusion.pack_towers(fusion.strip_align_kv(params))
    torch.cuda.synchronize()
    return params, cache, full, time.perf_counter() - t0


def run_prefill(torch, params, cfg, cache, kernels, steps=10, warmup=3):
    from macaw_llm_tpu_torch.prefill import prefill
    b, s = 16, 256
    batch = make_batch(torch, cfg, b, s, seed=3)
    reset_counts(kernels)
    logits = prefill(params, cfg, batch, cache)
    torch.cuda.synchronize()
    launched = counts(kernels)
    # the 16 last positions' logits are one single-row int8 matmul of 16
    # rows: the pipelined matvec
    expect = {"mh_attention": 32, "flash_attention": 8, "matvec_int8": 0,
              "flash_attention_combine": combines(torch, (
                  (whisper(b), 6), (video_long(b), 1), (video_align(b), 1))),
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "flash_attention_delta": 0,
              "matvec_int8_pipelined": 1}
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
              "flash_attention_combine": 0,
              "matvec_int8": 1 + (new - 1) * per_step,
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "flash_attention_delta": 0,
              "matvec_int8_pipelined": 0}
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


# --------------------------------------------------------------------------
# phases 4c, 6, 6b: the rest of decode and the server
# --------------------------------------------------------------------------

class BenchTok:
    """Stand-in tokenizer (bench.py's, with a hash that does not change
    from process to process): 41 tokens per prompt."""

    def encode(self, text):
        h = zlib.crc32(text.encode())
        return [1] + [16 + (h + 37 * i) % 31000 for i in range(40)]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def engine_media(cfg, seed: int):
    """One request's image, 30 s of audio and video frames from a seed."""
    import numpy as np
    rng = np.random.RandomState(seed)
    size = cfg.vision.image_size
    return dict(
        image=rng.randint(0, 255, (size, size, 3)).astype(np.uint8),
        audio=(rng.randn(cfg.audio.n_audio_samples) * 0.1).astype(np.float32),
        video=rng.randint(0, 255, (cfg.fusion.n_frames, size, size, 3)
                          ).astype(np.uint8))


def serve_all(engine, requests, timeout: float = 900.0):
    """Submit every request at once, each from its own thread. Returns the
    results in request order and, per request, the submit time followed by
    the arrival time of each streamed token."""
    results = [None] * len(requests)
    stamps = [[] for _ in requests]

    def worker(i):
        stamps[i].append(time.perf_counter())
        requests[i].stream_cb = lambda tok, i=i: stamps[i].append(
            time.perf_counter())
        results[i] = engine.generate_sync(requests[i], timeout=timeout)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    bad = [r for r in results if r is None or "text" not in r]
    if bad:
        raise AssertionError(f"{len(bad)} requests failed, first: {bad[0]}")
    return results, stamps


def result_tokens(result) -> list:
    return [int(t) for t in result["text"].split()]


def small_engine_parity(torch, cfg7, kernels):
    """2 LLaMA layers and 2 layers per tower at 7b widths, int8 packed
    weights, int8 KV and alignment cache, 16 slots: the same 6 greedy
    requests (3 text-only, 3 with media) through ``ContinuousEngine`` on
    the card and on the CPU. A request's tokens must be identical, or
    differ first at a step where the CPU's logits of the two tokens are
    within LOGITS_REL_TOL of max |logit| (what follows a flipped token is
    another sequence and is not compared)."""
    from macaw_llm_tpu_torch.data.templates import format_prompt
    from macaw_llm_tpu_torch.models import fusion, llama
    from macaw_llm_tpu_torch.serve import ContinuousEngine, Request
    from macaw_llm_tpu_torch.utils import quantize as qz
    cfg = dataclasses.replace(
        cfg7, llm=dataclasses.replace(cfg7.llm, num_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_layers=2),
        audio=dataclasses.replace(cfg7.audio, encoder_layers=2))
    params = fusion.init_params(21, cfg, dtype=torch.bfloat16, device="cuda")
    params["llm"] = qz.pack_llama_for_decode(qz.quantize_llama(params["llm"]))
    tok = BenchTok()
    slots, new = 16, 8

    def requests():
        budgets = (new, new, 1, new, 4, new)
        return [Request(prompt=f"parity request number {i}",
                        max_new_tokens=budgets[i],
                        **(engine_media(cfg, 30 + i) if i % 2 else {}))
                for i in range(6)]

    def run(p, device):
        eng = ContinuousEngine(p, cfg, tok, slots=slots, prompt_bucket=64,
                               max_new_tokens=new, align_cache="int8",
                               kv_cache_dtype="int8", device=device)
        eng.start()
        try:
            results, _ = serve_all(eng, requests())
        finally:
            eng.stop()
        return eng, [result_tokens(r) for r in results]

    reset_counts(kernels)
    gpu_eng, gpu = run(params, "cuda")
    torch.cuda.synchronize()
    launched = counts(kernels)
    steps = gpu_eng.stats["steps"]
    per_step = 4 * cfg.llm.num_layers + 1
    # 3 media admissions and the zero-media prefix: 2 Whisper layers and
    # the video-long attention each
    expect = {"mh_attention": 0, "flash_attention": 4 * 3,
              "flash_attention_combine": combines(torch, (
                  (whisper(1), 4 * 2), (video_long(1), 4))),
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "flash_attention_delta": 0,
              "matvec_int8": 6, "matvec_int8_pipelined": per_step * steps}
    if launched != expect:
        raise AssertionError(f"2-layer engine launches {launched} != {expect}")
    t0 = time.perf_counter()
    cpu_params = to_device(params, "cpu")
    cpu_eng, cpu = run(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0

    def cpu_logits(req, prefix):
        """The CPU's next-token logits after the request's prompt and
        ``prefix`` (no cache, float keys and values)."""
        ids = torch.tensor([tok.encode(format_prompt(req.prompt))])
        zeros = engine_media(cfg, 0)
        media = {k: torch.from_numpy(
            (getattr(req, k) if getattr(req, k) is not None
             else zeros[k] * 0)[None]) for k in zeros}
        with torch.inference_mode():
            fused = fusion.prepare_inputs(
                cpu_eng.params, cfg, input_ids=ids, images=media["image"],
                audios=media["audio"], videos=media["video"],
                align_cache=cpu_eng.align_cache)
            emb = fused.inputs_embeds
            if prefix:
                emb = torch.cat([emb, cpu_eng.params["llm"]["embed_tokens"][
                    torch.tensor([prefix])].to(emb.dtype)], dim=1)
            h = llama.forward_hidden(cpu_eng.params["llm"], cfg.llm, emb)
            return llama.logits_from_hidden(
                cpu_eng.params["llm"], h[:, -1:],
                llama.valid_vocab(cfg.llm))[0, 0]

    flips = []
    for i, (g, c, req) in enumerate(zip(gpu, cpu, requests())):
        if len(g) != len(c):
            raise AssertionError(f"request {i}: {len(g)} tokens on the "
                                 f"card, {len(c)} on the CPU")
        diff = [j for j, (a, b) in enumerate(zip(g, c)) if a != b]
        if not diff:
            continue
        j = diff[0]
        logits = cpu_logits(req, c[:j])
        gap = (logits[c[j]] - logits[g[j]]).abs().item() / \
            logits.abs().max().item()
        flips.append(dict(request=i, step=j, rel_gap=gap))
        if not gap <= LOGITS_REL_TOL:
            raise AssertionError(f"request {i} differs at token {j}: the "
                                 f"CPU's logits are {gap} apart")
    result = dict(requests=6, slots=slots, new_tokens=new, steps=steps,
                  identical=6 - len(flips), flips=flips, cpu_seconds=cpu_s,
                  launches=launched, tokens=gpu)
    log(json.dumps({"small_engine_parity": result}))
    return result


def run_decode_variants(torch, params, cfg, fused, kernels, b=4, new=16):
    """``generate`` sampled (per-row temperatures, top_k) and with the int8
    KV cache, and ``beam_search`` of 2 requests x 4 beams x 8 tokens: each
    twice, the same generator seed giving the same tokens; every token a
    real vocab entry. All of these decode up to 8 rows: B5."""
    from macaw_llm_tpu_torch.generate import beam_search, generate
    emb, mask = fused.inputs_embeds, fused.attention_mask
    temps = torch.tensor([0.0, 0.8, 0.0, 1.2], device="cuda")
    per_step = 4 * cfg.llm.num_layers + 1

    def in_vocab(t):
        return bool(((t >= 0) & (t < cfg.llm.vocab_size)).all())

    def sampled(seed):
        return generate(params["llm"], cfg.llm, inputs_embeds=emb,
                        attention_mask=mask, max_new_tokens=new, eos_id=-1,
                        temperature=temps, top_k=50,
                        generator=torch.Generator(device="cuda").manual_seed(
                            seed)).tokens

    def int8_kv():
        return generate(params["llm"], cfg.llm, inputs_embeds=emb,
                        attention_mask=mask, max_new_tokens=new, eos_id=-1,
                        cache_dtype="int8").tokens

    def beams():
        return beam_search(params["llm"], cfg.llm, inputs_embeds=emb[:2],
                           attention_mask=mask[:2], num_beams=4,
                           max_new_tokens=8, eos_id=-1)

    result = {}
    for name, fn, expect in (
            ("sampled", lambda: sampled(5), 1 + (new - 1) * per_step),
            ("int8_kv", int8_kv, 1 + (new - 1) * per_step),
            ("beam_search", lambda: beams().tokens, 7 * per_step)):
        reset_counts(kernels)
        t0 = time.perf_counter()
        first = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts(kernels)
        if launched["matvec_int8"] != expect or \
                launched["matvec_int8_pipelined"]:
            raise AssertionError(f"{name} launches {launched}, expected "
                                 f"{expect} matvec_int8")
        second = fn()
        if not (in_vocab(first) and torch.equal(first, second)):
            raise AssertionError(f"{name}: tokens out of range or not "
                                 "repeatable")
        result[name] = dict(seconds=seconds, shape=list(first.shape),
                            matvec_int8=launched["matvec_int8"],
                            first_tokens=first[:, :4].tolist())
    greedy = generate(params["llm"], cfg.llm, inputs_embeds=emb,
                      attention_mask=mask, max_new_tokens=new,
                      eos_id=-1).tokens
    s5 = sampled(5)
    if not torch.equal(s5[[0, 2]], greedy[[0, 2]]):
        raise AssertionError("rows at temperature 0 left the greedy tokens")
    if torch.equal(s5, sampled(6)):
        raise AssertionError("another seed sampled the same tokens")
    log(json.dumps({"decode_variants": result}))
    return result


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * (len(xs) - 1) + 0.5))]


def run_engine(torch, params, cfg, kernels, card: str, slots: int, new: int,
               n_req: int = 64, n_media: int = 8, n_sampled: int = 2):
    """bench.py --mode serve: the 7b ``ContinuousEngine`` with int8 packed
    weights, int8 KV and the int8 alignment cache, prompt bucket 64; one
    warm-up request, then ``n_req`` concurrent streamed requests, the first
    ``n_media`` of them with image + audio + video and ``n_sampled`` of
    those at temperature 0.8. Served tokens/s, TTFT and ITL as
    ``bench_serve`` computes them; steady tokens/s over the stretches in
    which every slot held a request."""
    from macaw_llm_tpu_torch.serve import ContinuousEngine, Request
    engine = ContinuousEngine(params, cfg, BenchTok(), slots=slots,
                              prompt_bucket=64, max_new_tokens=new,
                              align_cache="int8", kv_cache_dtype="int8")
    per_step = 4 * cfg.llm.num_layers + 1
    # Whisper's layers and the video-long attention; the alignments stay
    # below their 4e8-byte switch at batch 1
    flash_per_admission = cfg.audio.encoder_layers + 1
    engine.start()
    try:
        reset_counts(kernels)
        engine.generate_sync(Request(prompt="warmup request",
                                     max_new_tokens=4), timeout=600)
        warm = counts(kernels)
        # the text-only warm-up computes the zero-media prefix once
        if warm["flash_attention"] != flash_per_admission or \
                warm["matvec_int8"] != 1:
            raise AssertionError(f"warm-up launches {warm}")

        # one request alone on the warm engine: its time to the first token
        # is the admission prefill, its token gaps the bare decode step
        _, solo = serve_all(engine, [Request(prompt="solo request",
                                             max_new_tokens=8)])
        solo_ttft_ms = (solo[0][1] - solo[0][0]) * 1e3
        solo_itl_ms = statistics.median(
            b - a for a, b in zip(solo[0][1:-1], solo[0][2:])) * 1e3

        def requests():
            reqs = []
            for i in range(n_req):
                media = engine_media(cfg, 100 + i) if i < n_media else {}
                reqs.append(Request(
                    prompt=f"bench request number {i}", max_new_tokens=new,
                    temperature=0.8 if i < n_sampled else 0.0, **media))
            return reqs

        samples = []  # (t, decode steps, requests in a slot)
        stop_poll = threading.Event()

        def poll():
            while not stop_poll.is_set():
                samples.append((time.perf_counter(), engine.stats["steps"],
                                engine.stats["admitted"]
                                - engine.stats["requests"]))
                time.sleep(0.02)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        base_steps, base_done = engine.stats["steps"], \
            engine.stats["requests"]
        poller = threading.Thread(target=poll, daemon=True)
        t0 = time.perf_counter()
        poller.start()
        results, stamps = serve_all(engine, requests())
        elapsed = time.perf_counter() - t0
        stop_poll.set()
        poller.join(5)
        torch.cuda.synchronize()
        launched = counts(kernels)
        steps = engine.stats["steps"] - base_steps
        expect = {"mh_attention": 0,
                  "flash_attention": flash_per_admission * n_media,
                  "flash_attention_combine": n_media * combines(torch, (
                      (whisper(1), 6), (video_long(1), 1))),
                  "flash_attention_dq": 0, "flash_attention_dkv": 0,
                  "flash_attention_delta": 0,
                  "matvec_int8": n_req,
                  "matvec_int8_pipelined": per_step * steps}
        if launched != expect:
            raise AssertionError(f"engine launches at {slots} slots "
                                 f"{launched} != {expect}")
        if engine.stats["requests"] - base_done != n_req or \
                engine.stats["admitted"] != n_req + 2:
            raise AssertionError(f"engine stats {engine.stats}")
        tokens = [result_tokens(r) for r in results]
        for i, (r, toks) in enumerate(zip(results, tokens)):
            if r["tokens"] != len(toks) or not 1 <= len(toks) <= new or \
                    not all(0 <= t < cfg.llm.vocab_size for t in toks):
                raise AssertionError(f"request {i}: {r}")
            if len(stamps[i]) != 1 + len(toks):
                raise AssertionError(f"request {i}: {len(stamps[i]) - 1} "
                                     f"tokens streamed, {len(toks)} returned")
        # a greedy request again, with media and without
        again, _ = serve_all(engine, [requests()[n_sampled],
                                      requests()[n_media]])
        for i, r in zip((n_sampled, n_media), again):
            if result_tokens(r) != tokens[i]:
                raise AssertionError(f"greedy request {i} changed on a "
                                     "second run")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        engine.stop()

    total = sum(len(t) for t in tokens)
    ttfts = [ts[1] - ts[0] for ts in stamps if len(ts) >= 2]
    itls = [b - a for ts in stamps if len(ts) >= 3
            for a, b in zip(ts[1:-1], ts[2:])]
    # steady state: the stretches between two polls that both found every
    # slot holding a request
    dt = dsteps = 0
    for (t0_, st0, busy0), (t1_, st1, busy1) in zip(samples, samples[1:]):
        if busy0 == slots and busy1 == slots:
            dt, dsteps = dt + t1_ - t0_, dsteps + st1 - st0
    steady = step_ms = None
    if dsteps:
        steady, step_ms = dsteps * slots / dt, dt / dsteps * 1e3
    result = dict(
        slots=slots, requests=n_req, media_requests=n_media,
        sampled_requests=n_sampled, new_tokens=new, seconds=elapsed,
        tokens=total, served_tokens_per_s=total / elapsed,
        steady_tokens_per_s=steady, steady_step_ms=step_ms, steps=steps,
        ttft_p50_ms=statistics.median(ttfts) * 1e3,
        ttft_p95_ms=percentile(ttfts, 0.95) * 1e3,
        itl_p50_ms=statistics.median(itls) * 1e3,
        itl_p95_ms=percentile(itls, 0.95) * 1e3,
        solo_ttft_ms=solo_ttft_ms, solo_itl_ms=solo_itl_ms,
        peak_mem_gb=peak_gb,
        launches=launched, stats=dict(engine.stats), card=card)
    log(json.dumps({"serve": result}))
    return result, engine


def profile_engine_steps(torch, engine, out_dir: Path, steps: int = 20):
    """torch.profiler over ``steps`` decode steps of a stopped engine,
    dispatched from this thread with every slot active: the kernels' time
    against the wall time gives the device's idle share of a step."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    slots = list(range(engine.slots))
    engine._ctl_dirty = True

    def run(n):
        with torch.inference_mode(), torch.cuda.stream(
                engine._decode_stream):
            for _ in range(n):
                engine._dispatch(slots)
        torch.cuda.synchronize()

    engine.lengths.fill_(engine.prompt_bucket + engine.cfg.total_prefix_len)
    run(3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = device_busy_ms(prof)
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_engine{engine.slots}.txt").write_text(table)
    result = dict(slots=engine.slots, steps=steps, wall_ms_per_step=wall_ms
                  / steps, device_ms_per_step=device_ms / steps,
                  device_idle_share=1.0 - device_ms / wall_ms)
    log(f"== profile engine{engine.slots}\n{table}")
    log(json.dumps({"engine_step_profile": result}))
    return result


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
    towers = combines(torch, ((whisper(1), 2), (video_long(1), 1)))
    expects = {256: {"mh_attention": 4, "flash_attention": 3,
                     "flash_attention_combine": towers,
                     "flash_attention_dq": 1, "flash_attention_dkv": 1,
                     "flash_attention_delta": 1,
                     "matvec_int8": 0, "matvec_int8_pipelined": 0},
               1024: {"mh_attention": 0, "flash_attention": 7,
                      "flash_attention_combine": towers + combines(
                          torch, ((llama(1, 1080), 4),)),
                      "flash_attention_dq": 3, "flash_attention_dkv": 3,
                      "flash_attention_delta": 3,
                      "matvec_int8": 0, "matvec_int8_pipelined": 0}}
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
    towers = ((whisper(8), 6),)
    plan = ((1024, 2, 3, {"mh_attention": 0, "flash_attention": 70,
                          "flash_attention_combine": combines(
                              torch, towers + ((llama(8, 1080), 64),)),
                          "flash_attention_dq": 32,
                          "flash_attention_dkv": 32,
                          "flash_attention_delta": 32, "matvec_int8": 0,
                          "matvec_int8_pipelined": 0}),
            (256, 2, 3, {"mh_attention": 64, "flash_attention": 6,
                         "flash_attention_combine": combines(torch, towers),
                         "flash_attention_dq": 0, "flash_attention_dkv": 0,
                         "flash_attention_delta": 0,
                         "matvec_int8": 0, "matvec_int8_pipelined": 0}))
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


# --------------------------------------------------------------------------
# phase 10: the 1b full fine-tune through the command-line entry points
# --------------------------------------------------------------------------

def _leaf_map(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_map(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def state_leaves(state) -> dict:
    out = {}
    for name, tree in (("trainable", state.trainable),
                       ("frozen", state.frozen),
                       ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        out.update(_leaf_map(tree, name))
    return out


def differing_leaves(torch, a: dict, b: dict) -> list:
    """Leaves of two trees (of the same layout) whose bits differ."""
    if sorted(a) != sorted(b):
        raise AssertionError("trees of another layout")
    return [k for k in a if a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


def states_equal(torch, a, b) -> list:
    """Leaves (and step, count, generator) in which two states differ."""
    diff = differing_leaves(torch, state_leaves(a), state_leaves(b))
    if a.step != b.step or a.opt_state.count != b.opt_state.count:
        diff.append("step")
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        diff.append("rng")
    return diff


TRAIN_1B_RUN = ROOT / "bench_artifacts" / "train_1b_chip.json"


def phase10_config(out: Path, layers=None, **train):
    """A copy of the committed 1b run file with the phase's cadence (and,
    for the resume, the depth of every stack cut to ``layers``)."""
    from macaw_llm_tpu_torch.config import Config
    cfg = Config.from_json(TRAIN_1B_RUN.read_text())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train))
    if layers is not None:
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, llm=dataclasses.replace(m.llm, num_layers=layers),
            vision=dataclasses.replace(m.vision, num_layers=layers),
            audio=dataclasses.replace(m.audio, encoder_layers=layers)))
    out.write_text(cfg.to_json())
    return cfg


def metrics_rows(run_dir: Path) -> list:
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def run_train_1b(torch, kernels, card: str, work: Path, expect: dict,
                 out_dir=None):
    """10a: ``run_train.main`` on the 1b run file (synthetic zero-media
    batches), 2 warm-up + 5 timed steps, then --do-eval and the forced
    final save; every step synchronized and its launches read by the
    ``on_step`` hook. With ``out_dir`` one more step runs under
    torch.profiler (untimed; its table goes to out_dir). Returns the
    result line and the trained state."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from macaw_llm_tpu_torch import run_train
    cfg = phase10_config(work / "train_1b.json", save_steps=1000,
                         log_steps=1)
    run_dir = work / "run_1b"
    warm, timed = 2, 5
    n_steps = warm + timed + (out_dir is not None)
    steps = []
    mark = [time.perf_counter()]
    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(step, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        row = dict(step=step, step_ms=(now - mark[0]) * 1e3,
                   loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   loader_wait_s=metrics["loader_wait_s"],
                   launches=counts(kernels),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        steps.append(row)
        log(json.dumps({"train_1b_step": row}))
        if out_dir is not None and step == n_steps:  # one loop iteration
            prof.__exit__(None, None, None)
            table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25)
            (out_dir / "profile_train1b.txt").write_text(table)
            log(f"== profile train1b\n{table}")
            log(json.dumps({"profile": "train1b", "wall_ms": row["step_ms"],
                            "device_busy_ms": device_busy_ms(prof)}))
        reset_counts(kernels)
        if out_dir is not None and step == n_steps - 1:
            prof.__enter__()
        mark[0] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state = run_train.main([
        "--config", str(work / "train_1b.json"), "--synthetic",
        "--steps", str(n_steps), "--do-eval", "--output-dir",
        str(run_dir), "--device", "cuda"], on_step=on_step)
    wall = time.perf_counter() - t0
    eval_launches = counts(kernels)  # after the last step: eval only
    bad = [r for r in steps if r["launches"] != expect]
    if bad:
        raise AssertionError(f"1b train step launches {bad[0]['launches']}"
                             f" != {expect}")
    losses = [r["loss"] for r in steps]
    if not all(map(math.isfinite, losses)) or losses[-1] > 1.5 * losses[0]:
        raise AssertionError(f"1b train losses: {losses}")
    rows = metrics_rows(run_dir)
    save = [r for r in rows if "ckpt_bytes" in r]
    ev = [r for r in rows if "eval_loss" in r]
    if state.step != n_steps or len(save) != 1 or len(ev) != 1:
        raise AssertionError(f"1b run: step {state.step}, saves {save}, "
                             f"eval {ev}")
    if not math.isfinite(ev[0]["eval_loss"]):
        raise AssertionError(f"1b eval: {ev[0]}")
    times = [r["step_ms"] for r in steps[warm:warm + timed]]
    b = cfg.train.per_device_batch_size * cfg.train.grad_accum_steps
    fused = cfg.data.max_text_len + cfg.model.total_prefix_len
    step_ms = statistics.median(times)
    result = dict(
        batch=b, text=cfg.data.max_text_len, fused_len=fused,
        step_ms_median=step_ms, step_ms_min=min(times),
        step_ms_max=max(times), tokens_per_s=b * fused / (step_ms / 1e3),
        peak_mem_gb=steps[-1]["peak_mem_gb"], losses=losses,
        eval_loss=ev[0]["eval_loss"],
        eval_token_accuracy=ev[0]["eval_token_accuracy"],
        save_blocking_ms=save[0]["ckpt_blocking_ms"],
        save_write_s=save[0]["ckpt_write_s"], save_bytes=save[0]["ckpt_bytes"],
        save_snapshot=bool(save[0]["ckpt_snapshot"]),
        launches_per_step=steps[-1]["launches"], eval_launches=eval_launches,
        loader_wait_s_max=max(r["loader_wait_s"] for r in steps),
        run_wall_s=wall, card=card)
    log(json.dumps({"train_1b": result}))
    return result, state, cfg, run_dir


def restored_generation(torch, state, cfg, run_dir: Path):
    """10b: ``run_inference.restore_params`` on the checkpoint of 10a, held
    bit for bit against the trained state still in memory, and 8 prompts x
    16 greedy tokens from each: the same tokens."""
    from macaw_llm_tpu_torch import run_inference
    from macaw_llm_tpu_torch.eval import batch_inference_generation
    from macaw_llm_tpu_torch.train.checkpoint import load_config
    from macaw_llm_tpu_torch.train.state import merge_params
    t0 = time.perf_counter()
    saved_cfg = load_config(str(run_dir))
    if saved_cfg != cfg:
        raise AssertionError("config.json differs from the run's config")
    restored = run_inference.restore_params(str(run_dir), saved_cfg,
                                            device="cuda")
    restore_s = time.perf_counter() - t0
    trained = merge_params(state.trainable, state.frozen)
    diff = differing_leaves(torch, _leaf_map(restored), _leaf_map(trained))
    if diff:
        raise AssertionError(f"restored params differ from the saved state: "
                             f"{diff[:8]}")
    examples = [{"instruction": f"describe what happens in clip {i}",
                 "response": "", "image": "None", "video": "None",
                 "audio": "None"} for i in range(8)]
    new = 16
    gens = {}
    for name, params in (("restored", restored), ("in_memory", trained)):
        t1 = time.perf_counter()
        out = batch_inference_generation(params, cfg, BenchTok(), examples,
                                         batch_size=8, max_new_tokens=new,
                                         device="cuda")
        gens[name] = ([r["generation"] for r in out],
                      time.perf_counter() - t1)
    if gens["restored"][0] != gens["in_memory"][0]:
        raise AssertionError(f"restored generation differs: {gens}")
    result = dict(prompts=len(examples), new_tokens=new, restore_s=restore_s,
                  leaves=len(_leaf_map(restored)),
                  generate_s=gens["restored"][1],
                  tokens=[g.split()[:4] for g in gens["restored"][0][:2]])
    log(json.dumps({"restore_1b": result}))
    return result


def resume_1b(torch, work: Path):
    """10c: at 1b width and 2 layers a stack, 4 uninterrupted
    steps against 2 steps stopped by SIGTERM (the checkpoint-and-exit
    path) and a second call of ``main`` that resumes to 4: the checkpoint
    restores the saved state bit for bit, steps 3-4 give the same losses
    within 1e-3, and the final states are compared bit for bit (the
    leaves that differ are listed where they are not the same)."""
    import signal
    from macaw_llm_tpu_torch import run_train
    from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
    layers = 2
    phase10_config(work / "resume.json", layers=layers, save_steps=1000,
                   log_steps=1)

    def args(name):
        return ["--config", str(work / "resume.json"), "--synthetic",
                "--steps", "4", "--output-dir", str(work / name),
                "--device", "cuda"]

    t0 = time.perf_counter()
    straight = run_train.main(args("straight"))

    def preempt(step, state, metrics):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)

    stopped = run_train.main(args("stopped"), on_step=preempt)
    if stopped.step != 2:
        raise AssertionError(f"SIGTERM run stopped at step {stopped.step}")
    back = CheckpointManager(str(work / "stopped")).restore(stopped)
    diff = states_equal(torch, back, stopped)
    if diff:
        raise AssertionError(f"restored state differs from the saved one: "
                             f"{diff[:8]}")
    del back
    resumed = run_train.main(args("stopped"))
    wall = time.perf_counter() - t0
    losses = {name: {r["step"]: r["loss"] for r in metrics_rows(work / name)
                     if "loss" in r} for name in ("straight", "stopped")}
    rel = max(abs(losses["stopped"][k] - losses["straight"][k])
              / abs(losses["straight"][k]) for k in (3, 4))
    if resumed.step != 4 or rel > 1e-3:
        raise AssertionError(f"resume: step {resumed.step}, losses {losses}")
    final_diff = states_equal(torch, resumed, straight)
    result = dict(layers=layers, losses_straight=losses["straight"],
                  losses_resumed=losses["stopped"], loss_rel_err_3_4=rel,
                  restored_state_bitwise=True,
                  final_state_bitwise=not final_diff,
                  final_differing_leaves=final_diff[:12],
                  final_differing_count=len(final_diff), wall_s=wall)
    log(json.dumps({"resume_1b": result}))
    return result


def run_phase10(torch, kernels, card: str, out_dir: Path, expect: dict,
                do_profile: bool):
    """Phase 10 (10a, 10b, 10c) in a directory under ``out_dir`` that is
    deleted when the phase ends, whatever happens."""
    work = out_dir / "phase10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        log(json.dumps({"phase10_disk_free_gb":
                        shutil.disk_usage(work).free / 1e9}))
        t0 = time.perf_counter()
        train, state, cfg, run_dir = run_train_1b(
            torch, kernels, card, work, expect,
            out_dir=out_dir if do_profile else None)
        restore = restored_generation(torch, state, cfg, run_dir)
        del state
        torch.cuda.empty_cache()
        resume = resume_1b(torch, work)
        log(json.dumps({"phase10_seconds": time.perf_counter() - t0}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(train=train, restore=restore, resume=resume)


def step_totals(rows, b: int, keys) -> dict:
    """One decode step of the timed rows at ``b`` rows: each key summed
    over the 7b shapes times their launches a step (None where a row has
    none), and what bounds the largest share of the bound."""
    timed = [r for r in rows if r["shape"][0] == b and "kernel_ms" in r]

    def total(key):
        if any(r.get(key) is None for r in timed):
            return None
        return sum(r[key] * r["per_step"] for r in timed)

    out = {key: total(key) for key in keys}
    out["bound_by"] = max(timed, key=lambda r: r["bound_ms"]
                          * r["per_step"])["bound_by"]
    out["per_shape_ms"] = {r["call"]: r["kernel_ms"] for r in timed}
    return out


STEP_KEYS = ("kernel_ms", "event_ms", "plain_ms", "bound_ms", "library_ms")


def matvec_entry(name: str, rows, source, launches: int,
                 serve_res) -> dict:
    """B5's entry of the kernels line: one `generate` decode step at 4 rows
    (its 129 launches), with the same at 16 and 32 rows beside it."""
    s4 = step_totals(rows, 4, STEP_KEYS)
    return {
        "name": name, "route": "cuda", "source": source[0],
        "replaces": source[1], "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": s4["kernel_ms"], "plain_ms": s4["plain_ms"],
        "bound_ms": s4["bound_ms"], "bound_by": s4["bound_by"],
        "library_ms": s4["library_ms"],
        "work": "one generate decode step at 4 rows (129 launches); ms is "
                "device time (CUDA graph), event_ms back-to-back event time",
        "event_ms": s4["event_ms"], "per_shape_ms": s4["per_shape_ms"],
        "step_at_16_rows": step_totals(rows, 16, STEP_KEYS[:-1]),
        "step_at_32_rows": step_totals(rows, 32, STEP_KEYS[:-1]),
        "engine_launches": {str(slots): res["launches"][name]
                            for slots, res in serve_res.items()},
        "train_step_launches": 0,
    }


def pipelined_entry(name: str, rows, source, serve_res) -> dict:
    """B6's entry of the kernels line: one engine decode step at 16 slots
    (its 129 launches), with the same at 32 slots, B5, every depth and the
    fp32 FMA bound beside it."""
    keys = STEP_KEYS + ("fma_bound_ms", "matvec_int8_ms") + tuple(
        f"kernel_ms_depth{d}" for d in PIPELINED_DEPTHS)
    s16, s32 = step_totals(rows, 16, keys), step_totals(rows, 32, keys)
    return {
        "name": name, "route": "cuda", "source": source[0],
        "replaces": source[1],
        "launches": serve_res[16]["launches"][name],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": s16["kernel_ms"], "plain_ms": s16["plain_ms"],
        "bound_ms": s16["bound_ms"], "bound_by": s16["bound_by"],
        "library_ms": s16["library_ms"],
        "work": "one engine decode step at 16 slots (129 launches), depth "
                "4; ms is device time (CUDA graph), event_ms back-to-back "
                "event time",
        "event_ms": s16["event_ms"], "per_shape_ms": s16["per_shape_ms"],
        "fma_bound_ms": s16["fma_bound_ms"],
        "matvec_int8_ms": s16["matvec_int8_ms"],
        "ms_by_depth": {str(d): s16[f"kernel_ms_depth{d}"]
                        for d in PIPELINED_DEPTHS},
        "step_at_32_rows": s32,
        "engine_launches": {str(slots): res["launches"][name]
                            for slots, res in serve_res.items()},
        "engine_steps": {str(slots): res["steps"]
                         for slots, res in serve_res.items()},
        "train_step_launches": 0,
    }


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    return [tree]


def device_busy_ms(prof) -> float:
    """The time (ms) in which at least one kernel ran on the card: the
    union of the profiler's kernel intervals. A sum of kernel times would
    count twice the matvec's reduce kernel, which launches early as a
    programmatic dependent and waits for the main kernel."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


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
    log(json.dumps({"profile": name, "device_busy_ms": device_busy_ms(prof)}))


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

    global LOG_FILE
    out_dir.mkdir(parents=True, exist_ok=True)
    LOG_FILE = open(out_dir / "chip_smoke.log", "w")

    t_start = time.perf_counter()
    # 1. build
    info = _build.build()
    log(f"kernel build: {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if line.startswith("==") or re.search(r"registers|spill|warn", line):
            log("  " + line.strip())
    # the backward kernels' registers and spills; the D = 128 instances of
    # the train path must not spill
    res = kernel_resources(info["log"])
    bwd_res = {name: r for name, r in res.items()
               if name.startswith("flash_bwd_")}
    log(json.dumps({"backward_kernel_resources": bwd_res}))
    # the forward attention kernels (B1, B2 and its combine), logged
    log(json.dumps({"forward_kernel_resources": {
        name: r for name, r in res.items()
        if name.startswith(("flash_fwd_", "mh_attention_"))}}))
    spilled = {name: r for name, r in bwd_res.items()
               if name.endswith("<128>") and r.get("spill_stores", 0)
               + r.get("spill_loads", 0)}
    if spilled:
        raise AssertionError(f"backward kernels spill at D = 128: {spilled}")
    # the matvec kernels (B5, B6 and their reduce) must not spill
    mv_res = {name: r for name, r in res.items()
              if name.startswith("matvec_")}
    log(json.dumps({"matvec_kernel_resources": mv_res}))
    spilled = {name: r for name, r in mv_res.items()
               if r.get("spill_stores", 0) + r.get("spill_loads", 0)}
    if not mv_res or spilled:
        raise AssertionError(f"matvec kernels: none in the build log, or a "
                             f"spill: {spilled}")
    _build.library()

    # 2. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    device = torch.cuda.get_device_name(0)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {"mh_attention": mh.mh_attention,
               "flash_attention": fa.flash_attention_with_lse,
               "flash_attention_combine": fa.flash_attention_combine,
               "flash_attention_dq": fa.flash_attention_dq,
               "flash_attention_dkv": fa.flash_attention_dkv,
               "flash_attention_delta": fa.flash_attention_delta,
               "matvec_int8": mv.matvec_int8,
               "matvec_int8_pipelined": mv.matvec_int8_pipelined}

    # 3. kernels vs plain at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_attention(torch, mh, fa, gen, sms)
    checks.update(check_matvec(torch, mv, gen))
    # 3c. the pipelined matvec, with B5 beside it at 16 and 32 rows
    checks.update(check_matvec_pipelined(torch, mv, gen))
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
    # 4c. 2-layer continuous-batching engine at 7b widths: card vs CPU
    small_engine_parity(torch, cfg, kernels)
    torch.cuda.empty_cache()
    # 4b. 2-layer QLoRA train step at 7b widths: card vs CPU
    small_train_parity(torch, cfg, kernels)
    torch.cuda.empty_cache()

    # 5. full 7b prefill
    params, cache, params_full, build_s = build_7b(torch, cfg)
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

    run_decode_variants(torch, params, cfg, fused, kernels)

    # 6b. the continuous-batching engine at 16 and at 32 slots
    del cache, batch, fused
    engine_params = dict(params_full, llm=params["llm"])
    serve_res = {}
    for slots, new in ((16, 64), (32, 32)):
        serve_res[slots], engine = run_engine(torch, engine_params, cfg,
                                              kernels, card, slots, new)
        if args.profile:
            profile_engine_steps(torch, engine, out_dir)
        del engine
        torch.cuda.empty_cache()

    # 7. release the serving weights
    del params, params_full, engine_params
    torch.cuda.empty_cache()

    # 8. the 7b QLoRA train step
    train_res = run_train(torch, cfg, kernels, card, args.profile, out_dir)
    train_launches = {name: n for text in (256, 1024) for name, n in
                      train_res[text]["launches_per_step"].items() if n}
    torch.cuda.empty_cache()

    # 10. the 1b full fine-tune through run_train, run_inference and a
    # resume; per step: B1 in every LLaMA layer, forward and the remat
    # recompute, and B2 in Whisper's 6 layers
    towers = ((whisper(8), 6),)
    expect_1b = {"mh_attention": 32, "flash_attention": 6,
                 "flash_attention_combine": combines(torch, towers),
                 "flash_attention_dq": 0, "flash_attention_dkv": 0,
                 "flash_attention_delta": 0, "matvec_int8": 0,
                 "matvec_int8_pipelined": 0}
    phase10 = run_phase10(torch, kernels, card, out_dir, expect_1b,
                          args.profile)
    train_1b_launches = phase10["train"]["launches_per_step"]
    torch.cuda.empty_cache()

    # 11. the kernels line: per prefill (B1, B2), per decode step (B5, at
    # batch 4; B6, at 16 engine slots) or per train step at text 1024 (B3,
    # B4)
    sources = {
        "mh_attention": ("macaw_llm_tpu_torch/csrc/mh_attention.cu",
                         "macaw_llm_tpu/ops/pallas/mh_attention.py:147"),
        "flash_attention": ("macaw_llm_tpu_torch/csrc/flash_attention.cu",
                            "macaw_llm_tpu/ops/pallas/flash_attention.py:188"),
        # the merge of B2's split over keys (the TPU kernel walks every key
        # block of a row in one grid row and needs none)
        "flash_attention_combine": (
            "macaw_llm_tpu_torch/csrc/flash_attention.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:188"),
        "flash_attention_dq": (
            "macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:366"),
        "flash_attention_dkv": (
            "macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:413"),
        # the delta of _flash_bwd (plain jnp beside its two pallas_calls)
        "flash_attention_delta": (
            "macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu",
            "macaw_llm_tpu/ops/pallas/flash_attention.py:318"),
        "matvec_int8": ("macaw_llm_tpu_torch/csrc/matvec.cu",
                        "macaw_llm_tpu/ops/pallas/matvec.py:79"),
        "matvec_int8_pipelined": (
            "macaw_llm_tpu_torch/csrc/matvec.cu",
            "macaw_llm_tpu/ops/pallas/matvec.py:175"),
    }
    entries = []
    for name, rows in checks.items():
        if name.startswith("flash_attention_d"):
            row = rows[0]  # the train shape, 32 launches per train step
            lib = row["library_ms"]
            entries.append({
                "name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1],
                "launches": train_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["kernel_ms"] * row["per_step"],
                "plain_ms": row["plain_ms"] * row["per_step"],
                "bound_ms": row["bound_ms"] * row["per_step"],
                "bound_by": row["bound_by"],
                "library_ms": None if lib is None else lib * row["per_step"],
                "work": "one 7b train step at text 1024" + (
                    "" if name.endswith("delta") else
                    " (plain and library: the whole backward, dq, dk and "
                    "dv together)"),
                "train_step_launches": train_launches[name]})
            continue
        if name == "matvec_int8_pipelined":
            entries.append(pipelined_entry(name, rows, sources[name],
                                           serve_res))
            continue
        if name == "matvec_int8":
            entries.append(matvec_entry(name, rows, sources[name],
                                        main_launches[name], serve_res))
            continue
        per = "per_prefill"
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
            "work": "one prefill",
            "train_step_launches": train_launches.get(name, 0),
        }
        if name in ("mh_attention", "flash_attention"):
            entry["train_1b_step_launches"] = train_1b_launches[name]
        if name.startswith("flash_attention"):  # 7 B2 per media admission
            entry["engine_launches"] = {
                str(slots): res["launches"][name]
                for slots, res in serve_res.items()}
        adm = [r for r in rows if r.get("per_admission")]
        if adm:  # B2 at an engine admission's batch 1, split over keys
            entry["engine_admission"] = {
                key: sum(r[key] * r["per_admission"] for r in adm)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")}
            entry["engine_admission"].update(
                launches=sum(r["per_admission"] for r in adm),
                chunks={r["call"]: r["chunks"] for r in adm})
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
    LOG_FILE.close()
    LOG_FILE = None
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
