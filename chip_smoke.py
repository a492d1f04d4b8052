"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Phases, in order (any failure raises and the script exits non-zero):
 1. build the CUDA kernels from ``macaw_llm_tpu_torch/csrc`` (nvcc, sm_90a);
 2. print the card's name and power limit (nvidia-smi);
 3. hold each forward kernel against its plain PyTorch version at the
    main-path shapes of the 7b profile (B2 also at the batch-1 shapes of an
    engine admission, where it splits the keys into chunks and launches
    its combine kernel, and with every key outside one chunk masked) and
    time kernel, plain version, the library call that computes the same
    function (where one exists) and the bound; also at the shapes of a
    tensor-parallel rank at t = 2 and 4 (phase 13): B1 at 16 and 8 heads,
    B2 at Whisper's 4 and 2 heads and the alignment fold's 8 and 4; B1
    at the 1b train step's rank shape [8, 312, 8, 128] (phase 14a); and a
    ZeRO-3 rank's 2 rows (phase 15): B1 [2, 312, 16 / 32, 128] (1b / 7b),
    B2 Whisper [2, 1500, 8, 64];
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
    with B5, the fp32 FMA bound and the library call beside it; B5 and B6
    at a tensor-parallel rank's shard shapes (t = 2: qkv (4096, 6144), wo
    (2048, 4096), gateup (4096, 11008), down (5504, 4096); t = 4: (4096,
    3072), (1024, 4096), (4096, 5504), (2752, 4096)) at 4 and 16 rows, wo
    and down with the fp32 output the TP decode asks for;
 3b. the same for the backward kernels (delta, flash dq, flash dk/dv) at
    the 7b train shape and at the edge cases (ragged tail, a fully masked
    batch row, an LSE cotangent, head dims 64 and 256), after holding the
    flash forward that feeds them against its plain version in every case
    and timing it at the train shape; at the train shape the gradients
    must be the same bits on a rerun, and the whole CUDA backward (delta,
    dq, dk/dv) is timed beside SDPA's backward (phase 1 fails if ptxas
    reports a spill in a D = 128 backward kernel); the same at a tensor
    rank's train shape [8, 1080, 32 / t, 128], t = 2 and 4 (phase 14b);
 4. a 2-layer model at 7b widths (batch 2, seq 256) on the card with the
    kernels against the same weights on the CPU with the plain versions:
    the reference prefill, ``video_mode="simple"``, and ``quantize_towers``
    (W8A8 CLIP and Whisper projections);
 4b. a 2-layer QLoRA train step at 7b widths (loss and the trainable
    leaves' gradients), card against CPU, at text 256 and text 1024, then
    at text 256 with remat policy "dots" and with Whisper LayerDrop 0.5
    (the same host-drawn keep vector on both sides);
 4c. a 2-layer continuous-batching engine at 7b widths (16 slots, int8
    weights, int8 KV, int8 alignment cache): the same 6 greedy requests on
    the card and on the CPU;
 5. the full-width 7b fused prefill, batch 16, seq 256 (fused length 312),
    int8 W8A8 LLaMA, int8 alignment cache, packed towers;
 5b. the same prefill (batch and weights) with ``quantize_towers``: its
    median beside phase 5's, its logits' cosine and argmax agreement
    against phase 5's;
 6. greedy decode of 4 requests, 16 new tokens, int8 packed weights, bf16
    KV cache; then one sampled call, one with the int8 KV cache, and a
    beam search of 2 requests x 4 beams x 8 tokens, each run twice;
 6c. speculative decode on phase 6's prefix and weights, 4 requests x 64
    tokens, draft 4, n-gram 2, the ngram and the oracle proposer, bf16 and
    int8 KV cache, each run twice: 129 B6 launches a verify round (20
    rows), the greedy tokens (or a first difference at a near tie), tokens/s
    beside ``generate``'s at 64 tokens;
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
    chunked loss; synthetic zero-media batches): first the seeded LLaMA,
    cut to 32000 vocab rows, exported by ``hf_export`` as safetensors and
    loaded back by ``run_train.load_pretrained`` (bit for bit, the 7 new
    rows the mean); 10a ``run_train.main --llama-weights`` of it,
    2 warm-up + 5 timed steps (launches asserted per step), --do-eval and
    the forced final save; 10b ``run_inference.restore_params`` of that
    checkpoint (bit for bit against the state in memory) and 8 x 16 greedy
    tokens from it, the same as from the state in memory, and the same
    again with speculative decode (draft 4; or a near tie); 10c at 2 layers
    a stack, 4 steps straight against 2 steps stopped by SIGTERM and a
    resume to 4 (the restored state bit for bit, steps 3-4's losses within
    1e-3); the checkpoints are deleted when the phase ends;
 12. the parallel layer: 12a ``ring_attention_local`` at 7b widths
    ([1, 8192, 32, 128] bf16), n = 4 and 8, contiguous and zig-zag, forward
    and backward against one B2 forward and B3/B4 backward over the whole
    sequence, and at [1, 2048, 32, 128] against the plain attention in
    fp32, with the B2/B3/B4 launches of a ring asserted (n(n+1)/2
    contiguous, n(2n+1) zig-zag) and its time beside the single call's;
    12b phase 10a's run with ``offload_optimizer`` (the same losses, Adam's
    moments pinned in host memory between steps; host bytes, device peak
    and step time beside 10a's); 12c ``run_train.main`` in a child process
    joined to a one-rank NCCL group through the reference's environment,
    the run file's mesh (all 1s), ring attention (zig-zag, n = 1), the
    sharded Trainer's collectives issued through NCCL, the losses within
    1e-3 of 10a's;
 13. tensor-parallel inference (``parallel.tensor_parallel``) at
    ``macaw_7b()`` full width and depth, int8 weights, t = 2 ranks: two
    child processes of this script on this card (NCCL takes one rank a
    card; gloo carries the all-reduces and broadcasts of CUDA tensors
    through host memory), each drawing the whole tree from phase 5's seed
    and keeping its block. 13a: phase 5's b16 W8A8 prefill, held stage by
    stage: the ranks' LLaMA on phase 5's own prefix gives phase 5's logits
    bit for bit, their prefix (towers and alignment cut too) is within 1e-3
    of phase 5's and their logits are one device's LLaMA on it, bit for bit
    (the end-to-end logits reported beside how far one device's move under
    a one-ulp change of 1% of its prefix); phase 6's 4 x 16 greedy decode
    on phase 6's prefix (tokens phase 6's, or first differing at a near
    tie: phase 4c's rule); 13b: the engine over 16 requests (4 with media,
    2 sampled), with the int8 KV cache and with a bf16 one, held by the
    same stages: each request's prefix within 1e-3 of the one-device
    engine's, and the tokens those of the one-device engine on the ranks'
    prefixes or first differing at a near tie of its own logits (phase
    4c's bar; the sampled ones in the vocab and their budgets), both ranks
    ending in the same slot state; the end-to-end tokens read beside the
    gaps at which the one-device engine's tokens move under a one-ulp
    change of 1% of its token table; per-rank ms, collectives and peak
    memory, which say nothing of tensor parallelism's speed across cards
    (the ranks share one card);
 14. tensor-parallel training (Megatron over the mesh's tensor axis), t =
    2 ranks as child processes of this script on this card, joined through
    gloo (host memory), in phase 10's directory: 14a phase 10a's 1b full
    fine-tune at full depth through ``run_train.main --backend gloo`` on
    its imported weights, mesh tensor 2, the vocab padded to 32008
    (vocab-parallel embed_tokens and lm_head), 2 + 3 steps, then the same
    with ``shard_sequence``: the ranks' losses the same bits, step 1
    within 1e-3 of 10a's and steps 2-3 within the bf16 bar, 32 B1 and 6
    B2 launches a step asserted, per-rank step ms, peak memory and
    collectives; 14b phase 4b's 2-layer QLoRA step at text 1024 on a
    rank's block (B2, B3 and B4 on 16 heads), its loss and LoRA gradients
    against 4b's one-device step on the card by 4b's bars. The ranks share
    one card and sum through host memory: their times say nothing of
    tensor parallelism across cards;
 15. the parallel layer across cards, one rank a card over NCCL (the
    ranks are this script's and ``parallel.dryrun``'s children, each
    taking the card of its local rank through ``multihost_initialize``),
    where the process sees two cards or more, at t = 4 where it sees four
    (on one card one line says it did not run): the cards' names, power
    limits and ``nvidia-smi topo -m``; one-card references first (phase
    10's imported 1b weights and its run file at 10a's global batch of 8).
    15a the 1b run file under ZeRO-3 (mesh fsdp t, 8 / t rows a rank),
    2 + 3 steps and the final gathered save: step 1 within 1e-3 of the
    one-card run, steps 2-3 within 3e-2, the ranks the same bits, B1/B2
    launches asserted; the checkpoint restored over the mesh and on one
    card bit for bit; 15b the 7b full fine-tune through ``run_train
    --profile 7b`` at full width and depth under ZeRO-3 (random weights
    from the seed; its state, about 81 GB, fits no one card): finite
    losses, the same bits on every rank, the gathered save (rank 0's host
    peak) and a resume of it bit for bit; the same at 2 layers a stack
    against one card's run by 15a's bars; 15c phase 13 at t = 2 and 4
    against phases 5 and 6 run again here (3 timed prefills) and the
    one-device engine on the same requests (13a's and 13b's stage checks;
    served tokens/s, TTFT and ITL beside one device's); 15d phase 14a at
    t = 2 and 4; 15e ``ring_attention`` at [1, 8192, 32, 128] over t
    ranks, both layouts, forward and backward, against one B2 + B3/B4 call
    by 12a's bars, its launches asserted and its ms beside the single
    call's, then the 1b run file with the ring (zig-zag) over mesh tensor
    t against the one-card run by 15a's bars. Per-rank step ms, peak and
    collectives throughout. Its scratch (15b's checkpoint is 67 GB) is
    ``build/phase15``, deleted when the phase ends;
 11. one ``{"kernels": [...]}`` line (with a tensor-parallel rank's
    launches and the shard shapes' times, its training launches and
    train shapes, and phase 15's launches and ZeRO-3 shapes), then the
    contract line ``{"ok": true, "device": {...}}`` last.

Weights are random, made on the card from a seed. Usage, from the root of
a checkout:  python3 chip_smoke.py [--profile] [--phase 15]
(--phase 15 runs the build, the card's line and phase 15 alone, and exits
1 where the process sees fewer than two cards.)
(--profile adds torch.profiler tables, and Chrome traces under
build/traces/, of one prefill, of greedy decode
with 1 and 4 new tokens, of 20 engine decode steps at 16 slots (with the
device's idle share of a step), of one train step at text 1024 and of one
more (untimed) loop iteration of the 1b run, with its device busy time,
written to chiprun_out/.) Every line the script logs is also kept in
chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

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
# 12a: the ring's gradients against its plain version (the same steps on
# the CPU): a chunk's q, k or v gradient sums the contributions of the steps
# that see it, each within BWD_ROW_REL_TOL of its own row, so the sum gets
# twice that; the output, merged in fp32, keeps ATTN_ROW_REL_TOL. Against
# one kernel call over the whole sequence (whose rows are within the
# per-call bars of the exact values) the ring is held to twice the
# per-call bars.
RING_GRAD_REL_TOL = 2 * BWD_ROW_REL_TOL
RING_VS_SINGLE_TOL = 2 * max(ATTN_ROW_REL_TOL, BWD_ROW_REL_TOL)
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
               ("engine_video_long", 1, 1176, 1178, 8, 64, 0, 1),
               # a tensor-parallel rank's (phase 13): Whisper's 8 heads and
               # the alignment's 16 (the fold's batch) cut over t = 2 and 4;
               # at t = 4 the b16 video alignment's logits fit the einsum
               # route (ALIGN_EINSUM_MAX_BYTES), so its fold is checked only
               ("tp2_whisper", 16, 1500, 1500, 4, 64, 0, 0),
               ("tp4_whisper", 16, 1500, 1500, 2, 64, 0, 0),
               ("tp2_video_align", 8, 624, 32009, 1, 256, 0, 0),
               ("tp4_video_align", 4, 624, 32009, 1, 256, 0, 0),
               # a ZeRO-3 rank's Whisper at 2 rows (phase 15a, 15b)
               ("zero3_whisper", 2, 1500, 1500, 8, 64, 0, 0))

# B1's calls: batch, heads, launches per prefill, call: the 7b's 32 heads,
# a tensor-parallel rank's at t = 2 and 4 (phase 13), and the 1b train
# step's 16 heads cut over t = 2 (phase 14a: batch 8, fused length 312)
MH_CALLS = ((16, 32, 32, "llama"), (16, 16, 0, "tp2_llama"),
            (16, 8, 0, "tp4_llama"), (8, 8, 0, "tp2_train_1b"),
            # a ZeRO-3 rank's at 2 rows (phase 15a and 15b: 8 over 4 cards)
            (2, 16, 0, "zero3_1b"), (2, 32, 0, "zero3_7b"))


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

    results = {"mh_attention": []}
    # B1: [b, 312, n, 128], causal, zero padding bias (all-ones mask), at
    # the 7b's 32 heads and a tensor-parallel rank's
    for b, n, per, call in MH_CALLS:
        s, d = 312, 128
        q, k, v = rn(b, s, n, d), rn(b, s, n, d), rn(b, s, n, d)
        bias = torch.zeros(b, s, device="cuda")
        out = mh.mh_attention(q, k, v, bias, causal=True)
        ref, _ = fa.attention_reference(q, k, v, bias, causal=True)
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        # the same inputs with only the keys of the last, partial 64-key
        # tile (the kernel's tile width) left valid
        tail = tail_bias(torch, b, s, 64)
        tail_rel = row_rel_err(mh.mh_attention(q, k, v, tail, causal=True),
                               fa.attention_reference(q, k, v, tail,
                                                      causal=True)[0])
        if not (rel <= ATTN_ROW_REL_TOL and tail_rel <= ATTN_ROW_REL_TOL):
            raise AssertionError(f"mh_attention at {n} heads: row rel err "
                                 f"{rel}, ragged tail {tail_rel}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(torch, lambda: mh.mh_attention(q, k, v, bias,
                                                    causal=True), 20)
        plain = cuda_ms(torch, lambda: fa.attention_reference(
            q, k, v, bias, causal=True), 5)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        nbytes = 4 * q.numel() * 2 + bias.numel() * 4
        bms, by = bound(attn_flops(b, s, s, n, d, True), nbytes)
        results["mh_attention"].append(dict(
            call=call, shape=[b, s, n, d], causal=True, max_abs_err=err,
            row_rel_err=rel, tail_row_rel_err=tail_rel, kernel_ms=ms,
            plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
            per_prefill=per))
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
    SDPA's backward. The same timing at a tensor rank's train shape, [8,
    1080, 32 / t, 128] for t = 2 and 4 (phase 14b's QLoRA step; the rows
    ``tp2_train`` and ``tp4_train``)."""
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    neg = torch.finfo(torch.float32).min
    # name, B, Sq, Sk, N, D, causal, bias kind, LSE cotangent
    cases = (("train", 8, 1080, 1080, 32, 128, True, "ones", False),
             ("tp2_train", 8, 1080, 1080, 16, 128, True, "ones", False),
             ("tp4_train", 8, 1080, 1080, 8, 128, True, "ones", False),
             ("train_tail", 8, 1080, 1080, 32, 128, True, "tail", False),
             ("masked_row", 8, 1080, 1080, 32, 128, True, "row0", False),
             ("lse_cotangent", 2, 1080, 1080, 8, 128, False, "ones", True),
             ("d64", 2, 300, 300, 4, 64, True, "row0", False),
             ("d256", 2, 260, 260, 2, 256, True, "tail", True))
    rows = {"flash_attention_dq": [], "flash_attention_dkv": [],
            "flash_attention_delta": [], "flash_attention": []}
    timing, tp_timing = None, {}
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
        if name in ("train", "tp2_train", "tp4_train"):
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
            fwd.update(call="llama_train" if name == "train" else
                       f"{name[:3]}_llama_train", kernel_ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, per_step=64)
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
            timed = {"flash_attention_dq": (ms_dq, b3, plain, lib),
                     "flash_attention_dkv": (ms_dkv, b4, plain, lib),
                     "flash_attention_delta": (ms_delta, bd, plain_delta,
                                               None)}
            if name == "train":
                timing = timed
            else:  # a tensor rank's shape: its rows carry their times
                tp_timing[name] = timed
            log(json.dumps({"backward_timing": dict(
                case=name, shape=[b, sq, n, d], causal=True,
                delta_ms=ms_delta,
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
        for row in krows:
            times = timing if row["case"] == "train" else \
                tp_timing.get(row["case"])
            if times is None:
                continue
            ms, (bms, by), plain, lib = times[kname]
            row.update(kernel_ms=ms, plain_ms=plain, library_ms=lib,
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


def matvec_times(torch, mv, fn, x, ws, s, cycle, ref, library: bool,
                 out_dtype=None):
    """A matvec's times at one shape and row count: device time per call
    (``kernel_ms``, a CUDA graph of 4 calls a weight copy, at least 8),
    the back-to-back event time that earlier rows report (``event_ms``),
    the plain version (with ``fn``'s output dtype), the library call
    (where asked) and the byte bound."""
    b, k = x.shape
    n = ws[0].shape[1]
    iters = max(8, 4 * len(ws))
    row = {"kernel_ms": graph_ms(torch, cycle(fn), iters),
           "event_ms": cuda_ms(torch, cycle(fn), iters),
           "plain_ms": cuda_ms(torch, cycle(
               lambda w: mv.matvec_reference(x, w, s, out_dtype)),
               2 * len(ws))}
    if library:
        lib, lib_err, lib_note = library_int8_mm(torch, x, ws, s, ref, cycle)
        row.update(library_ms=lib, library_rel_err=lib_err,
                   library_note=lib_note)
    out_bytes = 4 if out_dtype == torch.float32 else 2
    bms, by = bound(2 * b * k * n,
                    k * n + n * 4 + b * k * 2 + b * n * out_bytes)
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


# the decode shapes of a tensor-parallel rank of the 7b (phase 13) at
# t = 2 and 4: the column-parallel qkv and gateup cut N, the row-parallel
# wo and down cut K (2752 = 43 x 64: whole 64-row k tiles) and write fp32
# (``qz.matmul`` sums them over the ranks before it rounds); the lm_head's
# 32007 columns stay whole (phase 3a's row)
TP_SIZES = (2, 4)
TP_MATVEC_ROWS = (4, 16)


def tp_matvecs(t: int):
    return (("qkv", 4096, 12288 // t, 32), ("wo", 4096 // t, 4096, 32),
            ("gateup", 4096, 22016 // t, 32),
            ("down", 11008 // t, 4096, 32))


def check_tp_matvec(torch, mv, gen):
    """B5 and B6 (depth 4) at a tensor-parallel rank's shard shapes, 4 and
    16 rows, called as the TP decode calls them (``qz.matmul`` under a
    tensor group: the row-parallel wo and down with an fp32 output),
    against the plain version under phase 3a's bar and bitwise on a rerun;
    timed as ``check_matvec`` times them (device time of a CUDA graph over
    >= 128 MB of distinct weights), with the plain version, the library
    call and the byte bound. Returns rows by kernel."""
    kernels = (("matvec_int8", mv.matvec_int8),
               ("matvec_int8_pipelined",
                functools.partial(mv.matvec_int8_pipelined, depth=4)))
    rows = {name: [] for name, _ in kernels}
    for t in TP_SIZES:
        for name, k, n, per in tp_matvecs(t):
            od = torch.float32 if name in ("wo", "down") else None
            ws, s, cycle = matvec_weights(torch, gen, k, n, per)
            for b in TP_MATVEC_ROWS:
                x = torch.randn(b, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                ref = mv.matvec_reference(x.float(), ws[0], s)
                for kname, kfn in kernels:
                    fn = functools.partial(kfn, out_dtype=od)
                    out, again = fn(x, ws[0], s), fn(x, ws[0], s)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    if not (rel <= MATVEC_REL_TOL and torch.equal(out,
                                                                  again)):
                        raise AssertionError(
                            f"{kname} tp{t} {name} at {b} rows: rel err "
                            f"{rel}, rerun equal {torch.equal(out, again)}")
                    row = dict(call=f"tp{t}_{name}", tp=t, shape=[b, k, n],
                               out_dtype=str(out.dtype).split(".")[1],
                               max_abs_err=err, rel_err=rel, per_step=per)
                    row.update(matvec_times(
                        torch, mv, lambda w: fn(x, w, s), x, ws, s, cycle,
                        ref, library=True, out_dtype=od))
                    rows[kname].append(row)
            del ws
            torch.cuda.empty_cache()
    return rows


def tp_step_totals(rows) -> dict:
    """A rank's 32 layers of decode matvecs (its qkv, wo, gateup, down; the
    whole lm_head is phase 3a's) at each t and row count: ms, plain,
    library and bound summed over the 128 launches."""
    out = {}
    for t in TP_SIZES:
        for b in TP_MATVEC_ROWS:
            sel = [r for r in rows if r["tp"] == t and r["shape"][0] == b]
            out[f"tp{t}_rows{b}"] = {
                key: None if any(r[key] is None for r in sel) else
                sum(r[key] * r["per_step"] for r in sel)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")}
            out[f"tp{t}_rows{b}"]["bound_by"] = max(
                sel, key=lambda r: r["bound_ms"])["bound_by"]
    return out


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
    and the same int8 alignment cache. Three prefills: the reference's
    (video-long), ``video_mode="simple"`` (the pooled video: no video-long
    attention, and at the 7b video conv kernel of 36 over 6 frames no video
    token between the boundaries) and ``quantize_towers`` (W8A8 CLIP and
    Whisper projections, torch._int_mm on the card, on the CPU too)."""
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.prefill import prefill
    from macaw_llm_tpu_torch.utils import quantize as qz
    cfg = dataclasses.replace(
        cfg7, llm=dataclasses.replace(cfg7.llm, num_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_layers=2),
        audio=dataclasses.replace(cfg7.audio, encoder_layers=2))
    params = fusion.init_params(1, cfg, dtype=torch.bfloat16, device="cuda")
    cache = fusion.precompute_align_cache(params, cfg, quantize=True)
    params = fusion.pack_towers(fusion.strip_align_kv(params))
    batch = make_batch(torch, cfg, 2, 256, seed=2)
    towers = combines(torch, ((whisper(2), 2),))
    cases = (
        ("long", params, "long", {"mh_attention": 2, "flash_attention": 3,
                                  "flash_attention_combine": towers
                                  + combines(torch, ((video_long(2), 1),))}),
        ("video_simple", params, "simple", {
            "mh_attention": 2, "flash_attention": 2,
            "flash_attention_combine": towers}),
        ("quantize_towers", qz.quantize_towers(params), "long", {
            "mh_attention": 2, "flash_attention": 3,
            "flash_attention_combine": towers
            + combines(torch, ((video_long(2), 1),))}))
    results = {}
    for name, p, video_mode, expect in cases:
        reset_counts(kernels)
        gpu = prefill(p, cfg, batch, cache, video_mode=video_mode)
        torch.cuda.synchronize()
        launched = counts(kernels)
        if any(launched[k] != n for k, n in expect.items()):
            raise AssertionError(f"2-layer model ({name}) launches "
                                 f"{launched}, expected {expect}")
        t0 = time.perf_counter()
        cpu = prefill(to_device(p, "cpu"), cfg, to_device(batch, "cpu"),
                      to_device(cache, "cpu"), video_mode=video_mode,
                      device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu = gpu.float().cpu()
        rel = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
        top2 = cpu.topk(2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) / cpu.abs().max()).tolist()
        same = bool((gpu.argmax(-1) == cpu.argmax(-1)).all())
        result = dict(case=name, rel_err=rel, argmax_equal=same,
                      cpu_top2_rel_gap=gap, cpu_seconds=cpu_s,
                      launches=launched)
        log(json.dumps({"small_model_parity": result}))
        if not (rel <= LOGITS_REL_TOL and same):
            raise AssertionError(f"2-layer model parity ({name}) failed: "
                                 f"{result}")
        results[name] = result
    return results


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


def run_prefill(torch, params, cfg, cache, kernels, steps=10, warmup=3,
                batch=None, name="prefill"):
    """The 7b prefill at batch 16, text 256: launches asserted, then the
    median of ``steps`` timed calls. Returns the result line, the batch and
    the first call's logits."""
    from macaw_llm_tpu_torch.prefill import prefill
    b, s = 16, 256
    if batch is None:
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
        raise AssertionError(f"{name} launches {launched} != {expect}")
    if logits.shape != (b, cfg.llm.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} logits {logits.shape} not finite")
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
    log(json.dumps({name: result}))
    return result, batch, logits


def run_prefill_quantized_towers(torch, params, cfg, cache, kernels, batch,
                                 logits_5, prefill_5, card: str):
    """5b: phase 5's batch and weights with ``quantize_towers`` (int8 CLIP
    and Whisper projections, W8A8 like the LLaMA): the same launches, its
    median ms beside phase 5's, and its logits against phase 5's (cosine,
    argmax agreement)."""
    from macaw_llm_tpu_torch.utils import quantize as qz
    qparams = qz.quantize_towers(params)
    torch.cuda.synchronize()
    res, _, logits = run_prefill(torch, qparams, cfg, cache, kernels,
                                 batch=batch, name="prefill_quantize_towers")
    a, b = logits.double(), logits_5.double()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    agree = (logits.argmax(-1) == logits_5.argmax(-1)).float().mean().item()
    result = dict(step_ms_median=res["step_ms_median"],
                  phase5_step_ms_median=prefill_5["step_ms_median"],
                  examples_per_s=res["examples_per_s"],
                  logits_cosine_min=cos.min().item(),
                  logits_cosine_mean=cos.mean().item(),
                  argmax_agreement=agree, launches=res["launches"],
                  card=card)
    log(json.dumps({"prefill_quantize_towers_vs_5": result}))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("5b logits not finite")
    del qparams
    return result


def run_generate(torch, params, cfg, cache, batch, kernels, new=16, b=4,
                 name="decode"):
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
                  tokens=toks.tolist())
    log(json.dumps({name: result}))
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


def stream_metrics(stamps, seconds: float, tokens) -> dict:
    """Served tokens/s, TTFT and ITL p50/p95 (ms) of requests whose
    ``stamps`` are their submit time followed by each streamed token's
    arrival (``serve_all``'s), over a run of ``seconds``."""
    ttfts = [ts[1] - ts[0] for ts in stamps if len(ts) >= 2]
    itls = [b - a for ts in stamps if len(ts) >= 3
            for a, b in zip(ts[1:-1], ts[2:])]
    total = sum(len(t) for t in tokens)
    return dict(requests=len(stamps), tokens=total, seconds=seconds,
                served_tokens_per_s=total / seconds,
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                ttft_p95_ms=percentile(ttfts, 0.95) * 1e3,
                itl_p50_ms=statistics.median(itls) * 1e3,
                itl_p95_ms=percentile(itls, 0.95) * 1e3)


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


def greedy_with_logits(torch, params, cfg, emb, mask, n: int,
                       cache_dtype=None):
    """``generate``'s greedy loop, step for step (the same calls, so the
    same tokens up to each row's EOS), keeping every step's fp32 logits on
    the host: [B, n] tokens and [B, n, V] logits."""
    from macaw_llm_tpu_torch.generate import _prompt_layout
    from macaw_llm_tpu_torch.models import llama
    with torch.inference_mode():
        b, s, _ = emb.shape
        full_mask, prompt_pos, prompt_len, last_valid = _prompt_layout(
            mask, b, s, n, emb.device)
        valid = llama.valid_vocab(cfg)
        cache = llama.KVCache.create(
            cfg, b, s + n, emb.dtype if cache_dtype is None else cache_dtype,
            emb.device)
        h = llama.forward_hidden(params, cfg, emb, attention_mask=full_mask,
                                 positions=prompt_pos, kv_cache=cache)
        logits = llama.logits_from_hidden(
            params, h[torch.arange(b, device=emb.device), last_valid][:, None],
            valid)[:, 0]
        toks, steps = [logits.argmax(-1)], [logits.float().cpu()]
        for step in range(1, n):
            e = params["embed_tokens"].to(emb.dtype)[toks[-1]][:, None, :]
            logits = llama.forward(params, cfg, inputs_embeds=e,
                                   attention_mask=full_mask,
                                   positions=(prompt_len + step - 1)[:, None],
                                   kv_cache=cache)[:, -1]
            toks.append(logits.argmax(-1))
            steps.append(logits.float().cpu())
    return torch.stack(toks, 1).cpu(), torch.stack(steps, 1)


def near_tie_flips(torch, got, greedy, logits_fn, eos_id=None,
                   tol=LOGITS_REL_TOL) -> list:
    """Rows whose tokens differ from the greedy ones: at the first
    differing step the greedy step's logits of the two tokens must be
    within ``tol`` of max |logit| (phase 4c's rule; what follows is
    another sequence and is not compared). ``logits_fn()`` gives
    ``greedy_with_logits``' tokens and logits, asked for only if a row
    differs."""
    got, greedy = got.cpu(), greedy.cpu()
    flips, ref = [], None
    for r in range(got.shape[0]):
        diff = (got[r] != greedy[r]).nonzero()
        if not len(diff):
            continue
        j = int(diff[0, 0])
        if ref is None:
            ref = logits_fn()
            if not torch.equal(ref[0][:, :j + 1][r], greedy[r, :j + 1]):
                raise AssertionError("the greedy loop with logits left "
                                     "generate's tokens")
        lg = ref[1][r, j]
        gap = (lg[greedy[r, j]] - lg[got[r, j]]).abs().item() / \
            lg.abs().max().item()
        flips.append(dict(row=r, step=j, rel_gap=gap))
        if not gap <= tol:
            raise AssertionError(f"row {r} differs from greedy at step {j}: "
                                 f"the greedy step's logits are {gap} apart")
    return flips


def run_speculative(torch, params, cfg, fused, prompt_ids, kernels,
                    card: str, new=64, k=4, ngram=2):
    """6c: ``generate_speculative`` at 7b on phase 6's fused prefix (4
    requests, int8 packed weights): draft_len 4, ngram 2, with the bf16
    and the int8 KV cache, proposer "ngram", "oracle" (the greedy tokens of
    ``generate`` at 64 steps as the oracle) and "oracle_self" (the ngram
    run's own tokens as the oracle: the verify's acceptance-1 speed, where
    "oracle" loses its drafts at the first token that the verify's B6
    rounding flips against the greedy step's B5); ``prompt_ids`` are the
    text ids the fusion consumed. Every verify round launches B6 129 times
    at 4 x 5 = 20 rows; the tokens are the greedy ones, or differ first at
    a near tie; each run twice, the same tokens."""
    from macaw_llm_tpu_torch.generate import generate, generate_speculative
    emb, mask = fused.inputs_embeds, fused.attention_mask
    b = emb.shape[0]
    per_round = 4 * cfg.llm.num_layers + 1
    results = {}
    for cache_dtype in (None, "int8"):
        cache_name = cache_dtype or "bf16"

        def greedy():
            out = generate(params["llm"], cfg.llm, inputs_embeds=emb,
                           attention_mask=mask, max_new_tokens=new,
                           eos_id=-1, cache_dtype=cache_dtype)
            torch.cuda.synchronize()
            return out

        greedy()
        t0 = time.perf_counter()
        ref = greedy()
        greedy_s = time.perf_counter() - t0
        logits_fn = functools.partial(
            greedy_with_logits, torch, params["llm"], cfg.llm, emb, mask,
            new, cache_dtype)
        results[cache_name] = {"generate": dict(
            tokens_per_s=b * new / greedy_s, seconds=greedy_s)}
        oracles = {"ngram": None, "oracle": ref.tokens}
        for proposer in ("ngram", "oracle", "oracle_self"):
            def spec():
                out = generate_speculative(
                    params["llm"], cfg.llm, inputs_embeds=emb,
                    prompt_ids=prompt_ids, attention_mask=mask,
                    max_new_tokens=new, eos_id=-1, draft_len=k, ngram=ngram,
                    cache_dtype=cache_dtype,
                    proposer="ngram" if proposer == "ngram" else "oracle",
                    oracle_tokens=oracles[proposer])
                torch.cuda.synchronize()
                return out

            reset_counts(kernels)
            first = spec()
            launched = counts(kernels)
            expect = dict({name: 0 for name in launched},
                          matvec_int8=1,
                          matvec_int8_pipelined=per_round * first.num_steps)
            if launched != expect:
                raise AssertionError(f"speculative ({cache_name}, "
                                     f"{proposer}) launches {launched} != "
                                     f"{expect}")
            t0 = time.perf_counter()
            second = spec()
            seconds = time.perf_counter() - t0
            if not torch.equal(first.tokens, second.tokens) or \
                    first.num_steps != second.num_steps:
                raise AssertionError(f"speculative ({cache_name}, "
                                     f"{proposer}) is not repeatable")
            flips = near_tie_flips(torch, first.tokens, ref.tokens,
                                   logits_fn)
            if proposer == "ngram":
                oracles["oracle_self"] = first.tokens
            row = dict(tokens_per_s=b * new / seconds, seconds=seconds,
                       rounds=first.num_steps,
                       acceptance=(new - 1) / first.num_steps,
                       b6_per_round=per_round, rows_per_round=b * (k + 1),
                       identical_rows=b - len(flips), flips=flips,
                       same_as_ngram=bool(torch.equal(
                           first.tokens, oracles["oracle_self"])),
                       launches=launched)
            results[cache_name][proposer] = row
    result = dict(requests=b, new_tokens=new, draft_len=k, ngram=ngram,
                  prompt_len=emb.shape[1], card=card, **results)
    log(json.dumps({"speculative": result}))
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
        slots=slots, media_requests=n_media, sampled_requests=n_sampled,
        new_tokens=new, **stream_metrics(stamps, elapsed, tokens),
        steady_tokens_per_s=steady, steady_step_ms=step_ms, steps=steps,
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
    engine._active_dev.fill_(True)

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
    text 1024 (fused 1080: flash forward, dq, dk/dv); then at text 256
    with remat policy "dots" and with Whisper LayerDrop 0.5 (the keep
    vector drawn on the host from one seeded CPU generator a side: the
    same layers dropped on both)."""
    from macaw_llm_tpu_torch.models import whisper as whisper_model
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

    def loss_and_grads(device, batch, cfg=cfg, rng_seed=None):
        tr = fresh(trainable, device)
        rng = None if rng_seed is None else \
            torch.Generator().manual_seed(rng_seed)
        loss, _ = fusion.forward(
            merge_params(tr, to_device(frozen, device)), cfg,
            input_ids=batch["input_ids"], images=batch["images"],
            audios=batch["audios"], videos=batch["videos"],
            attention_mask=batch["attention_mask"], labels=batch["labels"],
            dropout_rng=rng, lora_scale=2.0,
            align_cache=to_device(cache, device))
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
    # LayerDrop: the first seed whose keep vector over Whisper's 2 layers
    # keeps one and drops one (alignment dropout stays off: the generator
    # draws only the keep vector)
    drop_cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, encoder_layerdrop=0.5))
    drop_seed = next(seed for seed in range(100) if sum(
        whisper_model.layerdrop_keep(torch.Generator().manual_seed(seed), 2,
                                     0.5)) == 1)
    kept = 1
    cases = [(str(text), text, cfg, None, expect)
             for text, expect in expects.items()]
    cases += [
        ("256_dots", 256, dataclasses.replace(cfg, remat_policy="dots"),
         None, expects[256]),
        ("256_layerdrop", 256, drop_cfg, drop_seed, dict(
            expects[256], flash_attention=kept + 1,
            flash_attention_combine=combines(torch, (
                (whisper(1), kept), (video_long(1), 1)))))]
    results = {}
    for name, text, case_cfg, rng_seed, expect in cases:
        batch = {k: v[0] for k, v in
                 train_batch(torch, cfg, 1, 1, text, seed=7).items()}
        reset_counts(kernels)
        gpu_loss, gpu_grads = loss_and_grads("cuda", batch, case_cfg,
                                             rng_seed)
        torch.cuda.synchronize()
        launched = counts(kernels)
        if launched != expect:
            raise AssertionError(f"2-layer train step ({name}): launches "
                                 f"{launched} != {expect}")
        t0 = time.perf_counter()
        cpu_loss, cpu_grads = loss_and_grads("cpu", to_device(batch, "cpu"),
                                             case_cfg, rng_seed)
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
        result = dict(case=name, remat_policy=case_cfg.remat_policy,
                      layerdrop_keep=None if rng_seed is None else
                      whisper_model.layerdrop_keep(
                          torch.Generator().manual_seed(rng_seed), 2, 0.5),
                      text=text, fused_len=batch["input_ids"].shape[1]
                      + cfg.total_prefix_len, gpu_loss=gpu_loss,
                      cpu_loss=cpu_loss, loss_rel_err=loss_rel,
                      max_grad_rel_err=grad_rel[worst], worst_leaf=worst,
                      grad_rel_err=grad_rel, leaves_zero_on_both=len(
                          zero_leaves), cpu_seconds=cpu_s, launches=launched)
        log(json.dumps({"small_train_parity": result}))
        if not (loss_rel <= TRAIN_LOSS_REL_TOL
                and grad_rel[worst] <= TRAIN_GRAD_REL_TOL):
            raise AssertionError(f"2-layer train parity ({name}) failed: "
                                 f"loss {loss_rel}, {worst} "
                                 f"{grad_rel[worst]}")
        results[name] = result
        if name == "1024":  # phase 14b's reference: the one-device step
            results["card_1024"] = dict(loss=gpu_loss, grads={
                k: g.float().cpu() for k, g in gpu_grads.items()
                if "/lora/" in k})
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


def phase10_config(out: Path, layers=None, mesh=None, model=None,
                   model_fields=None, vocab_pad_to=None, **train):
    """A copy of the committed 1b run file, written to ``out``, with the
    train fields in ``train``; ``model`` (a ModelConfig, e.g. macaw_7b())
    gives the LLaMA and the towers in place of the file's, ``vocab_pad_to``
    pads the LLaMA's vocab, ``layers`` cuts the depth of every stack and
    ``model_fields`` sets other model fields (``shard_sequence``, the
    ring). ``mesh`` (axis sizes, the file's mesh being all 1s) spreads the
    run: the per-device batch is cut so that the global batch stays 10a's
    8, the tensor axis, which does not cut the batch, included
    (run_train's global batch is per-device x processes)."""
    from macaw_llm_tpu_torch.config import Config
    cfg = Config.from_json(TRAIN_1B_RUN.read_text())
    m = cfg.model
    llm, vision, audio = (model or m).llm, (model or m).vision, \
        (model or m).audio
    if vocab_pad_to is not None:
        llm = dataclasses.replace(llm, vocab_pad_to=vocab_pad_to)
    if layers is not None:
        llm = dataclasses.replace(llm, num_layers=layers)
        vision = dataclasses.replace(vision, num_layers=layers)
        audio = dataclasses.replace(audio, encoder_layers=layers)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                                **mesh))
        train = dict(per_device_batch_size=cfg.train.per_device_batch_size
                     // math.prod(mesh.values()), **train)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(m, llm=llm, vision=vision,
                                       audio=audio, **(model_fields or {})),
        train=dataclasses.replace(cfg.train, **train))
    out.write_text(cfg.to_json())
    return cfg


def metrics_rows(run_dir: Path) -> list:
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


HF_VOCAB = 32000  # the reference's LLaMA vocab before its 7 new tokens


def import_1b(torch, work: Path) -> tuple:
    """10 (before 10a): the seeded 1b LLaMA, cut to its first 32000 vocab
    rows, written by ``hf_export.export_llama`` as safetensors into the
    phase's directory; ``run_train.load_pretrained`` of it (the path of
    ``--llama-weights``) must give the seeded leaves bit for bit, and the 7
    rows ``resize_token_embeddings`` adds each the mean of the 32000.
    Returns the checkpoint directory and the result line."""
    from macaw_llm_tpu_torch import run_train
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.utils.hf_export import export_llama
    from macaw_llm_tpu_torch.utils.safetensors_io import save_safetensors
    cfg = phase10_config(work / "train_1b.json", save_steps=1000,
                         log_steps=1)
    m = cfg.model
    seeded = fusion.init_params(cfg.train.seed, m,
                                dtype=getattr(torch, m.param_dtype),
                                device="cuda")["llm"]
    t0 = time.perf_counter()
    cut = dict(seeded, embed_tokens=seeded["embed_tokens"][:HF_VOCAB],
               lm_head=seeded["lm_head"][:, :HF_VOCAB])
    hf_dir = work / "llama_hf"
    hf_dir.mkdir()
    save_safetensors(export_llama(cut, m.llm),
                     str(hf_dir / "model.safetensors"))
    export_s = time.perf_counter() - t0
    args = run_train.parse_args(["--llama-weights", str(hf_dir),
                                 "--device", "cuda"])
    t0 = time.perf_counter()
    loaded = run_train.load_pretrained(cfg, args)["llm"]
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    want = _leaf_map(seeded)
    got = _leaf_map(loaded)
    for key in ("/embed_tokens", "/lm_head"):
        cols = key == "/lm_head"
        ref = (want[key][:, :HF_VOCAB] if cols else
               want[key][:HF_VOCAB]).contiguous()  # the imported layout
        mean = ref.mean(1 if cols else 0, keepdim=True)
        want[key] = torch.cat([ref, mean.expand(
            ref.shape[0], m.llm.vocab_size - HF_VOCAB) if cols else
            mean.expand(m.llm.vocab_size - HF_VOCAB, ref.shape[1])],
            1 if cols else 0)
    diff = differing_leaves(torch, got, want)
    if diff:
        raise AssertionError(f"imported 1b LLaMA differs from the seeded "
                             f"one: {diff}")
    result = dict(leaves=len(got), bytes=(hf_dir / "model.safetensors")
                  .stat().st_size, export_s=export_s, import_s=import_s,
                  resized_rows=m.llm.vocab_size - HF_VOCAB,
                  bitwise=True)
    log(json.dumps({"import_1b": result}))
    del seeded, cut, loaded, want, got
    torch.cuda.empty_cache()
    return hf_dir, result


def step_hook(torch, kernels, rows: list, each=None):
    """``run_train.main``'s ``on_step``: each step synchronized, its ms (since
    the last step, the first since the hook was made), loss, gradient norm,
    loader wait, launches, collectives and peak memory appended to
    ``rows``; ``each(step, state, row)`` runs before the counts are reset
    and the clock restarts."""
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    mark = [time.perf_counter()]

    def on_step(step, state, metrics):
        torch.cuda.synchronize()
        row = dict(step=step, step_ms=(time.perf_counter() - mark[0]) * 1e3,
                   loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   loader_wait_s=metrics["loader_wait_s"],
                   launches=counts(kernels), collectives=dict(COLLECTIVES),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows.append(row)
        if each is not None:
            each(step, state, row)
        reset_counts(kernels)
        COLLECTIVES.clear()
        mark[0] = time.perf_counter()

    return on_step


def run_train_1b(torch, kernels, card: str, work: Path, expect: dict,
                 out_dir=None, llama_dir=None, offload: bool = False):
    """10a: ``run_train.main`` on the 1b run file (synthetic zero-media
    batches), 2 warm-up + 5 timed steps, then --do-eval and the forced
    final save; every step synchronized and its launches read by the
    ``on_step`` hook. With ``out_dir`` one more step runs under
    torch.profiler (untimed; its table goes to out_dir); ``llama_dir``
    passes ``--llama-weights``. ``offload`` (12b): the same run with
    ``offload_optimizer``, Adam's moments checked to be in pinned host
    memory after every step. Returns the result line and the trained
    state."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from macaw_llm_tpu_torch import run_train
    tag = "train_1b_offload" if offload else "train_1b"
    extra = dict(offload_optimizer=True) if offload else {}
    cfg = phase10_config(work / f"{tag}.json", save_steps=1000,
                         log_steps=1, **extra)
    run_dir = work / f"run_{tag}"
    warm, timed = 2, 5
    n_steps = warm + timed + (out_dir is not None)
    steps = []
    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def each(step, state, row):
        if offload:
            moments = (_tensors(state.opt_state.mu)
                       + _tensors(state.opt_state.nu))
            row["moments_pinned"] = all(
                t.device.type == "cpu" and t.is_pinned() for t in moments)
            row["moments_host_bytes"] = sum(t.numel() * t.element_size()
                                            for t in moments)
        log(json.dumps({f"{tag}_step": row}))
        if out_dir is not None and step == n_steps:  # one loop iteration
            prof.__exit__(None, None, None)
            table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25)
            (out_dir / "profile_train1b.txt").write_text(table)
            log(f"== profile train1b\n{table}")
            log(json.dumps({"profile": "train1b", "wall_ms": row["step_ms"],
                            "device_busy_ms": device_busy_ms(prof)}))
        if out_dir is not None and step == n_steps - 1:
            prof.__enter__()

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    on_step = step_hook(torch, kernels, steps, each)
    t0 = time.perf_counter()
    weights = [] if llama_dir is None else ["--llama-weights",
                                            str(llama_dir)]
    state = run_train.main([
        "--config", str(work / f"{tag}.json"), "--synthetic",
        "--steps", str(n_steps), "--do-eval", "--output-dir",
        str(run_dir), "--device", "cuda"] + weights, on_step=on_step)
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
    if offload:
        if not all(r["moments_pinned"] for r in steps):
            raise AssertionError("12b: Adam's moments not in pinned host "
                                 "memory after every step")
        result["moments_host_bytes"] = steps[-1]["moments_host_bytes"]
    log(json.dumps({tag: result}))
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
    # speculative decode (draft 4) on the restored weights: the greedy
    # tokens, or a first difference at a near tie of the greedy step (its
    # inputs caught from eval's call of generate)
    from macaw_llm_tpu_torch import eval as eval_mod
    caught = {}
    real_generate = eval_mod.generate

    def catching(p, c, **kw):
        caught.update(kw, params=p, cfg=c)
        return real_generate(p, c, **kw)

    eval_mod.generate = catching
    try:
        batch_inference_generation(restored, cfg, BenchTok(), examples,
                                   batch_size=8, max_new_tokens=new,
                                   device="cuda")
    finally:
        eval_mod.generate = real_generate
    t1 = time.perf_counter()
    spec = batch_inference_generation(restored, cfg, BenchTok(), examples,
                                      batch_size=8, max_new_tokens=new,
                                      speculative=4, device="cuda")
    spec_s = time.perf_counter() - t1

    def tokens(gens):
        return torch.tensor([result_tokens({"text": g}) + [-1] * (
            new - len(g.split())) for g in gens])

    flips = near_tie_flips(
        torch, tokens([r["generation"] for r in spec]),
        tokens(gens["restored"][0]), functools.partial(
            greedy_with_logits, torch, caught["params"], caught["cfg"],
            caught["inputs_embeds"], caught["attention_mask"], new))
    result = dict(prompts=len(examples), new_tokens=new, restore_s=restore_s,
                  leaves=len(_leaf_map(restored)),
                  generate_s=gens["restored"][1],
                  speculative_s=spec_s, speculative_flips=flips,
                  speculative_identical=len(examples) - len(flips),
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
                do_profile: bool, card_4b: dict):
    """Phase 10 (10a, 10b, 10c), then 12b, 12c and 14 on its imported
    weights, in a directory under ``out_dir`` that is deleted when the
    phase ends, whatever happens. ``card_4b``: phase 4b's one-device step
    at text 1024 (14b's reference)."""
    work = out_dir / "phase10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        log(json.dumps({"phase10_disk_free_gb":
                        shutil.disk_usage(work).free / 1e9}))
        t0 = time.perf_counter()
        llama_dir, imported = import_1b(torch, work)
        train, state, cfg, run_dir = run_train_1b(
            torch, kernels, card, work, expect,
            out_dir=out_dir if do_profile else None, llama_dir=llama_dir)
        restore = restored_generation(torch, state, cfg, run_dir)
        del state
        torch.cuda.empty_cache()
        resume = resume_1b(torch, work)
        log(json.dumps({"phase10_seconds": time.perf_counter() - t0}))
        # phase 12b and 12c train the same imported weights
        t0 = time.perf_counter()
        offload = run_offload_1b(torch, kernels, card, work, expect,
                                 llama_dir, train)
        torch.cuda.empty_cache()
        ring = run_ring_child(torch, card, work, llama_dir, train)
        log(json.dumps({"phase12bc_seconds": time.perf_counter() - t0}))
        # 14: tensor-parallel training, 2 ranks on this card
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        tp_train = run_tp_train(torch, card, work, llama_dir, train, card_4b)
        log(json.dumps({"phase14_seconds": time.perf_counter() - t0}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(imported=imported, train=train, restore=restore,
                resume=resume, offload=offload, ring=ring, tp_train=tp_train)


# --------------------------------------------------------------------------
# phase 12: the parallel layer
# --------------------------------------------------------------------------

def ring_expected(n: int, layout: str) -> int:
    """B2 launches of one ring over n chunks (B3 and B4 alike): causal on
    the diagonal and full below it (contiguous), or every rank's late half
    against its early keys each step plus the diagonal's two causal halves
    and one full pair off it (zig-zag)."""
    return n * (n + 1) // 2 if layout == "contiguous" else n * (2 * n + 1)


def ring_case(torch, fa, ring, q, k, v, g, n: int, layout: str):
    """The ring over n chunks of whole [B, S, N, D] q/k/v in their natural
    order (zig-zag: permuted in, the output permuted back): (out, dq, dk,
    dv, B2/B3/B4/delta/combine launches of the forward and backward). On
    CPU tensors every step runs the wrappers' plain versions."""
    perm = (ring.zigzag_indices(q.shape[1], n) if layout == "zigzag"
            else torch.arange(q.shape[1]))
    inv = ring.inverse_permutation(perm).to(q.device)
    perm = perm.to(q.device)
    x = [t[:, perm].detach().requires_grad_() for t in (q, k, v)]
    names = ("flash_attention_with_lse", "flash_attention_dq",
             "flash_attention_dkv", "flash_attention_delta",
             "flash_attention_combine")
    fns = [getattr(fa, name) for name in names]
    for fn in fns:
        fn.launches = 0
    out = ring.ring_attention_local(*x, n, layout)
    fwd = fns[0].launches
    out.backward(g[:, perm])
    torch.cuda.synchronize()
    launches = dict(zip(names, [fn.launches for fn in fns]))
    launches["forward_b2"] = fwd
    return (out[:, inv].detach(), *(t.grad[:, inv] for t in x)), launches


def run_ring_local(torch, card: str) -> dict:
    """12a: ``ring_attention_local`` at 7b widths (32 heads of 128, bf16),
    forward and backward: at 8192 positions, n = 4 and 8, both layouts,
    against one B2 forward and B3/B4 backward over the whole sequence and
    timed beside it; at 2048, against its plain version (the same ring on
    the CPU: each step's plain forward and backward, which round as the
    kernels do) under phase 3's and 3b's row bars (the gradients, sums of
    several steps' rows, under twice 3b's); the launches of a ring
    asserted."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.parallel import ring_attention as ring
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def single(q, k, v, g):
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*x, causal=True)
        out.backward(g)
        return (out.detach(), *(t.grad for t in x))

    def check(got, ref, what, bars):
        errs = {}
        for name, a, b, bar in zip(("out", "dq", "dk", "dv"), got, ref,
                                   bars):
            fn = row_rel_err if name == "out" else grad_row_err
            errs[name] = fn(a, b)
            if not errs[name] <= bar:
                raise AssertionError(f"12a {what}: {name} row rel err "
                                     f"{errs[name]} > {bar}")
        return errs

    bars = (ATTN_ROW_REL_TOL,) + (RING_GRAD_REL_TOL,) * 3
    rows = []
    b, n_h, d = 1, 32, 128
    s = 8192
    q, k, v, g = (rn(b, s, n_h, d) for _ in range(4))
    ref = single(q, k, v, g)
    single_ms = cuda_ms(torch, lambda: single(q, k, v, g), iters=3)
    flops = 3.5 * attn_flops(b, s, s, n_h, d, True)  # fwd + 2.5x bwd
    for n in (4, 8):
        for layout in ("contiguous", "zigzag"):
            got, launches = ring_case(torch, fa, ring, q, k, v, g, n, layout)
            want = ring_expected(n, layout)
            counted = {key: launches[key] for key in (
                "forward_b2", "flash_attention_dq", "flash_attention_dkv",
                "flash_attention_delta")}
            if any(c != want for c in counted.values()):
                raise AssertionError(f"12a ring n={n} {layout}: launches "
                                     f"{launches}, expected {want} each")
            errs = check(got, ref, f"n={n} {layout} vs single call",
                         (RING_VS_SINGLE_TOL,) * 4)
            ms = cuda_ms(torch, lambda: ring_case(
                torch, fa, ring, q, k, v, g, n, layout), iters=3)
            # q, k, v and dO read, O, dQ, dK and dV written, bf16
            bound_ms, bound_by = bound(flops, 8 * b * s * n_h * d * 2)
            row = dict(seq=s, n=n, layout=layout, ms=ms,
                       single_call_ms=single_ms, bound_ms=bound_ms,
                       bound_by=bound_by, launches=launches,
                       expected_launches=want, row_rel_err=errs, card=card)
            rows.append(row)
            log(json.dumps({"ring_local": row}))
    del q, k, v, g, ref
    torch.cuda.empty_cache()
    # the plain version: the same schedule on the CPU, the same bf16 inputs
    s = 2048
    q, k, v, g = (rn(b, s, n_h, d) for _ in range(4))
    for layout in ("contiguous", "zigzag"):
        got, launches = ring_case(torch, fa, ring, q, k, v, g, 4, layout)
        t0 = time.perf_counter()
        plain, _ = ring_case(torch, fa, ring, *(t.cpu() for t in (q, k, v,
                                                                 g)),
                             4, layout)
        plain_s = time.perf_counter() - t0
        errs = check([t.cpu() for t in got], plain,
                     f"n=4 {layout} vs plain at {s}", bars)
        row = dict(seq=s, n=4, layout=layout, vs="plain (CPU)",
                   plain_s=plain_s, row_rel_err=errs, launches=launches,
                   card=card)
        rows.append(row)
        log(json.dumps({"ring_local": row}))
    return {"rows": rows,
            "launches": {f"n{r['n']}_{r['layout']}": r["expected_launches"]
                         for r in rows if "expected_launches" in r}}


def run_offload_1b(torch, kernels, card: str, work: Path, expect: dict,
                   llama_dir, train_10a: dict) -> dict:
    """12b: 10a's run with ``offload_optimizer``: the step losses the same
    bits as 10a's (else within 1e-3), the moments pinned in host memory."""
    res, state, _, _ = run_train_1b(torch, kernels, card, work, expect,
                                    llama_dir=llama_dir, offload=True)
    del state
    same = res["losses"] == train_10a["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(res["losses"], train_10a["losses"]))
    if not same and worst > 1e-3:
        raise AssertionError(f"12b losses {res['losses']} vs 10a's "
                             f"{train_10a['losses']}")
    line = dict(losses_same_bits=same, loss_max_rel_diff=worst,
                moments_host_bytes=res["moments_host_bytes"],
                peak_mem_gb=res["peak_mem_gb"],
                peak_mem_gb_10a=train_10a["peak_mem_gb"],
                step_ms_median=res["step_ms_median"],
                step_ms_median_10a=train_10a["step_ms_median"], card=card)
    log(json.dumps({"offload_1b": line}))
    return line


RING_CHILD = """
import json, sys, torch
from macaw_llm_tpu_torch import run_train
from macaw_llm_tpu_torch.parallel import sharding
import torch.distributed as dist
losses = []
def on_step(step, state, m):
    losses.append(float(m["loss"]))
state = run_train.main(sys.argv[1:], on_step=on_step)
print("RING_CHILD " + json.dumps(dict(
    losses=losses, step=state.step, backend=dist.get_backend(),
    world=dist.get_world_size(), collectives=dict(sharding.COLLECTIVES),
    nccl=".".join(map(str, torch.cuda.nccl.version())))), flush=True)
dist.destroy_process_group()
"""


def run_ring_child(torch, card: str, work: Path, llama_dir,
                   train_10a: dict) -> dict:
    """12c: ``run_train.main`` in a child process joined to a one-rank NCCL
    group through the reference's environment (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID), the run file's mesh (all 1s), ring
    attention (zig-zag, n = 1), 2 + 3 steps, no checkpoint."""
    import socket
    path = work / "train_1b_ring.json"
    phase10_config(path, model_fields=dict(ring_attention=True,
                                           ring_layout="zigzag"),
                   save_steps=0, log_steps=1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
               NUM_PROCESSES="1", PROCESS_ID="0",
               PYTHONPATH=str(ROOT))
    steps = 5
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", RING_CHILD, "--config", str(path),
         "--synthetic", "--steps", str(steps), "--output-dir",
         str(work / "run_ring"), "--device", "cuda", "--llama-weights",
         str(llama_dir)], env=env, capture_output=True, text=True,
        timeout=600, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RING_CHILD ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"12c child failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    got = json.loads(lines[-1][len("RING_CHILD "):])
    ref = train_10a["losses"][:steps]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref))
    issued = sum(got["collectives"].values())
    if got["backend"] != "nccl" or got["world"] != 1 or not issued \
            or worst > 1e-3 or got["step"] != steps:
        raise AssertionError(f"12c: {got} against 10a's losses {ref}")
    line = dict(got, losses_10a=ref, loss_max_rel_diff=worst,
                child_wall_s=wall, card=card)
    log(json.dumps({"ring_run_train": line}))
    return line


# --------------------------------------------------------------------------
# phase 13: tensor-parallel inference, t = 2 ranks on the one card
# --------------------------------------------------------------------------

TP_RANKS = 2
TP_NEW = 16
TP_TIMEOUT_S = 600.0  # the ranks are killed, and the phase fails, after this
# the ranks' fused prefix (towers and alignment cut) against one device's,
# relative to max |x|: bf16 roundings of sums in another order, read at
# 1.7e-5 to 2.1e-5 on an H100 80GB HBM3. The random 7b's 32 layers amplify
# such a rounding past any near-tie bar (13a reads one device's own logits
# under a one-ulp change of its prefix, 13b its engine's tokens under a
# one-ulp change of its token table), so 13a and 13b hold the prefix and
# the LLaMA that reads it apart: the prefix to this bar, the tokens to
# phase 4c's near-tie rule against one device's LLaMA on the ranks'
# prefix
TP_PREFIX_TOL = 1e-3


def kernel_table(mh, fa, mv) -> dict:
    """The kernel wrappers by name, each with its launch counter."""
    return {"mh_attention": mh.mh_attention,
            "flash_attention": fa.flash_attention_with_lse,
            "flash_attention_combine": fa.flash_attention_combine,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv,
            "flash_attention_delta": fa.flash_attention_delta,
            "matvec_int8": mv.matvec_int8,
            "matvec_int8_pipelined": mv.matvec_int8_pipelined}


def tp_requests(cfg):
    """13b's 16 requests: 4 with image, audio and video, 2 text ones
    sampled (temperature 0.8 and 1.2), budgets of 16 and 8 tokens."""
    from macaw_llm_tpu_torch.serve import Request
    return [Request(prompt=f"tensor parallel request {i}",
                    max_new_tokens=TP_NEW if i % 3 else 8,
                    temperature={6: 0.8, 10: 1.2}.get(i, 0.0),
                    **(engine_media(cfg, 60 + i) if i % 4 == 1 else {}))
            for i in range(16)]


TP_ENGINE_KW = dict(slots=16, prompt_bucket=64, max_new_tokens=TP_NEW,
                    align_cache="int8", kv_cache_dtype="int8")
# 13b's second engine run: the same with a bf16 KV cache
TP_KV_BF16 = dict(TP_ENGINE_KW, kv_cache_dtype=None)


def join_job(torch, job: dict, rank: int) -> None:
    """Join the job's process group (its FileStore): with ``job["across"]``
    one rank a card over NCCL (``multihost_initialize`` takes the card of
    the local rank); else gloo, every rank on card 0 (NCCL takes one rank
    a card)."""
    import torch.distributed as dist
    from macaw_llm_tpu_torch.parallel.mesh import multihost_initialize
    store = dist.FileStore(job["store"], job["world"])
    if job.get("across"):
        os.environ.update(PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                          NUM_PROCESSES=str(job["world"]))
        multihost_initialize("cuda", store=store)
        return
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=job["world"])


def tp_worker(job_path: str, rank: int) -> None:
    """One rank of phase 13 or 15c (``chip_smoke.py --tp-worker JOB
    --tp-rank R``): joins the job's group (``join_job``: gloo on one card,
    or one rank a card over NCCL), draws the whole 7b from phase 5's seed
    on its card (one rank at a time where they share it), quantizes its
    LLaMA, keeps this rank's block and packs it.
    13a: phase 5's b16 prefill through ``prefill`` (its fused prefix saved
    by rank 0), the LLaMA alone on phase 5's own prefix (saved by the
    parent), phase 6's 4 x 16 greedy ``generate`` on phase 6's prefix;
    13b: the engine over ``tp_requests``, with the int8 KV cache and then
    with a bf16 one. Launches and collectives counted, each timed on this
    rank; its results to the job's directory."""
    import torch
    import torch.distributed as dist
    from macaw_llm_tpu_torch import serve
    from macaw_llm_tpu_torch.config import macaw_7b
    from macaw_llm_tpu_torch.generate import generate
    from macaw_llm_tpu_torch.models import fusion, llama
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    from macaw_llm_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                              tp_params)
    from macaw_llm_tpu_torch.prefill import prefill
    from macaw_llm_tpu_torch.utils import quantize as qz
    with open(job_path) as f:
        job = json.load(f)
    world, work = job["world"], Path(job["out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    join_job(torch, job, rank)
    across = bool(job.get("across"))
    cfg = macaw_7b()
    tp = TensorParallel.world(cfg)
    kernels = kernel_table(mh, fa, mv)
    res = {"rank": rank, "cuts": sorted(tp.cuts)}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def start():
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        COLLECTIVES.clear()

    def counted(name):
        torch.cuda.synchronize()
        res[f"{name}_launches"] = counts(kernels)
        res[f"{name}_collectives"] = dict(COLLECTIVES)

    # the whole tree on the card, one rank at a time on a shared card
    t0 = time.perf_counter()
    block = None
    for r in [rank] if across else range(world):
        if r == rank:
            whole = fusion.init_params(0, cfg, dtype=torch.bfloat16,
                                       device="cuda")
            whole["llm"] = qz.quantize_llama(whole["llm"])
            block = tp_params(whole, tp)
            del whole
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    block["llm"] = qz.pack_llama_for_decode(block["llm"])
    with torch.inference_mode():
        cache = fusion.precompute_align_cache(block, cfg, quantize=True,
                                              tp=tp)
    served = fusion.pack_towers(fusion.strip_align_kv(block))
    sync()
    res["build_s"] = time.perf_counter() - t0
    res["block_gb"] = sum(x.numel() * x.element_size()
                          for x in _tensors(block["llm"])) / 1e9

    # 13a: phase 5's prefill, and its fused prefix
    batch = make_batch(torch, cfg, 16, 256, seed=3)
    start()
    res["logits"] = prefill(served, cfg, batch, cache, tp=tp).float().cpu()
    counted("prefill")
    times = []
    for i in range(3):  # a warm-up, then 2 timed
        sync()
        t1 = time.perf_counter()
        prefill(served, cfg, batch, cache, tp=tp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    res["prefill_ms"] = times[1:]
    res["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        fused = fusion.prepare_inputs(
            served, cfg, input_ids=batch["input_ids"],
            images=batch["images"], audios=batch["audios"],
            videos=batch["videos"], attention_mask=batch["attention_mask"],
            align_cache=cache, activation_quant=True, tp=tp)
        if rank == 0:
            torch.save(fused.inputs_embeds.cpu(), work / "tp_prefix.pt")
        # the LLaMA alone on phase 5's prefix
        emb = torch.load(work / "prefix5.pt").cuda()
        h = llama.forward_hidden(served["llm"], cfg.llm, emb,
                                 fused.attention_mask, use_flash=True,
                                 activation_quant=True, tp=tp)
        res["llama_on_prefix5"] = llama.logits_from_hidden(
            served["llm"], h[:, -1:], llama.valid_vocab(cfg.llm),
            tp=tp)[:, 0].float().cpu()
    del batch, fused, emb, h

    # 13a: phase 6's greedy decode on phase 6's prefix
    emb, mask = (x.cuda() for x in torch.load(work / "prefix6.pt"))

    def decode():
        out = generate(served["llm"], cfg.llm, inputs_embeds=emb,
                       attention_mask=mask, max_new_tokens=TP_NEW,
                       eos_id=-1, tp=tp)
        torch.cuda.synchronize()
        return out.tokens.cpu()

    start()
    res["tokens"] = decode()
    counted("decode")
    sync()
    t1 = time.perf_counter()
    res["decode_repeatable"] = torch.equal(decode(), res["tokens"])
    res["decode_s"] = time.perf_counter() - t1
    del emb, mask, cache, served
    torch.cuda.empty_cache()

    # 13b: the engine, the leader's schedule broadcast to the follower;
    # then the same with a bf16 KV cache
    serve._seed_from_clock = lambda: 1234

    def run_engine_tp(kw, prefixes=None, logits=None, key="engine_serve"):
        """The engine over ``tp_requests``: the leader's token lists (None
        on the follower), the seconds and the engine; the leader keeps
        each request's fused prefix in ``prefixes`` and its logits in
        ``logits``; its served tokens/s, TTFT and ITL go to ``res[key]``
        on the leader."""
        engine = serve.ContinuousEngine(block, cfg, BenchTok(), tp=tp, **kw)
        if tp.leader and prefixes is not None:
            record_prefixes(engine, prefixes)
        with (logits_recorded(engine, logits)
              if tp.leader and logits is not None
              else contextlib.nullcontext()):
            return drive(engine, key)

    def drive(engine, key):
        reqs = tp_requests(cfg)
        stamps = [[] for _ in reqs]  # the leader's: each token's arrival
        t1 = time.perf_counter()
        if tp.leader:
            for i, r in enumerate(reqs):
                stamps[i].append(t1)
                r.stream_cb = lambda tok, i=i: stamps[i].append(
                    time.perf_counter())
                engine.queue.put(r)
        engine.start()
        if tp.leader:
            for r in reqs:
                if not r._done.wait(TP_TIMEOUT_S):
                    raise TimeoutError("13b: a request did not finish")
            engine.stop()
        engine.join()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        if not tp.leader:
            return None, seconds, engine
        if any(r._result is None or "text" not in r._result for r in reqs):
            raise AssertionError("13b: a request failed")
        tokens = [result_tokens(r._result) for r in reqs]
        res[key] = stream_metrics(stamps, seconds, tokens)
        return tokens, seconds, engine

    start()
    res["engine_prefixes"], res["engine_logits"] = {}, {}
    res["engine_tokens"], res["engine_s"], engine = run_engine_tp(
        TP_ENGINE_KW, res["engine_prefixes"], res["engine_logits"])
    counted("engine")
    res["engine_stats"] = dict(engine.stats)
    res["engine_state"] = [engine.toks.cpu(), engine.lengths.cpu()]
    res["engine_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine
    torch.cuda.empty_cache()
    sync()
    res["engine_bf16_tokens"], res["engine_bf16_s"], engine = \
        run_engine_tp(TP_KV_BF16, key="engine_bf16_serve")
    del engine
    dist.barrier()
    torch.save(res, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def spawn_tp(world: int, work: Path, job: Optional[dict] = None,
             flag: str = "--tp-worker", phase: str = "13",
             timeout: float = TP_TIMEOUT_S) -> list:
    """Phase 13's (or, with ``flag`` and ``phase``, 14's and 15's) ranks as
    child processes of this script, given ``job`` (its "store" and "out"
    default to the FileStore and ``work``); every one is killed after
    ``timeout`` seconds, once it has written its threads' stacks to its
    output (SIGUSR1). A rank that fails fails the phase, with the ranks'
    output."""
    from macaw_llm_tpu_torch.parallel.dryrun import run_ranks
    store = work / "store"
    if store.exists():
        store.unlink()
    path = work / "job.json"
    path.write_text(json.dumps(dict({"world": world, "store": str(store),
                                     "out": str(work)}, **(job or {}))))
    codes, texts = run_ranks(
        [[sys.executable, str(Path(__file__).resolve()), flag, str(path),
          "--tp-rank", str(r)] for r in range(world)],
        dict(os.environ, GLOO_SOCKET_IFNAME="lo"), timeout, cwd=str(ROOT))
    if any(c != 0 for c in codes):
        raise AssertionError(
            f"phase {phase}: a rank failed (exit codes {codes}):\n"
            + "\n".join(f"--- rank {r} ---\n{t[-6000:]}"
                        for r, t in enumerate(texts)))
    import torch
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def engine_flips(torch, engine, cfg, reqs, got, ref, tol, prefixes=None,
                 logits=None):
    """Greedy requests whose token lists differ between ``got`` and
    ``ref`` (a one-device engine's): at the first difference (a list that
    ends first emitted EOS there) the one-device logits of the two tokens,
    after the request's fused prefix and the common tokens (no cache,
    ``engine``'s weights), must be within ``tol`` of max |logit| (phase
    4c's rule; ``math.inf`` only reads the gaps). The prefix is
    ``prefixes[prompt]`` where given, else ``engine``'s own. With
    ``logits`` (``ref``'s engine's own, ``logits_recorded``) the rule
    reads those at the difference instead (``rel_gap``; the no-cache
    logits' gap is ``clean_rel_gap``)."""
    from macaw_llm_tpu_torch.config import EOS_ID
    from macaw_llm_tpu_torch.data.templates import format_prompt
    from macaw_llm_tpu_torch.models import fusion, llama
    tok = BenchTok()
    zeros = engine_media(cfg, 0)
    flips = []
    for i, (g, c, req) in enumerate(zip(got, ref, reqs)):
        if req.temperature > 0 or g == c:
            continue
        j = next((j for j, (a, b) in enumerate(zip(g, c)) if a != b),
                 min(len(g), len(c)))
        tg = g[j] if j < len(g) else EOS_ID
        tc = c[j] if j < len(c) else EOS_ID
        with torch.inference_mode():
            if prefixes is not None:
                emb = prefixes[req.prompt]
            else:
                ids = torch.tensor([tok.encode(format_prompt(req.prompt))],
                                   device="cuda")
                media = {k: torch.from_numpy(
                    (getattr(req, k) if getattr(req, k) is not None
                     else zeros[k] * 0)[None]).cuda() for k in zeros}
                emb = fusion.prepare_inputs(
                    engine.params, cfg, input_ids=ids,
                    images=media["image"], audios=media["audio"],
                    videos=media["video"],
                    align_cache=engine.align_cache).inputs_embeds
            if j:
                emb = torch.cat([emb, llama.embed(
                    engine.params["llm"], torch.tensor([c[:j]],
                                                       device="cuda"),
                    emb.dtype)], dim=1)
            h = llama.forward_hidden(engine.params["llm"], cfg.llm, emb)
            lg = llama.logits_from_hidden(engine.params["llm"], h[:, -1:],
                                          llama.valid_vocab(cfg.llm))[0, 0]
        gap = (lg[tc] - lg[tg]).abs().item() / lg.abs().max().item()
        flip = dict(request=i, step=j, rel_gap=gap)
        if logits is not None:
            own = logits[req.prompt][j]
            gap = (own[tc] - own[tg]).abs().item() / own.abs().max().item()
            flip.update(rel_gap=gap, clean_rel_gap=flip["rel_gap"])
        flips.append(flip)
        if not gap <= tol:
            raise AssertionError(f"13b request {i} differs from the "
                                 f"one-device engine at token {j}: the "
                                 f"logits are {gap} apart (bar {tol})")
    return flips


def logits_drift(torch, reqs, got, ref, a: dict, b: dict) -> float:
    """The largest difference of two engines' recorded logits
    (``logits_recorded``) over the greedy requests' steps before their
    tokens first differ, relative to the step's max |logit| in ``b``."""
    worst = 0.0
    for g, c, req in zip(got, ref, reqs):
        if req.temperature > 0:
            continue
        same = next((j for j, (x, y) in enumerate(zip(g, c)) if x != y),
                    min(len(g), len(c)))
        for x, y in zip(a[req.prompt][:same + 1], b[req.prompt][:same + 1]):
            worst = max(worst, ((x - y).abs().max() /
                                y.abs().max()).item())
    return worst


def llama_last_logits(torch, llm, cfg, emb, mask):
    """Phase 5's LLaMA (W8A8, the attention kernels) on a fused prefix:
    the last positions' logits."""
    from macaw_llm_tpu_torch.models import llama
    with torch.inference_mode():
        h = llama.forward_hidden(llm, cfg.llm, emb, mask, use_flash=True,
                                 activation_quant=True)
        return llama.logits_from_hidden(llm, h[:, -1:],
                                        llama.valid_vocab(cfg.llm))[:, 0]


def nudge(torch, x, seed: int):
    """``x`` with one bf16 ulp taken off 1% of its elements (drawn from
    ``seed``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.rand(x.shape, generator=g, device="cuda") < 0.01
    return torch.where(pick, (x.float() * (1 - 2.0 ** -7)).to(x.dtype), x)


def record_prefixes(engine, store: dict) -> None:
    """Make ``engine``'s admission keep each request's fused prefix (the
    embeddings and mask its prefill reads, on the host) in
    ``store[prompt]``."""
    run, body, now = engine._prefill_ready, engine._prefill_body, {}

    def prefill_ready(req, adm):
        now["prompt"] = req.prompt
        return run(req, adm)

    def prefill_body(fused, temp):
        store[now["prompt"]] = (fused.inputs_embeds.cpu(),
                                fused.attention_mask.cpu())
        return body(fused, temp)
    engine._prefill_ready, engine._prefill_body = prefill_ready, prefill_body


def replay_prefixes(engine, store: dict) -> None:
    """Make ``engine``'s prefill read ``store[prompt]`` (another engine's
    fused prefix, ``record_prefixes``) instead of its own towers and
    alignment."""
    from macaw_llm_tpu_torch.models.fusion import FusedBatch
    run, now = engine._prefill_ready, {}

    def prefill_ready(req, adm):
        now["prompt"] = req.prompt
        return run(req, adm)

    def prefilled(temp):
        emb, mask = store[now["prompt"]]
        return engine._prefill_body(FusedBatch(
            emb.to(engine.device), mask.to(engine.device), None), temp)
    engine._prefill_ready = prefill_ready
    engine._prefill = lambda *args: prefilled(args[-1])
    engine._prefill_text = lambda ids, mask, temp: prefilled(temp)


@contextlib.contextmanager
def logits_recorded(engine, store: dict):
    """While open, ``engine`` keeps the logits each request's tokens are
    drawn from: ``store[prompt]`` = [the prefill's row, then one row a
    decode step] (fp32 on the host; a request that finished keeps the rows
    of its masked steps after its last token). ``serve._sample`` is
    wrapped, so one engine a process runs while it is open; open it before
    ``start``: the engine then steps eagerly, since a captured step cannot
    copy its logits to the host."""
    from macaw_llm_tpu_torch import serve
    sample, run, now = serve._sample, engine._prefill_ready, {}
    engine._capture_steps = lambda: None

    def prefill_ready(req, adm):
        now["prompt"] = req.prompt
        return run(req, adm)

    def recording(logits, gen, temp):
        rows = logits.float().cpu()
        if rows.shape[0] == engine.slots:  # a decode step
            for slot, req in enumerate(engine._reqs):
                if req is not None:
                    store[req.prompt].append(rows[slot])
        else:  # an admission's first token
            store[now["prompt"]] = [rows[0]]
        return sample(logits, gen, temp)
    engine._prefill_ready = prefill_ready
    serve._sample = recording
    try:
        yield
    finally:
        serve._sample = sample


def unpadded(store: dict) -> dict:
    """``record_prefixes``'s prefixes without their padding, on the card:
    [1, valid, H] by prompt."""
    return {k: emb[:, mask[0].bool()].cuda()
            for k, (emb, mask) in store.items()}


def one_device_engine(torch, params, cfg, kw, record=None, replay=None,
                      logits=None) -> list:
    """The one-device engine over ``tp_requests``: the token lists.
    ``record``/``replay``: a prefix store (``record_prefixes``,
    ``replay_prefixes``); ``logits``: a store for ``logits_recorded``."""
    from macaw_llm_tpu_torch.serve import ContinuousEngine
    engine = ContinuousEngine(params, cfg, BenchTok(), **kw)
    if record is not None:
        record_prefixes(engine, record)
    if replay is not None:
        replay_prefixes(engine, replay)
    with (logits_recorded(engine, logits) if logits is not None
          else contextlib.nullcontext()):
        engine.start()
        try:
            out, _ = serve_all(engine, tp_requests(cfg))
        finally:
            engine.stop()
    return [result_tokens(r) for r in out]


def run_tp(torch, cfg, kernels, card: str, params5, params6, cache,
           engine_params, logits_5, fused_6, greedy, work: Path,
           ranks: int = TP_RANKS, across: bool = False,
           refs: Optional[dict] = None, name: str = "tp_inference") -> dict:
    """Phase 13: the port's tensor-parallel path at ``macaw_7b()`` full width
    and depth, int8 weights, t = 2 ranks (``tp_worker``) on this card,
    against the one-device phases on the same weights. Phase 15c: the same
    at t = ``ranks``, one rank a card over NCCL (``across``), its one-device
    engine runs kept in ``refs`` for the next t; the result line is
    ``name``.

    13a prefill, held stage by stage: the ranks' LLaMA on phase 5's own
    fused prefix gives phase 5's logits bit for bit (W8A8: the int32 dots
    summed exactly over the ranks); the ranks' fused prefix (towers and
    alignment cut too) is within TP_PREFIX_TOL of phase 5's, and their
    logits are one device's LLaMA on that prefix, bit for bit. The
    end-to-end logits against phase 5's are reported beside how far one
    device's own move when one bf16 ulp changes in 1% of phase 5's prefix
    (the random 7b amplifies such a change through 32 layers). 13a decode:
    the ranks' 4 x 16 greedy tokens on phase 6's prefix against phase 6's
    (identical, or first differing at a near tie: phase 4c's rule). 13b,
    the engine's 16 requests with the int8 KV cache and again with a bf16
    one, held by the same stages: each request's fused prefix within
    TP_PREFIX_TOL of the one-device engine's (run here first, on
    ``engine_params``), and the greedy tokens those of the one-device
    engine replaying the ranks' prefixes, or first differing at a near
    tie: phase 4c's bar on that engine's own logits at the difference
    (``logits_recorded``; at 32 layers they are up to ~5% of max |logit|
    from the no-cache logits 4c reads at 2 layers, whose gaps are
    reported beside them); the sampled ones in the vocab and within their
    budgets, both ranks ending in the same slot state. Read, not held: the
    ranks' and one device's logits on the same tokens, and the tokens
    against the one-device engine's end to end, with either cache, beside
    how far the one-device engine's own move under a one-ulp change of 1%
    of its token table. Both ranks' results the same bits, their launches
    the counts a rank's shapes give.
    ``params5``: phase 5's serving tree; ``params6``: phase 6's (the LLaMA
    packed for decode)."""
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.serve import ContinuousEngine
    work.mkdir(parents=True, exist_ok=True)
    batch = make_batch(torch, cfg, 16, 256, seed=3)
    with torch.inference_mode():
        f5 = fusion.prepare_inputs(
            params5, cfg, input_ids=batch["input_ids"],
            images=batch["images"], audios=batch["audios"],
            videos=batch["videos"], attention_mask=batch["attention_mask"],
            align_cache=cache, activation_quant=True)
    prefix5, mask5 = f5.inputs_embeds, f5.attention_mask
    if not torch.equal(llama_last_logits(torch, params5["llm"], cfg, prefix5,
                                         mask5).float().cpu(), logits_5):
        raise AssertionError("phase 5's LLaMA on its prefix left its logits")
    # one device under a one-ulp change of 1% of the prefix's elements
    nudged = nudge(torch, prefix5, 13)
    lg_n = llama_last_logits(torch, params5["llm"], cfg, nudged,
                             mask5).float().cpu()
    sensitivity = dict(
        elements_changed=(nudged != prefix5).float().mean().item(),
        rel_err=((lg_n - logits_5).abs().max() /
                 logits_5.abs().max()).item(),
        argmax_agreement=int((lg_n.argmax(-1) ==
                              logits_5.argmax(-1)).sum()))
    del nudged
    torch.save(prefix5.cpu(), work / "prefix5.pt")
    torch.save([x.cpu() for x in (fused_6.inputs_embeds,
                                  fused_6.attention_mask)],
               work / "prefix6.pt")
    reqs = tp_requests(cfg)
    refs = {} if refs is None else refs
    if not refs:  # the one-device engine runs, the same for every t
        engine = ContinuousEngine(engine_params, cfg, BenchTok(),
                                  **TP_ENGINE_KW)
        refs["prefixes"] = {}
        record_prefixes(engine, refs["prefixes"])
        engine.start()
        try:
            t0 = time.perf_counter()
            out, stamps = serve_all(engine, tp_requests(cfg))
            seconds = time.perf_counter() - t0
        finally:
            engine.stop()
        refs["tokens"] = [result_tokens(r) for r in out]
        refs["serve"] = stream_metrics(stamps, seconds, refs["tokens"])
        refs["bf16"] = one_device_engine(torch, engine_params, cfg,
                                         TP_KV_BF16)
        llm = engine_params["llm"]
        refs["nudged"] = one_device_engine(
            torch, dict(engine_params, llm=dict(llm, embed_tokens=nudge(
                torch, llm["embed_tokens"], 14))), cfg, TP_ENGINE_KW)
    one_prefixes, ref = refs["prefixes"], refs["tokens"]
    ref_bf16, ref_nudged = refs["bf16"], refs["nudged"]
    engine = ContinuousEngine(engine_params, cfg, BenchTok(), **TP_ENGINE_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = ranks
    ranks = spawn_tp(t, work, {"across": across}, phase=name,
                     timeout=P15_TIMEOUT_S if across else TP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lead = ranks[0]
    for r in ranks[1:]:
        for key in ("logits", "llama_on_prefix5", "tokens"):
            if not torch.equal(r[key], lead[key]):
                raise AssertionError(f"13a: rank {r['rank']}'s {key} differ "
                                     "from rank 0's")
        if not (all(torch.equal(a, b) for a, b in zip(
                r["engine_state"], lead["engine_state"]))
                and r["engine_stats"] == lead["engine_stats"]):
            raise AssertionError("13b: the ranks' slot states differ")
    # every rank launches phase 5's and 6's kernels at its shapes; the
    # video alignment takes B2 while its fp32 logits at this rank's 16 / t
    # heads exceed the einsum's bytes (fusion.ALIGN_EINSUM_MAX_BYTES)
    align = 16 * (16 // t) * 39 * 32009 * 4 > fusion.ALIGN_EINSUM_MAX_BYTES
    expect = {"mh_attention": 32, "flash_attention": 7 + align,
              "matvec_int8": 0,
              "flash_attention_combine": combines(torch, (
                  ((16, 1500, 1500, 8 // t, 64, False), 6),
                  (video_long(16), 1),
                  ((16 // t, 39 * 16, 32009, 1, 256, False), align))),
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "flash_attention_delta": 0, "matvec_int8_pipelined": 1}
    per_step = 4 * cfg.llm.num_layers + 1
    expect_dec = dict({k: 0 for k in expect},
                      matvec_int8=1 + (TP_NEW - 1) * per_step)
    for r in ranks:
        if r["prefill_launches"] != expect or \
                r["decode_launches"] != expect_dec:
            raise AssertionError(f"13a rank {r['rank']} launches: prefill "
                                 f"{r['prefill_launches']} (expected "
                                 f"{expect}), decode {r['decode_launches']}")
    # 13a prefill, stage by stage
    if not torch.equal(lead["llama_on_prefix5"], logits_5):
        raise AssertionError("13a: the ranks' LLaMA on phase 5's prefix left "
                             "phase 5's logits")
    tp_prefix = torch.load(work / "tp_prefix.pt").cuda()
    prefix_rel = ((tp_prefix.float() - prefix5.float()).abs().max() /
                  prefix5.float().abs().max()).item()
    one_on_tp = llama_last_logits(torch, params5["llm"], cfg, tp_prefix,
                                  mask5).float().cpu()
    if not (prefix_rel <= TP_PREFIX_TOL and
            torch.equal(one_on_tp, lead["logits"])):
        raise AssertionError(f"13a: the ranks' prefix {prefix_rel} from phase "
                             "5's, or their logits not one device's LLaMA "
                             "on it")
    a = lead["logits"]
    rel = ((a - logits_5).abs().max() / logits_5.abs().max()).item()
    argmax = int((a.argmax(-1) == logits_5.argmax(-1)).sum())
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("13a logits not finite")
    # 13a decode
    flips = near_tie_flips(torch, lead["tokens"], greedy,
                           lambda: greedy_with_logits(
                               torch, params6["llm"], cfg.llm,
                               fused_6.inputs_embeds, fused_6.attention_mask,
                               TP_NEW))
    if not all(r["decode_repeatable"] for r in ranks):
        raise AssertionError("13a: greedy decode not repeatable")
    # 13b, the prefix: each request's against one device's
    tp_prefixes = lead["engine_prefixes"]
    prefix_errs = []
    for req in reqs:
        (a_, am), (b_, bm) = tp_prefixes[req.prompt], one_prefixes[req.prompt]
        if not torch.equal(am, bm):
            raise AssertionError(f"13b: {req.prompt!r}'s prefix mask is not "
                                 "one device's")
        prefix_errs.append(((a_.float() - b_.float()).abs().max() /
                            b_.float().abs().max()).item())
    if not max(prefix_errs) <= TP_PREFIX_TOL:
        raise AssertionError(f"13b: the ranks' prefixes {prefix_errs} from "
                             f"one device's (bar {TP_PREFIX_TOL})")
    # 13b, the LLaMA: the tokens against one device's on the same prefixes
    got, got_bf16 = lead["engine_tokens"], lead["engine_bf16_tokens"]
    one_logits, one_logits_bf16 = {}, {}
    replay = one_device_engine(torch, engine_params, cfg, TP_ENGINE_KW,
                               replay=tp_prefixes, logits=one_logits)
    replay_bf16 = one_device_engine(torch, engine_params, cfg, TP_KV_BF16,
                                    replay=tp_prefixes,
                                    logits=one_logits_bf16)
    tp_emb = unpadded(tp_prefixes)
    eflips = engine_flips(torch, engine, cfg, reqs, got, replay,
                          LOGITS_REL_TOL, prefixes=tp_emb, logits=one_logits)
    eflips_bf16 = engine_flips(torch, engine, cfg, reqs, got_bf16,
                               replay_bf16, LOGITS_REL_TOL, prefixes=tp_emb,
                               logits=one_logits_bf16)
    drift = logits_drift(torch, reqs, got, replay, lead["engine_logits"],
                         one_logits)
    del tp_emb
    # read: end to end, with the int8 and a bf16 KV cache, and one device
    # under a one-ulp change of its token table
    e2e_flips = engine_flips(torch, engine, cfg, reqs, got, ref, math.inf)
    e2e_flips_bf16 = engine_flips(torch, engine, cfg, reqs, got_bf16,
                                  ref_bf16, math.inf)
    nudge_flips = engine_flips(torch, engine, cfg, reqs, ref_nudged, ref,
                               math.inf)
    for g_, req in zip(got + got_bf16, reqs + reqs):
        if not (0 < len(g_) <= req.max_new_tokens and
                all(0 <= x < cfg.llm.vocab_size for x in g_)):
            raise AssertionError(f"13b tokens out of range: {g_}")
    del engine, prefix5, tp_prefix
    torch.cuda.empty_cache()

    def identical(a, b):
        return sum(x == y for x, y, req in zip(a, b, reqs)
                   if req.temperature == 0)
    result = dict(
        ranks=t, card=card, seconds=seconds,
        backend="nccl, one rank a card" if across else "gloo, one card",
        note="one rank a card, the collectives over NCCL" if across else
             "the ranks share one card's SMs and talk through gloo over "
             "host memory: these times say nothing of tensor parallelism's "
             "speed across cards",
        cuts=lead["cuts"], build_s=[r["build_s"] for r in ranks],
        block_gb=[r["block_gb"] for r in ranks],
        prefill=dict(llama_on_prefix5_bitwise=True, prefix_rel_err=prefix_rel,
                     prefix_tol=TP_PREFIX_TOL,
                     logits_one_device_on_tp_prefix_bitwise=True,
                     end_to_end_rel_err=rel, end_to_end_argmax=argmax,
                     one_device_sensitivity=sensitivity,
                     ms=[r["prefill_ms"] for r in ranks],
                     peak_gb=[r["prefill_peak_gb"] for r in ranks],
                     launches=lead["prefill_launches"],
                     collectives=lead["prefill_collectives"]),
        decode=dict(identical_rows=4 - len(flips), flips=flips,
                    flip_tol=LOGITS_REL_TOL,
                    seconds=[r["decode_s"] for r in ranks],
                    tokens_per_s=[4 * TP_NEW / r["decode_s"]
                                  for r in ranks],
                    launches=lead["decode_launches"],
                    collectives=lead["decode_collectives"]),
        engine=dict(requests=len(reqs), steps=lead["engine_stats"]["steps"],
                    prefix_rel_err_max=max(prefix_errs),
                    prefix_tol=TP_PREFIX_TOL,
                    greedy_identical=identical(got, replay),
                    flips=eflips, flip_tol=LOGITS_REL_TOL,
                    logits_drift=drift,
                    kv_bf16=dict(greedy_identical=identical(got_bf16,
                                                            replay_bf16),
                                 flips=eflips_bf16,
                                 flip_tol=LOGITS_REL_TOL),
                    end_to_end=dict(greedy_identical=identical(got, ref),
                                    flips=e2e_flips),
                    end_to_end_kv_bf16=dict(
                        greedy_identical=identical(got_bf16, ref_bf16),
                        flips=e2e_flips_bf16,
                        seconds=[r["engine_bf16_s"] for r in ranks]),
                    one_device_nudged=dict(
                        greedy_identical=identical(ref_nudged, ref),
                        flips=nudge_flips),
                    sampled_same_as_one_device=[
                        g_ == c for g_, c, req in zip(got, ref, reqs)
                        if req.temperature > 0],
                    seconds=[r["engine_s"] for r in ranks],
                    serve=lead["engine_serve"],
                    serve_kv_bf16=lead["engine_bf16_serve"],
                    serve_one_device=refs["serve"],
                    peak_gb=[r["engine_peak_gb"] for r in ranks],
                    launches=lead["engine_launches"],
                    collectives=lead["engine_collectives"]))
    log(json.dumps({name: result}))
    return result


# --------------------------------------------------------------------------
# phase 14: tensor-parallel training, t = 2 ranks on the one card
# --------------------------------------------------------------------------

TP_TRAIN_STEPS = 5  # 2 warm-up + 3 timed
# 14a's first step against 10a's: the same forward but for the association
# of the row-parallel fp32 sums and the vocab-parallel logits' columns
TP_TRAIN_STEP1_TOL = 1e-3
TP_PAD_VOCAB = 32008  # 2 divides it: embed_tokens and lm_head are cut
TP_TIMES_NOTE = ("the ranks share one card and sum through host memory "
                 "(gloo): these times say nothing of tensor parallelism "
                 "across cards")


def tp_train_config(work: Path, sequence: bool, t: int = TP_RANKS) -> Path:
    """14a's run file: the committed 1b run file over mesh tensor ``t``,
    the vocab padded to TP_PAD_VOCAB, a t-th of the per-device batch (the
    same global batch of 8 as 10a), no checkpoint, ``shard_sequence`` as
    asked."""
    path = work / f"train_1b_tp{t}{'_sequence' if sequence else ''}.json"
    phase10_config(path, mesh=dict(tensor=t), vocab_pad_to=TP_PAD_VOCAB,
                   model_fields=dict(shard_sequence=sequence),
                   save_steps=0, log_steps=1)
    return path


def tp_qlora_step(torch, kernels) -> dict:
    """14b on this rank: phase 4b's 2-layer QLoRA model at 7b widths (the
    same seeds, int8 base and alignment cache, LoRA B nonzero) at text 1024,
    this rank's block of it (``tp_params``, the cache's columns
    ``tp_align_cache``), one loss and backward through ``fusion.forward``
    under the world's tensor group: the loss, the LoRA gradients (B's
    all-gathered), launches, collectives, ms and peak memory."""
    from macaw_llm_tpu_torch.config import macaw_7b
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.parallel import tensor_parallel as tpar
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES, tree_map
    from macaw_llm_tpu_torch.train.lora import init_lora
    from macaw_llm_tpu_torch.train.state import merge_params, split_params
    from macaw_llm_tpu_torch.utils import quantize as qz
    cfg = train_cfg(torch, macaw_7b(), layers=2, dropout=0.0)
    params = fusion.init_params(5, cfg, dtype=torch.bfloat16, device="cuda")
    cache = fusion.precompute_align_cache(params, cfg, quantize=True)
    params["llm"] = qz.quantize_llama(params["llm"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    lora = init_lora(gen, cfg.llm, 8)
    for key in ("qb", "vb"):
        lora[key] = torch.randn(lora[key].shape, generator=gen,
                                device="cuda") * 0.01
    params["llm"]["layers"]["lora"] = lora
    tp = tpar.TensorParallel.world(cfg)
    block = tpar.tp_params(params, tp)
    cache = tpar.tp_align_cache(cache, tp)
    del params
    trainable, frozen = split_params(block, True, lora=True)
    # every trainable leaf takes a gradient, as in 4b
    trainable = tree_map(lambda _, x: x.detach().clone().requires_grad_(),
                         trainable)
    adapters = trainable["llm"]["layers"]["lora"]
    batch = {k: v[0] for k, v in
             train_batch(torch, cfg, 1, 1, 1024, seed=7).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    COLLECTIVES.clear()
    t0 = time.perf_counter()
    loss, _ = fusion.forward(
        merge_params(trainable, frozen), cfg, input_ids=batch["input_ids"],
        images=batch["images"], audios=batch["audios"],
        videos=batch["videos"], attention_mask=batch["attention_mask"],
        labels=batch["labels"], lora_scale=2.0, align_cache=cache, tp=tp)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, collectives = counts(kernels), dict(COLLECTIVES)
    grads = {}
    with torch.no_grad():
        for key, x in adapters.items():
            g = x.grad if key.endswith("a") else tpar.gather(tp, x.grad, -1)
            grads[f"/llm/layers/lora/{key}"] = g.float().cpu()
    return dict(loss=loss.float().item(), grads=grads, launches=launches,
                collectives=collectives, ms=ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                cuts=sorted(tp.cuts))


def tp_train_worker(job_path: str, rank: int) -> None:
    """One rank of phase 14 or 15 (``chip_smoke.py --tp-train-worker JOB
    --tp-rank R``): ``run_train.main`` of each run of the job (``tag``,
    ``config``, extra ``argv``; ``--llama-weights`` of the job's
    ``llama_dir`` unless ``weights`` is false), joined to the job's group
    through the reference's environment: with ``--backend gloo`` on one
    card (NCCL takes one rank a card), or under ``job["across"]`` with the
    default NCCL, one rank a card. Each step's loss, gradient norm, ms,
    peak memory, launches and collectives. After a run, ``check_save``:
    its final gathered checkpoint restored over the mesh (the same bits as
    the state in memory, every rank its shards) and, on rank 0, on one
    device through ``run_inference.restore_params`` (the same bits as the
    gathered state); ``check_resume``: the state kept in host memory, then
    ``run_train.main`` again on the same directory, which restores it and
    has no step left (the restored state the same bits), with the
    process's host peak before it. 14b (``job["qlora"]``):
    ``tp_qlora_step``. Its results to the job's directory."""
    import resource

    import torch
    import torch.distributed as dist
    from macaw_llm_tpu_torch import run_inference, run_train
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    from macaw_llm_tpu_torch.train import checkpoint as ckpt_mod
    from macaw_llm_tpu_torch.train.state import merge_params
    job = json.loads(Path(job_path).read_text())
    world, work = job["world"], Path(job["out"])
    across = bool(job.get("across"))
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{job['port']}",
                      NUM_PROCESSES=str(world), PROCESS_ID=str(rank),
                      LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank if across else 0)  # before any CUDA call
    kernels = kernel_table(mh, fa, mv)
    # the Trainer of each run_train.main call, which main does not hand
    # back: its init_state made the specs that gather and shard the state
    made = []

    class Recording(run_train.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    run_train.Trainer = Recording
    res = {"rank": rank}
    for run in job["runs"]:
        tag = run["tag"]
        steps = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        COLLECTIVES.clear()
        on_step = step_hook(torch, kernels, steps)
        run_dir = work / f"run_{tag}"
        argv = ["--config", run["config"], "--synthetic", "--steps",
                str(job["steps"]), "--output-dir", str(run_dir),
                "--device", "cuda"] + run.get("argv", [])
        if not across:
            argv += ["--backend", "gloo"]
        if run.get("weights", True):
            argv += ["--llama-weights", job["llama_dir"]]
        t0 = time.perf_counter()
        state = run_train.main(argv, on_step=on_step)
        out = dict(steps=steps, backend=dist.get_backend(),
                   world=dist.get_world_size(),
                   wall_s=time.perf_counter() - t0,
                   card=torch.cuda.current_device(),
                   host_peak_gb=resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)
        tr = made[-1]
        if run.get("check_save"):
            t0 = time.perf_counter()
            back = ckpt_mod.CheckpointManager(str(run_dir),
                                              trainer=tr).restore(state)
            torch.cuda.synchronize()
            out["sharded_restore_s"] = time.perf_counter() - t0
            out["sharded_restore_diff"] = states_equal(torch, back, state)
            del back
            whole = tr.whole_state(state, rank0_only=True)
            if rank == 0:
                cfg = ckpt_mod.load_config(str(run_dir))
                t0 = time.perf_counter()
                one = run_inference.restore_params(str(run_dir), cfg,
                                                   device="cuda")
                torch.cuda.synchronize()
                out["one_device_restore_s"] = time.perf_counter() - t0
                one = {k: v.cpu() for k, v in _leaf_map(one).items()}
                out["one_device_restore_diff"] = differing_leaves(
                    torch, one, _leaf_map(merge_params(whole.trainable,
                                                       whole.frozen)))
                del one
            del whole
        if run.get("check_resume"):
            kept = {k: v.cpu() for k, v in state_leaves(state).items()}
            kept_step = (state.step, state.opt_state.count,
                         state.rng.get_state())
            del state
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state = run_train.main(argv)
            out["resume_s"] = time.perf_counter() - t0
            got = {k: v.cpu() for k, v in state_leaves(state).items()}
            diff = differing_leaves(torch, got, kept)
            if (state.step, state.opt_state.count) != kept_step[:2]:
                diff.append("step")
            if not torch.equal(state.rng.get_state(), kept_step[2]):
                diff.append("rng")
            out["resume_diff"] = diff
            out["state_gb"] = sum(v.numel() * v.element_size()
                                  for v in kept.values()) / 1e9
            del kept, got
        res[tag] = out
        del state, tr
        made.clear()
        torch.cuda.empty_cache()
    if job.get("qlora"):
        res["qlora"] = tp_qlora_step(torch, kernels)
    dist.barrier()
    torch.save(res, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_train(world: int, work: Path, runs: list, llama_dir=None,
                phase: str = "14", steps: int = TP_TRAIN_STEPS,
                across: bool = False, timeout: float = TP_TIMEOUT_S,
                qlora: bool = False) -> list:
    """``tp_train_worker`` ranks over ``runs`` (dicts: ``tag``, ``config``,
    optional ``argv``, ``weights``, ``check_save``, ``check_resume``)."""
    work.mkdir(parents=True, exist_ok=True)
    return spawn_tp(world, work, dict(
        port=free_port(), runs=runs, steps=steps, across=across,
        qlora=qlora, llama_dir=None if llama_dir is None else str(llama_dir)),
        "--tp-train-worker", phase, timeout=timeout)


def hold_train(torch, ranks: list, tag: str, ref: dict, expect, card: str,
               note: str, name: str, tokens_per_step=None) -> dict:
    """A multi-rank run (``tag`` of each rank's results) against a one-card
    run of the same global batch (``ref``: its ``losses``,
    ``step_ms_median`` and ``peak_mem_gb``; None: no reference): the
    ranks' losses and gradient norms the same bits, finite, step 1 within
    TP_TRAIN_STEP1_TOL of the reference's and steps 2-3 within the bf16 bar
    (those the reference has), every step's launches ``expect`` (unless
    None). Logs the line ``name``: per-rank step ms (the median after 2
    warm-up steps) and peak, with ``tokens_per_step`` tokens/s at the
    slowest rank."""
    ref = ref or {"losses": [], "step_ms_median": None, "peak_mem_gb": None}
    steps = [r[tag]["steps"] for r in ranks]
    losses = [[x["loss"] for x in st] for st in steps]
    norms = [[x["grad_norm"] for x in st] for st in steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], ref["losses"])]
    bad = [] if expect is None else [x["launches"] for st in steps
                                     for x in st if x["launches"] != expect]
    times = [statistics.median(x["step_ms"] for x in st[2:]) for st in steps]
    line = dict(
        run=tag, losses=losses[0], grad_norms=norms[0],
        ref_losses=ref["losses"][:len(losses[0])], loss_rel_diff=rel,
        ranks_same_bits=all(x == losses[0] for x in losses)
        and all(x == norms[0] for x in norms),
        step_ms_median=times, ref_step_ms_median=ref["step_ms_median"],
        peak_mem_gb=[st[-1]["peak_mem_gb"] for st in steps],
        ref_peak_mem_gb=ref["peak_mem_gb"],
        launches_per_step=steps[0][-1]["launches"],
        collectives_per_step=[st[-1]["collectives"] for st in steps],
        backend=ranks[0][tag]["backend"], world=ranks[0][tag]["world"],
        cards=[r[tag]["card"] for r in ranks], note=note, card=card)
    if tokens_per_step:
        line["tokens_per_s"] = tokens_per_step / (max(times) / 1e3)
    log(json.dumps({name: line}))
    if not line["ranks_same_bits"] or bad or \
            not all(map(math.isfinite, losses[0])) or \
            max(rel[:1], default=0.0) > TP_TRAIN_STEP1_TOL or \
            max(rel[1:3], default=0.0) > TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"{name}: {line}, launches {bad[:1]} != "
                             f"{expect}")
    return line


def run_tp_train(torch, card: str, work: Path, llama_dir, train_10a: dict,
                 card_4b: Optional[dict] = None, t: int = TP_RANKS,
                 across: bool = False, prefix: str = "tp_train_1b") -> dict:
    """Phase 14: 14a, phase 10a's 1b full fine-tune at full depth through
    ``run_train.main`` over t = 2 ranks on this card (mesh tensor 2, the
    vocab padded to TP_PAD_VOCAB: embed_tokens and lm_head
    vocab-parallel), 2 + 3 steps, then the same with ``shard_sequence``:
    ``hold_train``'s bars against 10a, B1 and B2 launches asserted every
    step; 14b (with ``card_4b``, phase 4b's one-device step on the card),
    ``tp_qlora_step`` against it by 4b's bars. Runs in phase 10's
    directory, on its imported weights. Phase 15d: 14a at ``t`` ranks, one
    a card over NCCL (``across``)."""
    tp_dir = work / ("phase14" if prefix == "tp_train_1b" else prefix)
    runs = [dict(tag=tag, config=str(tp_train_config(
        work, tag.endswith("sequence"), t)))
        for tag in ("tp", "tp_sequence")]
    t0 = time.perf_counter()
    ranks = spawn_train(t, tp_dir, runs, llama_dir,
                        "14" if card_4b is not None else "15d",
                        across=across, qlora=card_4b is not None,
                        timeout=P15_TIMEOUT_S if across else TP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    # per step on a rank: B1 in the 16 LLaMA layers' forward and remat
    # recompute (16 / t heads), B2 in Whisper's 6 layers (8 / t heads)
    rank_whisper = (8, 1500, 1500, 8 // t, 64, False)
    expect_a = {"mh_attention": 32, "flash_attention": 6,
                "flash_attention_combine": combines(torch,
                                                    ((rank_whisper, 6),)),
                "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "flash_attention_delta": 0, "matvec_int8": 0,
                "matvec_int8_pipelined": 0}
    note = "one rank a card over NCCL" if across else TP_TIMES_NOTE
    out = {"note": note, "wall_s": wall, "card": card, "ranks": t}
    for run in runs:
        tag = run["tag"]
        out[tag] = hold_train(torch, ranks, tag, train_10a, expect_a, card,
                              note, f"{prefix}_{tag}",
                              tokens_per_step=8 * 312)
    if card_4b is None:
        return out
    # 14b against 4b's one-device card step
    qs = [r["qlora"] for r in ranks]
    rank_llama = (1, 1080, 1080, 32 // TP_RANKS, 128, True)
    expect_b = {"mh_attention": 0, "flash_attention": 7,
                "flash_attention_combine": combines(torch, (
                    ((1, 1500, 1500, 8 // TP_RANKS, 64, False), 2),
                    (video_long(1), 1), (rank_llama, 4))),
                "flash_attention_dq": 3, "flash_attention_dkv": 3,
                "flash_attention_delta": 3, "matvec_int8": 0,
                "matvec_int8_pipelined": 0}
    loss_rel = abs(qs[0]["loss"] - card_4b["loss"]) / abs(card_4b["loss"])
    grad_rel = {k: ((qs[0]["grads"][k] - g).abs().max()
                    / g.abs().max()).item()
                for k, g in card_4b["grads"].items()}
    same = qs[0]["loss"] == qs[1]["loss"] and all(
        torch.equal(qs[0]["grads"][k], qs[1]["grads"][k])
        for k in qs[0]["grads"])
    line = dict(loss=qs[0]["loss"], loss_4b=card_4b["loss"],
                loss_rel_err=loss_rel, grad_rel_err=grad_rel,
                ranks_same_bits=same, launches=[q["launches"] for q in qs],
                collectives=[q["collectives"] for q in qs],
                ms=[q["ms"] for q in qs],
                peak_mem_gb=[q["peak_mem_gb"] for q in qs],
                cuts=qs[0]["cuts"], note=TP_TIMES_NOTE, card=card)
    log(json.dumps({"tp_train_qlora": line}))
    if not same or any(q["launches"] != expect_b for q in qs) or \
            loss_rel > TRAIN_LOSS_REL_TOL or \
            max(grad_rel.values()) > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"14b: {line} (launches expected {expect_b})")
    out["qlora"] = line
    return out


# --------------------------------------------------------------------------
# phase 15: the parallel layer across cards, one rank a card over NCCL
# --------------------------------------------------------------------------

P15_RANKS = (2, 4)  # the tensor-parallel sizes, as far as the cards go
P15_TIMEOUT_S = 360.0  # a sub-phase's ranks are killed after this
P15_7B_TIMEOUT_S = 900.0  # 15b's: the 7b state's gathered save and resume
P15_NOTE = "one rank a card, the collectives over NCCL"


def expect_1b(torch, b: int = 8) -> dict:
    """Launches of one 1b train step at ``b`` rows a rank: B1 in the 16
    LLaMA layers' forward and remat recompute, B2 in Whisper's 6 layers."""
    return {"mh_attention": 32, "flash_attention": 6,
            "flash_attention_combine": combines(torch, ((whisper(b), 6),)),
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            "flash_attention_delta": 0, "matvec_int8": 0,
            "matvec_int8_pipelined": 0}


def card_links(n: int) -> dict:
    """Every card's name and power limit, ``nvidia-smi topo -m`` and card
    0's NVLink state (``nvidia-smi nvlink --status``: on some hosts topo
    cannot read the matrix); the link between cards 0 and 1 as topo names
    it (e.g. NV18), and card 0's active NVLinks and their rate."""
    def smi(*args, check=False):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60, check=check)
        text = (out.stdout + out.stderr).strip()
        log(f"== nvidia-smi {' '.join(args)} (exit {out.returncode})\n"
            + text)
        return text if out.returncode == 0 else ""

    query = smi("--query-gpu=index,name,power.limit", "--format=csv,noheader",
                check=True).splitlines()
    link = None
    for line in smi("topo", "-m").splitlines():
        cols = line.split()
        if cols[:1] == ["GPU0"] and len(cols) > 2:
            link = cols[2]  # the column of GPU1
    rates = re.findall(r"Link \d+: ([\d.]+ GB/s)",
                       smi("nvlink", "--status", "-i", "0"))
    return dict(card_names=query[:n], link_0_1=link,
                nvlinks_card0=len(rates),
                nvlink_rate=rates[0] if rates else None)


def one_card_run(torch, kernels, config: Path, run_dir: Path, steps: int,
                 argv=()) -> dict:
    """``run_train.main`` of ``config`` on this process's card (no group):
    its losses, step ms (the median after 2 warm-up steps) and peak."""
    from macaw_llm_tpu_torch import run_train
    rows = []
    torch.cuda.reset_peak_memory_stats()
    on_step = step_hook(torch, kernels, rows)
    state = run_train.main(["--config", str(config), "--synthetic",
                            "--steps", str(steps), "--output-dir",
                            str(run_dir), "--device", "cuda"] + list(argv),
                           on_step=on_step)
    del state
    out = dict(losses=[r["loss"] for r in rows],
               step_ms_median=statistics.median(
                   r["step_ms"] for r in rows[2:]),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    return out


def zero3_1b(torch, card: str, work: Path, llama_dir, ref_1b: dict,
             n: int) -> dict:
    """15a: the 1b run file (train.sh's ZeRO-3) over mesh fsdp ``n``, one
    rank a card, 2 rows a rank at n = 4 (10a's global batch of 8), 2 + 3
    steps and the forced final save: ``hold_train``'s bars against 10a's
    one-card run, B1 and B2 launches asserted every step; the gathered
    checkpoint restored over the mesh (every rank its shards, the same
    bits) and on one card (the same bits as the gathered state)."""
    config = work / "train_1b_zero3.json"
    phase10_config(config, mesh=dict(fsdp=n), save_steps=1000, log_steps=1)
    run = dict(tag="zero3", config=str(config), check_save=True)
    ranks = spawn_train(n, work / "zero3_1b", [run], llama_dir, "15a",
                        across=True, timeout=P15_TIMEOUT_S)
    line = hold_train(torch, ranks, "zero3", ref_1b, expect_1b(torch, 8 // n),
                      card, P15_NOTE + f", ZeRO-3 over fsdp {n}", "zero3_1b",
                      tokens_per_step=8 * 312)
    save = [r for r in metrics_rows(work / "zero3_1b" / "run_zero3")
            if "ckpt_bytes" in r]
    out = [r["zero3"] for r in ranks]
    ckpt = dict(
        save_blocking_ms=[r["ckpt_blocking_ms"] for r in save],
        save_write_s=[r["ckpt_write_s"] for r in save],
        save_bytes=[r["ckpt_bytes"] for r in save],
        sharded_restore_s=[r["sharded_restore_s"] for r in out],
        sharded_restore_differing=[r["sharded_restore_diff"][:8]
                                   for r in out],
        one_device_restore_s=out[0]["one_device_restore_s"],
        one_device_restore_differing=out[0]["one_device_restore_diff"][:8],
        host_peak_gb=[r["host_peak_gb"] for r in out], card=card)
    log(json.dumps({"zero3_1b_checkpoint": ckpt}))
    if len(save) != 1 or any(r["sharded_restore_diff"] for r in out) or \
            out[0]["one_device_restore_diff"]:
        raise AssertionError(f"15a checkpoint: {ckpt}")
    return dict(line, checkpoint=ckpt)


def zero3_7b(torch, kernels, card: str, work: Path, n: int) -> dict:
    """15b: the 7b full fine-tune under ZeRO-3 over fsdp ``n``, one rank a
    card, through ``run_train --profile 7b`` at full width and depth with
    the 1b run file's settings (fp32 masters, bf16 grads and Adam m, frozen
    bf16 towers, remat, chunked loss, 2 rows a rank at text 256, random
    weights from the seed), 2 + 3 steps and the forced final save (every
    leaf gathered to rank 0's host): finite losses, the same bits on every
    rank; then ``run_train`` again on that directory, which restores the
    state (the same bits as the one kept in host memory). The same run at
    2 layers a stack against one card's (``hold_train``'s bars)."""
    from macaw_llm_tpu_torch.config import macaw_7b
    config = work / "train_7b_zero3.json"
    phase10_config(config, mesh=dict(fsdp=n), save_steps=1000, log_steps=1)
    run = dict(tag="zero3_7b", config=str(config), argv=["--profile", "7b"],
               weights=False, check_resume=True)
    need = 1.1 * 10 * 6.8e9  # fp32 masters and Adam v, bf16 Adam m
    free = shutil.disk_usage(work).free
    if free < need:
        raise AssertionError(f"15b: {free / 1e9:.1f} GB free on the disk, "
                             f"the 7b checkpoint needs {need / 1e9:.0f}")
    ranks = spawn_train(n, work / "zero3_7b", [run], None, "15b",
                        across=True, timeout=P15_7B_TIMEOUT_S)
    expect = dict(expect_1b(torch, 8 // n), mh_attention=64)
    line = hold_train(torch, ranks, "zero3_7b", None, expect, card,
                      P15_NOTE + f", ZeRO-3 over fsdp {n}", "zero3_7b",
                      tokens_per_step=8 * 312)
    rows = metrics_rows(work / "zero3_7b" / "run_zero3_7b")
    save = [r for r in rows if "ckpt_bytes" in r]
    out = [r["zero3_7b"] for r in ranks]
    ckpt = dict(
        save_blocking_ms=[r["ckpt_blocking_ms"] for r in save],
        save_write_s=[r["ckpt_write_s"] for r in save],
        save_bytes=[r["ckpt_bytes"] for r in save],
        host_peak_gb=[r["host_peak_gb"] for r in out],
        state_gb_a_rank=[r["state_gb"] for r in out],
        resume_s=[r["resume_s"] for r in out],
        resume_restore_s=[r["ckpt_restore_s"] for r in rows
                          if "ckpt_restore_s" in r],
        resume_differing=[r["resume_diff"][:8] for r in out],
        disk_free_gb=shutil.disk_usage(work).free / 1e9, card=card)
    log(json.dumps({"zero3_7b_checkpoint": ckpt}))
    if len(save) != 1 or len(ckpt["resume_restore_s"]) != 1 or \
            any(r["resume_diff"] for r in out):
        raise AssertionError(f"15b checkpoint: {ckpt}")
    shutil.rmtree(work / "zero3_7b", ignore_errors=True)
    # 2 layers a stack: the ranks against one card
    one = work / "train_7b_l2.json"
    phase10_config(one, model=macaw_7b(), layers=2, save_steps=0,
                   log_steps=1)
    ref = one_card_run(torch, kernels, one, work / "run_7b_l2", 3)
    config = work / "train_7b_l2_zero3.json"
    phase10_config(config, mesh=dict(fsdp=n), model=macaw_7b(), layers=2,
                   save_steps=0, log_steps=1)
    ranks = spawn_train(n, work / "zero3_7b_l2",
                        [dict(tag="l2", config=str(config), weights=False)],
                        None, "15b", steps=3, across=True,
                        timeout=P15_TIMEOUT_S)
    expect = dict(expect_1b(torch, 8 // n), mh_attention=4,
                  flash_attention=2, flash_attention_combine=combines(
                      torch, ((whisper(8 // n), 2),)))
    l2 = hold_train(torch, ranks, "l2", ref, expect, card,
                    P15_NOTE + f", ZeRO-3 over fsdp {n}", "zero3_7b_l2",
                    tokens_per_step=8 * 312)
    return dict(line, checkpoint=ckpt, two_layers=l2)


def tp_inference_nccl(torch, cfg, kernels, card: str, work: Path,
                      sizes) -> dict:
    """15c: phase 13 (``run_tp``: 13a's and 13b's stage checks and bars)
    at t of ``sizes``, one rank a card over NCCL, against phases 5 and 6
    run here on card 0 (the same seeds: 3 timed prefills, 4 x 16 greedy
    tokens) and the one-device engine on the same 16 requests."""
    params, cache, params_full, build_s = build_7b(torch, cfg)
    prefill_res, batch, logits_5 = run_prefill(
        torch, params, cfg, cache, kernels, steps=3, warmup=1,
        name="phase15_prefill")
    logits_5 = logits_5.float().cpu()
    decode_res, params6, fused = run_generate(torch, params, cfg, cache,
                                              batch, kernels,
                                              name="phase15_decode")
    del batch
    engine_params = dict(params_full, llm=params6["llm"])
    refs, out = {}, {}
    for t in sizes:
        line = run_tp(torch, cfg, kernels, card, params, params6, cache,
                      engine_params, logits_5, fused,
                      torch.tensor(decode_res["tokens"]), work / f"tp{t}",
                      ranks=t, across=True, refs=refs,
                      name=f"tp{t}_inference_nccl")
        line["one_device"] = dict(
            prefill_ms=prefill_res["step_ms_median"],
            decode_tokens_per_s=decode_res["tokens_per_s"],
            engine=refs["serve"])
        out[t] = line
        shutil.rmtree(work / f"tp{t}", ignore_errors=True)
    del params, params6, params_full, engine_params, cache, fused
    torch.cuda.empty_cache()
    return out


def ring_nccl(torch, card: str, work: Path, n: int, llama_dir,
              ref_1b: dict) -> dict:
    """15e: ``ring_attention`` at [1, 8192, 32, 128] bf16 over the tensor
    axis of n ranks, one a card (``parallel.dryrun``'s ring task), both
    layouts, forward and backward, against one B2 + B3/B4 call over the
    whole sequence on card 0 (12a's bars), B2/B3/B4 launches of the ring
    asserted, its ms beside the single call's; then the 1b run file with
    the ring (zig-zag) over mesh tensor n, the global batch of 8 on every
    rank, against 10a's one-card run (``hold_train``'s bars)."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.parallel import ring_attention as ring
    from macaw_llm_tpu_torch.parallel.dryrun import spawn
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, s, h, d = 1, 8192, 32, 128
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))

    def single():
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*x, causal=True)
        o.backward(g)
        return (o.detach(), *(t.grad for t in x))

    ref = single()
    single_ms = cuda_ms(torch, single, iters=3)
    layouts = ("contiguous", "zigzag")
    paths, perms = {}, {}
    for layout in layouts:
        perm = (ring.zigzag_indices(s, n) if layout == "zigzag"
                else torch.arange(s))
        perms[layout] = perm
        paths[layout] = str(work / f"ring_{layout}.pt")
        torch.save([t[:, perm.cuda()].cpu() for t in (q, k, v, g)],
                   paths[layout])
    t0 = time.perf_counter()
    ranks = spawn(n, "ring", {"qkv": paths, "layouts": list(layouts),
                              "iters": 5}, str(work / "ring"), device="cuda")
    wall = time.perf_counter() - t0
    flops = 3.5 * attn_flops(b, s, s, h, d, True)  # fwd + 2.5x bwd
    bound_ms, bound_by = bound(flops, 8 * b * s * h * d * 2)
    rows = []
    for layout in layouts:
        inv = ring.inverse_permutation(perms[layout])
        got = [torch.cat([r[layout]["out"] for r in ranks], 1)[:, inv]]
        got += [torch.cat([r[layout]["grads"][i] for r in ranks], 1)[:, inv]
                for i in range(3)]
        errs = {}
        for name, a, want in zip(("out", "dq", "dk", "dv"), got, ref):
            fn = row_rel_err if name == "out" else grad_row_err
            errs[name] = fn(a.cuda(), want)
        launches = {key: sum(r[layout]["launches"][key] for r in ranks)
                    for key in ranks[0][layout]["launches"]}
        want = ring_expected(n, layout)
        row = dict(seq=s, n=n, layout=layout,
                   ms=max(statistics.median(r[layout]["ms"]) for r in ranks),
                   ms_by_rank=[statistics.median(r[layout]["ms"])
                               for r in ranks],
                   single_call_ms=single_ms, bound_ms=bound_ms,
                   bound_by=bound_by, launches=launches,
                   expected_launches=want, row_rel_err=errs,
                   collectives=ranks[0][layout]["collectives"],
                   note=P15_NOTE, card=card)
        log(json.dumps({"ring_nccl": row}))
        rows.append(row)
        if any(launches[key] != want for key in (
                "flash_attention_with_lse", "flash_attention_dq",
                "flash_attention_dkv")) or \
                max(errs.values()) > RING_VS_SINGLE_TOL:
            raise AssertionError(f"15e ring n={n} {layout}: {row}")
    del q, k, v, g, ref
    for path in paths.values():
        os.remove(path)
    torch.cuda.empty_cache()
    config = work / "train_1b_ring.json"
    phase10_config(config, mesh=dict(tensor=n), model_fields=dict(
        ring_attention=True, ring_layout="zigzag"), save_steps=0, log_steps=1)
    ranks = spawn_train(n, work / "ring_1b",
                        [dict(tag="ring", config=str(config))], llama_dir,
                        "15e", across=True, timeout=P15_TIMEOUT_S)
    line = hold_train(torch, ranks, "ring", ref_1b, None, card,
                      P15_NOTE + f", ring zig-zag over tensor {n}",
                      "ring_run_train_nccl", tokens_per_step=8 * 312)
    return dict(attention=rows, spawn_wall_s=wall, run_train=line)


def phase15_launches(res: dict, name: str) -> Optional[dict]:
    """Rank 0's launches of the kernel ``name`` in phase 15's runs: a step
    of each training run, 13a's prefill and decode and 13b's engine run at
    each t, one ring forward and backward of each layout (every rank's);
    None where the phase did not run."""
    if not res.get("ran"):
        return None
    out = {"zero3_1b_step": res["a"]["launches_per_step"][name],
           "zero3_7b_step": res["b"]["launches_per_step"][name],
           "zero3_7b_l2_step": res["b"]["two_layers"]["launches_per_step"][
               name]}
    for t, line in res["c"].items():
        for part in ("prefill", "decode", "engine"):
            out[f"tp{t}_{part}"] = line[part]["launches"][name]
    for t, line in res["d"].items():
        for tag in ("tp", "tp_sequence"):
            out[f"tp{t}_train_1b_{tag}_step"] = \
                line[tag]["launches_per_step"][name]
    out["ring_run_train_step"] = \
        res["e"]["run_train"]["launches_per_step"][name]
    key = {"flash_attention": "flash_attention_with_lse"}.get(name, name)
    for row in res["e"]["attention"]:
        out[f"ring_{row['layout']}_all_ranks"] = row["launches"].get(key, 0)
    return out


def run_phase15(torch, kernels, card: str, work_dir: Path) -> dict:
    """Phase 15 where the process sees two cards or more (t = 4 where it
    sees four): 15a-15e, one rank a card over NCCL, in a directory under
    ``work_dir`` (not copied back: 15b's checkpoint is 67 GB) deleted when
    the phase ends; against one-card runs made here first (the imported 1b
    weights and 10a's run file, as phase 10 makes them). On one card a
    line saying it did not run."""
    cards = torch.cuda.device_count()
    if cards < 2:
        line = {"phase": "15", "ran": False, "cards": cards,
                "why": "the parallel layer across cards needs two or more"}
        log(json.dumps(line))
        return line
    from macaw_llm_tpu_torch.config import macaw_7b
    sizes = [t for t in P15_RANKS if t <= cards]
    n = sizes[-1]
    t0 = time.perf_counter()
    res = {"phase": "15", "ran": True, "cards": cards, "ranks": n,
           **card_links(cards)}
    log(json.dumps({"phase15_cards": res}))
    work = work_dir / "phase15"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        log(json.dumps({"phase15_disk_free_gb":
                        shutil.disk_usage(work).free / 1e9}))
        llama_dir, _ = import_1b(torch, work)
        # 10a's run on one card: its file, weights and global batch of 8
        config = work / "train_1b_one.json"
        phase10_config(config, save_steps=0, log_steps=1)
        ref_1b = one_card_run(torch, kernels, config, work / "run_1b_one",
                              TP_TRAIN_STEPS,
                              ["--llama-weights", str(llama_dir)])
        log(json.dumps({"phase15_train_1b_one_card": dict(ref_1b,
                                                          card=card)}))
        res["a"] = zero3_1b(torch, card, work, llama_dir, ref_1b, n)
        res["b"] = zero3_7b(torch, kernels, card, work, n)
        res["c"] = tp_inference_nccl(torch, macaw_7b(), kernels, card, work,
                                     sizes)
        res["d"] = {t: run_tp_train(torch, card, work, llama_dir, ref_1b,
                                    t=t, across=True,
                                    prefix=f"tp{t}_train_1b_nccl")
                    for t in sizes}
        res["e"] = ring_nccl(torch, card, work, n, llama_dir, ref_1b)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase15_seconds": res["seconds"]}))
    return res


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


def device_busy_ms(prof, ranges=()) -> float:
    """The time (ms) in which at least one kernel ran on the card: the
    union of the profiler's kernel intervals. A sum of kernel times would
    count twice the matvec's reduce kernel, which launches early as a
    programmatic dependent and waits for the main kernel. The device-side
    span of a named range (``profiling.annotate``, its name in ``ranges``)
    is not a kernel."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in ranges
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def profile(torch, name: str, fn, out_dir: Path) -> None:
    """torch.profiler table (device time by kernel) of one call of fn, and
    its Chrome trace (``utils.profiling.trace``) under build/traces/."""
    from macaw_llm_tpu_torch.utils.profiling import annotate, trace
    fn()
    torch.cuda.synchronize()
    with trace(str(ROOT / "build" / "traces" / name)) as prof:
        with annotate(name):
            fn()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(table)
    log(f"== profile {name}\n{table}")
    log(json.dumps({"profile": name,
                    "device_busy_ms": device_busy_ms(prof, (name,))}))


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one prefill "
                         "and of decode (written to chiprun_out/)")
    # phases 13 and 14 run this script again as each of their ranks
    ap.add_argument("--tp-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-train-worker", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--phase", default=None, choices=["15"],
                    help="run only this phase (after the build and the "
                         "card): 15, the parallel layer across cards")
    args = ap.parse_args()
    out_dir = ROOT / "chiprun_out"
    if not (ROOT / "macaw_llm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.tp_worker or args.tp_train_worker:
        import faulthandler  # spawn_tp asks a hung rank for its stacks
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    if args.tp_worker:
        tp_worker(args.tp_worker, args.tp_rank)
        return 0
    if args.tp_train_worker:
        tp_train_worker(args.tp_train_worker, args.tp_rank)
        return 0
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
    kernels = kernel_table(mh, fa, mv)
    if args.phase == "15":
        phase15 = run_phase15(torch, kernels, card, ROOT / "build")
        log(json.dumps({"card": card,
                        "seconds": time.perf_counter() - t_start}))
        LOG_FILE.close()
        LOG_FILE = None
        if not phase15["ran"]:
            return 1  # the phase needs the cards it did not find
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernels vs plain at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_attention(torch, mh, fa, gen, sms)
    checks.update(check_matvec(torch, mv, gen))
    # 3c. the pipelined matvec, with B5 beside it at 16 and 32 rows
    checks.update(check_matvec_pipelined(torch, mv, gen))
    # B5 and B6 at a tensor-parallel rank's shard shapes (phase 13)
    tp_checks = check_tp_matvec(torch, mv, gen)
    # 3b. the backward kernels (and the forward at their inputs)
    bwd = check_backward(torch, fa, gen)
    checks["flash_attention"] += bwd.pop("flash_attention")
    checks.update(bwd)
    for name, rows in list(checks.items()) + list(tp_checks.items()):
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
    card_4b = small_train_parity(torch, cfg, kernels)["card_1024"]
    torch.cuda.empty_cache()

    # 5. full 7b prefill
    params, cache, params_full, build_s = build_7b(torch, cfg)
    log(json.dumps({"build_7b_seconds": build_s}))
    prefill_res, batch, logits_5 = run_prefill(torch, params, cfg, cache,
                                               kernels)
    main_launches = dict(prefill_res["launches"])
    # 5b. the same prefill with int8 W8A8 towers
    prefill_qt = run_prefill_quantized_towers(
        torch, params, cfg, cache, kernels, batch, logits_5, prefill_res,
        card)
    logits_5 = logits_5.float().cpu()  # 13a's reference
    torch.cuda.empty_cache()
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
    # 6c. speculative decode on the same prefix and weights
    spec_res = run_speculative(torch, params, cfg, fused,
                               batch["input_ids"][:4], kernels, card)
    if args.profile:
        from macaw_llm_tpu_torch.generate import generate_speculative
        profile(torch, "speculative16", lambda: generate_speculative(
            params["llm"], cfg.llm, inputs_embeds=fused.inputs_embeds,
            prompt_ids=batch["input_ids"][:4],
            attention_mask=fused.attention_mask, max_new_tokens=16,
            eos_id=-1), out_dir)

    # 6b. the continuous-batching engine at 16 and at 32 slots
    del batch
    engine_params = dict(params_full, llm=params["llm"])
    serve_res = {}
    for slots, new in ((16, 64), (32, 32)):
        serve_res[slots], engine = run_engine(torch, engine_params, cfg,
                                              kernels, card, slots, new)
        if args.profile:
            profile_engine_steps(torch, engine, out_dir)
        del engine
        torch.cuda.empty_cache()

    # 13. tensor-parallel inference, 2 ranks on this card, against phases
    # 5, 6 and the one-device engine
    tp_dir = out_dir / "phase13"
    try:
        tp_res = run_tp(torch, cfg, kernels, card,
                        dict(params, llm=params_full["llm"]), params, cache,
                        engine_params, logits_5, fused,
                        torch.tensor(decode_res["tokens"]), tp_dir)
    finally:
        shutil.rmtree(tp_dir, ignore_errors=True)
    del fused, logits_5, cache

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
                          args.profile, card_4b)
    train_1b_launches = phase10["train"]["launches_per_step"]
    tp_train = phase10["tp_train"]
    torch.cuda.empty_cache()

    # 12a. the ring's schedule at 7b widths (12b and 12c ran in phase 10's
    # directory, on its imported weights)
    ring_res = run_ring_local(torch, card)
    ring_launches = {name: ring_res["launches"] for name in (
        "flash_attention", "flash_attention_dq", "flash_attention_dkv")}
    torch.cuda.empty_cache()

    # 15. the parallel layer across cards, one rank a card over NCCL (a
    # line saying it did not run on one card)
    phase15 = run_phase15(torch, kernels, card, ROOT / "build")
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
    def spec_launches(name):
        """6c's launches of a matvec kernel, per run of 64 tokens, and the
        verify rounds of each run (129 B6 launches a round)."""
        return {f"{cache}_{proposer}": dict(
            launches=spec_res[cache][proposer]["launches"][name],
            rounds=spec_res[cache][proposer]["rounds"])
            for cache in ("bf16", "int8")
            for proposer in ("ngram", "oracle", "oracle_self")}

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
            entry = pipelined_entry(name, rows, sources[name], serve_res)
            entry["prefill_quantize_towers_launches"] = \
                prefill_qt["launches"][name]
            entry["speculative_launches"] = spec_launches(name)
            entries.append(entry)
            continue
        if name == "matvec_int8":
            entry = matvec_entry(name, rows, sources[name],
                                 main_launches[name], serve_res)
            entry["speculative_launches"] = spec_launches(name)
            entries.append(entry)
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
        entry["prefill_quantize_towers_launches"] = \
            prefill_qt["launches"][name]
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
    for entry in entries:  # 12a: B2/B3/B4 launches of one ring a layer
        if entry["name"] in ring_launches:
            entry["ring_launches"] = ring_launches[entry["name"]]
    # 13: a tensor-parallel rank's launches (t = 2) and phase 3's shard
    # shapes (t = 2 and 4)
    keep = ("call", "shape", "shape_q", "shape_kv", "chunks", "out_dtype",
            "max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    for entry in entries:
        name = entry["name"]
        entry["tp_launches"] = {
            part: tp_res[part]["launches"][name]
            for part in ("prefill", "decode", "engine")}
        rows = tp_checks.get(name) or [
            r for r in checks[name] if str(r.get("call")).startswith("tp")]
        if rows:
            entry["tp_shapes"] = [{k: r[k] for k in keep if k in r}
                                  for r in rows]
        if name in tp_checks:
            entry["tp_step_layers"] = tp_step_totals(tp_checks[name])
        # 14: a tensor rank's training launches (14a per 1b step, 14b per
        # 2-layer QLoRA step) and phase 3/3b's rank train shapes
        entry["tp_train_launches"] = {
            "train_1b_step": tp_train["tp"]["launches_per_step"][name],
            "train_1b_step_sequence":
                tp_train["tp_sequence"]["launches_per_step"][name],
            "qlora_2_layer_step": tp_train["qlora"]["launches"][0][name]}
        rows = [r for r in checks.get(name, ()) if "train" in str(
            r.get("call", r.get("case"))) and str(
            r.get("call", r.get("case"))).startswith("tp")]
        if rows:
            entry["tp_train_shapes"] = [
                {k: r[k] for k in keep + ("case", "per_step") if k in r}
                for r in rows]
    # 15: a rank's launches a step or a call across cards (rank 0's), and
    # phase 3's ZeRO-3 rank shapes
    for entry in entries:
        name = entry["name"]
        entry["phase15_shapes"] = [
            {k: r[k] for k in keep if k in r} for r in checks.get(name, ())
            if str(r.get("call")).startswith("zero3")]
        entry["phase15_launches"] = phase15_launches(phase15, name)
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
