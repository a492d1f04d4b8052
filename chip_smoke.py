"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Phases, in order (any failure raises and the script exits non-zero):
 1. build the CUDA kernels from ``macaw_llm_tpu_torch/csrc`` (nvcc, sm_90a);
 2. print the card's name and power limit (nvidia-smi);
 3. hold each kernel against its plain PyTorch version at the main-path
    shapes of the 7b profile and time kernel, plain version, the library
    call that computes the same function (where one exists) and the bound;
 4. a 2-layer model at 7b widths (batch 2, seq 256) on the card with the
    kernels against the same weights on the CPU with the plain versions;
 5. the full-width 7b fused prefill, batch 16, seq 256 (fused length 312),
    int8 W8A8 LLaMA, int8 alignment cache, packed towers;
 6. greedy decode of 4 requests, 16 new tokens, int8 packed weights, bf16
    KV cache;
 7. one ``{"kernels": [...]}`` line, then the contract line
    ``{"ok": true, "device": {...}}`` last.

Weights are random, made on the card from a seed. Usage, from the root of
a checkout:  python3 chip_smoke.py [--profile]
(--profile adds torch.profiler tables of one prefill and of greedy decode
with 1 and 4 new tokens, written to chiprun_out/.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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


def attn_flops(b, sq, sk, n, d, causal) -> float:
    """FLOPs of QK^T and PV that the inputs need (causal: keys <= query)."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 2 * 2 * b * n * d * pairs


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


# one 7b decode step at batch 4: (name, K, N, launches per step)
DECODE_MATVECS = (("qkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
                  ("gateup", 4096, 22016, 32), ("down", 11008, 4096, 32),
                  ("lm_head", 4096, 32007, 1))


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
        nbytes = k * n + n * 4 + batch * k * 2 + batch * n * 2
        bms, by = bound(2 * batch * k * n, nbytes)
        rows.append(dict(call=name, shape=[batch, k, n], max_abs_err=err,
                         rel_err=rel, kernel_ms=ms, plain_ms=plain,
                         library_ms=None, bound_ms=bms, bound_by=by,
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
    expect = {"mh_attention": 32, "flash_attention": 8, "matvec_int8": 1}
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
              "matvec_int8": 1 + (new - 1) * per_step}
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
               "matvec_int8": mv.matvec_int8}

    # 3. kernels vs plain at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_attention(torch, mh, fa, gen)
    checks.update(check_matvec(torch, mv, gen))
    for name, rows in checks.items():
        for row in rows:
            log(json.dumps({"kernel_check": name, **row}))
    torch.cuda.empty_cache()

    # 4. 2-layer model at 7b widths: card vs CPU
    cfg = macaw_7b()
    small_model_parity(torch, cfg, kernels)
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

    # 7. the kernels line: per prefill (B1, B2) or per decode step (B5)
    sources = {
        "mh_attention": ("macaw_llm_tpu_torch/csrc/mh_attention.cu",
                         "macaw_llm_tpu/ops/pallas/mh_attention.py:147"),
        "flash_attention": ("macaw_llm_tpu_torch/csrc/flash_attention.cu",
                            "macaw_llm_tpu/ops/pallas/flash_attention.py:188"),
        "matvec_int8": ("macaw_llm_tpu_torch/csrc/matvec.cu",
                        "macaw_llm_tpu/ops/pallas/matvec.py:79"),
    }
    entries = []
    for name, rows in checks.items():
        per = "per_step" if name == "matvec_int8" else "per_prefill"

        def total(key):
            return sum(r[key] * r[per] for r in rows)

        lib = None if rows[0]["library_ms"] is None else total("library_ms")
        entries.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r[per]
                            )["bound_by"],
            "library_ms": lib,
            "work": ("one decode step" if name == "matvec_int8"
                     else "one prefill"),
        })
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"card": card, "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
