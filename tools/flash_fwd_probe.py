"""The attention forward kernels on one GPU, alone: build, check, time. A
quicker loop than ``chip_smoke.py`` for work on
``macaw_llm_tpu_torch/csrc/flash_attention.cu`` (B2 and its combine) and
``csrc/mh_attention.cu`` (B1).

1. builds the kernel library and prints the two files' ptxas lines;
2. holds B2 (through its wrapper: the split over keys and the combine
   where ``split_plan`` takes them) against ``attention_reference`` at
   edge shapes (head dims 64, 128 and 256, causal and not, S_q != S_k, a
   padding bias, a row with no valid key, a chunk whose keys are all
   masked, the ragged last key tile) and at the main-path shapes (Whisper,
   video-long and the video alignment at batch 16, Whisper and video-long
   at batch 1 as an engine admission runs them, the 7b train shape), and
   B1 at the 7b prefill shape and edge shapes; each output also the same
   bits on a rerun;
3. unless ``--quick``: times each main-path shape through its wrapper
   (CUDA events over back-to-back calls: what the caller pays, host issue
   included) and by the profiler's device time of its kernels, beside
   SDPA (``torch.nn.functional.scaled_dot_product_attention``) and the
   bound;
4. with ``--against DIR``: builds ``DIR/flash_attention.cu`` and
   ``DIR/mh_attention.cu`` (another version with the previous C interface:
   no split arguments, and a warp count for mh_attention; for instance the
   parent commit's, from ``git show`` into ``build/parent/``) standalone
   and times them beside this checkout's at every main-path shape, in
   turns (A B B A), each through a wrapper that allocates its outputs as
   the port's does, and by device time, with the largest row difference
   between the two.

Usage, from the root of a checkout:
    python3 tools/flash_fwd_probe.py [--quick] [--against DIR]
Prints JSON lines; the last is ``{"ok": true|false, ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROW_TOL = 2.0 ** -6  # chip_smoke.py's ATTN_ROW_REL_TOL
LSE_TOL = 1e-3
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12

# B2 edge cases: name, B, Sq, Sk, N, D, causal, bias kind
EDGE = (("d64_causal_pad", 2, 40, 40, 2, 64, True, "pad"),
        ("d256_sq_lt_sk", 2, 100, 130, 2, 256, False, "pad"),
        ("d128_causal_pad", 2, 300, 300, 4, 128, True, "pad"),
        ("d128_causal_sq_gt_sk", 2, 77, 50, 3, 128, True, "none"),
        ("d64_tail", 1, 200, 1178, 2, 64, False, "tail"),
        ("d256_tail", 2, 100, 2009, 1, 256, False, "tail"),
        ("split_d256", 2, 100, 5000, 1, 256, False, "none"),
        ("split_masked_chunk", 2, 100, 5000, 1, 256, False, "chunk"),
        ("split_masked_row", 2, 300, 1500, 2, 64, False, "pad"),
        ("split_causal", 1, 200, 1200, 2, 128, True, "pad"),
        ("split_tail_d128", 1, 130, 3000, 1, 128, False, "tail"))
# main-path shapes: name, B, Sq, Sk, N, D, causal, launches per prefill
MAIN = (("whisper", 16, 1500, 1500, 8, 64, False, 6),
        ("video_long", 16, 1176, 1178, 8, 64, False, 1),
        ("video_align", 16, 624, 32009, 1, 256, False, 1),
        ("engine_whisper_b1", 1, 1500, 1500, 8, 64, False, 0),
        ("engine_video_long_b1", 1, 1176, 1178, 8, 64, False, 0),
        ("llama_train", 8, 1080, 1080, 32, 128, True, 0))
# B1: name, B, S, N, D, causal, bias kind
MH = (("prefill", 16, 312, 32, 128, True, "none"),
      ("prefill_tail", 16, 312, 32, 128, True, "tail"),
      ("s1", 2, 1, 2, 64, True, "none"),
      ("s17_pad", 3, 17, 2, 64, True, "pad"),
      ("s64", 2, 64, 2, 128, False, "pad"),
      ("s311_tail", 2, 311, 4, 128, True, "tail"),
      ("gate_max_d128", 2, "max", 2, 128, True, "pad"),
      ("gate_max_d64", 1, "max", 2, 64, True, "tail"))


def row_err(out, ref) -> float:
    diff = (out.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def cuda_ms(torch, fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=10) -> float | None:
    """Device time (ms) per call of the kernels ``fn`` launches, from the
    profiler's kernel records; None where it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if re.search(r"flash_fwd|mh_attention", evt.key):
            total += t
    return total / iters / 1e3 if total else None


def attn_flops(b, sq, sk, n, d, causal) -> float:
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4.0 * b * n * d * pairs


def bound_ms(b, sq, sk, n, d, causal, bias: bool) -> float:
    nbytes = (2 * b * sq * n * d + 2 * b * sk * n * d) * 2 + b * sq * n * 4 \
        + (b * sk * 4 if bias else 0)
    return max(attn_flops(b, sq, sk, n, d, causal) / PEAK_BF16_FLOPS,
               nbytes / PEAK_BYTES) * 1e3


def make_bias(torch, kind, b, sk):
    neg = torch.finfo(torch.float32).min
    if kind == "none":
        return None
    if kind == "tail":  # only the ragged last 64-key tile valid
        bias = torch.full((b, sk), neg, device="cuda")
        bias[:, sk - (sk % 64 or 64):] = 0.0
        return bias
    bias = torch.zeros(b, sk, device="cuda")
    if kind == "chunk":  # every key but those of the first 64-key tile
        bias[:, 64:] = neg
        return bias
    bias[-1, sk // 2:] = neg  # "pad": half the last row, all of row 0
    bias[0] = neg
    return bias


def build_other(build, src: Path, out_dir: Path, name: str, argtypes):
    nvcc = build._nvcc()
    lib = out_dir / f"lib_{src.stem}.so"
    cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(lib), str(src),
           *build._link_flags(nvcc)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout[-4000:]}")
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def parent_mh_warps(s: int, d: int) -> int:
    """The previous mh_attention's warp count for its shared memory."""
    pitch, sp = d + 8, -(-s // 16) * 16
    for w in (8, 4, 2):
        if 2 * sp * pitch * 2 + w * (16 * pitch * 2 + 16 * 16 * 4
                                     + 16 * 24 * 2) <= 232448:
            return w
    return 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check only, no timing")
    ap.add_argument("--against", type=Path, default=None,
                    help="a directory holding another flash_attention.cu "
                         "and mh_attention.cu to time beside these")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F

    from macaw_llm_tpu_torch.ops.kernels import _build
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.ops.kernels import mh_attention as mh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    section = False
    for line in info["log"].splitlines():
        if line.startswith("=="):
            section = ("flash_attention.cu" in line
                       or "mh_attention.cu" in line)
        elif section and re.search(r"Function properties|spill|Used|warn",
                                   line):
            print("  " + re.sub(r"_ZN5macaw\w*?_cu_\w{8}\d+", "",
                                line.strip()))
    _build.library()
    print(json.dumps({"build_seconds": info["seconds"]}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    ok = True
    # B2 edge cases and main-path shapes
    cases = [c + (None,) for c in EDGE] + [
        (name, b, sq, sk, n, d, causal, "none", per)
        for name, b, sq, sk, n, d, causal, per in MAIN]
    for name, b, sq, sk, n, d, causal, kind, per in cases:
        q, k, v = rn(b, sq, n, d), rn(b, sk, n, d), rn(b, sk, n, d)
        bias = make_bias(torch, kind, b, sk)
        combine0 = fa.flash_attention_combine.launches
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        again, lse2 = fa.flash_attention_with_lse(q, k, v, bias,
                                                  causal=causal)
        torch.cuda.synchronize()
        chunks = len(fa.split_plan(b, sq, sk, n, d, causal, sms))
        ref, ref_lse = fa.attention_reference(q, k, v, bias, causal=causal)
        live = ref_lse > -1e30
        res = dict(kernel="flash_attention", case=name,
                   shape_q=[b, sq, n, d], shape_kv=[b, sk, n, d],
                   causal=causal, chunks=chunks,
                   combine_launches=fa.flash_attention_combine.launches
                   - combine0,
                   row_rel_err=row_err(out, ref),
                   lse_err=((lse - ref_lse)[live].abs().max().item()
                            if live.any() else 0.0),
                   masked_rows_zero=bool((lse[~live] < -1e30).all()
                                         and not out[~live].any()),
                   same_bits=bool(torch.equal(out, again)
                                  and torch.equal(lse, lse2)))
        if chunks > 1:
            s_out, s_lse = fa.split_attention_reference(
                q, k, v, bias, causal=causal,
                chunks=fa.split_plan(b, sq, sk, n, d, causal, sms))
            res["split_plain_row_rel_err"] = row_err(out, s_out)
            res["split_plain_lse_err"] = ((lse - s_lse)[live].abs().max()
                                          .item() if live.any() else 0.0)
            del s_out, s_lse
        del ref, ref_lse, again, lse2
        res["ok"] = (res["row_rel_err"] <= ROW_TOL
                     and res["lse_err"] <= LSE_TOL
                     and res["masked_rows_zero"] and res["same_bits"]
                     and res["combine_launches"] == (2 if chunks > 1 else 0)
                     and res.get("split_plain_row_rel_err", 0) <= ROW_TOL)
        ok &= res["ok"]
        if per is not None and not args.quick:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res.update(
                kernel_ms=cuda_ms(torch, lambda: fa.flash_attention_with_lse(
                    q, k, v, bias, causal=causal)),
                device_ms=device_ms(torch, lambda: fa.flash_attention_with_lse(
                    q, k, v, bias, causal=causal)),
                sdpa_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)),
                bound_ms=bound_ms(b, sq, sk, n, d, causal, False),
                per_prefill=per)
            del qt, kt, vt
            if args.against is not None:
                res["against"] = against_flash(
                    torch, fa, _build, args.against, q, k, v, out, causal)
        print(json.dumps(res), flush=True)
        del q, k, v, out, lse, bias
        torch.cuda.empty_cache()

    # B1
    for name, b, s, n, d, causal, kind in MH:
        if s == "max":  # the largest S the shared-memory gate admits
            s = max(x for x in range(1, 4096)
                    if mh.fits_mh_attention(x, x, d))
        q, k, v = rn(b, s, n, d), rn(b, s, n, d), rn(b, s, n, d)
        bias = make_bias(torch, kind, b, s)
        out = mh.mh_attention(q, k, v, bias, causal=causal)
        again = mh.mh_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.attention_reference(q, k, v, bias, causal=causal)
        live = ref_lse > -1e30
        res = dict(kernel="mh_attention", case=name, shape=[b, s, n, d],
                   causal=causal, row_rel_err=row_err(out, ref),
                   masked_rows_zero=not out[~live].any(),
                   same_bits=bool(torch.equal(out, again)))
        res["ok"] = (res["row_rel_err"] <= ROW_TOL
                     and res["masked_rows_zero"] and res["same_bits"])
        ok &= res["ok"]
        if name == "prefill" and not args.quick:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res.update(
                kernel_ms=cuda_ms(torch, lambda: mh.mh_attention(
                    q, k, v, bias, causal=causal), 20),
                device_ms=device_ms(torch, lambda: mh.mh_attention(
                    q, k, v, bias, causal=causal), 20),
                sdpa_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 20),
                bound_ms=bound_ms(b, s, s, n, d, causal, False),
                per_prefill=32)
            if args.against is not None:
                res["against"] = against_mh(torch, mh, _build, args.against,
                                            q, k, v, out)
        print(json.dumps(res), flush=True)
        del q, k, v, out, again, ref
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "card": smi,
                      "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


_OTHER = {}


def _other(build, src_dir: Path, name: str, argtypes):
    if name not in _OTHER:
        out_dir = ROOT / "build" / "flash_fwd_probe"
        out_dir.mkdir(parents=True, exist_ok=True)
        src = src_dir / ("mh_attention.cu" if "mh" in name
                         else "flash_attention.cu")
        _OTHER[name] = build_other(build, src, out_dir, name, argtypes)
    return _OTHER[name]


def ab(torch, this, other, iters=10) -> dict:
    """this and other in turns, A B B A: each one's two times through its
    wrapper, then each one's device time."""
    res = {"this_ms": [], "other_ms": []}
    for key in ("this_ms", "other_ms", "other_ms", "this_ms"):
        res[key].append(cuda_ms(torch, this if key == "this_ms" else other,
                                iters))
    res["this_device_ms"] = device_ms(torch, this, iters)
    res["other_device_ms"] = device_ms(torch, other, iters)
    return res


def against_flash(torch, fa, build, src_dir, q, k, v, out, causal):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _other(build, src_dir, "macaw_flash_attention",
                [P, P, P, P, P, P, I, I, I, I, I, F, I, P])
    b, sq, n, d = q.shape
    got = {}

    def other():  # the wrapper's checks and allocations, the other kernel
        fa._check_cuda(q, k, v, None, "other flash_attention")
        o2 = torch.empty_like(q)
        l2 = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                 o2.data_ptr(), l2.data_ptr(), b, sq, k.shape[1], n, d,
                 d ** -0.5, int(causal), build.stream_ptr(q))
        build.check(err, "other flash_attention")
        got["out"] = o2

    other()
    torch.cuda.synchronize()
    res = ab(torch, lambda: fa._forward(q, k, v, None, causal, d ** -0.5),
             other)
    res["row_diff"] = row_err(out, got["out"])
    return res


def against_mh(torch, mh, build, src_dir, q, k, v, out):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _other(build, src_dir, "macaw_mh_attention",
                [P, P, P, P, P, I, I, I, I, F, I, I, P])
    b, s, n, d = q.shape
    got = {}

    def other():  # the wrapper's allocation, the other kernel
        o2 = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                 o2.data_ptr(), b, s, n, d, d ** -0.5, 1,
                 parent_mh_warps(s, d), build.stream_ptr(q))
        build.check(err, "other mh_attention")
        got["out"] = o2

    other()
    torch.cuda.synchronize()
    res = ab(torch, lambda: mh._forward(q, k, v, None, True, d ** -0.5),
             other, 20)
    res["row_diff"] = row_err(out, got["out"])
    return res


if __name__ == "__main__":
    sys.exit(main())
