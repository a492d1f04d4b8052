"""The flash-attention backward kernels on one GPU, alone: build, check,
time. A quicker loop than ``chip_smoke.py`` (under a minute) for work on
``macaw_llm_tpu_torch/csrc/flash_attention_bwd.cu``.

1. builds the kernel library and prints the backward file's ptxas lines;
2. holds delta, dq (B3) and dk/dv (B4) against the plain backward at small
   and ragged shapes (causal and not, Sq != Sk, a padding bias, a row with
   no valid key, an LSE cotangent, head dims 64, 128 and 256) and at the 7b
   train shape (B=8, S=1080, N=32, D=128, causal), and checks that a
   second run gives the same bits;
3. times, at the train shape, delta, B3, B4 (causal and not), the whole
   CUDA backward, the plain delta and SDPA's backward;
4. with ``--against A.cu [B.cu ...]``: builds each other version of
   ``flash_attention_bwd.cu`` (the same C entry points; for instance the
   parent commit's, from ``git show``) standalone and times its B3 and B4
   at the train shape beside this checkout's, in turns (A B B A); it also
   says whether each gives the same bits and the largest gradient-row
   difference to this checkout's, against the row bar.

Usage, from the root of a checkout:
    python3 tools/flash_bwd_probe.py [--against OTHER.cu ...]
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
ROW_TOL = 2.0 ** -6      # chip_smoke.py's BWD_ROW_REL_TOL, with its floor
ROW_FLOOR = 2.0 ** -10
DELTA_TOL = 1e-5         # chip_smoke.py's DELTA_REL_TOL

# name, B, Sq, Sk, N, D, causal, bias kind, LSE cotangent
CASES = (("small_causal", 1, 128, 128, 1, 128, True, "none", False),
         ("ragged_pad", 2, 300, 300, 4, 128, True, "pad", False),
         ("ragged_tail", 2, 300, 300, 4, 128, True, "tail", False),
         ("sq_lt_sk", 2, 77, 130, 2, 128, False, "pad", True),
         ("causal_sq_gt_sk", 2, 300, 200, 2, 128, True, "none", False),
         ("causal_sq_lt_sk_d64", 2, 150, 400, 2, 64, True, "none", True),
         ("d64_long_kv", 2, 200, 1178, 2, 64, False, "tail", False),
         ("d256", 2, 130, 130, 2, 256, True, "pad", False),
         ("train", 8, 1080, 1080, 32, 128, True, "none", False))


def row_err(out, ref) -> float:
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(
        ROW_FLOOR * ref.float().abs().max().item())
    return (diff / scale.clamp_min(1e-30)).max().item()


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
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


def build_other(build, src: Path, out_dir: Path):
    """``src`` (another flash_attention_bwd.cu) as its own library."""
    nvcc = build._nvcc()
    lib = out_dir / f"lib_{src.stem}_{abs(hash(str(src))) % 10**8}.so"
    cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o",
           str(lib), str(src), *build._link_flags(nvcc)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout[-4000:]}")
    handle = ctypes.CDLL(str(lib))
    for name in ("macaw_flash_attention_bwd_dq",
                 "macaw_flash_attention_bwd_dkv"):
        fn = getattr(handle, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path,
                    help="other versions of flash_attention_bwd.cu to time "
                         "beside this checkout's")
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
            section = "flash_attention_bwd" in line
        elif section and re.search(r"Function properties|spill|Used", line):
            print("  " + re.sub(r"_ZN5macaw\w*?_cu_\w{8}\d+", "",
                                line.strip()))
    _build.library()
    print(json.dumps({"build_seconds": info["seconds"]}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    neg = torch.finfo(torch.float32).min

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    ok = True
    for name, b, sq, sk, n, d, causal, kind, lse_grad in CASES:
        q, k, v, g = rn(b, sq, n, d), rn(b, sk, n, d), rn(b, sk, n, d), \
            rn(b, sq, n, d)
        bias = None
        if kind == "pad":  # batch row 0: no valid key; the last: half
            bias = torch.zeros(b, sk, device="cuda")
            bias[-1, sk // 2:] = neg
            bias[0] = neg
        elif kind == "tail":  # only the ragged last 64-key tile valid
            bias = torch.full((b, sk), neg, device="cuda")
            bias[:, sk - (sk % 64 or 64):] = 0.0
        g_lse = (torch.randn(b, sq, n, generator=gen, device="cuda")
                 if lse_grad else None)
        out, lse = fa.flash_attention_with_lse(q, k, v, bias, causal=causal)
        delta = fa.flash_attention_delta(out, g, g_lse)
        ref_delta = fa.backward_delta(out, g, g_lse)
        kw = dict(causal=causal, scale=d ** -0.5)

        def grads():
            return (fa.flash_attention_dq(q, k, v, bias, g, lse, delta, **kw),
                    *fa.flash_attention_dkv(q, k, v, bias, g, lse, delta,
                                            **kw))

        got, again = grads(), grads()
        torch.cuda.synchronize()
        ref = fa.attention_backward_reference(q, k, v, bias, lse, g, delta,
                                              **kw)
        res = dict(case=name, shape_q=[b, sq, n, d], shape_kv=[b, sk, n, d],
                   causal=causal,
                   delta_rel_err=((delta - ref_delta).abs().max()
                                  / ref_delta.abs().max()).item(),
                   same_bits=all(torch.equal(x, y)
                                 for x, y in zip(got, again)),
                   **{f"{key}_row_err": row_err(x, r) for key, x, r in
                      zip(("dq", "dk", "dv"), got, ref)})
        if kind == "pad":
            res["masked_row_zero"] = not any(x[0].any() for x in got)
        res["ok"] = (res["delta_rel_err"] <= DELTA_TOL and res["same_bits"]
                     and res.get("masked_row_zero", True)
                     and all(res[f"{key}_row_err"] <= ROW_TOL
                             for key in ("dq", "dk", "dv")))
        ok &= res["ok"]
        print(json.dumps(res), flush=True)
        del ref, again
        if name != "train":
            continue

        kwn = dict(causal=False, scale=d ** -0.5)
        _, lse_n = fa.flash_attention_with_lse(q, k, v, bias, causal=False)

        def whole():  # what _FlashAttention.backward launches
            dl = fa.flash_attention_delta(out, g)
            fa.flash_attention_dq(q, k, v, bias, g, lse, dl, **kw)
            fa.flash_attention_dkv(q, k, v, bias, g, lse, dl, **kw)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        t = dict(
            delta=cuda_ms(torch, lambda: fa.flash_attention_delta(out, g)),
            plain_delta=cuda_ms(torch, lambda: fa.backward_delta(out, g)),
            dq=cuda_ms(torch, lambda: fa.flash_attention_dq(
                q, k, v, bias, g, lse, delta, **kw)),
            dkv=cuda_ms(torch, lambda: fa.flash_attention_dkv(
                q, k, v, bias, g, lse, delta, **kw)),
            dq_noncausal=cuda_ms(torch, lambda: fa.flash_attention_dq(
                q, k, v, bias, g, lse_n, delta, **kwn)),
            dkv_noncausal=cuda_ms(torch, lambda: fa.flash_attention_dkv(
                q, k, v, bias, g, lse_n, delta, **kwn)),
            whole_cuda_backward=cuda_ms(torch, whole),
            sdpa_backward=cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), gt, retain_graph=True)))
        print(json.dumps({"train_shape_ms": t, "card": smi}), flush=True)
        del qt, kt, vt, lib_out, gt

        if args.against:
            ab = compare(torch, fa, _build, args.against, got,
                         (q, k, v, bias, g, lse, delta, b, sq, n, d))
            ok &= ab.pop("ok")
            print(json.dumps({"against": ab, "card": smi}), flush=True)
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


def compare(torch, fa, build, sources, got, inputs):
    """B3 and B4 of each other source beside this checkout's, A B B A."""
    q, k, v, bias, g, lse, delta, b, s, n, d = inputs
    lse_f, delta_f = fa._folded(lse), fa._folded(delta)
    stream = torch.cuda.current_stream().cuda_stream
    out_dir = ROOT / "build" / "flash_bwd_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {"this": build.library()}
    for src in sources:
        libs[str(src)] = build_other(build, src, out_dir)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if bias is None else bias.data_ptr(), g.data_ptr(),
            lse_f.data_ptr(), delta_f.data_ptr())
    scale = d ** -0.5

    def launch(lib, which, outs):
        if which == "dq":
            return lib.macaw_flash_attention_bwd_dq(
                *ptrs, outs[0].data_ptr(), b, s, s, n, d, scale, 1, stream)
        return lib.macaw_flash_attention_bwd_dkv(
            *ptrs, outs[0].data_ptr(), outs[1].data_ptr(), b, s, s, n, d,
            scale, 1, stream)

    res, ok = {}, True
    for which, ref in (("dq", got[:1]), ("dkv", got[1:])):
        outs = [torch.empty_like(x) for x in ref]
        for name, lib in libs.items():
            err = launch(lib, which, outs)
            torch.cuda.synchronize()
            build.check(err, f"{which} of {name}")
            res[f"{which}_same_bits:{name}"] = all(
                torch.equal(o, r) for o, r in zip(outs, ref))
            diff = max(row_err(o, r) for o, r in zip(outs, ref))
            res[f"{which}_row_err:{name}"] = diff
            ok &= diff <= ROW_TOL
        order = list(libs)
        for name in order + order[::-1]:
            res.setdefault(f"{which}_ms:{name}", []).append(cuda_ms(
                torch, lambda: launch(libs[name], which, outs), 30))
    res["ok"] = ok
    return res


if __name__ == "__main__":
    sys.exit(main())
