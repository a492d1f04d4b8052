"""Probes of the decode path on one GPU, for measurements that
``chip_smoke.py`` does not make.

``sweep``: the int8 matvec kernel (``csrc/matvec.cu``, B5 and B6) at the
five 7b decode shapes and 4, 16 and 32 rows, for every K split count the
kernel takes (1 to 8), calling the C entry point directly; one JSON line
per shape and row count with the device time of each split count in
microseconds (a CUDA graph of the launches) and the count that
``ops/kernels/matvec.matvec_splits`` picks. This is what the plan is
checked against.

``--against DIR``: builds ``DIR/matvec.cu`` and ``DIR/matvec_pipelined.cu``
(the earlier CUDA-core B5 and B6, with their C interface and grid plans)
and times them A B B A beside this checkout's kernels at the five 7b
shapes and 4, 16 and 32 rows, each through a wrapper that allocates as
the port's does, by device time (a CUDA graph of the launches: the
profiler's kernel records would count the reduce kernel's early,
programmatic launch twice); one JSON line per shape and row count,
after one with each wrapper's host time per call (2000 calls at a one-tile
shape, on the TMA path and the ragged one). DIR is filled from git, for example:
    mkdir -p build/parent; for f in matvec.cu matvec_pipelined.cu \
      kernels.cuh; do git show <commit>:macaw_llm_tpu_torch/csrc/$f \
      > build/parent/$f; done

Usage, from the root of a checkout:
    python3 tools/decode_probes.py sweep
    python3 tools/decode_probes.py --against build/parent
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, K, N, launches per decode step)
SHAPES = (("qkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
          ("gateup", 4096, 22016, 32), ("down", 11008, 4096, 32),
          ("lm_head", 4096, 32007, 1))
ROWS = (4, 16, 32)


def graph_ms(torch, fn, n: int, replays: int = 5) -> float:
    """Device time (ms) per call: ``n`` calls in one CUDA graph, replayed
    between CUDA events (no host issue time)."""
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


def weights(torch, gen, k: int, n: int, least: int = 128 << 20):
    """``least`` bytes of distinct int8 weights (by default 128 MB: no call
    finds its weight in the 50 MB L2), their scale and a cycling call
    maker."""
    copies = max(1, -(-least // (k * n)))
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


def sweep(torch) -> None:
    from macaw_llm_tpu_torch.ops.kernels import _build
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"smem_bytes_per_block": {
        f"rows{r}_vec{v}": {d: lib.macaw_matvec_smem_bytes(r, v, d)
                            for d in (1, 2, 4, 8)}
        for r in (8, 16, 24, 32) for v in (1, 0)}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call(x, q, s, splits):
        b, k = x.shape
        n = q.shape[1]
        ws = torch.empty((splits, b, n) if splits > 1 else (0,),
                         dtype=torch.float32, device="cuda")
        out = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
        err = lib.macaw_matvec_int8_pipelined(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, k, n, splits, 4, _build.stream_ptr(x))
        _build.check(err, "matvec_int8_pipelined")
        return out

    # beside the 7b shapes: the lm_head's width rounded to 16 (the TMA
    # path, against the ragged one), and one 64 x 128 tile and 8 tiles
    # (a launch's fixed cost, the weights in L2)
    extra = (("lm_head_n32000", 4096, 32000, 0), ("tile", 64, 128, 0),
             ("tiles8", 512, 128, 0))
    for name, k, n, per in SHAPES + extra:
        ws, s, cycle = weights(torch, gen, k, n,
                               128 << 20 if k * n > 1 << 20 else 0)
        tile_k = mv.TILE_K if n % 16 == 0 else mv.RAGGED_TILE_K
        tiles_k, tiles_n = -(-k // tile_k), -(-n // mv.TILE_N)
        for b in ROWS:
            x = torch.randn(b, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            ref = mv.matvec_reference(x, ws[0], s).float()
            seen, times = set(), {}
            for want in range(1, min(mv.MAX_SPLITS, tiles_k) + 1):
                per = -(-tiles_k // want)
                splits = -(-tiles_k // per)
                if splits in seen:
                    continue
                seen.add(splits)
                out = call(x, ws[0], s, splits).float()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                if not rel <= 1e-2:
                    raise AssertionError(f"{name} at {splits} splits: {rel}")
                times[splits] = round(graph_ms(torch, cycle(
                    lambda w: call(x, w, s, splits)),
                    max(8, 4 * len(ws))) * 1e3, 2)
            print(json.dumps({"call": name, "k": k, "n": n, "rows": b,
                              "tiles_n": tiles_n,
                              "plan": mv.matvec_splits(k, n, sms, tile_k),
                              "us_by_splits": times}), flush=True)
        del ws
        torch.cuda.empty_cache()


# ------------------------------------------------ the CUDA-core B5 and B6
# this kernel replaced (their grid plans, as ops/kernels/matvec.py had them)

def _parent_b5_splits(k: int, n: int) -> int:
    tiles = -(-n // 512)
    splits = max(-(-264 // tiles), -(-k // 1024))
    return max(1, min(splits, k))


def _parent_b6_plan(k: int, n: int, vec: bool, resident: int, sms: int):
    tiles = -(-n // 256)
    share = (0.9, 1.0, 1.0) if vec else (0.5, 0.85, 1.0)
    best = None
    for want in range(1, max(1, resident * sms // tiles) + 1):
        rps = -(-(-(-k // want)) // 32) * 32
        splits = -(-k // rps)
        per_sm = -(-tiles * splits // sms)
        cost = per_sm * rps / share[min(per_sm, len(share)) - 1]
        if best is None or cost < best[0]:
            best = (cost, splits, rps)
    return best[1], best[2]


def _build_other(build, src: Path):
    nvcc = build._nvcc()
    out_dir = ROOT / "build" / "decode_probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib_{src.stem}.so"
    cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
           str(build.CSRC), "-shared", "-o", str(lib), str(src),
           *build._link_flags(nvcc)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout[-4000:]}")
    return ctypes.CDLL(str(lib))


def against(torch, src_dir: Path) -> None:
    from macaw_llm_tpu_torch.ops.kernels import _build
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    P, I = ctypes.c_void_p, ctypes.c_int
    b5 = _build_other(_build, src_dir / "matvec.cu")
    b5.macaw_matvec_int8.argtypes = [P, P, P, P, P, I, I, I, I, P]
    b5.macaw_matvec_int8.restype = I
    b6 = _build_other(_build, src_dir / "matvec_pipelined.cu")
    b6.macaw_matvec_int8_pipelined.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                               I, I, P]
    b6.macaw_matvec_int8_pipelined.restype = I
    b6.macaw_matvec_int8_pipelined_blocks_per_sm.argtypes = [I, I, I]
    b6.macaw_matvec_int8_pipelined_blocks_per_sm.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = functools.lru_cache(maxsize=None)(
        b6.macaw_matvec_int8_pipelined_blocks_per_sm)  # as the wrapper did

    def old_b5(x, q, s):  # the previous wrapper's allocations and launch
        b, k = x.shape
        n = q.shape[1]
        splits = _parent_b5_splits(k, n)
        ws = torch.empty((splits, b, n), dtype=torch.float32, device="cuda")
        out = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
        _build.check(b5.macaw_matvec_int8(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
            out.data_ptr(), b, k, n, splits, _build.stream_ptr(x)),
            "parent matvec_int8")
        return out

    def old_b6(x, q, s, depth=4):
        b, k = x.shape
        n = q.shape[1]
        rows = 8 if b <= 8 else 16 if b <= 16 else 32
        vec = n % 16 == 0 and q.data_ptr() % 16 == 0
        splits, rps = _parent_b6_plan(k, n, vec,
                                      resident(rows, int(vec), depth), sms)
        depth = min(depth, rps // 32)
        scratch = torch.empty(k * rows + splits * b * n,
                              dtype=torch.float32, device="cuda")
        out = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
        _build.check(b6.macaw_matvec_int8_pipelined(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * k * rows, out.data_ptr(), b, k, n,
            splits, rps, depth, _build.stream_ptr(x)),
            "parent matvec_int8_pipelined")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the host's time per wrapper call: 2000 calls at a one-tile shape,
    # whose device time is below the host's, issued back to back
    x = torch.randn(16, 64, generator=gen, device="cuda").to(torch.bfloat16)
    res = {"call": "host_us_per_call", "k": 64, "n": 128, "rows": 16}
    for n in (128, 127):  # the TMA path and the ragged one
        q = torch.ones(64, n, dtype=torch.int8, device="cuda")
        s = torch.ones(n, device="cuda")
        for label, fn in (("this_b6", lambda: mv.matvec_int8_pipelined(
                              x, q, s)),
                          ("parent_b6", lambda: old_b6(x, q, s)),
                          ("this_b5", lambda: mv.matvec_int8(x, q, s)),
                          ("parent_b5", lambda: old_b5(x, q, s))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            res[f"{label}_n{n}"] = (time.perf_counter() - t0) / 2000 * 1e6
    print(json.dumps(res), flush=True)
    for name, k, n, per in SHAPES:
        ws, s, cycle = weights(torch, gen, k, n)
        iters = max(8, 4 * len(ws))
        for b in ROWS:
            x = torch.randn(b, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            ref = mv.matvec_reference(x, ws[0], s).float()
            pairs = {"b5": (lambda w: mv.matvec_int8(x, w, s),
                            lambda w: old_b5(x, w, s)),
                     "b6": (lambda w: mv.matvec_int8_pipelined(x, w, s),
                            lambda w: old_b6(x, w, s))}
            res = {"call": name, "k": k, "n": n, "rows": b,
                   "per_step": per}
            for kern, (this, other) in pairs.items():
                for label, fn in (("this", this), ("parent", other)):
                    out = fn(ws[0]).float()
                    rel = ((out - ref).abs().max() / ref.abs().max()).item()
                    if not rel <= 1e-2:
                        raise AssertionError(f"{kern} {label} {name} {b}: "
                                             f"{rel}")
                times = {"this": [], "parent": []}
                for label in ("this", "parent", "parent", "this"):
                    fn = this if label == "this" else other
                    times[label].append(graph_ms(torch, cycle(fn), iters))
                res[kern] = {f"{label}_device_ms": t
                             for label, t in times.items()}
            print(json.dumps(res), flush=True)
        del ws
        torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not args or (args[0] not in ("sweep", "--against")
                    or (args[0] == "--against" and len(args) != 2)):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the probes need one GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True
                         ).stdout.strip().splitlines()[0], flush=True)
    if args[0] == "sweep":
        sweep(torch)
    else:
        against(torch, Path(args[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
