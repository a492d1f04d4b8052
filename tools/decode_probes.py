"""Two probes of the decode path on one GPU, for measurements that
``chip_smoke.py`` does not make.

``sweep``: the pipelined matvec (``csrc/matvec_pipelined.cu``) at the five
7b decode shapes, 16 and 32 rows, for every grid (K splits x rows per
split) of up to four blocks per SM, calling the C entry point directly;
prints how many blocks an SM holds per kernel instance and ring depth,
then one JSON line per shape and row count with the time of each grid in
microseconds. This is what ``ops/kernels/matvec.pipelined_splits`` was
fitted to.

``graph [layers]``: whether one decode step of ``ContinuousEngine`` can be
captured as a CUDA graph: a 7b-width engine of ``layers`` LLaMA layers
(default 8), 16 slots, int8 weights and KV, every slot filled by hand;
20 eager steps against 20 replays of the captured step from the same
state; prints both times per step and whether the tokens are equal.

Usage, from the root of a checkout:
    python3 tools/decode_probes.py sweep
    python3 tools/decode_probes.py graph 8
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
          (4096, 32007))


def cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
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


def sweep(torch) -> None:
    from macaw_llm_tpu_torch.ops.kernels import _build
    from macaw_llm_tpu_torch.ops.kernels import matvec as mv
    lib = _build.library()
    for rows in (8, 16, 32):
        for vec in (1, 0):
            print(json.dumps({"rows": rows, "vec": vec, "blocks_per_sm": {
                d: lib.macaw_matvec_int8_pipelined_blocks_per_sm(rows, vec, d)
                for d in (1, 2, 4, 8)}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call(x, q, s, splits, rps, depth=4):
        b, k = x.shape
        n = q.shape[1]
        rows = 8 if b <= 8 else 16 if b <= 16 else 32
        scratch = torch.empty(k * rows + splits * b * n, dtype=torch.float32,
                              device="cuda")
        out = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
        err = lib.macaw_matvec_int8_pipelined(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * k * rows, out.data_ptr(), b, k, n,
            splits, rps, min(depth, rps // 32), _build.stream_ptr(x))
        _build.check(err, "matvec_int8_pipelined")
        return out

    for k, n in SHAPES:
        copies = max(1, -(-(128 << 20) // (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen,
                            device="cuda").to(torch.int8)
              for _ in range(copies)]
        s = torch.rand(1, n, generator=gen, device="cuda") * 0.01
        tiles = -(-n // 256)
        for b in (16, 32):
            x = torch.randn(b, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            ref = mv.matvec_reference(x, ws[0], s).float()
            seen, times = set(), {}
            for want in range(1, 4 * 132 // tiles + 1):
                rps = -(-(-(-k // want)) // 32) * 32
                splits = -(-k // rps)
                if splits in seen:
                    continue
                seen.add(splits)
                out = call(x, ws[0], s, splits, rps).float()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                if not rel <= 1e-2:
                    raise AssertionError(f"{k}x{n} at {splits} splits: {rel}")
                i = [0]

                def cycle():
                    i[0] = (i[0] + 1) % copies
                    return call(x, ws[i[0]], s, splits, rps)

                times[f"{splits}x{rps}={tiles * splits}"] = round(
                    cuda_ms(torch, cycle, 4 * copies) * 1e3, 1)
            print(json.dumps({"k": k, "n": n, "rows": b, "tiles": tiles,
                              "splits_x_rows_per_split=blocks: us": times}),
                  flush=True)
        del ws


class _Tok:
    def encode(self, text):
        h = zlib.crc32(text.encode())
        return [1] + [16 + (h + 37 * i) % 31000 for i in range(40)]


def graph(torch, layers: int) -> None:
    from macaw_llm_tpu_torch.config import macaw_7b
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.serve import ContinuousEngine, Request
    from macaw_llm_tpu_torch.utils import quantize as qz
    cfg7 = macaw_7b()
    cfg = dataclasses.replace(
        cfg7, llm=dataclasses.replace(cfg7.llm, num_layers=layers),
        vision=dataclasses.replace(cfg7.vision, num_layers=2),
        audio=dataclasses.replace(cfg7.audio, encoder_layers=2))
    params = fusion.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    params["llm"] = qz.pack_llama_for_decode(qz.quantize_llama(params["llm"]))
    eng = ContinuousEngine(params, cfg, _Tok(), slots=16, prompt_bucket=64,
                           max_new_tokens=64, align_cache="int8",
                           kv_cache_dtype="int8")
    slots = list(range(16))
    steps = 20
    with torch.inference_mode(), torch.cuda.stream(eng._decode_stream):
        for i in slots:
            eng._place(i, eng._run_prefill(Request(prompt=f"request {i}",
                                                   max_new_tokens=64)))
        eng._dispatch(slots)  # uploads the control vectors, warms up
        torch.cuda.synchronize()
        state = (eng.lengths.clone(), eng.toks.clone(),
                 {k: v.clone() for k, v in eng.cache.items()})

        def run(step):
            toks = []
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
                toks.append(eng.toks.clone())
            torch.cuda.synchronize()
            return torch.stack(toks), (time.perf_counter() - t0) / steps * 1e3

        ref, eager_ms = run(eng._step)
        eng.lengths.copy_(state[0])
        eng.toks.copy_(state[1])
        for key, v in state[2].items():
            eng.cache[key].copy_(v)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=eng._decode_stream):
            eng._step()  # captured, not run
        got, graph_ms = run(g.replay)
    print(json.dumps({"layers": layers, "slots": 16,
                      "eager_ms_per_step": eager_ms,
                      "graph_ms_per_step": graph_ms,
                      "tokens_equal": bool(torch.equal(got, ref))}),
          flush=True)


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("sweep", "graph"):
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
    if sys.argv[1] == "sweep":
        sweep(torch)
    else:
        graph(torch, int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
