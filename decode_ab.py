"""Greedy-decode A/B of two checkouts of the PyTorch/CUDA port on one GPU.

Both checkouts' ``macaw_llm_tpu_torch`` are imported into one process (each
with its own kernels, built in its own checkout) and drive the same
weights: the 7b LLaMA with random int8 weights from a seed, packed for
decode as ``chip_smoke.py`` phase 6 does, after a ``--prompt``-long prompt
of random embeddings. Decode is host-bound, so the two sides alternate
(A B, B A, A B, ...) over ``--rounds`` rounds in the same process, on the
same host threads, and each side's median tokens/s is compared; each
round also gives a paired ratio B/A.

Usage, from anywhere:
    python3 decode_ab.py ROOT_A ROOT_B [--rounds 20] [--new 64]
Prints one JSON line per round and a summary line; exits non-zero when no
GPU is present or the two sides' tokens differ.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = "macaw_llm_tpu_torch"


def load(root: Path) -> dict:
    """Import the decode path of the package under ``root``; returns its
    modules. The modules of the previously loaded checkout leave
    ``sys.modules`` first, and keep working through their own globals."""
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        mods = {name: importlib.import_module(f"{PACKAGE}.{name}") for name in
                ("config", "generate", "models.llama", "utils.quantize",
                 "ops.kernels._build")}
    finally:
        sys.path.remove(str(root))
    for m in mods.values():
        if not Path(m.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {m.__file__}, not from {root}")
    mods["ops.kernels._build"].build()
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=312)
    ap.add_argument("--new", type=int, default=64)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: decode_ab.py needs one GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card, flush=True)
    roots = [Path(r).resolve() for r in args.roots]
    sides = {str(r): load(r) for r in roots}
    a, b = sides
    first = sides[a]
    cfg = first["config"].macaw_7b().llm
    qz = first["utils.quantize"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = qz.pack_llama_for_decode(qz.quantize_llama(
        first["models.llama"].init_params(gen, cfg, dtype=torch.bfloat16)))
    embeds = (torch.randn(args.batch, args.prompt, cfg.hidden_size,
                          generator=gen, device="cuda") * 0.02
              ).to(torch.bfloat16)
    mask = torch.ones(args.batch, args.prompt, dtype=torch.int64,
                      device="cuda")

    def run(side: str):
        t0 = time.perf_counter()
        out = sides[side]["generate"].generate(
            params, cfg, inputs_embeds=embeds, attention_mask=mask,
            max_new_tokens=args.new, eos_id=-1)
        torch.cuda.synchronize()
        return out.tokens, args.batch * args.new / (time.perf_counter() - t0)

    ref = {side: run(side)[0] for side in (a, b)}  # warm-up
    if not torch.equal(ref[a], ref[b]):
        raise AssertionError("the two checkouts decode different tokens")
    rates = {a: [], b: []}
    for i in range(args.rounds):
        for side in ((a, b) if i % 2 == 0 else (b, a)):
            tokens, rate = run(side)
            if not torch.equal(tokens, ref[side]):
                raise AssertionError("greedy decode is not deterministic")
            rates[side].append(rate)
        print(json.dumps({"round": i, a: rates[a][-1], b: rates[b][-1]}),
              flush=True)
    ratios = [y / x for x, y in zip(rates[a], rates[b])]
    print(json.dumps({"decode_ab": {
        "card": card, "batch": args.batch, "prompt": args.prompt,
        "new_tokens": args.new, "rounds": args.rounds, "a": a, "b": b,
        "median_tokens_per_s": {s: statistics.median(v)
                                for s, v in rates.items()},
        "min_max": {s: [min(v), max(v)] for s, v in rates.items()},
        "ratio_b_over_a_median": statistics.median(ratios),
        "ratio_b_over_a_min_max": [min(ratios), max(ratios)]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
