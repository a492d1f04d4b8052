"""A training cell: the program's ``Trainer`` in the QLoRA form of the
configuration, driven over batches drawn from the seed, one measured
window, then the comparison with the reference.

Set-up builds one trainer and one state (weights drawn on the card from
the seed; the trainable leaves, the fusion and the LoRA factors, as fp32
masters; the program quantizes the base, casts the frozen towers and
computes the alignment cache), and takes the first ``checked_steps`` steps
through the same ``train_step`` call the window makes, each on a batch of
its own: they warm every shape up and are the steps the reference follows.
The window then runs steps over the rest of the batch pool until the first
step that ends ``seconds`` after it opened; its length is taken to that
step's end, so the rate counts whole steps and all the time they took.
Every step's loss is read (a non-finite loss is a failed step), which
synchronizes each step with the host. A traced run traces the steps that
start in the window's last ``trace.TRACE_S`` seconds and reads the trace
after the window closes. Rows carry media or text alone, as the mix says.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from . import program, weights, work
from .reference import check as ref_check
from .trace import TRACE_S
from .traffic import train_batch


class Window:
    """What a training window produced, for the metric readers."""

    kind = "train"

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def step_flops(self) -> float:
        s = self.spec
        return work.qlora_step_flops(self.sizes, s["rows"], s["text_tokens"],
                                     self.cfg["training"]["lora_rank"],
                                     media=s["media"] == "all")


def _trainable(tree: dict) -> dict:
    """The fusion and LoRA leaves as fp32 masters (the rest stays bf16)."""
    out = dict(tree)
    out["fusion"] = weights.tree_map(lambda x: x.float(), tree["fusion"])
    llm = dict(tree["llm"])
    layers = dict(llm["layers"])
    layers["lora"] = weights.tree_map(lambda x: x.float(), layers["lora"])
    llm["layers"] = layers
    out["llm"] = llm
    return out


def _norms(tree: dict) -> dict:
    return {k: float(v.float().norm())
            for k, v in weights.leaves(tree).items()}


def run(cfg: dict, spec: dict, w: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, limits: dict,
        control: bool = False) -> dict:
    form = cfg["training"]
    mcfg = program.model_config(cfg, training=True)
    tcfg = program.train_config(form, spec["total_steps"])
    sizes = work.Sizes.of(cfg)
    rng_seed = (seed * 7 + 3) % (2 ** 63)
    batches = [train_batch(spec, cfg, seed, k, device)
               for k in range(spec["batch_pool"])]
    params = _trainable(weights.make_tree(cfg, seed, device,
                                          lora_rank=form["lora_rank"]))
    trainer = program.trainer(mcfg, tcfg, spec["total_steps"], device)
    state = trainer.init_state(params, rng=torch.Generator().manual_seed(
        rng_seed))
    del params
    gc.collect()

    def step(k: int):
        nonlocal state
        b = {key: v[None] for key, v in batches[k % len(batches)].items()}
        state, m = trainer.train_step(state, b)
        return float(m["loss"]), float(m["grad_norm"])

    start = {k: v.detach().clone()
             for k, v in weights.leaves(state.trainable).items()}
    losses, norms, first = [], [], None
    b1 = form["adam_b1"]
    for k in range(spec["checked_steps"]):
        loss, norm = step(k)
        losses.append(loss)
        norms.append(norm)
        if k == 0:
            first = {p: n / (1.0 - b1)
                     for p, n in _norms(state.opt_state.mu).items()}
    change = {p: float((v.detach() - start[p]).norm())
              for p, v in weights.leaves(state.trainable).items()}
    del start

    # the window
    dev_trace, trace_from = None, None
    ends, window_losses = [], []
    k = spec["checked_steps"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        if trace and dev_trace is None and \
                time.perf_counter() - t0 >= seconds - TRACE_S:
            from .trace import DeviceTrace
            dev_trace = DeviceTrace()
            dev_trace.start(program.launches)
            trace_from = len(ends)
        window_losses.append(step(k)[0])
        k += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    t1 = ends[-1]
    if dev_trace is not None:
        dev_trace.stop()
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    del state, trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(1 for x in window_losses if not math.isfinite(x))
    prefix = sizes.prefix_len if spec["media"] == "all" else 0
    tokens = spec["rows"] * (spec["text_tokens"] + prefix)
    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": tokens * len(ends) / (t1 - t0)}
    win = Window(t0=t0, t1=t1, seconds=t1 - t0, steps=len(ends),
                 trace_steps=None if trace_from is None
                 else len(ends) - trace_from,
                 sizes=sizes, cfg=cfg, spec=spec, trace=dev_trace, e2e=e2e)
    program_side = {"loss": losses, "grad_norm": norms, "first_grad": first,
                    "change": change}
    checks, info = compare(cfg, spec, limits, program_side, batches, seed,
                           rng_seed, device, control)
    info.update(step_s_median=statistics.median(
        b - a for a, b in zip([t0] + ends[:-1], ends)),
        steps=len(ends), window_loss_last=window_losses[-1])
    return {"attempted": len(ends), "failed": failed, "e2e": e2e,
            "window": win, "peak": peak, "checks": checks, "info": info}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the widest relative gap of a step's loss and
    of its global gradient norm before the clip; of a leaf's first
    gradient norm (after the clip, as the optimizer gets it) and of its
    change after the checked steps, each against the larger of the
    reference's norm of that leaf and of the median leaf. A leaf whose
    largest reference gradient is under a thousandth of the median leaf's
    moves by round-off alone and is left out of the change."""
    def rel(a, b):
        return max(abs(p - r) / abs(r) for p, r in zip(a, b))

    def widest(pn: dict, rn: dict, keys) -> float:
        med = statistics.median(rn[k] for k in keys)
        return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
                   for k in keys)

    keys = sorted(ref["first_grad"])
    raw = ref["raw_grad_max"]
    med_raw = statistics.median(raw.values())
    moving = [k for k in keys if raw[k] >= 1e-3 * med_raw]
    return {"loss_gap": rel(prog["loss"], ref["loss"]),
            "grad_norm_gap": rel(prog["grad_norm"], ref["grad_norm"]),
            "first_grad_gap": widest(prog["first_grad"], ref["first_grad"],
                                     keys),
            "change_gap": widest(prog["change"], ref["change"], moving)}


def reference_config(form: dict, total_steps: int) -> dict:
    keys = ("learning_rate", "adam_b1", "adam_b2", "adam_eps",
            "warmup_ratio", "max_grad_norm", "lora_rank", "lora_alpha")
    return dict({k: form[k] for k in keys}, total_steps=total_steps)


def compare(cfg, spec, lim, prog, batches, seed, rng_seed, device,
            control: bool = False) -> tuple:
    """The reference trained on the checked steps' batches from the same
    weights and dropout generator: (checks, the readings). ``control``
    also trains the reference with a 4-bit base and reads its gaps."""
    form = cfg["training"]
    rcfg = reference_config(form, spec["total_steps"])
    checked = batches[:spec["checked_steps"]]

    def tree():
        return weights.make_tree(cfg, seed, device,
                                 lora_rank=form["lora_rank"])

    ref = ref_check.train_steps(tree(), cfg, rcfg, checked, rng_seed, device)
    g = gaps(prog, ref)
    info = {"loss_program": prog["loss"], "loss_reference": ref["loss"],
            "grad_norm_program": prog["grad_norm"],
            "grad_norm_reference": ref["grad_norm"]}
    if control:
        low = ref_check.train_steps(tree(), cfg, rcfg, checked, rng_seed,
                                    device, base_bits=4)
        info["control"] = gaps(low, ref)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in g.items()}
    return checks, info
