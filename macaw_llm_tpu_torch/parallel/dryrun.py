"""Multi-process dry run (counterpart of ``__graft_entry__.dryrun_multichip``)
and the worker entry that runs a task in each process of a job.

    python -m macaw_llm_tpu_torch.parallel.dryrun --procs 4 [--device cuda]

starts n processes (gloo on the CPU; nccl with one card a rank), joins
them through a ``FileStore`` (no port to race for), and runs one sharded
train step of the tiny config over the mesh (1, 1, n/2, 2) (or (1, 1, n,
1) for odd n): each rank prints its shard shapes and the loss.

``spawn(world, task, payload)`` is the same start-up for any task of
``TASKS``: ``train`` (the Trainer over a mesh on given weights and whole
batches, with an optional restore, save and eval), ``ring`` (ring
attention on given q/k/v), ``run_train`` (``run_train.main`` in every
process), ``tp`` (tensor-parallel inference over the world as one tensor
group: forward, generation, the fused prefill, the engine, the server,
``run_inference``) and ``dryrun``. A worker imports torch and this package
only.
Each rank writes its results to ``<out>/rank<r>.pt``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import torch
import torch.distributed as dist

from macaw_llm_tpu_torch.config import (Config, MeshConfig, TrainConfig,
                                        tiny_model_config)


def _mesh_cfg(shape) -> MeshConfig:
    c, d, f, t = shape
    return MeshConfig(dcn=c, data=d, fsdp=f, tensor=t)


def _shapes(tree, prefix=""):
    from macaw_llm_tpu_torch.parallel.sharding import tree_paths
    return {p: list(x.shape) for p, x in tree_paths(tree, prefix)}


def task_train(p: dict, device, out: str) -> None:
    """The Trainer over the mesh ``p["mesh"]``, for each run of
    ``p["runs"]``: init from ``run["params"]`` (a saved whole tree),
    optionally restore ``run["restore"]``, one train step per whole batch
    of ``run["batches"]`` (each rank takes its rows), optionally save to
    ``run["save"]`` and evaluate ``run["eval"]`` (whole [B, ...] batches);
    {"runs": results} (losses, shard shapes, the shapes of layer 0's
    leaves as the models read them, collectives, the whole trainable tree
    and moments after the steps, after a restore this rank's restored
    shards and the trainable leaves' specs, and with
    ``run["count_llama"]`` the collectives of one LLaMA forward and
    backward) to ``out``."""
    from macaw_llm_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(_mesh_cfg(p["mesh"]), device)
    torch.save({"runs": [_train_run(r, mesh, p["mesh"], device)
                         for r in p["runs"]]}, out)


def _train_run(run: dict, mesh, shape, device) -> dict:
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    from macaw_llm_tpu_torch.train.checkpoint import CheckpointManager
    from macaw_llm_tpu_torch.train.trainer import Trainer
    cfg = Config.from_dict({"model": run["model"], "train": run["train"]})
    cfg = Config(model=cfg.model, train=cfg.train, mesh=_mesh_cfg(shape))
    cfg.validate(world_size=dist.get_world_size())
    tr = Trainer(cfg.model, cfg.train, run.get("total_steps", 10),
                 device=device, mesh=mesh)
    state = tr.init_state(torch.load(run["params"], weights_only=False))
    res = {}
    if run.get("restore"):
        state = CheckpointManager(run["restore"], trainer=tr).restore(state)
        whole = tr.whole_state(state)
        res["restored"] = {"trainable": whole.trainable,
                           "mu": whole.opt_state.mu,
                           "nu": whole.opt_state.nu, "step": whole.step}
        res["restored_shards"] = {
            "trainable": _to_cpu(state.trainable),
            "mu": _to_cpu(state.opt_state.mu),
            "nu": _to_cpu(state.opt_state.nu)}
        res["specs"] = tr.specs["trainable"]
    res.update({"loss": [], "grad_norm": [], "lr": [],
                "shapes": {"trainable": _shapes(state.trainable),
                           "frozen": _shapes(state.frozen),
                           "mu": _shapes(state.opt_state.mu),
                           "nu": _shapes(state.opt_state.nu)},
                "gathered": _layer0_shapes(tr, state)})
    if run.get("count_llama"):
        res["llama_collectives"] = _llama_collectives(tr, state, cfg.model)
    COLLECTIVES.clear()
    for batch in (torch.load(run["batches"], weights_only=False)
                  if run.get("batches") else []):
        batch = tr.shard_batch({k: v.to(tr.device) for k, v in batch.items()})
        state, m = tr.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            res[k].append(float(m[k]))
        res["lr"].append(m["lr"])
    res["collectives"] = dict(COLLECTIVES)
    if run.get("save"):
        ckpt = CheckpointManager(run["save"], save_steps=1, trainer=tr)
        ckpt.save(state, cfg, force=True)
        ckpt.wait()
        res["last_save"] = ckpt.last_save
    if run.get("eval"):
        evals = []
        for batch in torch.load(run["eval"], weights_only=False):
            b = tr.shard_batch({k: v[None].to(tr.device)
                                for k, v in batch.items()})
            evals.append({k: v[0] for k, v in b.items()})
        res["eval"] = tr.evaluate(state, evals)
    whole = tr.whole_state(state)
    if dist.get_rank() == 0:
        res["trainable"] = whole.trainable
        res["mu"], res["nu"] = whole.opt_state.mu, whole.opt_state.nu
    res["step"] = state.step
    return res


def _to_cpu(tree):
    from macaw_llm_tpu_torch.parallel.sharding import tree_map
    return tree_map(lambda _, x: x.detach().cpu(), tree)


def _view(tr, state) -> dict:
    from macaw_llm_tpu_torch.parallel.sharding import gathered_view
    with torch.no_grad():
        return gathered_view(tr._entries(state.trainable, state.frozen),
                             tr.mesh, None)


def _layer0_shapes(tr, state) -> dict:
    """{path: shape} of LLaMA layer 0's leaves as the models read them."""
    with torch.no_grad():
        layer = _view(tr, state)["llm"]["layers"].gather_layer(0)
    return _shapes(layer, "llm/layers")


def _llama_collectives(tr, state, mcfg) -> dict:
    """The collectives of one forward (and then backward) of the LLaMA
    stack alone over this rank's view, on a seeded [2, 7, D] input that
    takes a gradient (no remat)."""
    from macaw_llm_tpu_torch.models import llama
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    llm = _view(tr, state)["llm"]
    x = torch.randn((2, 7, mcfg.llm.hidden_size),
                    generator=torch.Generator().manual_seed(0))
    x = x.to(tr.device).requires_grad_()
    COLLECTIVES.clear()
    h = llama.forward_hidden(llm, mcfg.llm, x, tp=tr.tp,
                             shard_sequence=mcfg.shard_sequence)
    fwd = dict(COLLECTIVES)
    h.square().sum().backward()
    return {"forward": fwd, "total": dict(COLLECTIVES)}


def _leaves(tree):
    from macaw_llm_tpu_torch.parallel.sharding import tree_paths
    return [x for _, x in tree_paths(tree)]


def task_ring(p: dict, device, out: str) -> None:
    """``ring_attention`` over the mesh axis "tensor" of a (1, 1, 1, n)
    mesh on this rank's chunk of the whole q/k/v in ``p["qkv"]`` (in the
    layout's order), for each layout of ``p["layouts"]``: the output and
    the gradients of sum(out * g), this rank's attention kernel launches
    and collectives, and with ``p["iters"]`` the ms of that many more
    forwards and backwards, each started together on every rank."""
    from macaw_llm_tpu_torch.ops.kernels import flash_attention as fa
    from macaw_llm_tpu_torch.parallel.mesh import create_mesh
    from macaw_llm_tpu_torch.parallel.ring_attention import ring_attention
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    n = dist.get_world_size()
    mesh = create_mesh(MeshConfig(dcn=1, data=1, fsdp=1, tensor=n), device)
    me = dist.get_rank()
    kernels = (fa.flash_attention_with_lse, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    res = {}
    for layout in p["layouts"]:
        q, k, v, g = (t.to(device).chunk(n, dim=1)[me].clone() for t in
                      torch.load(p["qkv"][layout], weights_only=False))

        def run():
            x = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ring_attention(*x, mesh=mesh, axis="tensor", layout=layout)
            return o, torch.autograd.grad((o * g).sum(), x)

        for fn in kernels:
            fn.launches = 0
        COLLECTIVES.clear()
        o, grads = run()
        res[layout] = {"out": o.detach().cpu(),
                       "grads": [t.cpu() for t in grads],
                       "launches": {fn.__name__: fn.launches
                                    for fn in kernels},
                       "collectives": dict(COLLECTIVES), "ms": []}
        for _ in range(p.get("iters", 0)):
            _synchronize(device)
            dist.barrier()
            t0 = time.perf_counter()
            run()
            _synchronize(device)
            res[layout]["ms"].append((time.perf_counter() - t0) * 1e3)
    torch.save(res, out)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def task_run_train(p: dict, device, out: str) -> None:
    """``run_train.main(p["argv"])``, its model from the whole tree saved
    at ``p["params"]`` when given (else ``load_pretrained``); the final
    step to ``out``."""
    from macaw_llm_tpu_torch import run_train
    if p.get("params"):
        run_train.load_pretrained = lambda cfg, args: torch.load(
            p["params"], weights_only=False)
    state = run_train.main(p["argv"])
    torch.save({"step": state.step}, out)


def task_dryrun(p: dict, device, out: str) -> None:
    """One sharded train step of the tiny config; prints each rank's shard
    shapes and the loss."""
    import numpy as np
    from macaw_llm_tpu_torch.config import IGNORE_ID
    from macaw_llm_tpu_torch.models import fusion
    from macaw_llm_tpu_torch.parallel.mesh import create_mesh
    from macaw_llm_tpu_torch.train.trainer import Trainer
    n = dist.get_world_size()
    t = 2 if n % 2 == 0 else 1
    mcfg = tiny_model_config()
    tcfg = TrainConfig(per_device_batch_size=1, grad_accum_steps=1)
    mesh = create_mesh(_mesh_cfg((1, 1, n // t, t)), device)
    tr = Trainer(mcfg, tcfg, total_steps=10, device=device, mesh=mesh)
    state = tr.init_state(fusion.init_params(0, mcfg, device="cpu"))
    rng = np.random.RandomState(7)
    b, s = n, 16
    ids = rng.randint(16, 32000, (1, b, s))
    ids[:, :, 0] = 1
    labels = ids.copy()
    labels[:, :, :4] = IGNORE_ID
    batch = {"input_ids": torch.from_numpy(ids),
             "attention_mask": torch.ones(1, b, s, dtype=torch.long),
             "labels": torch.from_numpy(labels)}
    state, m = tr.train_step(state, tr.shard_batch(
        {k: v.to(tr.device) for k, v in batch.items()}))
    shapes = _shapes(state.trainable)
    print(f"RANK {dist.get_rank()} mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
          f"llm/layers/attn/wq {shapes['llm/layers/attn/wq']} "
          f"llm/embed_tokens {shapes['llm/embed_tokens']} "
          f"loss {float(m['loss']):.6f}", flush=True)
    torch.save({"loss": float(m["loss"]), "shapes": shapes}, out)


def task_tp(p: dict, device, out: str) -> None:
    """Tensor-parallel inference with the world as one tensor group, for
    each case of ``p["cases"]`` (``TP_CASES``): the model ``case["model"]``
    (a ``ModelConfig`` dict; default ``p["model"]``) on the whole tree
    saved at ``case["params"]`` (default ``p["params"]``), of which each
    rank keeps its block. {case name: result, "cuts": the cut modules of
    ``p["model"]``, "collectives": counts in all, "collectives_by_case"}
    to ``out``."""
    from macaw_llm_tpu_torch.config import MeshConfig
    from macaw_llm_tpu_torch.parallel.mesh import create_mesh
    from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES
    from macaw_llm_tpu_torch.parallel.tensor_parallel import TensorParallel
    n = dist.get_world_size()
    mesh = create_mesh(MeshConfig(dcn=1, data=1, fsdp=1, tensor=n), device)
    trees: dict = {}
    res = {"cuts": sorted(TensorParallel.from_mesh(
        mesh, Config.from_dict({"model": p["model"]}).model).cuts),
        "collectives_by_case": {}}
    total: dict = {}
    for case in p["cases"]:
        cfg = Config.from_dict({"model": case.get("model", p["model"])}).model
        path = case.get("params", p.get("params"))
        if path not in trees:
            trees[path] = torch.load(path, weights_only=False)
        COLLECTIVES.clear()
        res[case["name"]] = TP_CASES[case["kind"]](
            case, trees[path], cfg, TensorParallel.from_mesh(mesh, cfg),
            device)
        res["collectives_by_case"][case["name"]] = dict(COLLECTIVES)
        for k, v in COLLECTIVES.items():
            total[k] = total.get(k, 0) + v
    res["collectives"] = total
    torch.save(res, out)


def _tp_tree(whole, cfg, tp, case: dict, device):
    """This rank's block of ``whole`` on ``device``, with int8 LLaMA
    weights as ``case["int8"]`` asks ("whole": quantized, then cut;
    "block": cut, then quantized on the block) and packed for decode
    under ``case["pack"]``."""
    from macaw_llm_tpu_torch.parallel.tensor_parallel import tp_params
    from macaw_llm_tpu_torch.utils import quantize as qz
    tree = dict(whole)
    if case.get("int8") == "whole":
        tree["llm"] = qz.quantize_llama(tree["llm"])
    tree = to_device(tp_params(tree, tp), device)
    if case.get("int8") == "block":
        tree["llm"] = qz.quantize_llama(tree["llm"], tp)
    if case.get("pack"):
        tree["llm"] = qz.pack_llama_for_decode(tree["llm"])
    return tree


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _load(path: str, device):
    x = torch.load(path, weights_only=False)
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in x.items()}


def _tp_forward(case, whole, cfg, tp, device):
    """LLaMA logits of ``case["ids"]`` (a saved {"ids"})."""
    from macaw_llm_tpu_torch.models import llama
    tree = _tp_tree(whole, cfg, tp, case, device)
    with torch.inference_mode():
        return llama.forward(tree["llm"], cfg.llm, tp=tp,
                             **_load(case["inputs"], device)).cpu()


def _tp_generate(case, whole, cfg, tp, device):
    """Tokens of ``generate`` (or ``beam_search``, ``generate_speculative``
    by ``case["fn"]``) on the saved inputs, keyword arguments from
    ``case["kw"]``; a ``case["seed"]`` samples from a generator seeded
    alike on every rank."""
    from macaw_llm_tpu_torch import generate as G
    tree = _tp_tree(whole, cfg, tp, case, device)
    kw = dict(case.get("kw", {}), **_load(case["inputs"], device))
    if "seed" in case:
        kw["generator"] = torch.Generator(device=device).manual_seed(
            case["seed"])
    fn = getattr(G, case.get("fn", "generate"))
    out = fn(tree["llm"], cfg.llm, device=device, tp=tp, **kw)
    return out.tokens.cpu()


def _tp_prefill(case, whole, cfg, tp, device):
    """Logits of the fused prefill (towers, alignment over a cache of
    ``case["align_cache"]``: "bf16", "int8" or "off", splice, LLaMA) on
    the saved batch: every position's, and ``prefill.prefill``'s last
    ones (``case["last"]``: W8A8, flash kernels)."""
    from macaw_llm_tpu_torch.models import fusion, llama
    from macaw_llm_tpu_torch.serve import _init_align_cache
    tree = _tp_tree(whole, cfg, tp, case, device)
    batch = _load(case["inputs"], device)
    with torch.inference_mode():
        tree, cache = _init_align_cache(tree, cfg, case["align_cache"], tp)
        fused = fusion.prepare_inputs(tree, cfg, align_cache=cache, tp=tp,
                                      **batch)
        logits = llama.forward(tree["llm"], cfg.llm,
                               inputs_embeds=fused.inputs_embeds,
                               attention_mask=fused.attention_mask, tp=tp)
    return logits.cpu()


def _tp_prefill_entry(case, whole, cfg, tp, device):
    """``prefill.prefill`` of the saved batch (W8A8 over the gate, the
    attention kernels' route): the last positions' logits."""
    from macaw_llm_tpu_torch.prefill import prefill
    from macaw_llm_tpu_torch.serve import _init_align_cache
    tree = _tp_tree(whole, cfg, tp, case, device)
    with torch.inference_mode():
        tree, cache = _init_align_cache(tree, cfg, case["align_cache"], tp)
    return prefill(tree, cfg, _load(case["inputs"], device), cache,
                   device=device, tp=tp).cpu()


def _tp_engine(case, whole, cfg, tp, device):
    """``serve.ContinuousEngine`` (or ``InferenceEngine`` under
    ``case["static"]``) over the saved requests, all queued before it
    starts, the generators seeded with ``case["seed"]``: {"results": each
    request's result on the leader (None on a follower, whose stand-ins
    mirror them), "stats", "seconds" from the start to the loop's end, and
    the continuous engine's final slot state "toks" and "lengths"}. Faults
    on the leader: ``case["stream_fail"]``, requests whose stream callback
    raises; ``case["fail_plan_at"]``, the call of the continuous engine's
    ``_tp_plan`` that raises. On a follower: ``case["follower_fail"]``,
    the prompts whose admission raises there (before any collective);
    ``case["follower_fail_prefill_at"]``, the call of ``_prefill_body``
    (the static engine's ``_run_batch``) that raises there, inside a
    prefill's collectives. ``case["leader_lag_s"]``: the leader waits that
    long after each all-reduce of failure flags (``_failed_anywhere``),
    so that its watcher sees a follower's teardown before its next
    check."""
    from macaw_llm_tpu_torch import serve
    serve._seed_from_clock = lambda: case["seed"]
    flags = serve._failed_anywhere
    if tp.leader and case.get("leader_lag_s"):
        serve._failed_anywhere = _lagging(flags, case["leader_lag_s"])
    try:
        return _run_engine(serve, case, whole, cfg, tp, device)
    finally:
        serve._failed_anywhere = flags


def _lagging(fn, seconds: float):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        time.sleep(seconds)
        return out
    return wrapped


def _run_engine(serve, case, whole, cfg, tp, device):
    tree = _tp_tree(whole, cfg, tp, case, device)
    reqs = [serve.Request(**r) for r in
            torch.load(case["requests"], weights_only=False)]
    tok = _WordTokenizer()
    if case.get("static"):
        engine = serve.InferenceEngine(tree, cfg, tok, device=device, tp=tp,
                                       **case["kw"])
    else:
        engine = serve.ContinuousEngine(tree, cfg, tok, device=device,
                                        tp=tp, **case["kw"])
    if tp.leader:
        for i in case.get("stream_fail", ()):
            reqs[i].stream_cb = _closed_stream
        if "fail_plan_at" in case:
            engine._tp_plan = _failing(engine._tp_plan,
                                       case["fail_plan_at"],
                                       "the leader's plan failed")
        for r in reqs:
            engine.queue.put(r)
    else:
        if case.get("follower_fail"):
            engine._admission = _failing_on(engine._admission,
                                            set(case["follower_fail"]))
        if "follower_fail_prefill_at" in case:
            name = "_run_batch" if case.get("static") else "_prefill_body"
            setattr(engine, name, _failing(
                getattr(engine, name), case["follower_fail_prefill_at"],
                "the follower's prefill failed"))
    t0 = time.monotonic()
    engine.start()
    if tp.leader:
        for r in reqs:
            if not r._done.wait(600):
                raise TimeoutError("a request did not finish")
        engine.stop()
    engine.join()
    out = {"results": [r._result for r in reqs] if tp.leader else None,
           "stats": dict(engine.stats), "seconds": time.monotonic() - t0}
    if not case.get("static"):
        out.update(toks=engine.toks.cpu(), lengths=engine.lengths.cpu())
    return out


def _closed_stream(tok):
    raise BrokenPipeError("the client went away")


def _failing(fn, at: int, message: str):
    """``fn``, whose ``at``-th call raises."""
    calls = [0]

    def wrapped(*args, **kw):
        calls[0] += 1
        if calls[0] == at:
            raise RuntimeError(message)
        return fn(*args, **kw)
    return wrapped


def _failing_on(admission, prompts: set):
    """An engine's ``_admission`` that raises for the requests of
    ``prompts``."""
    def wrapped(req):
        if req.prompt in prompts:
            raise RuntimeError("this rank's admission failed")
        return admission(req)
    return wrapped


class _WordTokenizer:
    """Ids of whitespace words by a fixed hash, decoded as their numbers
    (the same in every process)."""

    def encode(self, text):
        import zlib
        return [1] + [16 + zlib.crc32(w.encode()) % 31000
                      for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _tp_http(case, whole, cfg, tp, device):
    """``serve.serve`` under the group: the leader binds the HTTP server
    and answers one request; a follower's stand-in follows until the
    leader stops."""
    import json as _json
    import threading
    import urllib.request
    from macaw_llm_tpu_torch import serve
    tree = _tp_tree(whole, cfg, tp, case, device)
    server = serve.serve(tree, cfg, _WordTokenizer(), host="127.0.0.1",
                         port=0, device=device, tp=tp, **case["kw"])
    if not tp.leader:
        server.serve_forever()
        return {"follower": type(server).__name__}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=_json.dumps(case["request"]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = _json.loads(r.read())
    finally:
        server.shutdown()
        server.engine.stop()
        server.server_close()
    thread.join(timeout=30)
    return out


def _tp_run_inference(case, whole, cfg, tp, device):
    """``run_inference.main(case["argv"])`` in every process."""
    from macaw_llm_tpu_torch import run_inference
    return run_inference.main(case["argv"])


TP_CASES = {"forward": _tp_forward, "generate": _tp_generate,
            "prefill": _tp_prefill, "prefill_entry": _tp_prefill_entry,
            "engine": _tp_engine, "http": _tp_http,
            "run_inference": _tp_run_inference}


TASKS = {"train": task_train, "ring": task_ring, "run_train": task_run_train,
         "tp": task_tp, "dryrun": task_dryrun}


def worker(rank: int, world: int, store: str, device: str, task: str,
           payload: dict, out_dir: str) -> None:
    """One process of a job: join the group (a FileStore at ``store``),
    run ``TASKS[task]``, leave the group. SIGUSR1 writes every thread's
    stack to its output (``spawn`` sends it to a job that outlives its
    time)."""
    import faulthandler

    from macaw_llm_tpu_torch.parallel.mesh import multihost_initialize
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.set_num_threads(1)
    os.environ.update(PROCESS_ID=str(rank), NUM_PROCESSES=str(world),
                      LOCAL_RANK=str(rank))
    multihost_initialize(device, store=dist.FileStore(store, world))
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        TASKS[task](payload, dev, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JOB_TIMEOUT_S = 300.0  # a spawned job's processes are killed after this


def run_ranks(argvs: list, env: dict, timeout: float, cwd=None) -> tuple:
    """One process a rank, each running its entry of ``argvs``, waited for
    ``timeout`` seconds in all; past that, a rank still running is asked for
    its threads' stacks (SIGUSR1: the workers dump them through
    faulthandler) and then killed. Returns the exit codes and each rank's
    output."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in argvs]
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for argv, log in zip(argvs, logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(3)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    return [p.returncode for p in procs], texts


def spawn(world: int, task: str, payload: dict, out_dir: str,
          device: str = "cpu") -> list:
    """Run ``task`` in ``world`` fresh processes (``python -m`` this
    module); returns each rank's results. Raises with the processes'
    output when one fails or the job outlives ``JOB_TIMEOUT_S`` (every
    process is killed then, once it has written its threads' stacks)."""
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    job = os.path.join(out_dir, "job.json")
    with open(job, "w") as f:
        json.dump({"task": task, "payload": payload, "device": device,
                   "store": store, "out": out_dir, "world": world}, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                     OMP_NUM_THREADS="1",
                     PYTHONPATH=os.pathsep.join(
                         [root] + [x for x in os.environ.get(
                             "PYTHONPATH", "").split(os.pathsep) if x]))
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        child_env.pop(k, None)
    codes, texts = run_ranks(
        [[sys.executable, "-m", "macaw_llm_tpu_torch.parallel.dryrun",
          "--job", job, "--rank", str(r)] for r in range(world)],
        child_env, JOB_TIMEOUT_S)
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{task} over {world} processes failed (exit "
                           f"codes {codes}):\n"
                           + "\n".join(f"--- rank {r} ---\n{t[-4000:]}"
                                       for r, t in enumerate(texts)))
    results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    for r, t in enumerate(texts):
        results[r] = dict(results[r], log=t)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.job:  # a worker of spawn()
        with open(args.job) as f:
            job = json.load(f)
        worker(args.rank, job["world"], job["store"], job["device"],
               job["task"], job["payload"], job["out"])
        return 0
    with tempfile.TemporaryDirectory() as d:
        res = spawn(args.procs, "dryrun", {}, d, device=args.device)
    for r in res:
        sys.stdout.write(r["log"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
