"""Training loop of the fused model (counterpart of
``macaw_llm_tpu/train/trainer.py``), on one device or data-parallel over a
mesh with ZeRO-3 sharding.

* optimizer: ``clip_by_global_norm`` then AdamW with a warmup + cosine
  (or linear, or constant) schedule, with optax's semantics: the clip
  scales by max/norm only when norm >= max, the schedule starts from 0 (the
  first step's learning rate is 0), ``mu_dtype`` applies to Adam's first
  moment only, weight decay is added to the Adam update before the
  learning rate;
* gradient accumulation over a leading [A, ...] batch axis, the mean of
  the micro-batch gradients;
* ``grad_dtype="bfloat16"`` differentiates with respect to bf16 copies of
  the trainable parameters; the masters keep their dtype;
* frozen parameters form their own tree and take no gradient; under LoRA
  the int8 base, the towers and (with ``align_cache``) the alignment K/V
  projections are frozen.

* ``offload_optimizer``: Adam's moments live in pinned host memory
  between steps; the update copies them in leaf by leaf on a side stream
  (the next leaf's while the current one updates) and back, non-blocking,
  into the same pinned buffers: the same AdamW on the device, the same
  bits.

Over a mesh (``parallel.mesh.create_mesh``; one process a device) every
rank holds the partition rules' shards of the trainable and frozen
parameters and of Adam's moments. The batch is cut over (dcn, data, fsdp)
and, with ring attention, the fused sequence over the ring axis. The
forward gathers the unstacked leaves once and the stacked [L, ...] leaves
one layer at a time inside the layer's (remat) function
(``parallel.sharding.GatherLayer``); the backward reduce-scatters their
gradients into the shards' buffers, and the mesh axes that cut neither the
leaf nor the work (replicas) are summed after it. The loss is the global
mean over valid targets: each rank divides its NLL sum by the count summed
over the batch (and ring) axes. The gradient norm sums each leaf's squares
once over the axes that cut it. Dropout masks are drawn for the whole
batch (and every head) on every rank, which keeps its rows (and heads):
the masks of one device whatever the mesh.

A ``tensor`` axis of 2 or more without ring attention computes
Megatron-style (``parallel.tensor_parallel``, ``self.tp``): the modules
whose heads, FFN width or padded vocab the axis divides are cut, and a
rank gathers the leaves of a cut module over fsdp only, to its tensor
block (``sharding.LeafPlan``), or, where the partition rules' tensor cut
is not its compute block (LoRA's B, the alignment's in- and
out-projections, an int8 column scale), gathers the whole leaf and takes
its block. Every tensor rank backpropagates the whole loss; a leaf that
every rank computes whole (norms, LoRA's A, ``to_hidden``, ``conv``, the
modules the axis does not divide) carries the same gradient on every
tensor rank and is not summed over it, while the blocks of a leaf whose
storage is not cut like its compute are. ``shard_sequence`` adds
sequence parallelism to the LLaMA stack, whose norms (and LoRA's A) then
take partial gradients, summed over the axis. Towers that train, or
whose frozen layers are packed (``pack_frozen_towers``), compute whole.
Under ring attention the tensor axis keeps its other meaning: the ring's
axis, or storage only (the reference's ring keeps whole heads on every
device), and its ranks, computing the same rows, each carry 1/t of the
loss.

The state is updated in place (the reference's is a new pytree per step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from macaw_llm_tpu_torch import resolve_device
from macaw_llm_tpu_torch.config import (IGNORE_ID, ModelConfig,
                                        TrainConfig)
from macaw_llm_tpu_torch.models import fusion
from macaw_llm_tpu_torch.train.state import (TrainState, merge_params,
                                             split_params)
from macaw_llm_tpu_torch.utils.profiling import SPANS


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def make_lr_schedule(cfg: TrainConfig,
                     total_steps: int) -> Callable[[int], float]:
    """Learning rate of optimizer step ``count`` (0-based): a linear warmup
    from 0 over ``warmup_ratio`` of the steps (at least 1), then cosine to
    0, linear to 0, or constant."""
    warmup = max(1, int(cfg.warmup_ratio * total_steps))
    total_steps = max(total_steps, warmup + 1)
    peak = cfg.learning_rate
    if cfg.lr_schedule not in ("cosine", "linear", "constant"):
        raise ValueError(cfg.lr_schedule)

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = count - warmup
        if cfg.lr_schedule == "cosine":
            decay = total_steps - warmup
            t = min(t, decay)
            return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        if cfg.lr_schedule == "linear":
            t = min(t, total_steps - warmup)
            return peak * (1.0 - t / (total_steps - warmup))
        return peak

    return schedule


def _moments_on(params: list, mus: list, nus: list):
    """(m, v) pairs on the parameters' device: the moments themselves, or,
    for moments offloaded to the host, device copies fetched on a side
    stream one leaf ahead; after the caller has updated a pair in place it
    is copied back (non-blocking) into the host buffers, and the stream is
    synchronized at the end, so that the host holds every moment when the
    update returns."""
    if not params or mus[0].device == params[0].device:
        yield from zip(mus, nus)
        return
    dev = params[0].device
    cur, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(cur)

    def fetch(i):
        with torch.cuda.stream(side):
            pair = (mus[i].to(dev, non_blocking=True),
                    nus[i].to(dev, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(side)
        return pair, ready

    nxt = fetch(0)
    for i in range(len(mus)):
        (m, v), ready = nxt
        if i + 1 < len(mus):
            nxt = fetch(i + 1)
        cur.wait_event(ready)
        m.record_stream(cur)
        v.record_stream(cur)
        yield m, v
        mus[i].copy_(m, non_blocking=True)
        nus[i].copy_(v, non_blocking=True)
    cur.synchronize()


def _offload(tree):
    """Moments to host memory, pinned (CPU moments stay as they are)."""
    return _tree_map(lambda t: t if t.device.type == "cpu"
                     else t.cpu().pin_memory(), tree)


def _weak(x: float, t: torch.Tensor) -> float:
    """``x`` rounded to ``t``'s dtype: JAX casts a Python scalar to the
    dtype of the array it meets, so optax's bf16 moments are updated with
    bf16 constants (1 - b1 = 0.1 becomes 0.10009765625); PyTorch would keep
    the scalar in fp32."""
    return float(torch.tensor(x, dtype=t.dtype))


@dataclasses.dataclass
class AdamWState:
    count: int   # updates applied
    mu: dict     # first moment, in mu_dtype
    nu: dict     # second moment, in each parameter's dtype


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    b1, b2, eps, weight_decay, mu_dtype))`` applied in place."""

    def __init__(self, cfg: TrainConfig, total_steps: int):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, total_steps)
        self.mu_dtype = getattr(torch, cfg.mu_dtype)

    def init(self, params: dict) -> AdamWState:
        return AdamWState(
            count=0,
            mu=_tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                         params),
            nu=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: AdamWState,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step: clip, Adam moments, bias correction, decoupled weight
        decay, the scheduled learning rate; ``params`` and ``state`` change
        in place (moments in host memory are streamed through the device,
        ``_moments_on``). Returns the global norm of ``grads`` (before the
        clip), or uses ``g_norm`` when given (a sharded state's)."""
        c = self.cfg
        ps, gs = _leaves(params), _leaves(grads)
        mus, nus = _leaves(state.mu), _leaves(state.nu)
        # in fp32 (optax sums bf16 gradients in bf16); the clip divides
        # by it rounded to the gradients' dtype, as optax does
        if g_norm is None:
            g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
        keep = g_norm < c.max_grad_norm
        count = state.count + 1
        lr = self.schedule(state.count)
        bc1, bc2 = 1.0 - c.adam_b1 ** count, 1.0 - c.adam_b2 ** count
        # the stream of moments first: zip then runs it to its end (the
        # last copy back and the synchronize)
        for (m, v), p, g in zip(_moments_on(ps, mus, nus), ps, gs):
            g = torch.where(keep, g, g / g_norm.to(g.dtype)
                            * _weak(c.max_grad_norm, g))
            m_new = _weak(1.0 - c.adam_b1, g) * g + _weak(c.adam_b1, m) * m
            v.copy_(_weak(1.0 - c.adam_b2, g) * (g * g) + c.adam_b2 * v)
            u = (m_new / _weak(bc1, m_new)) / (torch.sqrt(v / bc2)
                                               + c.adam_eps)
            if c.weight_decay:
                u = u + c.weight_decay * p
            p.copy_((p + (-lr) * u).to(p.dtype))
            m.copy_(m_new.to(self.mu_dtype))
        state.count = count
        return g_norm


def make_optimizer(cfg: TrainConfig, total_steps: int) -> AdamW:
    return AdamW(cfg, total_steps)


def create_train_state(params: dict, tcfg: TrainConfig, total_steps: int,
                       rng: Optional[torch.Generator] = None) -> TrainState:
    """A state over ``params`` split by ``freeze_encoders`` (no LoRA)."""
    trainable, frozen = split_params(params, tcfg.freeze_encoders)
    return TrainState(
        step=0, trainable=trainable, frozen=frozen,
        opt_state=make_optimizer(tcfg, total_steps).init(trainable),
        rng=rng if rng is not None else
        torch.Generator().manual_seed(tcfg.seed))


def _loss(trainable: dict, frozen: dict, mcfg: ModelConfig, batch: dict,
          dropout_rng, lora_scale: float, align_cache) -> torch.Tensor:
    loss, _ = fusion.forward(
        merge_params(trainable, frozen), mcfg,
        input_ids=batch["input_ids"], images=batch.get("images"),
        audios=batch.get("audios"), videos=batch.get("videos"),
        attention_mask=batch.get("attention_mask"), labels=batch["labels"],
        dropout_rng=dropout_rng, lora_scale=lora_scale,
        align_cache=align_cache)
    return loss


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               mcfg: ModelConfig, tx: AdamW, lora_scale: float = 1.0,
               grad_dtype=torch.float32, align_cache=None):
    """One optimizer step over a batch with a leading grad-accumulation
    axis [A, B, ...] (A = 1 for none). Returns (state, metrics) with the
    loss (mean over micro-batches), the gradients' global norm and the
    step's learning rate; the state is updated in place. Spans
    ``train.step`` > ``train.forward``, ``train.backward``,
    ``train.optimizer``, with the device's time of each read at the next
    step (the caller's read of the loss has synchronized by then)."""
    first = next(iter(batch.values()))
    accum, dev = first.shape[0], first.device
    gd = grad_dtype
    SPANS.settle()
    with SPANS.span("train.step", device=dev):
        diff = _tree_map(lambda p: (p if gd == torch.float32 else p.to(gd))
                         .detach().requires_grad_(), state.trainable)
        loss_sum = 0.0
        for a in range(accum):
            mb = {k: v[a] for k, v in batch.items()}
            with SPANS.span("train.forward", device=dev):
                loss = _loss(diff, state.frozen, mcfg, mb, state.rng,
                             lora_scale, align_cache)
            with SPANS.span("train.backward", device=dev):
                loss.backward()
            loss_sum = loss_sum + loss.detach()

        def grad(p):
            if p.grad is None:  # a leaf the loss does not reach
                return torch.zeros_like(p)
            return p.grad if accum == 1 else (p.grad / accum).to(gd)

        with SPANS.span("train.optimizer", device=dev):
            grads = _tree_map(grad, diff)
            del diff
            lr = tx.schedule(state.step)
            g_norm = tx.update(state.trainable, grads, state.opt_state)
        state.step += 1
    return state, {"loss": loss_sum / accum, "grad_norm": g_norm, "lr": lr}


def _cast_frozen(tree, dtype):
    """Cast frozen floating leaves to ``dtype``, except the fp32 scales of
    int8 {"q", "s"} records."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return tree
        return {k: _cast_frozen(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class Trainer:
    """Binds a model and training configuration to train and eval steps on
    one device (the GPU unless ``device="cpu"`` is asked for), or, given a
    ``mesh`` (``parallel.mesh.create_mesh``), on this process's device of
    the mesh with the state sharded (see the module docstring)."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig,
                 total_steps: int, device="cuda", mesh=None):
        self.mcfg, self.tcfg = mcfg, tcfg
        self.mesh = mesh
        if mesh is not None:
            device = ("cpu" if mesh.device_type == "cpu" else
                      torch.device("cuda", torch.cuda.current_device()))
        self.device = resolve_device(device)
        self.total_steps = total_steps
        self.tx = make_optimizer(tcfg, total_steps)
        self.lr_schedule = self.tx.schedule
        self.lora_scale = tcfg.lora_alpha / max(tcfg.lora_rank, 1)
        self.align_cache = None
        self.specs = None  # {"trainable": specs, "frozen": specs} on a mesh
        self.plans = None  # the same trees' LeafPlans
        self.tp = None     # the tensor group that computes Megatron-style
        if mesh is not None:
            self._mesh_axes(mesh)

    # -------------------- the mesh's axes --------------------

    def _mesh_axes(self, mesh) -> None:
        from macaw_llm_tpu_torch.parallel.mesh import TENSOR_AXIS, axis_size
        from macaw_llm_tpu_torch.parallel.tensor_parallel import (
            TensorParallel, without)
        ring = self.mcfg.ring_attention
        # axes that cut the batch rows, and the ranks that hold them
        self.batch_axes = _batch_axes(self.mcfg)
        self.batch_index, self.batch_count = batch_layout(self.mcfg, mesh)
        # axes whose ranks compute different parts of the loss
        self.loss_axes = self.batch_axes + (
            (self.mcfg.ring_axis,) if ring else ())
        if not ring and axis_size(mesh, (TENSOR_AXIS,)) > 1:
            self.tp = TensorParallel.from_mesh(mesh, self.mcfg)
            if not self.tcfg.freeze_encoders or \
                    self.tcfg.pack_frozen_towers:
                self.tp = without(self.tp, "clip_attn", "clip_mlp",
                                  "whisper_attn", "whisper_mlp")
        # the others hold replicas of the same work (the tensor ranks of a
        # Megatron group each compute the whole loss)
        self.replicas = axis_size(mesh, tuple(
            a for a in mesh.mesh_dim_names if a not in self.loss_axes
            and not (self.tp is not None and a == TENSOR_AXIS)))

    def _plan(self, path: str, x, spec):
        """The ``LeafPlan`` of a leaf (see the module docstring)."""
        from macaw_llm_tpu_torch.parallel.mesh import TENSOR_AXIS as T
        from macaw_llm_tpu_torch.parallel.sharding import LeafPlan
        from macaw_llm_tpu_torch.parallel.tensor_parallel import (cut_dim,
                                                                  leaf_cut)
        if self.tp is None:
            return LeafPlan(spec)
        how = leaf_cut(path, self.tp)
        if how is None:  # every rank computes the whole leaf
            return LeafPlan(spec, same=(T,))
        if T in spec and how != "qkv" and \
                spec.index(T) == cut_dim(how, x.dim()):
            return LeafPlan(spec, axes=tuple(a for a in spec
                                             if a is not None and a != T))
        return LeafPlan(spec, cut=(how, self.tp))

    def _sums_tensor(self, path: str) -> bool:
        """Whether a leaf stored whole over the tensor axis has its
        gradient summed over it: always without Megatron compute (its
        ranks carry 1/t of the loss each), else for the blocks of a cut
        leaf and, under sequence parallelism, for the norms and LoRA's
        A."""
        from macaw_llm_tpu_torch.parallel.tensor_parallel import (
            leaf_cut, partial_under_sequence)
        if self.tp is None:
            return True
        return leaf_cut(path, self.tp) is not None or (
            self.mcfg.shard_sequence and partial_under_sequence(path))

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> dict:
        """This rank's rows of a whole batch [A, B, ...]: block
        ``batch_index`` of the ``batch_count`` blocks of B (the batch
        layout of the reference's ``P(None, (dcn, data, fsdp))``)."""
        def rows(x):
            b = x.shape[1] // self.batch_count
            return x[:, self.batch_index * b:(self.batch_index + 1) * b]
        return {k: rows(v) for k, v in batch.items()}

    def _reduce_count(self, axes):
        from macaw_llm_tpu_torch.parallel.sharding import all_reduce
        return lambda c: all_reduce(c.clone(), self.mesh, axes)

    # -------------------- state --------------------

    @torch.no_grad()
    def init_state(self, params: dict,
                   rng: Optional[torch.Generator] = None) -> TrainState:
        """The state over ``params`` (moved to the trainer's device): the
        int8 base (``quantize_base``), the trainable/frozen split, frozen
        leaves cast to ``frozen_dtype``, packed frozen towers, zero AdamW
        moments (in host memory under ``offload_optimizer``) and, under
        LoRA, the alignment K/V cache computed once. Over a mesh every rank
        passes the whole tree and keeps its shards."""
        with SPANS.span("setup.init_state", device=self.device):
            return self._init_state(params, rng)

    def _init_state(self, params: dict,
                    rng: Optional[torch.Generator]) -> TrainState:
        t = self.tcfg
        params = _tree_map(lambda x: x.to(self.device), params)
        if t.quantize_base:
            if t.lora_rank <= 0:
                raise ValueError("quantize_base requires LoRA (the base "
                                 "must be frozen)")
            if not isinstance(params["llm"]["layers"]["attn"]["wq"], dict):
                from macaw_llm_tpu_torch.utils.quantize import quantize_llama
                params = dict(params, llm=quantize_llama(params["llm"]))
        trainable, frozen = split_params(params, t.freeze_encoders,
                                         lora=t.lora_rank > 0)
        # AdamW writes the trainable leaves in place, and ``.to`` on their
        # own device returns the caller's tensors: copy them so that the
        # caller's tree never changes (frozen leaves are never written)
        trainable = _tree_map(torch.clone, trainable)
        if frozen and t.frozen_dtype != "param":
            frozen = _cast_frozen(frozen, getattr(torch, t.frozen_dtype))
        if t.pack_frozen_towers and t.freeze_encoders:
            from macaw_llm_tpu_torch.ops.attention import pack_mha
            frozen = dict(frozen)
            for tower in ("image_encoder", "video_encoder", "audio_encoder"):
                if tower in frozen:
                    layers = dict(frozen[tower]["layers"],
                                  attn=pack_mha(frozen[tower]["layers"]
                                                ["attn"]))
                    frozen[tower] = dict(frozen[tower], layers=layers)
        if t.lora_rank > 0 and t.align_cache != "off":
            # precomputed once and constant: the align in-proj K/V rows
            # and bias_k/bias_v take zero gradients and never move, so the
            # cache never goes stale; the Q rows and out-proj still train
            from macaw_llm_tpu_torch.parallel.tensor_parallel import \
                tp_align_cache
            self.align_cache = tp_align_cache(fusion.precompute_align_cache(
                merge_params(trainable, frozen), self.mcfg,
                quantize=t.align_cache == "int8"), self.tp)
        if self.mesh is not None:
            from macaw_llm_tpu_torch.parallel.sharding import (
                at_path, shard_params, tree_map)
            trainable, t_specs = shard_params(trainable, self.mesh)
            frozen, f_specs = shard_params(frozen, self.mesh)
            self.specs = {"trainable": t_specs, "frozen": f_specs}
            self.plans = {kind: tree_map(
                lambda p, x, specs=specs: self._plan(p, x, at_path(specs, p)),
                tree) for kind, tree, specs in (
                    ("trainable", trainable, t_specs),
                    ("frozen", frozen, f_specs))}
        opt_state = self.tx.init(trainable)
        if t.offload_optimizer:
            opt_state.mu = _offload(opt_state.mu)
            opt_state.nu = _offload(opt_state.nu)
        return TrainState(
            step=0, trainable=trainable, frozen=frozen, opt_state=opt_state,
            rng=rng if rng is not None else
            torch.Generator().manual_seed(t.seed))

    # -------------------- steps --------------------

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step over a [A, B, ...] batch; see ``train_step``.
        Over a mesh, ``batch`` is this rank's rows (``shard_batch``), with
        the whole fused sequence under ring attention."""
        if self.mesh is None:
            return train_step(state, batch, self.mcfg, self.tx,
                              self.lora_scale,
                              getattr(torch, self.tcfg.grad_dtype),
                              self.align_cache)
        return self._sharded_step(state, batch)

    def _entries(self, trainable: dict, frozen: dict, grads=None) -> list:
        """(path, shard, plan, gradient buffer or None) of every leaf."""
        from macaw_llm_tpu_torch.parallel.sharding import at_path, tree_paths
        out = [(p, x, at_path(self.plans["trainable"], p),
                None if grads is None else at_path(grads, p))
               for p, x in tree_paths(trainable)]
        out += [(p, x, at_path(self.plans["frozen"], p), None)
                for p, x in tree_paths(frozen)]
        return out

    def _sharded_step(self, state: TrainState, batch: dict):
        from macaw_llm_tpu_torch.ops.attention import batch_rows
        from macaw_llm_tpu_torch.parallel.sharding import (
            all_reduce, at_path, gathered_view, tree_paths)
        mesh = self.mesh
        gd = getattr(torch, self.tcfg.grad_dtype)
        accum = next(iter(batch.values())).shape[0]
        b = next(iter(batch.values())).shape[1]
        with torch.no_grad():
            diff = _tree_map(lambda p: p if gd == torch.float32 else
                             p.to(gd), state.trainable)
            grads = _tree_map(torch.zeros_like, diff)
        entries = self._entries(diff, state.frozen, grads)
        anchor = torch.zeros((), device=self.device, requires_grad=True)
        ring = mesh if self.mcfg.ring_attention else None
        count = self._reduce_count(self.loss_axes)
        loss_sum = torch.zeros((), device=self.device)
        with batch_rows(self.batch_index * b, self.batch_count * b):
            for a in range(accum):
                mb = {k: v[a] for k, v in batch.items()}
                loss, _ = fusion.forward(
                    gathered_view(entries, mesh, anchor), self.mcfg,
                    input_ids=mb["input_ids"], images=mb.get("images"),
                    audios=mb.get("audios"), videos=mb.get("videos"),
                    attention_mask=mb.get("attention_mask"),
                    labels=mb["labels"], dropout_rng=state.rng,
                    lora_scale=self.lora_scale,
                    align_cache=self.align_cache, ring_mesh=ring,
                    reduce_count=count, tp=self.tp)
                (loss / self.replicas).backward()
                loss_sum = loss_sum + loss.detach()
        del diff, entries
        loss_sum = all_reduce(loss_sum, mesh, self.loss_axes)
        # the axes that cut neither a leaf nor the work: sum their ranks'
        # shards (the tensor axis as ``_sums_tensor`` says); then each
        # leaf's squares once over the axes that cut it
        from macaw_llm_tpu_torch.parallel.mesh import TENSOR_AXIS
        squares: dict = {}
        with torch.no_grad():
            for path, g in tree_paths(grads):
                spec = _spec_axes(at_path(self.specs["trainable"], path))
                sum_t = self._sums_tensor(path)
                all_reduce(g, mesh, tuple(
                    a for a in mesh.mesh_dim_names if a not in spec
                    and (sum_t or a != TENSOR_AXIS)))
                if accum > 1:
                    g.copy_((g / accum).to(g.dtype))
                squares[spec] = squares.get(spec, 0.0) + \
                    (g.float() ** 2).sum()
            total = torch.zeros((), device=self.device)
            for spec in sorted(squares):
                total = total + all_reduce(
                    torch.as_tensor(squares[spec], device=self.device)
                    .clone(), mesh, spec)
            g_norm = torch.sqrt(total)
        lr = self.tx.schedule(state.step)
        self.tx.update(state.trainable, grads, state.opt_state, g_norm)
        state.step += 1
        return state, {"loss": loss_sum / accum, "grad_norm": g_norm,
                       "lr": lr}

    def eval_step_fn(self):
        """The forward-only eval step: (loss, correct, count) of the
        shifted argmax token accuracy on a [B, ...] batch, full logits
        (``loss_chunk`` off), no dropout, no ring. Over a mesh the batch is
        this rank's rows and the three numbers are the whole batch's."""
        mcfg = dataclasses.replace(self.mcfg, loss_chunk=0)

        @torch.no_grad()
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            if self.mesh is None:
                params, count = merge_params(state.trainable,
                                             state.frozen), None
            else:
                from macaw_llm_tpu_torch.parallel.sharding import \
                    gathered_view
                params = gathered_view(
                    self._entries(state.trainable, state.frozen), self.mesh,
                    None)
                count = self._reduce_count(self.batch_axes)
            loss, logits = fusion.forward(
                params, mcfg,
                input_ids=batch["input_ids"], images=batch.get("images"),
                audios=batch.get("audios"), videos=batch.get("videos"),
                attention_mask=batch.get("attention_mask"),
                labels=batch["labels"], lora_scale=self.lora_scale,
                reduce_count=count, tp=self.tp)
            lab = batch["labels"]
            prefix = logits.shape[1] - lab.shape[1]
            ext = torch.cat([lab.new_full((lab.shape[0], prefix), IGNORE_ID),
                             lab], dim=1)
            refs = ext[:, 1:]
            valid = refs != IGNORE_ID
            correct = ((logits[:, :-1].argmax(-1) == refs) & valid).sum()
            valid = valid.sum()
            if count is not None:
                loss, correct, valid = (count(x) for x in (loss, correct,
                                                           valid))
            return loss, correct, valid

        return step

    def evaluate(self, state: TrainState, batches) -> Dict[str, float]:
        """Mean eval loss and token-weighted accuracy over [B, ...]
        batches."""
        step = self.eval_step_fn()
        losses, correct, total = [], 0, 0
        for batch in batches:
            loss, c, n = step(state, batch)
            losses.append(float(loss))
            correct += int(c)
            total += int(n)
        return {"eval_loss": sum(losses) / max(len(losses), 1),
                "eval_token_accuracy": correct / max(total, 1)}

    # -------------------- whole state (checkpoints) --------------------

    def whole_state(self, state: TrainState,
                    rank0_only: bool = False) -> TrainState:
        """A sharded state's leaves as whole host tensors (copies), gathered
        leaf by leaf (collective: every rank calls it). ``rank0_only``: the
        other ranks drop each leaf once gathered (their leaves are None),
        so that one host copy of the state exists, not one a rank."""
        import torch.distributed as dist
        from macaw_llm_tpu_torch.parallel.sharding import (at_path, gather,
                                                            tree_map)
        keep = not rank0_only or dist.get_rank() == 0

        def whole(specs):  # a copy: an uncut leaf gathers to itself
            def one(p, x):
                t = gather(x.to(self.device), at_path(specs, p), self.mesh)
                return t.to("cpu", copy=True) if keep else None
            return one

        ts, fs = self.specs["trainable"], self.specs["frozen"]
        return TrainState(
            step=state.step,
            trainable=tree_map(whole(ts), state.trainable),
            frozen=tree_map(whole(fs), state.frozen),
            opt_state=AdamWState(count=state.opt_state.count,
                                 mu=tree_map(whole(ts), state.opt_state.mu),
                                 nu=tree_map(whole(ts), state.opt_state.nu)),
            rng=state.rng)

    def shard_leaf(self, kind: str, path: str, x: torch.Tensor,
                   like: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf ``x`` of the ``kind`` tree
        ("trainable", "frozen"; the moments follow "trainable"), placed as
        ``like`` (its device, pinned host memory included)."""
        from macaw_llm_tpu_torch.parallel.sharding import (at_path,
                                                            local_shard)
        x = local_shard(x, at_path(self.specs[kind], path), self.mesh)
        if like.device.type == "cpu":
            return x.pin_memory() if like.is_pinned() else x
        return x.to(like.device)


def _batch_axes(mcfg: ModelConfig) -> tuple:
    """The mesh axes that cut the batch: (dcn, data, fsdp), less the ring
    axis when the sequence is cut over it."""
    from macaw_llm_tpu_torch.parallel.mesh import BATCH_AXES
    return tuple(a for a in BATCH_AXES
                 if not (mcfg.ring_attention and a == mcfg.ring_axis))


def batch_layout(mcfg: ModelConfig, mesh) -> tuple:
    """(index, count) of this rank's block of the batch rows over the mesh
    (0, 1 without one): what its loaders load."""
    if mesh is None:
        return 0, 1
    from macaw_llm_tpu_torch.parallel.mesh import axis_index, axis_size
    axes = _batch_axes(mcfg)
    return axis_index(mesh, axes), axis_size(mesh, axes)


def _spec_axes(spec) -> tuple:
    """The mesh axes a spec cuts, in the mesh's order."""
    from macaw_llm_tpu_torch.parallel.mesh import AXES
    return tuple(a for a in AXES if a in spec)
