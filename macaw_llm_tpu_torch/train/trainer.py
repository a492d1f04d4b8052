"""Training loop of the fused model (counterpart of
``macaw_llm_tpu/train/trainer.py``, one device, no mesh).

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

The state is updated in place (the reference's is a new pytree per step).
Mesh, sharding, optimizer offload and ring attention are not ported.
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
    def update(self, params: dict, grads: dict,
               state: AdamWState) -> torch.Tensor:
        """One step: clip, Adam moments, bias correction, decoupled weight
        decay, the scheduled learning rate; ``params`` and ``state`` change
        in place. Returns the global norm of ``grads`` (before the clip)."""
        c = self.cfg
        ps, gs = _leaves(params), _leaves(grads)
        mus, nus = _leaves(state.mu), _leaves(state.nu)
        # in fp32 (optax sums bf16 gradients in bf16); the clip divides
        # by it rounded to the gradients' dtype, as optax does
        g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
        keep = g_norm < c.max_grad_norm
        count = state.count + 1
        lr = self.schedule(state.count)
        bc1, bc2 = 1.0 - c.adam_b1 ** count, 1.0 - c.adam_b2 ** count
        for p, g, m, v in zip(ps, gs, mus, nus):
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
    step's learning rate; the state is updated in place."""
    accum = next(iter(batch.values())).shape[0]
    gd = grad_dtype
    diff = _tree_map(lambda p: (p if gd == torch.float32 else p.to(gd))
                     .detach().requires_grad_(), state.trainable)
    loss_sum = 0.0
    for a in range(accum):
        mb = {k: v[a] for k, v in batch.items()}
        loss = _loss(diff, state.frozen, mcfg, mb, state.rng, lora_scale,
                     align_cache)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    def grad(p):
        if p.grad is None:  # a leaf the loss does not reach
            return torch.zeros_like(p)
        return p.grad if accum == 1 else (p.grad / accum).to(gd)

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
    one device (the GPU unless ``device="cpu"`` is asked for)."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig,
                 total_steps: int, device="cuda"):
        self.mcfg, self.tcfg = mcfg, tcfg
        self.device = resolve_device(device)
        self.total_steps = total_steps
        self.tx = make_optimizer(tcfg, total_steps)
        self.lr_schedule = self.tx.schedule
        self.lora_scale = tcfg.lora_alpha / max(tcfg.lora_rank, 1)
        self.align_cache = None

    @torch.no_grad()
    def init_state(self, params: dict,
                   rng: Optional[torch.Generator] = None) -> TrainState:
        """The state over ``params`` (moved to the trainer's device): the
        int8 base (``quantize_base``), the trainable/frozen split, frozen
        leaves cast to ``frozen_dtype``, packed frozen towers, zero AdamW
        moments and, under LoRA, the alignment K/V cache computed once."""
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
        state = TrainState(
            step=0, trainable=trainable, frozen=frozen,
            opt_state=self.tx.init(trainable),
            rng=rng if rng is not None else
            torch.Generator().manual_seed(t.seed))
        if t.lora_rank > 0 and t.align_cache != "off":
            # precomputed once and constant: the align in-proj K/V rows
            # and bias_k/bias_v take zero gradients and never move, so the
            # cache never goes stale; the Q rows and out-proj still train
            self.align_cache = fusion.precompute_align_cache(
                merge_params(trainable, frozen), self.mcfg,
                quantize=t.align_cache == "int8")
        return state

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step over a [A, B, ...] batch; see ``train_step``."""
        return train_step(state, batch, self.mcfg, self.tx, self.lora_scale,
                          getattr(torch, self.tcfg.grad_dtype),
                          self.align_cache)

    def eval_step_fn(self):
        """The forward-only eval step: (loss, correct, count) of the
        shifted argmax token accuracy on a [B, ...] batch, full logits
        (``loss_chunk`` off), no dropout."""
        mcfg = dataclasses.replace(self.mcfg, loss_chunk=0)

        @torch.no_grad()
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            loss, logits = fusion.forward(
                merge_params(state.trainable, state.frozen), mcfg,
                input_ids=batch["input_ids"], images=batch.get("images"),
                audios=batch.get("audios"), videos=batch.get("videos"),
                attention_mask=batch.get("attention_mask"),
                labels=batch["labels"], lora_scale=self.lora_scale)
            lab = batch["labels"]
            prefix = logits.shape[1] - lab.shape[1]
            ext = torch.cat([lab.new_full((lab.shape[0], prefix), IGNORE_ID),
                             lab], dim=1)
            refs = ext[:, 1:]
            valid = refs != IGNORE_ID
            correct = ((logits[:, :-1].argmax(-1) == refs) & valid).sum()
            return loss, correct, valid.sum()

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
