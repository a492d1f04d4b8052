"""Megatron tensor-parallel inference over the mesh's ``tensor`` axis: what
the reference's GSPMD makes of its partition rules
(``parallel.sharding.PARTITION_RULES``) when a mesh cuts ``tensor``.

One process per rank; each rank holds its block of every leaf the rules
cut on ``tensor`` (``tp_params``) and the whole leaf otherwise.

* Column-parallel projections (LLaMA wq/wk/wv and gate/up, the towers'
  q/k/v and fc1, the alignment's in-projection) give a rank its own heads
  or FFN columns, biases and int8 scales cut with their columns.
* Row-parallel projections (wo, down, o, fc2, the alignment's
  out-projection) end in one all-reduce over the tensor group
  (``reduce``); their bias is added once, after it. The sum is one
  device's up to its order: W8A8 sums its int32 dots (exact), the other
  routes their fp32 partials, rounded once (``row_mm``,
  ``utils.quantize.matmul``).
* A stack whose head count ``t`` does not divide would be cut inside a
  head: it stays whole and computes gathered, as where the rules drop an
  axis that does not divide its dim (``TensorParallel.cuts``, ``on``).
* The vocab, where ``t`` divides the padded vocab (``vocab_pad_to``), is
  vocab-parallel: the embedding is a masked lookup and an all-reduce
  (``embed``), the logits are all-gathered (``gather``). At 32007
  rows it is whole on every rank.
* The alignment's in-projection is cut by heads, rows of the torch
  [3E, E] layout (q, k and v thirds each cut), where the reference's
  rule cuts its input dim (ROADMAP C).
* Leaves whose cut has no Megatron partner (``fusion/to_hidden``,
  ``fusion/conv``, ``audio_encoder/embed_positions``) and the
  ``video_long_attn``/``temporal_attn`` weights (the rules replicate them)
  stay whole.

The models take a ``TensorParallel`` (``tp``) argument; None, or a size of
1, is the one-device path with nothing changed. Pack after cutting
(``utils.quantize.pack_llama_for_decode``, ``fusion.pack_towers``), never
cut a packed tensor: a rank's packed qkv is [its q | its k | its v].
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES


# the modules a tensor group may cut, and the counts it must divide
def _module_counts(cfg) -> dict:
    llm, vis, aud = cfg.llm, cfg.vision, cfg.audio
    return {
        "llm_attn": (llm.num_heads, llm.kv_heads),
        "llm_mlp": (llm.intermediate_size,),
        "vocab": (llm.padded_vocab,),
        "clip_attn": (vis.num_heads,),
        "clip_mlp": (vis.intermediate_size,),
        "whisper_attn": (aud.encoder_attention_heads,),
        "whisper_mlp": (aud.encoder_ffn_dim,),
        "align": (cfg.fusion.attention_heads * 2,),
    }


@dataclass(frozen=True)
class TensorParallel:
    """The tensor group of this rank for one model: ``size`` ranks, this
    one ``rank``, collectives over ``group`` (None: the default group);
    ``cuts`` names the modules whose heads, FFN width or vocab ``size``
    divides: those are cut, every other one computes whole."""

    size: int
    rank: int
    group: Any = None
    cuts: frozenset = frozenset()

    @classmethod
    def of(cls, cfg, size: int, rank: int, group=None) -> "TensorParallel":
        """The group for model ``cfg`` (a ``ModelConfig``)."""
        cuts = frozenset(
            m for m, counts in _module_counts(cfg).items()
            if size > 1 and all(c % size == 0 for c in counts))
        return cls(size, rank, group, cuts)

    @classmethod
    def from_mesh(cls, mesh, cfg) -> "TensorParallel":
        from macaw_llm_tpu_torch.parallel.mesh import (TENSOR_AXIS,
                                                       axis_group,
                                                       axis_index, axis_size)
        axes = (TENSOR_AXIS,)
        return cls.of(cfg, axis_size(mesh, axes), axis_index(mesh, axes),
                      axis_group(mesh, axes))

    @classmethod
    def world(cls, cfg) -> "TensorParallel":
        """Every process of the job as one tensor group."""
        return cls.of(cfg, dist.get_world_size(), dist.get_rank())

    @property
    def leader(self) -> bool:
        return self.rank == 0


def on(tp: Optional[TensorParallel], module: str
       ) -> Optional[TensorParallel]:
    """``tp`` where it cuts ``module``, else None: the module computes
    whole (the one-device code)."""
    return tp if tp is not None and module in tp.cuts else None


def local(tp: Optional[TensorParallel], n: int) -> int:
    """This rank's share of ``n`` under an ``on`` result."""
    return n if tp is None else n // tp.size


class _AllReduce(torch.autograd.Function):
    """Sum over the tensor group; the backward is the identity (Megatron's
    g: every rank's partial gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES["all_reduce"] += 1
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """The row-parallel sum of the ranks' partials (nothing under None)."""
    return x if tp is None else _AllReduce.apply(x, tp.group)


def row_mm(tp: Optional[TensorParallel], x: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] of a row-parallel weight's block (x this
    rank's block of the input): each rank's partial product in fp32,
    summed over the group and rounded once to x's dtype, as one device
    rounds its fp32 sum once (the sum's order differs). ``x @ w`` under
    None."""
    if tp is None:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    y = reduce(tp, y).to(x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def reduce_max(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the tensor group (nothing under None)."""
    if tp is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    COLLECTIVES["all_reduce"] += 1
    return x


def gather(tp: TensorParallel, x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather of the ranks' blocks of ``dim``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def embed(tp: Optional[TensorParallel], table: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: this rank's rows of ``table`` (its block of
    the vocab), zeros for the ids outside it, summed over the ranks (one
    rank holds each id, so the sum is exact)."""
    if tp is None:
        return F.embedding(ids, table)
    rows = table.shape[0]
    off = ids - tp.rank * rows
    mine = (off >= 0) & (off < rows)
    e = F.embedding(torch.where(mine, off, 0), table)
    return reduce(tp, torch.where(mine[..., None], e, 0.0))


# --------------------------------------------------------------------------
# a rank's block of the whole tree

# (path regex, how the leaf is cut, module): "col" cuts the last dim (a
# column-parallel [.., in, out] weight, its [.., out] bias, an int8 record
# with its [.., 1, out] scale), "row" the dim before it (a row-parallel
# weight; an int8 record keeps its scale whole), "vocab" dim 0, "qkv" the
# rows of each third of a torch-layout [3E, E] in-projection (or of its
# [3E] bias). The torch-layout [E_out, E_in] out-projection is cut on its
# input, its last dim: "col" too. The module decides whether the cut is
# made (``TensorParallel.cuts``).
_CUTS = [
    (r"^llm/layers/attn/w[qkv]$", "col", "llm_attn"),
    (r"^llm/layers/attn/wo$", "row", "llm_attn"),
    (r"^llm/layers/lora/[qv]b$", "col", "llm_attn"),
    (r"^llm/layers/mlp/(gate|up)$", "col", "llm_mlp"),
    (r"^llm/layers/mlp/down$", "row", "llm_mlp"),
    (r"^llm/embed_tokens$", "vocab", "vocab"),
    (r"^llm/lm_head$", "col", "vocab"),
    (r"^(image|video)_encoder/layers/attn/[qkv]/[wb]$", "col", "clip_attn"),
    (r"^(image|video)_encoder/layers/attn/o/w$", "row", "clip_attn"),
    (r"^(image|video)_encoder/layers/mlp/fc1/[wb]$", "col", "clip_mlp"),
    (r"^(image|video)_encoder/layers/mlp/fc2/w$", "row", "clip_mlp"),
    (r"^audio_encoder/layers/attn/[qkv]/[wb]$", "col", "whisper_attn"),
    (r"^audio_encoder/layers/attn/o/w$", "row", "whisper_attn"),
    (r"^audio_encoder/layers/mlp/fc1/[wb]$", "col", "whisper_mlp"),
    (r"^audio_encoder/layers/mlp/fc2/w$", "row", "whisper_mlp"),
    (r"^fusion/(image|audio|video)_align/in_proj_[wb]$", "qkv", "align"),
    (r"^fusion/(image|audio|video)_align/bias_[kv]$", "col", "align"),
    (r"^fusion/(image|audio|video)_align/out_proj_w$", "col", "align"),
]


def _block(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    m = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * m, m).clone()


def _cut_leaf(x, how: str, tp: TensorParallel):
    if isinstance(x, dict):  # an int8 record {"q", "s"}
        if how == "row":
            return {"q": _block(x["q"], -2, tp), "s": x["s"]}
        return {"q": _cut_leaf(x["q"], how, tp),
                "s": _cut_leaf(x["s"], how, tp)}
    if how == "col":
        return _block(x, -1, tp)
    if how == "row":
        return _block(x, -2, tp)
    if how == "vocab":
        return _block(x, 0, tp)
    # "qkv": each third of dim 0 cut by heads
    thirds = x.reshape((3, x.shape[0] // 3) + tuple(x.shape[1:]))
    return _block(thirds, 1, tp).reshape((-1,) + tuple(x.shape[1:]))


def tp_params(params: dict, tp: Optional[TensorParallel]) -> dict:
    """This rank's tree from the whole tree ``params``: the tensor blocks
    of the leaves that a cut module holds, every other leaf as it is
    (shared, not copied). Quantize first
    (``utils.quantize``): an int8 record's scale must come from its whole
    column. The tree must not be packed yet."""
    if tp is None or tp.size == 1:
        return params
    for name in ("llm", "image_encoder", "video_encoder", "audio_encoder"):
        sub = params.get(name, {})
        attn = sub.get("layers", {}).get("attn", {})
        if "qkv" in attn:
            raise ValueError(f"{name} is packed: cut the tree before "
                             "packing it")

    def leaf(path: str, x):
        for pat, how, module in _CUTS:
            if re.search(pat, path):
                mtp = on(tp, module)
                return x if mtp is None else _cut_leaf(x, how, mtp)
        return x

    def walk(tree, prefix=""):
        if isinstance(tree, dict) and not (set(tree) == {"q", "s"}):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return leaf(prefix, tree)

    return walk(params)

