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

Training (Megatron's f and g): a column-parallel product whose input
takes a gradient reads it through ``copy`` (f: the identity forward, the
all-reduce of the input's gradient backward, since each rank's block
gives part of it); the row-parallel sum (g: ``reduce``, ``row_mm``) passes
the whole output's gradient to every rank. ``gather`` (the vocab-parallel
logits, the token memory) hands each rank its block of the gradient back.
Every leaf outside a cut module then takes the same gradient on every
rank. Under sequence parallelism (``sequence_parallel``: a tensor group
with ``sequence`` set, LLaMA's layers without a cache) the residual stream
between layers is this rank's block of the sequence, padded to a multiple
of the size (``split_sequence``); a cut module gathers the whole sequence
before its column products (``gather_sequence``, whose backward
reduce-scatters) and reduce-scatters its row-parallel partials
(``row_mm``, whose backward all-gathers).
"""

from __future__ import annotations

import dataclasses
import re
import weakref
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
    # the row-parallel sums reduce-scatter over the sequence (dim 1) instead
    # of all-reducing (``sequence_parallel``)
    sequence: bool = False

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


def without(tp: Optional[TensorParallel], *modules: str
            ) -> Optional[TensorParallel]:
    """``tp`` with ``modules`` computed whole."""
    if tp is None:
        return None
    return dataclasses.replace(tp, cuts=tp.cuts - set(modules))


def sequence_parallel(tp: Optional[TensorParallel]
                      ) -> Optional[TensorParallel]:
    """``tp`` whose row-parallel sums reduce-scatter over the sequence:
    the group of a sequence-parallel stack (None without a group of 2 or
    more)."""
    if tp is None or tp.size == 1:
        return None
    return dataclasses.replace(tp, sequence=True)


# process groups torn down after a failure on one of their ranks (the
# server's teardown): a collective over one raises instead of being issued
# on a communicator that was aborted
TORN_GROUPS: "weakref.WeakSet" = weakref.WeakSet()


def check_live(group) -> None:
    """Raise if ``group`` was torn down (``TORN_GROUPS``)."""
    if group is not None and group in TORN_GROUPS:
        raise RuntimeError("the tensor group was torn down on another rank")


def _issue(kind: str, group) -> None:
    """Before each collective: refuse a torn-down group, count the call."""
    check_live(group)
    COLLECTIVES[kind] += 1


def _trains(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Copy(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum of the gradient over the
    tensor group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _issue("all_reduce", ctx.group)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def copy(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (f): ``x`` itself, whose
    gradient is summed over the group in the backward; nothing to do under
    None or where ``x`` takes no gradient (inference)."""
    if tp is None or not _trains(x):
        return x
    return _Copy.apply(x, tp.group)


class _AllReduce(torch.autograd.Function):
    """Sum over the tensor group; the backward is the identity (Megatron's
    g: every rank's partial gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        _issue("all_reduce", group)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """The row-parallel sum of the ranks' partials (nothing under None)."""
    return x if tp is None else _AllReduce.apply(x, tp.group)


def _rank_block(x: torch.Tensor, dim: int, tp: TensorParallel):
    m = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * m, m)


def _all_gather(tp: TensorParallel, x: torch.Tensor, dim: int):
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    _issue("all_gather", tp.group)
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(tp: TensorParallel, x: torch.Tensor, dim: int):
    """This rank's block of dim ``dim`` of the sum of ``x`` over the group
    (the dim a multiple of the size)."""
    parts = list(x.movedim(dim, 0).contiguous().chunk(tp.size))
    out = torch.empty_like(parts[0])
    _issue("reduce_scatter", tp.group)
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=tp.group)
    return out.movedim(0, dim)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` [B, S, ...] padded with zero rows on dim 1 up to a multiple
    of ``n``."""
    pad = -x.shape[1] % n
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


class _RowMM(torch.autograd.Function):
    """A row-parallel product: the fp32 partial x @ w of this rank's
    block, summed over the group (all-reduced, or reduce-scattered over
    the sequence under ``tp.sequence``) and rounded once to x's dtype. The
    backward (g) takes the whole output's gradient (all-gathered over the
    sequence first under ``tp.sequence``): gx = g @ w^T, gw = x^T @ g, in
    x's dtype, as one device's product. An int8 ``w`` (a record's q) is
    converted to x's dtype for each product and saved as it is, as
    ``quantize._Int8Matmul`` saves it."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.tp, ctx.shape = tp, x.shape
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
            y = torch.mm(x2, w.to(x.dtype), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float()
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        if tp.sequence:
            y = _reduce_scatter(tp, _pad_rows(y, tp.size), 1)
        else:
            # a copy: remat "dots" keeps the product itself for its
            # recompute, which sums it again
            y = y.contiguous().clone()
            _issue("all_reduce", tp.group)
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=tp.group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        tp = ctx.tp
        if tp.sequence:
            g = _all_gather(tp, g, 1)[:, :ctx.shape[1]]
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if w is not None:
            gx = (g2 @ w.to(g2.dtype).T).reshape(ctx.shape)
        if x is not None:
            gw = x.reshape(-1, x.shape[-1]).T @ g2
        return gx, gw, None


def row_mm(tp: Optional[TensorParallel], x: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] of a row-parallel weight's block (x this
    rank's block of the input): each rank's partial product in fp32,
    summed over the group and rounded once to x's dtype, as one device
    rounds its fp32 sum once (the sum's order differs). ``x @ w`` under
    None. Under ``tp.sequence`` x is [B, S, K] and the result this rank's
    block of the sequence, padded to a multiple of the size. ``w`` may be
    int8 (a record's q, scaled by the caller), converted for each
    product and kept as int8 for the backward."""
    if tp is None:
        return x @ w.to(x.dtype)
    return _RowMM.apply(x, w, tp)


def reduce_max(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the tensor group (nothing under None)."""
    if tp is None:
        return x
    x = x.contiguous().clone()
    _issue("all_reduce", tp.group)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


class _Gather(torch.autograd.Function):
    """All-gather of dim ``dim`` forward; this rank's block of the gradient
    backward (every rank computed the same whole result from it)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(tp, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _rank_block(g, ctx.dim, ctx.tp).contiguous(), None, None


def gather(tp: TensorParallel, x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather of the ranks' blocks of ``dim``, in rank order; the
    backward hands this rank its block of the (whole, the same on every
    rank) gradient."""
    return _Gather.apply(x, tp, dim)


class _GatherSequence(torch.autograd.Function):
    """All-gather of the sequence (dim 1) forward, reduce-scatter of the
    gradient backward (the ranks' column blocks each give part of it)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(tp, x, 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.tp, g, 1), None


class _SplitSequence(torch.autograd.Function):
    """This rank's block of the (padded) sequence forward, the all-gather
    of the blocks' gradients backward (the whole input's gradient, the
    same on every rank)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.s = tp, x.shape[1]
        return _rank_block(_pad_rows(x, tp.size), 1, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.tp, g, 1)[:, :ctx.s], None


def split_sequence(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the sequence of the whole ``x`` [B, S, ...],
    S padded with zero rows to a multiple of the size: [B, ceil(S/t),
    ...]."""
    return _SplitSequence.apply(x, tp)


def gather_sequence(tp: TensorParallel, x: torch.Tensor, s: int,
                    cut: bool) -> torch.Tensor:
    """The whole sequence [B, s, ...] from the ranks' blocks ``x`` (the
    padding dropped): the input of a module that ``cut`` (its column
    products give each rank part of the gradient, reduce-scattered
    backward), or of one computed whole on every rank (this rank's block
    of the same gradient)."""
    fn = _GatherSequence.apply(x, tp) if cut else gather(tp, x, 1)
    return fn[:, :s]


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
    return _rank_block(x, dim, tp).clone()


def cut(x, how: str, tp: TensorParallel):
    """This rank's block (a copy) of the whole leaf ``x`` (a tensor or an
    int8 record) under the cut ``how`` of ``_CUTS``."""
    if isinstance(x, dict):  # an int8 record {"q", "s"}
        if how == "row":
            return {"q": _block(x["q"], -2, tp), "s": x["s"]}
        return {"q": cut(x["q"], how, tp), "s": cut(x["s"], how, tp)}
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
                return x if mtp is None else cut(x, how, mtp)
        return x

    def walk(tree, prefix=""):
        if isinstance(tree, dict) and not (set(tree) == {"q", "s"}):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return leaf(prefix, tree)

    return walk(params)


# --------------------------------------------------------------------------
# training: the cut of each leaf of the state's paths

# leaves whose gradient is partial on every rank under sequence parallelism,
# summed over the group: the norms (they run on this rank's block of the
# sequence) and LoRA's A (its middle is computed on the block, then
# all-gathered)
_SEQUENCE_PARTIAL = (r"^llm/layers/(input|post)_norm$", r"^llm/norm$",
                     r"^llm/layers/lora/[qv]a$")


def leaf_cut(path: str, tp: Optional[TensorParallel]) -> Optional[str]:
    """How ``tp`` cuts the leaf at ``path`` (a state path: an int8
    record's leaves end in /q and /s): "col", "row", "vocab", "qkv", or
    None (whole)."""
    if tp is None:
        return None
    base, sub = path, None
    m = re.match(r"^(.*)/([qs])$", path)
    if m:
        base, sub = m.groups()
    for pat, how, module in _CUTS:
        if re.search(pat, base):
            if on(tp, module) is None or (sub == "s" and how == "row"):
                return None
            return how
    return None


def cut_dim(how: str, ndim: int) -> Optional[int]:
    """The dim a cut narrows in a leaf of ``ndim`` dims (None: "qkv", the
    thirds of dim 0)."""
    return {"col": ndim - 1, "row": ndim - 2, "vocab": 0}.get(how)


def partial_under_sequence(path: str) -> bool:
    return any(re.search(p, path) for p in _SEQUENCE_PARTIAL)


def uncut(g: torch.Tensor, how: str, tp: TensorParallel,
          shape) -> torch.Tensor:
    """The whole-shaped gradient of a block: ``g`` in this rank's place,
    zeros elsewhere (summed over the group, the whole gradient)."""
    out = g.new_zeros(shape)
    if how == "qkv":
        thirds = out.view((3, shape[0] // 3) + tuple(shape[1:]))
        _rank_block(thirds, 1, tp).copy_(
            g.reshape((3, -1) + tuple(shape[1:])))
    else:
        _rank_block(out, cut_dim(how, len(shape)), tp).copy_(g)
    return out


def tp_align_cache(cache: Optional[dict],
                   tp: Optional[TensorParallel]) -> Optional[dict]:
    """This rank's block of a whole alignment K/V cache
    (``fusion.precompute_align_cache``): its heads' columns, int8 rows
    keeping the whole rows' scales, as ``precompute_align_cache`` under
    ``tp`` makes it."""
    atp = on(tp, "align")
    if cache is None or atp is None:
        return cache
    return {mod: {kv: (_block(q, -1, atp), scale)
                  for kv, (q, scale) in entry.items()}
            for mod, entry in cache.items()}
