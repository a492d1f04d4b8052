"""Parameter partition rules and ZeRO-3 storage over the mesh (counterpart
of ``macaw_llm_tpu/parallel/sharding.py``).

Each parameter path maps to a spec over the (dcn, data, fsdp, tensor) mesh,
one entry per tensor dim: a mesh axis that cuts the dim, or None. The rules
are the reference's (megatron-style: column-parallel weights [in, out] cut
in on fsdp and out on tensor, row-parallel ones the other way round, the
embedding's vocab on tensor and hidden on fsdp, norms and small vectors
replicated); an axis that does not divide its dim is dropped, and trailing
Nones are trimmed, so the specs equal the reference's ``PartitionSpec``s.

A rank holds the local shard of every leaf (``local_shard``): the block of
the whole tensor at its coordinates on the axes of the spec. ``gather``
rebuilds the whole tensor with one all-gather per cut dim;
``reduce_scatter`` sums whole tensors (gradients) over those axes and
leaves each rank its block. ``GatherLayer`` is the pair as one autograd
function: all-gather in the forward, reduce-scatter of the gradients in
the backward into the shards' gradient buffers; ``StackedShards`` hands a
stacked [L, ...] subtree to the models, which gather one layer at a time
(``models._tree.layer``). A ``LeafPlan`` names the axes a leaf is gathered
over (a tensor-parallel rank keeps its tensor block of a leaf whose tensor
cut is its compute block), the axes whose ranks compute the same gradient
(not summed), and a tensor-parallel block taken from the gathered leaf.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from macaw_llm_tpu_torch.parallel.mesh import (FSDP_AXIS, TENSOR_AXIS,
                                               axis_group, axis_index,
                                               mesh_shape)

Spec = Tuple[Optional[str], ...]

F, T = FSDP_AXIS, TENSOR_AXIS

# (path regex, spec): first match wins. Paths look like "llm/layers/attn/wq"
# or "fusion/to_hidden/video/w"; layer-stacked leaves have a leading
# num_layers dim mapped to None. The reference's PARTITION_RULES.
PARTITION_RULES: List[Tuple[str, Spec]] = [
    # ---- LLaMA (stacked [L, ...]) ----
    (r"llm/layers/attn/w[qkv](/q)?$", (None, F, T)),
    (r"llm/layers/attn/wo(/q)?$", (None, T, F)),
    (r"llm/layers/mlp/(gate|up)(/q)?$", (None, F, T)),
    (r"llm/layers/mlp/down(/q)?$", (None, T, F)),
    (r"llm/layers/(input|post)_norm$", ()),
    (r"llm/embed_tokens$", (T, F)),
    (r"llm/lm_head(/q)?$", (F, T)),
    (r"llm/norm$", ()),
    # ---- CLIP / Whisper towers (frozen; shard the big matrices on fsdp) ----
    (r"(image|video)_encoder/layers/attn/[qkv]/w$", (None, F, T)),
    (r"(image|video)_encoder/layers/attn/o/w$", (None, T, F)),
    (r"(image|video)_encoder/layers/mlp/fc1/w$", (None, F, T)),
    (r"(image|video)_encoder/layers/mlp/fc2/w$", (None, T, F)),
    (r"audio_encoder/layers/attn/[qkv]/w$", (None, F, T)),
    (r"audio_encoder/layers/attn/o/w$", (None, T, F)),
    (r"audio_encoder/layers/mlp/fc1/w$", (None, F, T)),
    (r"audio_encoder/layers/mlp/fc2/w$", (None, T, F)),
    (r"audio_encoder/embed_positions$", (None, F)),
    # ---- fusion modules ----
    (r"fusion/(image|audio|video)_align/in_proj_w$", (F, T)),
    (r"fusion/(image|audio|video)_align/out_proj_w$", (T, F)),
    (r"fusion/to_hidden/\w+/w$", (F, T)),
    (r"fusion/conv/\w+/w$", (None, F, None)),
    # ---- default: replicate ----
    (r".*", ()),
]

# the stacked [L, ...] subtrees: gathered one layer at a time
STACKED = ("llm/layers", "image_encoder/layers", "video_encoder/layers",
           "audio_encoder/layers")

# collectives issued, by kind (all_gather, reduce_scatter, all_reduce,
# send_recv): counted where they are issued
COLLECTIVES: Counter = Counter()


def spec_for(path: str, shape: Sequence[int], mesh, rules=None) -> Spec:
    """The spec of one leaf: the first rule whose regex matches ``path``,
    less the axes that do not divide their dim (or are of size 1), with
    trailing Nones trimmed. ``mesh``: a mesh or its {axis: size}."""
    sizes = mesh_shape(mesh) if not isinstance(mesh, dict) else mesh
    spec: Spec = ()
    for pat, s in rules or PARTITION_RULES:
        if re.search(pat, path):
            spec = s
            break
    fixed = []
    for dim, axis in enumerate(spec):
        n = 1 if axis is None else sizes[axis]
        ok = axis is not None and dim < len(shape) and n > 1 \
            and shape[dim] % n == 0
        fixed.append(axis if ok else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def infer_shardings(tree, mesh, rules=None):
    """The tree of specs of ``tree`` (tensors, or anything with
    ``.shape``)."""
    return tree_map(lambda p, x: spec_for(p, x.shape, mesh, rules), tree)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The local shard's shape of a leaf of ``shape`` under ``spec`` (over
    a mesh or its {axis: size})."""
    sizes = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
    return tuple(n // sizes[spec[d]] if d < len(spec) and spec[d] else n
                 for d, n in enumerate(shape))


def local_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` (a copy)."""
    sizes = mesh_shape(mesh)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        m = x.shape[d] // sizes[axis]
        x = x.narrow(d, axis_index(mesh, (axis,)) * m, m)
    return x.clone()


def shard_params(params, mesh, rules=None):
    """(local shards, specs) of a whole parameter tree present on every
    rank."""
    specs = infer_shardings(params, mesh, rules)
    shards = tree_map(lambda p, x: local_shard(x, at_path(specs, p), mesh),
                      params)
    return shards, specs


def at_path(tree, path: str):
    """The node of a nested dict at a "/"-joined path."""
    for k in path.split("/") if path else ():
        tree = tree[k]
    return tree


def opt_state_shardings(moments, param_specs):
    """Specs of a moment tree (Adam's mu or nu): those of the parameters,
    leaf for leaf (the ZeRO-3 "optimizer state sharded like the
    parameters")."""
    return tree_map(lambda p, _: at_path(param_specs, p), moments)


# --------------------------------------------------------------------------
# collectives along one tensor dim

def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)
    COLLECTIVES["all_gather"] += 1


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["reduce_scatter"] += 1


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum ``x`` in place over ``axes`` (nothing to do when there are
    none)."""
    if axes:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis_group(mesh, axes))
        COLLECTIVES["all_reduce"] += 1
    return x


def _in(axis, axes) -> bool:
    return axes is None or axis in axes


def gather(x: torch.Tensor, spec: Spec, mesh, axes=None) -> torch.Tensor:
    """The whole tensor from the local shards ``x`` (all-gather over the
    axis of every cut dim, in dim order); with ``axes``, over those of
    them only (this rank keeps its block of the others)."""
    sizes = mesh_shape(mesh)
    for d, axis in enumerate(spec):
        if axis is None or not _in(axis, axes):
            continue
        n = sizes[axis]
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), axis_group(mesh, (axis,)))
        x = out.view((n,) + tuple(x.shape)).movedim(0, d).reshape(
            x.shape[:d] + (n * x.shape[d],) + x.shape[d + 1:])
    return x


def reduce_scatter(g: torch.Tensor, spec: Spec, mesh, axes=None,
                   same=()) -> torch.Tensor:
    """The local block of the sum of the whole tensors ``g`` over the axes
    of ``spec`` (reduce-scatter per cut dim, in reverse dim order); with
    ``axes``, over those of them only (``gather``'s). A dim whose axis is
    in ``same`` (its ranks hold the same gradient) is not summed: the rank
    takes its block."""
    sizes = mesh_shape(mesh)
    for d in reversed(range(len(spec))):
        axis = spec[d]
        if axis is None or not _in(axis, axes):
            continue
        n = sizes[axis]
        m = g.shape[d] // n
        if axis in same:
            g = g.narrow(d, axis_index(mesh, (axis,)) * m, m)
            continue
        parts = g.reshape(g.shape[:d] + (n, m) + g.shape[d + 1:]) \
            .movedim(d, 0).contiguous()
        out = g.new_empty(parts.shape[1:])
        _reduce_scatter(out, parts.view((-1,) + tuple(parts.shape[2:])),
                        axis_group(mesh, (axis,)))
        g = out
    return g


@dataclass(frozen=True)
class LeafPlan:
    """How a trainer's view takes one leaf: ``spec``, its shards' cut;
    ``axes``, the axes it is gathered over (None: every axis of the spec);
    ``same``, axes whose ranks compute the same gradient (kept, not
    summed); ``cut``, (how, TensorParallel): this rank's tensor-parallel
    block of the gathered leaf (``tensor_parallel.cut``; zeros around its
    gradient in the backward)."""

    spec: Spec
    axes: Optional[Tuple[str, ...]] = None
    same: Tuple[str, ...] = ()
    cut: Optional[tuple] = None

    def layer(self) -> "LeafPlan":
        """The plan of one layer of a stacked [L, ...] leaf."""
        return LeafPlan(self.spec[1:], self.axes, self.same, self.cut)


# --------------------------------------------------------------------------
# the gathered forward, the reduce-scattered backward

class GatherLayer(torch.autograd.Function):
    """All-gather of a group of leaves (layer ``index`` of stacked shards,
    or whole unstacked shards when ``index`` is None), each as its
    ``LeafPlan`` says; the backward reduce-scatters each gradient and adds
    it into the leaf's gradient buffer (at ``index``). ``anchor``, a
    scalar that takes a gradient, puts the function in the graph; the
    shards themselves take none, so no whole-size gradient ever reaches
    them."""

    @staticmethod
    def forward(ctx, anchor, mesh, index, leaves):
        # leaves: [(local shard, plan, gradient buffer)]
        ctx.mesh, ctx.index, ctx.leaves = mesh, index, leaves
        out, ctx.shapes = [], []
        for x, plan, _ in leaves:
            t, shape = _gather_at(x, plan, mesh, index)
            ctx.shapes.append(shape)
            # an uncut leaf comes back as the shard itself: hand out a view,
            # so that the shard never becomes an output of the graph
            out.append(t.view_as(t))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from macaw_llm_tpu_torch.parallel.tensor_parallel import uncut
        for g, shape, (_, plan, buf) in zip(grads, ctx.shapes, ctx.leaves):
            if ctx.index is not None:
                plan, buf = plan.layer(), buf[ctx.index]
            if plan.cut is not None:
                g = uncut(g, *plan.cut, shape)
            buf.add_(reduce_scatter(g.to(buf.dtype), plan.spec, ctx.mesh,
                                    plan.axes, plan.same))
        return None, None, None, None


def _gather_at(x, plan: LeafPlan, mesh, index: Optional[int]):
    """The leaf as ``plan`` gathers it, or its layer ``index`` of a stacked
    leaf; and the gathered shape (before a tensor-parallel cut)."""
    if index is not None:
        x, plan = x[index], plan.layer()
    t = gather(x, plan.spec, mesh, plan.axes)
    shape = tuple(t.shape)
    if plan.cut is not None:
        from macaw_llm_tpu_torch.parallel.tensor_parallel import cut
        t = cut(t, *plan.cut)
    return t, shape


def gather_leaves(leaves, mesh, index: Optional[int], anchor) -> list:
    """The tensors the models read of ``leaves`` [(shard, plan, gradient
    buffer or None)]: through ``GatherLayer`` for those with a buffer
    (when autograd is on), plain gathers for the others, in the order
    given."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    train = [i for i, (_, _, buf) in enumerate(leaves) if buf is not None]
    if train and torch.is_grad_enabled():
        got = GatherLayer.apply(anchor, mesh, index,
                                [leaves[i] for i in train])
        for i, t in zip(train, got):
            out[i] = t
    with torch.no_grad():
        for i, (x, plan, _) in enumerate(leaves):
            if out[i] is None:
                out[i] = _gather_at(x, plan, mesh, index)[0]
    return out


class StackedShards(dict):
    """A stacked [L, ...] subtree as local shards (so ``num_layers`` reads
    L from dim 0, which no rule cuts); ``gather_layer(i)`` returns layer
    i's whole tree. ``requires_grad`` tells whether any leaf trains."""

    def __init__(self, tree: dict, leaves: list, paths: list, mesh, anchor):
        super().__init__(tree)
        self._leaves, self._paths = leaves, paths
        self._mesh, self._anchor = mesh, anchor
        self.requires_grad = any(buf is not None for _, _, buf in leaves)

    def gather_layer(self, i: int) -> dict:
        out: dict = {}
        for path, t in zip(self._paths, gather_leaves(
                self._leaves, self._mesh, i, self._anchor)):
            _set(out, path, t)
        return out


def _set(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def gathered_view(entries, mesh, anchor) -> dict:
    """The parameter tree the models read, from ``entries`` [(path, shard,
    plan, gradient buffer or None)]: stacked subtrees as
    ``StackedShards``, every other leaf gathered now (one ``GatherLayer``
    for those that train)."""
    view: dict = {}
    stacked: dict = {}
    flat = []
    for path, x, plan, buf in entries:
        root = next((s for s in STACKED if path.startswith(s + "/")), None)
        if root is None:
            flat.append((path, (x, plan, buf)))
        else:
            stacked.setdefault(root, []).append(
                (path[len(root) + 1:], (x, plan, buf)))
    for path, t in zip([p for p, _ in flat], gather_leaves(
            [leaf for _, leaf in flat], mesh, None, anchor)):
        _set(view, path, t)
    for root, items in stacked.items():
        local: dict = {}
        for path, (x, _, _) in items:
            _set(local, path, x)
        _set(view, root, StackedShards(local, [leaf for _, leaf in items],
                                       [p for p, _ in items], mesh, anchor))
    return view
