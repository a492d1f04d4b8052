"""Helpers over the nested-dict parameter trees."""

from __future__ import annotations

import torch


def layer(tree, i: int):
    """Layer ``i`` of a stacked [L, ...] subtree (views, no copies); a
    subtree held as shards over a mesh (``parallel.sharding.StackedShards``)
    gathers it."""
    if hasattr(tree, "gather_layer"):
        return tree.gather_layer(i)
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def layer_fn(fn, layers, i: int):
    """``fn`` with layer ``i`` of ``layers`` as its first argument, taken
    inside the call: under remat a sharded layer is gathered again in the
    recompute instead of being kept whole until the backward."""
    def call(*args, **kwargs):
        return fn(layer(layers, i), *args, **kwargs)
    return call


def num_layers(tree) -> int:
    """Leading (layer) size of a stacked subtree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# Random init on the generator's device. Seeds give other numbers than the
# reference package's jax.random keys: tests share weights through
# utils.jax_bridge instead.
def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def uniform(gen: torch.Generator, shape, limit: float,
            dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(dtype)


def zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)
