"""Ring attention: causal attention over a sequence cut across the ranks of
a mesh axis (counterpart of ``macaw_llm_tpu/parallel/ring_attention.py``).

Each rank holds its chunk of q, k and v. For n steps it attends its
queries to the K/V chunk it holds, merges the partial result into a
running (out, lse) pair by the log-sum-exp ``_combine``, and passes the
chunk on to the next rank of the ring (and receives the previous rank's).
Every attention is a call of ``flash_attention_with_lse``: B2 forward, B3
and B4 in the backward, which the combine's gradient reaches as the LSE
cotangent.

The rank and the step are host integers here, so each step launches only
the attention that counts: with the contiguous layout, causal on the
diagonal (the rank's own chunk), full below it and none above it (n(n+1)/2
calls over the ring); with the zig-zag layout (``zigzag_indices``: rank i
holds blocks i and 2n-1-i, which balances the causal work) the late half's
queries attend the early half's keys in full every step, the diagonal adds
both halves causally, and an off-diagonal step the one full pair that
counts (n(2n+1) calls over the ring). A skipped attention is exact:
``_combine`` with (0, NEG_INF) leaves a row with a finite LSE unchanged,
and NEG_INF is finite (the float32 minimum), never -inf.

``ring_attention`` exchanges K and V over the ring axis's process group,
both in one ``batch_isend_irecv`` of one autograd function whose backward
sends their gradients the other way. ``ring_attention_local`` runs the
same steps in one process, the exchange being a rotation of the list of n
chunks: the counterpart of the reference's ring over simulated devices.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from macaw_llm_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF, flash_attention_with_lse)
from macaw_llm_tpu_torch.parallel.sharding import COLLECTIVES

LAYOUTS = ("zigzag", "contiguous")


def _combine(out_a, lse_a, out_b, lse_b):
    """Merge two partial attention results by their log-sum-exp weights.
    out [B, S, N, D] fp32, lse [B, S, N]."""
    lse_max = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - lse_max)[..., None]
    wb = torch.exp(lse_b - lse_max)[..., None]
    lse = lse_max + torch.log(wa[..., 0] + wb[..., 0])
    out = (out_a * wa + out_b * wb) / (wa + wb)
    return out, lse


def zigzag_indices(seq_len: int, n: int) -> torch.Tensor:
    """The permutation that lays the sequence out so that a contiguous
    split over n ranks gives rank i blocks (i, 2n-1-i) of 2n equal blocks:
    ``x[:, perm]``; ``x == x_perm[:, inverse_permutation(perm)]``."""
    if seq_len % (2 * n):
        raise ValueError(f"zig-zag layout: sequence length {seq_len} is "
                         f"not a multiple of 2 x {n} ranks")
    blk = seq_len // (2 * n)
    idx = []
    for i in range(n):
        idx.append(torch.arange(i * blk, (i + 1) * blk))
        j = 2 * n - 1 - i
        idx.append(torch.arange(j * blk, (j + 1) * blk))
    return torch.cat(idx)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def _attend(q, k, v, causal: bool):
    q, k, v = (t.contiguous() for t in (q, k, v))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                      scale=q.shape[-1] ** -0.5)
    return o.float(), lse


def _start(q) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device))


def _contiguous_step(q, k, v, src: int, me: int, acc):
    """One step of rank ``me`` holding the K/V chunk of rank ``src``."""
    if src > me:
        return acc
    return _combine(*acc, *_attend(q, k, v, causal=src == me))


def _zigzag_step(q, k, v, src: int, me: int, acc):
    """One zig-zag step; acc = (out0, lse0, out1, lse1) of the early (block
    me) and the late (block 2n-1-me) half of the local queries."""
    half = q.shape[1] // 2
    q0, q1 = q[:, :half], q[:, half:]
    k0, k1 = k[:, :half], k[:, half:]
    v0, v1 = v[:, :half], v[:, half:]
    a0, a1 = acc[:2], acc[2:]
    # the late block 2n-1-me is after every early block src < n
    a1 = _combine(*a1, *_attend(q1, k0, v0, causal=False))
    if src == me:
        a0 = _combine(*a0, *_attend(q0, k0, v0, causal=True))
        a1 = _combine(*a1, *_attend(q1, k1, v1, causal=True))
    elif src < me:  # block me after block src
        a0 = _combine(*a0, *_attend(q0, k0, v0, causal=False))
    else:           # block 2n-1-me after block 2n-1-src
        a1 = _combine(*a1, *_attend(q1, k1, v1, causal=False))
    return a0 + a1


def _step_fn(layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"ring layout {layout!r}: one of {LAYOUTS}")
    return _zigzag_step if layout == "zigzag" else _contiguous_step


def _init(q, layout: str):
    if layout == "zigzag":
        if q.shape[1] % 2:
            raise ValueError(f"zig-zag layout: local chunk of "
                             f"{q.shape[1]} positions is not two blocks")
        half = q[:, :q.shape[1] // 2]
        return _start(half) + _start(half)
    return _start(q)


def _finish(acc, dtype) -> torch.Tensor:
    if len(acc) == 4:
        return torch.cat([acc[0], acc[2]], dim=1).to(dtype)
    return acc[0].to(dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n: int, layout: str = "zigzag") -> torch.Tensor:
    """The ring's schedule in one process: q/k/v [B, S, N, D] in the
    layout's order (zig-zag: already permuted by ``zigzag_indices``), cut
    into n chunks; chunk r's steps see the chunks r, r-1, ... as rank r of
    a ring would. Returns [B, S, N, D] in the same order."""
    step = _step_fn(layout)
    if q.shape[1] % n:
        raise ValueError(f"ring: sequence length {q.shape[1]} is not a "
                         f"multiple of {n} chunks")
    qs, ks, vs = (list(t.chunk(n, dim=1)) for t in (q, k, v))
    outs = []
    for me in range(n):
        acc = _init(qs[me], layout)
        for t in range(n):
            src = (me - t) % n
            acc = step(qs[me], ks[src], vs[src], src, me, acc)
        outs.append(_finish(acc, q.dtype))
    return torch.cat(outs, dim=1)


class _Exchange(torch.autograd.Function):
    """K and V to the next rank of the ring, from the previous one, in one
    ``batch_isend_irecv``; the backward sends their gradients the other way
    (the transpose of the shift). ``carry`` (a running output) passes
    through unchanged: every exchange then lies on the path from the
    output, so every rank runs every exchange's backward, also where its
    received chunk met no attention (a skipped last step)."""

    @staticmethod
    def forward(ctx, k, v, carry, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _send_recv(k, v, nxt, prv, group) + (carry.view_as(carry),)

    @staticmethod
    def backward(ctx, gk, gv, gcarry):
        return _send_recv(gk, gv, ctx.prv, ctx.nxt, ctx.group) + (
            gcarry, None, None, None)


def _send_recv(a: torch.Tensor, b: torch.Tensor, to: int, frm: int,
               group) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b = a.contiguous(), b.contiguous()
    ra, rb = torch.empty_like(a), torch.empty_like(b)
    ops = [dist.P2POp(dist.isend, a, to, group),
           dist.P2POp(dist.isend, b, to, group),
           dist.P2POp(dist.irecv, ra, frm, group),
           dist.P2POp(dist.irecv, rb, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES["send_recv"] += 1
    return ra, rb


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "tensor",
                   layout: str = "zigzag") -> torch.Tensor:
    """Causal self-attention with the sequence cut over the mesh axis
    ``axis``: q/k/v [B, S_local, N, D] are this rank's chunk (zig-zag: of
    the sequence permuted by ``zigzag_indices(S, n)``, RoPE positions and
    targets permuted by the caller too). Returns this rank's chunk of the
    output. Each rank launches the flash kernels of its own steps only; the
    last step's exchange is left out."""
    from macaw_llm_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                   axis_size)
    step = _step_fn(layout)
    n = axis_size(mesh, (axis,))
    me = axis_index(mesh, (axis,))
    group = axis_group(mesh, (axis,))
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    acc = _init(q, layout)
    for t in range(n):
        src = (me - t) % n
        acc = step(q, k, v, src, me, acc)
        if t < n - 1:
            k, v, carried = _Exchange.apply(k, v, acc[0], group, nxt, prv)
            acc = (carried,) + tuple(acc[1:])
    return _finish(acc, q.dtype)
