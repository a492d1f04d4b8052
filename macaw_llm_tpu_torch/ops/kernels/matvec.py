"""Int8 weight-streaming matvecs for single-token decode.

Counterparts of ``macaw_llm_tpu/ops/pallas/matvec.py``: ``matvec_int8``
(``csrc/matvec.cu``, 8 activation rows per block, further rows on the
grid) and ``matvec_int8_pipelined`` (``csrc/matvec_pipelined.cu``, all
rows <= 32 against each weight tile through a ``depth``-stage cp.async
ring). Both compute the same function. On CUDA tensors a wrapper launches
its kernel; on CPU tensors it computes the plain version ``(x @ q) * s``
with the int8 weight converted to x's dtype (exact: |q| <= 127).
"""

from __future__ import annotations

import functools

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

MAX_ROWS = 32
_COLS_PER_BLOCK = 512   # csrc/matvec.cu kCols
_TARGET_BLOCKS = 264    # two blocks per SM on a 132-SM H100
_MAX_ROWS_PER_SPLIT = 1024  # bounds the activation slice in shared memory
_PIPE_TILE_N = 256      # csrc/matvec_pipelined.cu kTileN
_PIPE_CHUNK_K = 32      # csrc/matvec_pipelined.cu kChunkK
PIPE_MAX_DEPTH = 8
_SMS = 132              # H100 SXM
# share of its instruction slots an SM fills with 1, 2 or 3 blocks
_PIPE_SHARE_VEC = (0.9, 1.0, 1.0)
_PIPE_SHARE_BYTES = (0.5, 0.85, 1.0)


def matvec_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """The plain version: (x @ q) * s, fp32 scale applied after the dot."""
    y = (x @ q.to(x.dtype)).float() * s.reshape(1, -1).float()
    return y.to(out_dtype or x.dtype)


def k_splits(k: int, n: int) -> int:
    """How many K ranges the kernel's grid splits the contraction into:
    enough blocks to fill the card, at most 1024 rows per range."""
    tiles = -(-n // _COLS_PER_BLOCK)
    splits = max(-(-_TARGET_BLOCKS // tiles), -(-k // _MAX_ROWS_PER_SPLIT))
    return max(1, min(splits, k))


@functools.lru_cache(maxsize=256)
def pipelined_splits(k: int, n: int, vec: bool = True, resident: int = 3,
                     sms: int = _SMS):
    """(splits, rows per split) of the pipelined kernel's grid, each K
    range a multiple of the 32-row chunk. The kernel is bound by
    instruction throughput, so its time goes as the blocks the fullest SM
    gets, ceil(blocks / SMs), times the K rows per block, over the share
    of its instruction slots an SM fills with that many blocks (measured
    on an H100: about flat with 16-byte cp.async, but 0.5 / 0.85 / 1 for
    the byte-copy path, whose loads only other blocks' warps can hide).
    Among the grids of at most one resident wave, take the cheapest; on a
    tie, the fewer splits (less workspace)."""
    tiles = -(-n // _PIPE_TILE_N)
    share = _PIPE_SHARE_VEC if vec else _PIPE_SHARE_BYTES
    best = None
    for want in range(1, max(1, resident * sms // tiles) + 1):
        rps = -(-(-(-k // want)) // _PIPE_CHUNK_K) * _PIPE_CHUNK_K
        splits = -(-k // rps)
        per_sm = -(-tiles * splits // sms)
        cost = per_sm * rps / share[min(per_sm, len(share)) - 1]
        if best is None or cost < best[0]:
            best = (cost, splits, rps)
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def _pipelined_plan(k: int, n: int, vec: bool, rows: int, depth: int,
                    device: torch.device):
    """(splits, rows per split, depth) of one launch: the grid sized to
    the blocks the card holds at once (asked of the CUDA runtime for this
    kernel instance and ring depth) and ``depth`` clamped to the chunks of
    a K range. Cached: decode calls it 129 times per step with 5 shapes."""
    depth = min(depth, PIPE_MAX_DEPTH)
    resident = _build.library().macaw_matvec_int8_pipelined_blocks_per_sm(
        rows, int(vec), depth)
    if resident < 1:
        raise RuntimeError("matvec_int8_pipelined: the kernel does not fit "
                           f"an SM (rows {rows}, depth {depth})")
    splits, rps = pipelined_splits(
        k, n, vec, resident,
        torch.cuda.get_device_properties(device).multi_processor_count)
    return splits, rps, min(depth, rps // _PIPE_CHUNK_K)


def _check_operands(name: str, x, q, s, out_dtype) -> None:
    """What both kernels take on CUDA tensors; anything else raises."""
    if (x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16
            or q.dtype != torch.int8 or s.dtype != torch.float32):
        raise ValueError(f"{name} kernel: needs bf16 x and output, int8 "
                         f"q, fp32 s; got {x.dtype}, {out_dtype}, {q.dtype}, "
                         f"{s.dtype}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name} kernel: {x.shape[0]} rows, takes 1 to "
                         f"{MAX_ROWS}")
    for label, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"on {x.device}")


def matvec_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [B, K] @ int8 q [K, N] with per-output fp32 scales s ([N] or
    [1, N]) -> [B, N] in ``out_dtype`` (default x.dtype). CUDA: bf16 x and
    output, B <= 32, contiguous operands; anything else raises."""
    b, k = x.shape
    k2, n = q.shape
    if k != k2 or s.numel() != n:
        raise ValueError(f"shapes x {x.shape} q {q.shape} s {s.shape}")
    if x.device.type == "cpu":
        return matvec_reference(x, q, s, out_dtype)
    out_dtype = out_dtype or x.dtype
    _check_operands("matvec_int8", x, q, s, out_dtype)
    splits = k_splits(k, n)
    ws = torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    err = _build.library().macaw_matvec_int8(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, k, n, splits, _build.stream_ptr(x))
    _build.check(err, "matvec_int8")
    matvec_int8.launches += 1
    return out


matvec_int8.launches = 0


def matvec_int8_pipelined(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          depth: int = 4, out_dtype=None) -> torch.Tensor:
    """The same function as ``matvec_int8`` with every weight byte read
    once for all B <= 32 rows, through a ``depth``-stage asynchronous copy
    ring (depth 1: no overlap). ``depth`` is clamped to the number of
    32-row chunks of a K range and to 8. CUDA: bf16 x and output,
    contiguous operands; anything else raises."""
    b, k = x.shape
    k2, n = q.shape
    if k != k2 or s.numel() != n:
        raise ValueError(f"shapes x {x.shape} q {q.shape} s {s.shape}")
    if depth < 1:
        raise ValueError(f"depth {depth} < 1")
    if x.device.type == "cpu":
        return matvec_reference(x, q, s, out_dtype)
    out_dtype = out_dtype or x.dtype
    _check_operands("matvec_int8_pipelined", x, q, s, out_dtype)
    rows = 8 if b <= 8 else 16 if b <= 16 else 32
    # the kernel's own rule for its 16-byte copy path
    vec = n % 16 == 0 and q.data_ptr() % 16 == 0
    splits, rps, depth = _pipelined_plan(k, n, vec, rows, depth, x.device)
    # fp32 scratch: x transposed [K, rows], then the partial sums
    # [splits, B, N]
    scratch = torch.empty(k * rows + splits * b * n, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    err = _build.library().macaw_matvec_int8_pipelined(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * k * rows, out.data_ptr(), b, k, n, splits,
        rps, depth, _build.stream_ptr(x))
    _build.check(err, "matvec_int8_pipelined")
    matvec_int8_pipelined.launches += 1
    return out


matvec_int8_pipelined.launches = 0
