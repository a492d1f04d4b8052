"""Int8 weight-streaming matvecs for single-token decode.

Counterparts of ``macaw_llm_tpu/ops/pallas/matvec.py``: ``matvec_int8``
and ``matvec_int8_pipelined`` compute the same function with one kernel
(``csrc/matvec.cu``): every int8 weight converted to bf16 once, the
product on the tensor cores (wgmma, the weights on its 64-row side), the
weights streamed by TMA through a ring of 3 stages (``matvec_int8``) or
``depth`` stages (``matvec_int8_pipelined``). On CUDA tensors a wrapper
launches the kernel; on CPU tensors it computes the plain version
``(x @ q) * s`` with the int8 weight converted to x's dtype (exact:
|q| <= 127).

``out_dtype=torch.float32`` has the kernel write the product unrounded
(its K ranges' partials summed in range order, then scaled): a
tensor-parallel rank's row block of a weight gives a partial product,
summed over the ranks before it is rounded once.
"""

from __future__ import annotations

import functools

import torch

from macaw_llm_tpu_torch.ops.kernels import _build

MAX_ROWS = 32
# csrc/matvec.cu: weight rows per ring stage (MvLayout::KT) on the TMA
# path and on the ragged one, and columns per block (kTileN)
TILE_K, RAGGED_TILE_K, TILE_N = 64, 128, 128
PIPE_MAX_DEPTH = 8
MAX_SPLITS = 8  # csrc/matvec.cu kMaxSplits: bounds the fp32 partials
# blocks an SM holds at once on the TMA path at up to 32 rows and 4 stages
# (at most 67 KB of shared memory each): one wave of the grid
BLOCKS_PER_SM = 3
_SMS = 132      # H100 SXM; the wrappers ask the device


def matvec_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """The plain version: (x @ q) * s, fp32 scale applied after the dot."""
    y = (x @ q.to(x.dtype)).float() * s.reshape(1, -1).float()
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=256)
def matvec_splits(k: int, n: int, sms: int = _SMS,
                  tile_k: int = TILE_K) -> int:
    """How many K ranges (of whole ``tile_k``-row tiles) the kernel's grid
    splits the contraction into: the most, up to ``MAX_SPLITS``, whose
    blocks fit one wave of ``BLOCKS_PER_SM`` blocks an SM. A block streams
    its range at a rate its SM shares with the other blocks there, so more
    blocks, up to what the SMs hold at once, keep more bytes in flight
    (measured best at every 7b shape on an H100 by
    ``tools/decode_probes.py sweep``). The plan depends on the shape and
    the SM count only, so the output is the same bits at every ring
    depth."""
    tiles_k, tiles_n = -(-k // tile_k), -(-n // TILE_N)
    for want in range(min(MAX_SPLITS, tiles_k), 0, -1):
        if tiles_n * want <= BLOCKS_PER_SM * sms:
            return -(-tiles_k // -(-tiles_k // want))
    return 1


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_operands(name: str, x, q, s, out_dtype) -> None:
    """What both kernels take on CUDA tensors; anything else raises."""
    if (x.dtype != torch.bfloat16
            or out_dtype not in (torch.bfloat16, torch.float32)
            or q.dtype != torch.int8 or s.dtype != torch.float32):
        raise ValueError(f"{name} kernel: needs bf16 x, a bf16 or fp32 "
                         f"output, int8 q, fp32 s; got {x.dtype}, "
                         f"{out_dtype}, {q.dtype}, {s.dtype}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name} kernel: {x.shape[0]} rows, takes 1 to "
                         f"{MAX_ROWS}")
    if x.shape[1] % 8:  # x's TMA map: rows 16-byte aligned
        raise ValueError(f"{name} kernel: K = {x.shape[1]} is not a "
                         f"multiple of 8")
    for label, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"on {x.device}")


def _buffers(x: torch.Tensor, q: torch.Tensor, out_dtype: torch.dtype):
    """The grid's K splits, the fp32 partials [splits, B, N] (empty for
    one split, which writes the output itself) and the output. A ragged N,
    or a q not 16-byte aligned, takes the kernel's other path and its k
    tile."""
    b, k = x.shape
    n = q.shape[1]
    vec = n % 16 == 0 and q.data_ptr() % 16 == 0
    splits = matvec_splits(k, n, _sm_count(x.device),
                           TILE_K if vec else RAGGED_TILE_K)
    ws = torch.empty((splits, b, n) if splits > 1 else (0,),
                     dtype=torch.float32, device=x.device)
    return splits, ws, torch.empty((b, n), dtype=out_dtype, device=x.device)


def matvec_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [B, K] @ int8 q [K, N] with per-output fp32 scales s ([N] or
    [1, N]) -> [B, N] in ``out_dtype`` (default x.dtype). CUDA: bf16 x, a
    bf16 or fp32 output, B <= 32, contiguous operands; anything else
    raises."""
    b, k = x.shape
    k2, n = q.shape
    if k != k2 or s.numel() != n:
        raise ValueError(f"shapes x {x.shape} q {q.shape} s {s.shape}")
    if x.device.type == "cpu":
        return matvec_reference(x, q, s, out_dtype)
    out_dtype = out_dtype or x.dtype
    _check_operands("matvec_int8", x, q, s, out_dtype)
    splits, ws, out = _buffers(x, q, out_dtype)
    err = _build.library().macaw_matvec_int8(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), b, k, n, splits,
        _build.stream_ptr(x))
    _build.check(err, "matvec_int8")
    matvec_int8.launches += 1
    return out


matvec_int8.launches = 0


def matvec_int8_pipelined(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          depth: int = 4, out_dtype=None) -> torch.Tensor:
    """The same function as ``matvec_int8`` with ``depth`` 64-row weight
    tiles in flight in the kernel's TMA ring (depth 1: no overlap of copy
    and math; clamped to 8 and to what fits the shared memory); the output
    is the same bits at every depth. CUDA: bf16 x, a bf16 or fp32 output,
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
    splits, ws, out = _buffers(x, q, out_dtype)
    err = _build.library().macaw_matvec_int8_pipelined(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), b, k, n, splits,
        min(depth, PIPE_MAX_DEPTH), _build.stream_ptr(x))
    _build.check(err, "matvec_int8_pipelined")
    matvec_int8_pipelined.launches += 1
    return out


matvec_int8_pipelined.launches = 0
