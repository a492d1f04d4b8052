"""Device mesh and process start-up (counterpart of
``macaw_llm_tpu/parallel/mesh.py``).

One process drives one device. The processes form a
``torch.distributed.device_mesh.DeviceMesh`` over the reference's axes
(dcn, data, fsdp, tensor), ranks laid out row-major, so that ranks are
ordered as the reference orders its devices: by process, then by local
index. The batch is cut over ``BATCH_AXES``; parameters and Adam moments
over fsdp and tensor (``parallel.sharding``).

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``, unless the caller names one (``backend=``: gloo carries CUDA
tensors through host memory, for several ranks on one card, which NCCL
refuses); nothing else picks another. Collectives over any set of mesh
axes go through ``axis_group``: one process group for each way of fixing
the other axes, created on every rank in the same order when the mesh is
made (``new_subgroups_by_enumeration`` is collective).
"""

from __future__ import annotations

import itertools
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from macaw_llm_tpu_torch.config import MeshConfig

DCN_AXIS = "dcn"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXES = (DCN_AXIS, DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
BATCH_AXES = (DCN_AXIS, DATA_AXIS, FSDP_AXIS)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process-group backend of a device type: nccl or gloo."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}")
    return BACKENDS[kind]


# a rank waits this long for the others at the rendezvous and in each
# collective before the job fails
TIMEOUT = timedelta(minutes=10)


def multihost_initialize(device="cuda",
                         store: Optional[dist.Store] = None,
                         backend: Optional[str] = None) -> bool:
    """Join the job's process group; returns whether there is one.

    The job is read from the reference's environment (COORDINATOR_ADDRESS
    host:port, NUM_PROCESSES, PROCESS_ID) or torchrun's (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); ``store`` (a FileStore, as
    the tests pass) takes the place of the address. With neither, it does
    nothing and the world is one process. On ``cuda`` each process takes
    the card of its local rank; only an explicit ``backend="gloo"`` lets
    several ranks share a card (the local rank modulo the cards there
    are), since NCCL takes one rank a card. ``backend``: the process
    group's (default ``backend_for(device)``). A failed rendezvous
    raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if store is None and "COORDINATOR_ADDRESS" not in env \
            and "MASTER_ADDR" not in env:
        return False
    if "PROCESS_ID" in env or "COORDINATOR_ADDRESS" in env:
        rank = int(env["PROCESS_ID"])
        world = int(env["NUM_PROCESSES"])
        local = int(env.get("LOCAL_RANK", 0))
    else:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
    backend = backend or backend_for(device)
    kw = dict(backend=backend, rank=rank,
              world_size=world,
              timeout=TIMEOUT)
    if store is not None:
        kw["store"] = store
    elif "COORDINATOR_ADDRESS" in env:
        kw["init_method"] = f"tcp://{env['COORDINATOR_ADDRESS']}"
    else:
        kw["init_method"] = (f"tcp://{env['MASTER_ADDR']}:"
                             f"{env.get('MASTER_PORT', '29500')}")
    if torch.device(device).type == "cuda":
        if backend == "gloo":
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(**kw)
    return True


def create_mesh(cfg: MeshConfig = MeshConfig(), device="cuda",
                backend: Optional[str] = None) -> DeviceMesh:
    """The (dcn, data, fsdp, tensor) mesh of ``cfg`` resolved over the
    world's processes (one device each; the process group must exist:
    ``multihost_initialize``). Its axis groups are created here. The
    group's backend must be ``backend`` (default ``backend_for(device)``).
    """
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "multihost_initialize first")
    kind = torch.device(device).type
    want = backend or backend_for(kind)
    if dist.get_backend() != want:
        raise ValueError(f"the process group's backend is "
                         f"{dist.get_backend()}, the mesh of device {kind} "
                         f"asks for {want}")
    shape = cfg.resolved(dist.get_world_size())
    mesh = init_device_mesh(kind, shape, mesh_dim_names=AXES)
    _make_groups(mesh)
    return mesh


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis: size} of the mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def axis_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major index over ``axes`` (in mesh order); the rank
    of this process within ``axis_group(mesh, axes)``."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    i = 0
    for a in _ordered(mesh, axes):
        i = i * shape[a] + coord[a]
    return i


def _ordered(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[str, ...]:
    unknown = set(axes) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not mesh axes")
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def _make_groups(mesh: DeviceMesh) -> None:
    """One group per set of axes, for every way of fixing the other axes:
    the ranks that vary over the set, in increasing order (row-major over
    the set, the order ``axis_index`` counts). Sets of one device share
    one-rank groups: their collectives are still issued (they copy)."""
    names = mesh.mesh_dim_names
    grid = mesh.mesh
    single, _ = dist.new_subgroups_by_enumeration(
        [[r] for r in range(grid.numel())])
    groups = {}
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            n = axis_size(mesh, axes)
            if n == 1:
                groups[axes] = single
                continue
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            flat = grid.permute(*rest, *dims).reshape(-1, n)
            groups[axes], _ = dist.new_subgroups_by_enumeration(
                [sorted(row.tolist()) for row in flat])
    mesh._macaw_groups = groups


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of this rank over ``axes`` (a one-rank group when
    they hold one device)."""
    return mesh._macaw_groups[_ordered(mesh, axes)]


def batch_sharding(mesh: DeviceMesh) -> list:
    """The reference's ``P(BATCH_AXES)`` as DTensor placements: dim 0 cut
    over (dcn, data, fsdp), replicated over tensor."""
    return [Shard(0) if a in BATCH_AXES else Replicate()
            for a in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> list:
    """The reference's ``P()``: replicated over every axis."""
    return [Replicate() for _ in mesh.mesh_dim_names]
