"""Checkpoints of the train state with resume (counterpart of
``macaw_llm_tpu/train/checkpoint.py``, same ``CheckpointManager`` API).

The reference writes Orbax checkpoints; this module writes its own format
and reads only that:

    <directory>/config.json              the run's ``Config``
    <directory>/step_<N>/state.pt        ``torch.save`` of
        {"step": N, "trainable": tree, "frozen": tree,
         "opt": {"count": int, "mu": tree, "nu": tree},
         "rng": the dropout generator's state (uint8 tensor)}

Every tensor keeps its dtype and bits (fp32, bf16, int8 ``{"q", "s"}``
records). A step is written into ``.tmp-step_<N>`` and renamed into place
once its file is on disk, so a half-written step is never listed.

A save returns before the disk write: the write runs on a background
thread (one at a time) from copies that no later train step touches,
since ``train_step`` updates the state in place:

* snapshot (default): the mutable state (trainable leaves and the AdamW
  moments) is cloned on the device, the frozen tree is pulled to the host
  once per run, and the thread copies the clones to the host and writes;
* fenced: the mutable state is copied to the host before ``save``
  returns. Taken when ``snapshot=False`` or when the device has less free
  memory than 1.1x the device-resident bytes of the mutable state (host
  tensors cost no device memory and are not counted);
* gathered: a state sharded over a mesh (a ``Trainer`` with a mesh is
  given as ``trainer``) is gathered leaf by leaf into whole tensors on
  rank 0's host (every rank takes part in each gather), rank 0 writes the
  same file before ``save`` returns, and the other ranks wait at a
  barrier. Restore cuts the whole leaves into the
  trainer's shards, so a checkpoint moves between meshes and one device.

Restore maps the file into memory (``torch.load(mmap=True)``) instead of
reading it whole: a rank copies out the bytes of its own shards, and the
ranks of one host share the file's pages in the page cache, where each
would otherwise hold the whole state (67 GB at 7b) in its own memory.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from macaw_llm_tpu_torch.config import Config
from macaw_llm_tpu_torch.train.state import TrainState
from macaw_llm_tpu_torch.train.trainer import AdamWState, _leaves, _tree_map

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _device_resident(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def _free_device_bytes(device: torch.device) -> int:
    free, _ = torch.cuda.mem_get_info(device)
    return free


def _mutable(state: TrainState) -> dict:
    return {"trainable": state.trainable, "mu": state.opt_state.mu,
            "nu": state.opt_state.nu}


class CheckpointManager:
    def __init__(self, directory: str, save_steps: int = 5000,
                 max_to_keep: int = 1, snapshot: bool = True,
                 trainer=None):
        """``save_steps`` gates un-forced saves to multiples of it;
        ``max_to_keep`` newest steps are kept; ``snapshot`` selects the
        device-copy save (see the module docstring); ``trainer``, a
        ``Trainer`` over a mesh, the gathered save and the sharded
        restore."""
        self.directory = os.path.abspath(directory)
        self.trainer = trainer if trainer is not None and \
            trainer.mesh is not None else None
        self.save_steps = max(save_steps, 1)
        self.max_to_keep = max(max_to_keep, 1)
        self.snapshot = snapshot
        self._frozen_host = None
        self._frozen_key = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._warned_fallback = False
        # what the last save did: mode, bytes written, time save() blocked
        # the caller, and the background write's duration (set by wait())
        self.last_save: Optional[dict] = None
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def _snapshot_ok(self, state: TrainState) -> bool:
        """Whether a device copy of the mutable state fits: 1.1x its
        device-resident bytes against the device's free memory."""
        resident = [t for t in _leaves(_mutable(state))
                    if _device_resident(t)]
        need = sum(t.numel() * t.element_size() for t in resident)
        if need == 0:
            return True
        free = _free_device_bytes(resident[0].device)
        if need * 1.1 > free:
            if not self._warned_fallback:
                logger.warning(
                    "ckpt snapshot: mutable state %.2f GiB vs %.2f GiB free "
                    "device memory; falling back to fenced saves",
                    need / 2**30, free / 2**30)
                self._warned_fallback = True
            return False
        return True

    def _frozen_on_host(self, frozen: dict) -> dict:
        """The frozen tree on the host, copied once: frozen leaves never
        change within a run (keyed on their storage, so another tree is
        copied anew)."""
        key = tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                    for t in _leaves(frozen))
        if self._frozen_key != key:
            self._frozen_host = _tree_map(lambda t: t.cpu(), frozen)
            self._frozen_key = key
        return self._frozen_host

    def save(self, state: TrainState, config: Optional[Config] = None,
             force: bool = False) -> bool:
        """Save ``state`` at its step: only at multiples of ``save_steps``
        unless ``force``, never twice for one step. Returns whether a save
        was started; the write finishes in the background (``wait``)."""
        step = int(state.step)
        if not force and step % self.save_steps != 0:
            return False
        self.wait()  # one write in flight
        if step in self.all_steps():
            return False
        if self.trainer is not None:
            return self._save_gathered(state, config)
        t0 = time.perf_counter()
        snapshot = self.snapshot and self._snapshot_ok(state)
        mutable = _mutable(state)
        if snapshot:
            mutable = _tree_map(torch.clone, mutable)
            ready = None
            dev = next((t.device for t in _leaves(mutable)
                        if t.is_cuda), None)
            if dev is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
        else:  # a copy even where the state already lives on the host
            mutable = _tree_map(lambda t: t.to("cpu", copy=True), mutable)
            dev = ready = None
        payload = {"step": step, "frozen": self._frozen_on_host(state.frozen),
                   "count": state.opt_state.count,
                   "rng": state.rng.get_state()}
        if config is not None:
            _atomic_write(os.path.join(self.directory, "config.json"),
                          config.to_json().encode())
        nbytes = sum(t.numel() * t.element_size()
                     for t in _leaves(mutable) + _leaves(payload["frozen"]))
        self.last_save = {"step": step,
                          "mode": "snapshot" if snapshot else "fenced",
                          "bytes": nbytes,
                          "blocking_ms": (time.perf_counter() - t0) * 1e3,
                          "write_s": None}
        self._error = None
        self._thread = threading.Thread(
            target=self._write, args=(payload, mutable, dev, ready),
            name=f"ckpt-step-{step}")
        self._thread.start()
        return True

    def _save_gathered(self, state: TrainState,
                       config: Optional[Config]) -> bool:
        """The gathered save of a sharded state (every rank calls it)."""
        t0 = time.perf_counter()
        whole = self.trainer.whole_state(state, rank0_only=True)
        rank0 = dist.get_rank() == 0
        mutable = _mutable(whole)
        payload = {"step": whole.step, "frozen": whole.frozen,
                   "count": whole.opt_state.count,
                   "rng": whole.rng.get_state()}
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(mutable)
                     + _leaves(whole.frozen)) if rank0 else None
        self._error = None
        try:
            if rank0:
                if config is not None:
                    _atomic_write(os.path.join(self.directory,
                                               "config.json"),
                                  config.to_json().encode())
                self._write(payload, mutable, None, None)
        finally:
            dist.barrier()
        self.last_save = {"step": whole.step, "mode": "gathered",
                          "bytes": nbytes,
                          "blocking_ms": (time.perf_counter() - t0) * 1e3,
                          "write_s": self._write_s if rank0 else None}
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
        return True

    def _write(self, payload: dict, mutable: dict, dev, ready) -> None:
        t0 = time.perf_counter()
        try:
            if dev is not None:
                side = torch.cuda.Stream(dev)
                side.wait_event(ready)
                with torch.cuda.stream(side):
                    for t in _leaves(mutable):  # offloaded moments are host
                        if t.is_cuda:           # tensors already
                            t.record_stream(side)
                    mutable = _tree_map(lambda t: t.cpu(), mutable)
            record = {"step": payload["step"],
                      "trainable": mutable["trainable"],
                      "frozen": payload["frozen"],
                      "opt": {"count": payload["count"],
                              "mu": mutable["mu"], "nu": mutable["nu"]},
                      "rng": payload["rng"]}
            step = payload["step"]
            for name in os.listdir(self.directory):  # a failed write's
                if name.startswith(".tmp-step_"):     # leftovers
                    shutil.rmtree(os.path.join(self.directory, name))
            tmp = os.path.join(self.directory, f".tmp-step_{step}")
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(record, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(self.directory, f"step_{step}"))
            _fsync_dir(self.directory)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, f"step_{old}"),
                              ignore_errors=True)
        except BaseException as e:  # re-raised by wait()
            self._error = e
        finally:
            self._write_s = time.perf_counter() - t0

    def wait(self) -> None:
        """Block until the write in flight is on disk; re-raise its
        failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self.last_save["write_s"] = self._write_s
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()

    # ------------------------------------------------------------------
    def restore(self, target: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """The saved state at ``step`` (default: the newest) in the layout
        of ``target``: every leaf on the target leaf's device, with the
        same tree, shape and dtype (a mismatch raises). None when there is
        no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        rec = torch.load(os.path.join(self.directory, f"step_{step}",
                                      STATE_FILE),
                         map_location="cpu", weights_only=True, mmap=True)
        rng = torch.Generator(device=target.rng.device)
        rng.set_state(rec["rng"])
        tr = self.trainer

        def place(saved, like, kind):
            return _place(saved, like, kind, "", tr)

        return TrainState(
            step=rec["step"],
            trainable=place(rec["trainable"], target.trainable, "trainable"),
            frozen=place(rec["frozen"], target.frozen, "frozen"),
            opt_state=AdamWState(
                count=rec["opt"]["count"],
                mu=place(rec["opt"]["mu"], target.opt_state.mu, "trainable"),
                nu=place(rec["opt"]["nu"], target.opt_state.nu,
                         "trainable")),
            rng=rng)


def _place(saved, target, kind: str, path: str, trainer=None):
    """The saved whole leaves (mapped from the file) in ``target``'s
    layout, copied out of the map: on its device (pinned host memory kept
    pinned), or this rank's shards of them when the ``trainer`` holds a
    sharded state."""
    where = f"{kind}{path}"
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"checkpoint tree differs at {where}")
        return {k: _place(saved[k], target[k], kind, f"{path}/{k}", trainer)
                for k in target}
    if trainer is not None and saved.dtype == target.dtype:
        saved = trainer.shard_leaf(kind, path[1:], saved, target)
    if saved.shape != target.shape or saved.dtype != target.dtype:
        raise ValueError(f"checkpoint leaf {where}: {saved.dtype}"
                         f"{list(saved.shape)} vs {target.dtype}"
                         f"{list(target.shape)}")
    if trainer is not None:
        return saved
    if target.device.type == "cpu":
        return saved.pin_memory() if target.is_pinned() else saved.clone()
    return saved.to(target.device)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_config(directory: str) -> Optional[Config]:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return Config.from_json(f.read())
