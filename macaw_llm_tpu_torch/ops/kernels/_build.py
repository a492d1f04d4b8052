"""Build ``csrc/*.cu`` into one shared library with a plain C interface and
load it with ctypes.

One ``nvcc`` per source runs in parallel (``-c``), then one link. The
library lands in ``build/macaw_llm_tpu_torch/<hash>/`` at the repository
root, keyed by the sources and flags, so a checkout builds once at first
use. Processes that start together (the ranks of a job) build under a
file lock in that directory: one compiles, the others wait and load its
library. Nothing here runs at import time: the CPU-only tests import every
module of the package.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from macaw_llm_tpu_torch.utils.profiling import SPANS

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE.parent / "build" / "macaw_llm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: every one returns cudaGetLastError() as an int
_SIGNATURES = {
    "macaw_mh_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "macaw_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _F, _I, _I, _I, _P],
    "macaw_flash_attention_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _P],
    "macaw_flash_attention_bwd_delta": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "macaw_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _F, _I, _P],
    "macaw_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _F, _I, _P],
    "macaw_matvec_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "macaw_matvec_int8_pipelined": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P],
    "macaw_matvec_smem_bytes": [_I, _I, _I],
    "macaw_error_string": [_I],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _link_flags(nvcc: str) -> list:
    """libcuda, for the TMA tensor maps (cuTensorMapEncodeTiled): linked
    against the toolkit's stub, the installed libcuda.so.1 loaded at run
    time."""
    root = Path(nvcc).resolve().parents[1]
    stubs = [d for d in (root / "lib64" / "stubs",
                         root / "targets" / "x86_64-linux" / "lib" / "stubs")
             if d.is_dir()]
    return [f"-L{d}" for d in stubs] + ["-lcuda"]


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> dict:
    """Compile (if needed) and return {"path", "seconds", "log", "cached"}."""
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    # released when the process ends, however it ends
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(out_dir, cu)


def _build_locked(out_dir: Path, cu: list) -> dict:
    lib_path = out_dir / "libmacaw_kernels.so"
    if lib_path.is_file():
        log_path = out_dir / "build.log"
        return {"path": str(lib_path), "seconds": 0.0, "cached": True,
                "log": log_path.read_text() if log_path.is_file() else ""}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out_dir / f"libmacaw_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(o) for _, o, _ in procs],
         *_link_flags(nvcc)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    (out_dir / "build.log").write_text(log)
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "cached": False, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            with SPANS.span("setup.kernel_load"):
                info = build()
                lib = ctypes.CDLL(info["path"])
            SPANS.count("setup.kernel_load." +
                        ("cached" if info["cached"] else "built"))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "macaw_error_string" \
                    else ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().macaw_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
