"""ctypes bindings for the native media loader (native/libmacaw_media.so);
the port's own copy of ``macaw_llm_tpu/data/native.py``.

Falls back to the pure-Python paths (PIL / wave) when the shared library
has not been built. Build with ``make -C native``. ctypes releases the GIL
during calls, so the loader's thread pool gets true parallel decode.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_if_stale(so_path: str) -> None:
    """Build the shared library from source when it is missing or older
    than media_loader.cc (the binary is never checked in)."""
    src_dir = os.path.dirname(so_path)
    src = os.path.join(src_dir, "media_loader.cc")
    if not os.path.exists(src):
        return
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)):
        return
    import subprocess
    try:
        subprocess.run(["make", "-C", src_dir], check=True,
                       capture_output=True, timeout=120)
    except Exception:  # noqa: BLE001 — pure-Python fallback covers this
        pass


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    default = os.path.join(here, "native", "libmacaw_media.so")
    _build_if_stale(default)
    for cand in (default, os.environ.get("MACAW_MEDIA_LIB", "")):
        if cand and os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.macaw_decode_jpeg_crop.restype = ctypes.c_int
                lib.macaw_decode_jpeg_crop.argtypes = [
                    ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8)]
                lib.macaw_load_wav.restype = ctypes.c_int
                lib.macaw_load_wav.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                    ctypes.c_long, ctypes.c_int]
                _LIB = lib
                break
            except (OSError, AttributeError):
                continue
    return _LIB


def available() -> bool:
    return _lib() is not None


def decode_jpeg_crop(data: bytes, target: int) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [target, target, 3], or None on failure."""
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.macaw_decode_jpeg_crop(
        data, len(data), target,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out


def load_wav(path: str, target_len: int,
             target_rate: int = 16000) -> Optional[np.ndarray]:
    """WAV file -> fp32 mono [target_len] resampled to target_rate
    (pad-or-trim), or None on failure/malformed input."""
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((target_len,), np.float32)
    rc = lib.macaw_load_wav(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_len, target_rate)
    if rc < 0:
        return None
    return out
