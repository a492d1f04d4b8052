"""Minimal pure-numpy safetensors reader/writer.

HF ships LLaMA/CLIP/Whisper checkpoints as .safetensors; loading them via
torch doubles host RAM for 7B-class models. The format is trivial — an
8-byte little-endian header length, a JSON header mapping tensor name ->
{dtype, shape, data_offsets}, then the raw buffer — so we read it with
numpy memmap (zero-copy until device transfer) and no torch dependency.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
    # BF16 has no numpy dtype: read as uint16 and upconvert
    "BF16": np.uint16,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read every tensor from a .safetensors file as numpy arrays.

    BF16 tensors are upconverted to float32 (numpy has no bfloat16)."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len))
    data = np.memmap(path, np.uint8, mode="r", offset=8 + header_len)

    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = meta["dtype"]
        start, end = meta["data_offsets"]
        raw = np.frombuffer(data[start:end], dtype=_DTYPES[dt])
        arr = raw.reshape(meta["shape"])
        if dt == "BF16":
            # bf16 bits are the top half of an f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def load_checkpoint_dir(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """HF checkpoint directory -> flat state dict.

    Resolution order (mirrors HF from_pretrained, the loading the
    reference intended at run_clm_llms.py:478-483):
      1. ``model.safetensors.index.json`` — a SHARDED checkpoint: the
         index's weight_map names the shard file per tensor (7B-class
         checkpoints ship as 2+ shards); each listed shard is read once.
      2. any ``*.safetensors`` files (single-file or unindexed shards).
      3. ``pytorch_model.bin`` via torch (legacy).
    """
    import glob as _glob
    import os as _os

    index_path = _os.path.join(ckpt_dir, "model.safetensors.index.json")
    if _os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        weight_map: Dict[str, str] = index["weight_map"]
        sd: Dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(load_safetensors(_os.path.join(ckpt_dir, shard)))
        missing = [k for k in weight_map if k not in sd]
        assert not missing, (
            f"index lists tensors absent from shards: {missing[:5]}")
        return sd
    st_files = sorted(_glob.glob(_os.path.join(ckpt_dir, "*.safetensors")))
    if st_files:
        sd = {}
        for f in st_files:
            sd.update(load_safetensors(f))
        return sd
    import torch
    return torch.load(_os.path.join(ckpt_dir, "pytorch_model.bin"),
                      map_location="cpu")


def save_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write numpy arrays as a .safetensors file (f32/f16/ints/bool)."""
    rev = {v: k for k, v in _DTYPES.items() if k != "BF16"}
    header = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        code = rev.get(arr.dtype.type)
        if code is None:
            arr = arr.astype(np.float32)
            code = "F32"
        blob = arr.tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
