"""Safetensors reader (zero-copy mmap, no external deps).

A copy of inferflow_tpu/loaders/safetensors.py (no JAX in it), kept so
that this package imports nothing of the JAX one, with two additions:
``SafetensorsFile.torch_tensor`` reads a tensor into a CPU torch tensor of
its stored type (BF16 stays two bytes, for the loader to move to the card
before widening), and ``save_safetensors`` also takes torch tensors (BF16
included).

reference: ModelReader's safetensors path (src/transformer/
model_reader.cc:2272-2522).  Format: u64-le header length, JSON header
mapping tensor name -> {dtype, shape, data_offsets}, then a flat data
region.  Sharded checkpoints use `model.safetensors.index.json`
(model_reader.cc:1466-1510).
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # no native numpy bf16; view as uint16 and widen
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


_TORCH_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    u32 = raw.astype(np.uint32) << 16
    return u32.view(np.float32)


class SafetensorsFile:
    """One .safetensors file, mmap-backed."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mm[:8], "little")
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self._entries: Dict[str, dict] = header
        self._data_start = 8 + header_len

    def names(self) -> List[str]:
        return list(self._entries)

    def info(self, name: str) -> Tuple[str, tuple]:
        e = self._entries[name]
        return e["dtype"], tuple(e["shape"])

    def tensor(self, name: str, as_float32: bool = False) -> np.ndarray:
        """Read one tensor. BF16 widens to f32 (numpy has no bf16);
        other dtypes are returned natively (f16 stays f16)."""
        e = self._entries[name]
        dt = e["dtype"]
        start, end = e["data_offsets"]
        buf = self._mm[self._data_start + start:self._data_start + end]
        shape = tuple(e["shape"])
        if dt == "BF16":
            raw = np.frombuffer(buf, dtype=np.uint16)
            arr = _bf16_to_f32(raw).reshape(shape)
            return arr.astype(np.float32) if as_float32 else arr
        npdt = _DTYPES.get(dt)
        if npdt is None:
            raise ValueError(f"unsupported safetensors dtype {dt} for {name}")
        arr = np.frombuffer(buf, dtype=npdt).reshape(shape)
        if as_float32 and arr.dtype in (np.float16, np.float64):
            arr = arr.astype(np.float32)
        return arr

    def torch_tensor(self, name: str) -> torch.Tensor:
        """Read one tensor into a new CPU torch tensor of its stored type
        (BF16 as torch.bfloat16): one copy, straight from the file."""
        e = self._entries[name]
        dt = e["dtype"]
        if dt not in _TORCH_DTYPES:
            raise ValueError(f"unsupported safetensors dtype {dt} for {name}")
        start, end = e["data_offsets"]
        raw = torch.empty(end - start, dtype=torch.uint8)
        self._file.seek(self._data_start + start)
        if self._file.readinto(memoryview(raw.numpy())) != end - start:
            raise ValueError(f"{self.path}: {name} is truncated")
        return raw.view(_TORCH_DTYPES[dt]).reshape(tuple(e["shape"]))

    def close(self):
        self._mm.close()
        self._file.close()


def load_safetensors(paths: List[str]) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (name, array) over one or more .safetensors files."""
    for p in paths:
        f = SafetensorsFile(p)
        try:
            for name in f.names():
                yield name, f.tensor(name)
        finally:
            f.close()


def resolve_index(path: str) -> List[str]:
    """Expand a `*.index.json` into its shard file list; otherwise return
    [path] (model_reader.cc:1466-1510)."""
    if not path.endswith(".index.json"):
        return [path]
    with open(path) as fh:
        idx = json.load(fh)
    weight_map = idx.get("weight_map", {})
    base = os.path.dirname(path)
    shards = sorted(set(weight_map.values()))
    return [os.path.join(base, s) for s in shards]


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Dict[str, str] = None) -> None:
    """Minimal writer (the analog of ModelWriter::Save, model_writer.cc) —
    our `Std` interchange format IS safetensors.  Values are numpy arrays
    or CPU torch tensors (any type of the format, BF16 included), written
    without an intermediate copy of the whole file."""
    header = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            if arr.dtype not in _TORCH_NAMES:
                raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
            dt = _TORCH_NAMES[arr.dtype]
            shape = list(arr.shape)
            blob = arr.detach().cpu().contiguous().reshape(-1).view(
                torch.uint8).numpy()
            header[name] = {"dtype": dt, "shape": shape,
                            "data_offsets": [offset, offset + blob.nbytes]}
            blobs.append(blob)
            offset += blob.nbytes
            continue
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float16:
            dt = "F16"
        elif arr.dtype == np.float32:
            dt = "F32"
        elif arr.dtype == np.int8:
            dt = "I8"
        elif arr.dtype == np.uint8:
            dt = "U8"
        elif arr.dtype == np.int32:
            dt = "I32"
        elif arr.dtype == np.int64:
            dt = "I64"
        else:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        blob = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as fh:
        fh.write(len(hjson).to_bytes(8, "little"))
        fh.write(hjson)
        for blob in blobs:
            fh.write(blob if isinstance(blob, bytes) else memoryview(blob))
