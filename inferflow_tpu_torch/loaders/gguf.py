"""GGUF checkpoint reader (llama.cpp format), from scratch.

A copy of inferflow_tpu/loaders/gguf.py (no JAX in it), kept so that this
package imports nothing of the JAX one.

reference: the GGUF attribute/tensor-table/vocab parser in
src/transformer/model_reader.cc:2748-3247.  Covers GGUF v1-v3 headers,
all metadata value types, and the common ggml tensor dtypes (F32/F16 and
the classic quant blocks Q4_0/Q4_1/Q5_0/Q5_1/Q8_0, dequantized on read —
our engine re-quantizes into its own TPU block formats).
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12

# ggml tensor dtypes (ggml.h GGML_TYPE_*)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_BF16 = 30

_DENSE = {GGML_F32: (np.float32, 4), GGML_F16: (np.float16, 2),
          GGML_I8: (np.int8, 1), GGML_I16: (np.int16, 2),
          GGML_I32: (np.int32, 4)}

# (block_elems, block_bytes) for supported quant types
_QBLOCK = {GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20), GGML_Q5_0: (32, 22),
           GGML_Q5_1: (32, 24), GGML_Q8_0: (32, 34)}


class _Reader:
    def __init__(self, mm, version: int):
        self.mm = mm
        self.pos = 0
        self.version = version

    def u(self, fmt: str, size: int):
        v = struct.unpack_from(fmt, self.mm, self.pos)[0]
        self.pos += size
        return v

    def u32(self):
        return self.u("<I", 4)

    def u64(self):
        # GGUF v1 used u32 lengths/counts
        return self.u("<I", 4) if self.version == 1 else self.u("<Q", 8)

    def string(self) -> str:
        n = self.u64()
        s = self.mm[self.pos:self.pos + n].decode("utf-8", "replace")
        self.pos += n
        return s

    def value(self, vtype: int) -> Any:
        if vtype == _T_U8:
            return self.u("<B", 1)
        if vtype == _T_I8:
            return self.u("<b", 1)
        if vtype == _T_U16:
            return self.u("<H", 2)
        if vtype == _T_I16:
            return self.u("<h", 2)
        if vtype == _T_U32:
            return self.u32()
        if vtype == _T_I32:
            return self.u("<i", 4)
        if vtype == _T_F32:
            return self.u("<f", 4)
        if vtype == _T_BOOL:
            return bool(self.u("<B", 1))
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            etype = self.u32()
            count = self.u64()
            return [self.value(etype) for _ in range(count)]
        if vtype == _T_U64:
            return self.u("<Q", 8)
        if vtype == _T_I64:
            return self.u("<q", 8)
        if vtype == _T_F64:
            return self.u("<d", 8)
        raise ValueError(f"bad gguf value type {vtype}")


def _dequant_block_rows(dtype: int, raw: np.ndarray, n_elems: int) -> np.ndarray:
    """Dequantize ggml classic blocks to f32 (ggml quant layouts)."""
    be, bb = _QBLOCK[dtype]
    blocks = raw.reshape(-1, bb)
    nb = blocks.shape[0]
    if dtype == GGML_Q8_0:
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        q = blocks[:, 2:34].copy().view(np.int8).astype(np.float32)
        out = q * d
    elif dtype in (GGML_Q4_0, GGML_Q4_1):
        off = 2 if dtype == GGML_Q4_0 else 4
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        qs = blocks[:, off:off + 16]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)  # ggml: low nibbles then high
        if dtype == GGML_Q4_0:
            out = (q - 8.0) * d
        else:
            m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
            out = q * d + m
    elif dtype in (GGML_Q5_0, GGML_Q5_1):
        off = 2 if dtype == GGML_Q5_0 else 4
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        qh = blocks[:, off:off + 4].copy().view(np.uint32).reshape(nb, 1)
        qs = blocks[:, off + 4:off + 20]
        lo = (qs & 0x0F).astype(np.uint16)
        hi = (qs >> 4).astype(np.uint16)
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> shifts) & 1).astype(np.uint16)
        q = np.concatenate([lo, hi], axis=1) | (hbits << 4)
        q = q.astype(np.float32)
        if dtype == GGML_Q5_0:
            out = (q - 16.0) * d
        else:
            m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
            out = q * d + m
    else:
        raise ValueError(f"unsupported ggml quant type {dtype}")
    return out.reshape(-1)[:n_elems]


class GGUFFile:
    """Parsed GGUF: metadata dict + lazy tensor access."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = struct.unpack_from("<I", self._mm, 4)[0]
        if version > 3:
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        r = _Reader(self._mm, version)
        r.pos = 8
        self.version = version
        tensor_count = r.u64()
        kv_count = r.u64()
        self.metadata: Dict[str, Any] = {}
        for _ in range(kv_count):
            key = r.string()
            vtype = r.u32()
            self.metadata[key] = r.value(vtype)
        self.tensors: Dict[str, dict] = {}
        order: List[str] = []
        for _ in range(tensor_count):
            name = r.string()
            n_dims = r.u32()
            # GGUF dims are stored innermost-first (ggml ne[] order)
            dims = [r.u64() for _ in range(n_dims)]
            ttype = r.u32()
            offset = r.u64()
            self.tensors[name] = {"dims": dims, "type": ttype,
                                  "offset": offset}
            order.append(name)
        align = int(self.metadata.get("general.alignment", 32))
        self._data_start = (r.pos + align - 1) // align * align

    def names(self) -> List[str]:
        return list(self.tensors)

    def tensor(self, name: str) -> np.ndarray:
        """Read one tensor as numpy, shape in row-major (outermost-first)
        order — the reverse of the stored ggml ne[] dims."""
        info = self.tensors[name]
        dims = info["dims"]
        ttype = info["type"]
        n_elems = int(np.prod(dims)) if dims else 1
        start = self._data_start + info["offset"]
        shape = tuple(reversed(dims))
        if ttype == GGML_BF16:
            raw = np.frombuffer(self._mm, np.uint16, n_elems, start)
            return ((raw.astype(np.uint32) << 16).view(np.float32)
                    ).reshape(shape)
        if ttype in _DENSE:
            dt, isz = _DENSE[ttype]
            # copy: frombuffer would return a zero-copy view of the mmap,
            # which consumers may hold after close() (e.g. loader threads)
            return np.frombuffer(self._mm, dt, n_elems,
                                 start).reshape(shape).copy()
        if ttype in _QBLOCK:
            be, bb = _QBLOCK[ttype]
            nbytes = (n_elems // be) * bb
            raw = np.frombuffer(self._mm, np.uint8, nbytes, start)
            return _dequant_block_rows(ttype, raw, n_elems).reshape(shape)
        raise ValueError(f"{name}: unsupported ggml tensor type {ttype}")

    def vocab(self) -> dict:
        """Extract tokenizer data from GGUF metadata
        (model_reader.cc GGUF vocab path)."""
        md = self.metadata
        return {
            "model": md.get("tokenizer.ggml.model", "llama"),
            "tokens": md.get("tokenizer.ggml.tokens", []),
            "scores": md.get("tokenizer.ggml.scores", []),
            "token_type": md.get("tokenizer.ggml.token_type", []),
            "merges": md.get("tokenizer.ggml.merges", []),
            "bos_id": md.get("tokenizer.ggml.bos_token_id", -1),
            "eos_id": md.get("tokenizer.ggml.eos_token_id", -1),
            "unk_id": md.get("tokenizer.ggml.unknown_token_id", -1),
            "pad_id": md.get("tokenizer.ggml.padding_token_id", -1),
        }

    def close(self):
        self._mm.close()
        self._file.close()


def load_gguf(path: str):
    """Stream (name, array) pairs plus (metadata, vocab)."""
    f = GGUFFile(path)
    try:
        for name in f.names():
            yield name, f.tensor(name)
    finally:
        f.close()
