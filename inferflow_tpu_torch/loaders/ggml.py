"""Legacy GGML/GGMF/GGJT checkpoint reader (pre-GGUF llama.cpp format).

A copy of inferflow_tpu/loaders/ggml.py (no JAX in it), kept so that this
package imports nothing of the JAX one.

reference: ModelReader::LoadModel_GGML (src/transformer/
model_reader.cc:2523-2746).  Containers:
  'ggml' (0x67676d6c, unversioned, no scores)  — oldest
  'ggmf' (0x67676d66, v1, scored vocab)
  'ggjt' (0x67676a74, v1-3, scored vocab, 32-byte aligned tensor data)
Layout: magic [version] hparams(7 x i32) vocab tensors*.
Quantized tensor blocks reuse the ggml classic codecs from loaders/gguf.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

from .gguf import _DENSE, _QBLOCK, _dequant_block_rows

MAGIC_GGML = 0x67676D6C
MAGIC_GGMF = 0x67676D66
MAGIC_GGJT = 0x67676A74


class GGMLFile:
    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.pos = 0
        magic = self._u32()
        if magic not in (MAGIC_GGML, MAGIC_GGMF, MAGIC_GGJT):
            raise ValueError(f"{path}: not a GGML checkpoint "
                             f"(magic {magic:#x})")
        self.magic = magic
        self.version = self._u32() if magic != MAGIC_GGML else 0
        (self.n_vocab, self.n_embd, self.n_mult, self.n_head, self.n_layer,
         self.n_rot, self.ftype) = struct.unpack_from("<7i", self._mm,
                                                      self.pos)
        self.pos += 28
        self.vocab = self._read_vocab()
        self._tensor_index: Dict[str, dict] = {}
        self._index_tensors()

    def _u32(self) -> int:
        v = struct.unpack_from("<I", self._mm, self.pos)[0]
        self.pos += 4
        return v

    def _read_vocab(self):
        toks = []
        scored = self.magic != MAGIC_GGML
        for _ in range(self.n_vocab):
            ln = self._u32()
            s = bytes(self._mm[self.pos:self.pos + ln])
            self.pos += ln
            score = 0.0
            if scored:
                score = struct.unpack_from("<f", self._mm, self.pos)[0]
                self.pos += 4
            toks.append((s, score))
        return toks

    def _index_tensors(self):
        mm = self._mm
        end = len(mm)
        while self.pos + 12 <= end:
            n_dims, name_len, ttype = struct.unpack_from("<3I", mm, self.pos)
            self.pos += 12
            dims = list(struct.unpack_from(f"<{n_dims}i", mm, self.pos))
            self.pos += 4 * n_dims
            name = bytes(mm[self.pos:self.pos + name_len]).decode(
                "utf-8", "replace")
            self.pos += name_len
            if self.magic == MAGIC_GGJT:
                self.pos = (self.pos + 31) // 32 * 32
            n_elems = int(np.prod(dims))
            nbytes = self._tensor_nbytes(ttype, n_elems)
            self._tensor_index[name] = {"dims": dims, "type": ttype,
                                        "offset": self.pos,
                                        "nbytes": nbytes}
            self.pos += nbytes

    @staticmethod
    def _tensor_nbytes(ttype: int, n_elems: int) -> int:
        if ttype in _DENSE:
            return n_elems * _DENSE[ttype][1]
        if ttype in _QBLOCK:
            be, bb = _QBLOCK[ttype]
            return (n_elems // be) * bb
        raise ValueError(f"unsupported ggml tensor type {ttype}")

    def names(self):
        return list(self._tensor_index)

    def tensor(self, name: str) -> np.ndarray:
        info = self._tensor_index[name]
        dims = info["dims"]
        ttype = info["type"]
        n_elems = int(np.prod(dims))
        start = info["offset"]
        shape = tuple(reversed(dims))  # ggml ne[] order -> row major
        if ttype in _DENSE:
            dt, _ = _DENSE[ttype]
            # copy: don't hand out views of the mmap (closed by iterators)
            return np.frombuffer(self._mm, dt, n_elems,
                                 start).reshape(shape).copy()
        raw = np.frombuffer(self._mm, np.uint8, info["nbytes"], start)
        return _dequant_block_rows(ttype, raw, n_elems).reshape(shape)

    def close(self):
        self._mm.close()
        self._file.close()


def load_ggml(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    f = GGMLFile(path)
    try:
        for name in f.names():
            yield name, f.tensor(name)
    finally:
        f.close()
