"""Vocabulary (reference: StdVocabulary, src/common/std_vocabulary.h:15).

A copy of inferflow_tpu/tokenizer/vocab.py (no JAX in it), kept so that
this package imports nothing of the JAX one.

Token array with string/score/type, str<->id maps, BPE merge ranks,
special tokens (incl. a multi-EOS set), and byte-fallback token range.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class Token:
    id: int
    str: bytes
    score: float = 0.0
    type: int = 0  # 0 normal, 1 invalid, 2 control, 3 byte


@dataclasses.dataclass
class Vocabulary:
    tokens: List[Token] = dataclasses.field(default_factory=list)
    str_to_id: Dict[bytes, int] = dataclasses.field(default_factory=dict)
    merge_map: Dict[Tuple[bytes, bytes], int] = dataclasses.field(default_factory=dict)
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    mask_id: int = -1
    eos_set: Set[int] = dataclasses.field(default_factory=set)
    byte_token_id_start: int = -1

    def __len__(self):
        return len(self.tokens)

    @property
    def size(self):
        return len(self.tokens)

    def add(self, s: bytes, score: float = 0.0, ttype: int = 0) -> int:
        tid = len(self.tokens)
        self.tokens.append(Token(tid, s, score, ttype))
        if s not in self.str_to_id:
            self.str_to_id[s] = tid
        return tid

    def token_str(self, tid: int) -> bytes:
        if 0 <= tid < len(self.tokens):
            return self.tokens[tid].str
        return b""

    def is_eos(self, tid: int) -> bool:
        return tid == self.eos_id or tid in self.eos_set

    def find_byte_token_start(self) -> int:
        """Locate the <0x00>..<0xFF> byte-fallback run, if present."""
        zero = self.str_to_id.get(b"<0x00>")
        if zero is not None and self.str_to_id.get(b"<0xFF>") == zero + 255:
            self.byte_token_id_start = zero
        return self.byte_token_id_start

    def id_to_bytes(self, tid: int) -> bytes:
        """Token id -> output bytes, resolving byte-fallback tokens."""
        s = self.token_str(tid)
        if (self.byte_token_id_start >= 0
                and self.byte_token_id_start <= tid < self.byte_token_id_start + 256):
            return bytes([tid - self.byte_token_id_start])
        if len(s) == 6 and s.startswith(b"<0x") and s.endswith(b">"):
            try:
                return bytes([int(s[3:5], 16)])
            except ValueError:
                pass
        return s

    def decode(self, ids: List[int], skip_special: bool = True) -> str:
        out = bytearray()
        for tid in ids:
            if skip_special and (tid == self.bos_id or self.is_eos(tid)
                                 or tid == self.pad_id):
                continue
            out += self.id_to_bytes(tid)
        text = out.decode("utf-8", errors="replace")
        # sentencepiece-style visible space
        return text.replace("▁", " ")
