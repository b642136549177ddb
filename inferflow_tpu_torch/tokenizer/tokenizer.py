"""Text tokenizer: BPE (score- or merge-rank-based) and trie-backed forward
maximum matching, with byte fallback.

A copy of inferflow_tpu/tokenizer/tokenizer.py (no JAX in it), kept so
that this package imports nothing of the JAX one.

Reference: src/common/text_tokenizer.{h,cc} — algorithms Std/FMM/FMM2/BPE
(text_tokenizer.h:16-24); the BPE is the sentencepiece-style best-bigram
loop with scores from vocab entries or 1/(1+merge_rank)
(text_tokenizer.cc:103-256).
"""

from __future__ import annotations

import heapq
from typing import List, Optional

from .vocab import Vocabulary

UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def _utf8_len(b: int) -> int:
    return UTF8_LEN[b >> 4]


class Tokenizer:
    def __init__(self, vocab: Vocabulary, algorithm: str = "bpe"):
        self.vocab = vocab
        self.algorithm = algorithm.lower()
        if vocab.byte_token_id_start < 0:
            vocab.find_byte_token_start()
        self._trie = None

    # -- public API --------------------------------------------------------

    def tokenize(self, text: str, add_bos: bool = False,
                 algorithm: Optional[str] = None) -> List[int]:
        alg = (algorithm or self.algorithm).lower()
        out: List[int] = []
        if add_bos:
            out.append(self.vocab.bos_id)
        if not text:
            return out
        data = text.encode("utf-8")
        if alg in ("fmm", "fmm2"):
            out.extend(self._fmm(data))
        else:
            out.extend(self._bpe(data))
        return out

    def decode(self, ids: List[int], skip_special: bool = True) -> str:
        return self.vocab.decode(ids, skip_special)

    # -- BPE ---------------------------------------------------------------

    def _bigram_score(self, left: bytes, right: bytes):
        """Score for merging (left, right); None if not mergeable
        (TryAddBigram, text_tokenizer.cc:211-255)."""
        v = self.vocab
        if v.merge_map:
            rank = v.merge_map.get((left, right))
            if rank is None:
                return None
            return 1.0 / (1 + rank)
        tid = v.str_to_id.get(left + right)
        if tid is None or tid >= len(v.tokens):
            return None
        return v.tokens[tid].score

    def _bpe(self, data: bytes) -> List[int]:
        # initial symbols: one per utf-8 character
        starts: List[int] = []
        lens: List[int] = []
        off = 0
        n = len(data)
        while off < n:
            ln = min(n - off, _utf8_len(data[off]))
            starts.append(off)
            lens.append(ln)
            off += ln
        count = len(starts)
        prev = list(range(-1, count - 1))
        nxt = [i + 1 if i + 1 < count else -1 for i in range(count)]

        heap = []  # (-score, left_index, size)
        serial = 0

        def try_add(li: int, ri: int):
            nonlocal serial
            if li < 0 or ri < 0:
                return
            left = data[starts[li]:starts[li] + lens[li]]
            right = data[starts[ri]:starts[ri] + lens[ri]]
            score = self._bigram_score(left, right)
            if score is None:
                return
            heapq.heappush(heap, (-score, serial, li, ri, lens[li] + lens[ri]))
            serial += 1

        for i in range(1, count):
            try_add(i - 1, i)

        while heap:
            _, _, li, ri, size = heapq.heappop(heap)
            if lens[li] == 0 or lens[ri] == 0 or lens[li] + lens[ri] != size:
                continue
            lens[li] += lens[ri]
            lens[ri] = 0
            nxt[li] = nxt[ri]
            if nxt[ri] >= 0:
                prev[nxt[ri]] = li
            try_add(prev[li], li)
            try_add(li, nxt[li])

        out: List[int] = []
        v = self.vocab
        idx = 0
        while idx != -1:
            if lens[idx] > 0:
                piece = data[starts[idx]:starts[idx] + lens[idx]]
                tid = v.str_to_id.get(piece)
                if tid is None:
                    # byte fallback (text_tokenizer.cc:168-174)
                    base = v.byte_token_id_start
                    for b in piece:
                        out.append((base + b) if base >= 0 else v.unk_id)
                else:
                    out.append(tid)
            idx = nxt[idx]
        return out

    # -- FMM ---------------------------------------------------------------

    def _build_trie(self):
        trie = {}
        for tok in self.vocab.tokens:
            node = trie
            for b in tok.str:
                node = node.setdefault(b, {})
            node[-1] = tok.id
        self._trie = trie

    def _fmm(self, data: bytes) -> List[int]:
        """Forward maximum matching over the token trie
        (text_tokenizer.cc:59-102)."""
        if self._trie is None:
            self._build_trie()
        out: List[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            node = self._trie
            best_id, best_len = -1, 0
            ln = 0
            p = pos
            while p < n and data[p] in node:
                node = node[data[p]]
                p += 1
                ln += 1
                if -1 in node:
                    best_id, best_len = node[-1], ln
            if best_len > 0:
                out.append(best_id)
                pos += best_len
            else:
                pos += 1
        return out
