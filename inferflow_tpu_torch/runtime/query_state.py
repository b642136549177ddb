"""Per-query state + slot table for continuous batching (a copy of
inferflow_tpu/runtime/query_state.py, kept so that the PyTorch package
imports nothing of the JAX one).

reference: src/transformer/query_state_table.{h,cc} — QueryState carries
encoder/decoder token lists, accepted prefix tokens and a proc-slot id;
QueryStateTable::Get assembles compatible batches under token budgets;
Update commits sampled tokens.  Here the "batch" is implicit: every active
slot decodes each engine step (static shapes for XLA), and prefill runs
one bucketed query at a time into its slot of the shared KV cache.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

from ..sampling.strategies import SamplingOptions

# query phases
WAITING = "waiting"
PREFILL = "prefill"  # admitted, prompt not yet processed
DECODING = "decoding"
FINISHED = "finished"


@dataclasses.dataclass
class QueryState:
    query_id: int
    prompt_tokens: List[int]
    max_new_tokens: int = 256
    sampling: SamplingOptions = dataclasses.field(
        default_factory=SamplingOptions)
    # encoder-decoder: encoder input tokens (next_net==0 until encoded)
    encoder_tokens: Optional[List[int]] = None
    encoder_done: bool = False

    slot: int = -1
    phase: str = WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""
    # chunked prefill: prompt tokens already written to the KV cache
    # (reference GetLocalInput's per-query prefix_len bookkeeping)
    prefill_pos: int = 0

    @property
    def context_len(self) -> int:
        return len(self.prompt_tokens) + len(self.generated)


class QueryStateTable:
    """Slot allocator + per-query state registry
    (reference query_state_table.h:50, max proc slots = the engine's
    max_concurrent_queries)."""

    def __init__(self, max_slots: int = 16):
        self.max_slots = max_slots
        self._slots: List[Optional[int]] = [None] * max_slots
        self._queries: Dict[int, QueryState] = {}
        self._next_id = itertools.count(1)

    def __len__(self):
        return len(self._queries)

    @property
    def active(self) -> List[QueryState]:
        return [q for q in self._queries.values()
                if q.phase in (PREFILL, DECODING)]

    def add(self, prompt_tokens: List[int],
            sampling: Optional[SamplingOptions] = None,
            max_new_tokens: int = 256,
            encoder_tokens: Optional[List[int]] = None) -> int:
        """Admit a query; returns query_id or -1 when no slot is free
        (reference AddQuery admission control,
        inference_engine.cc:285-406)."""
        slot = next((i for i, s in enumerate(self._slots) if s is None), -1)
        if slot < 0:
            return -1
        qid = next(self._next_id)
        qs = QueryState(query_id=qid, prompt_tokens=list(prompt_tokens),
                        max_new_tokens=max_new_tokens,
                        sampling=sampling or SamplingOptions(),
                        encoder_tokens=encoder_tokens,
                        slot=slot, phase=PREFILL)
        self._slots[slot] = qid
        self._queries[qid] = qs
        return qid

    def get(self, qid: int) -> Optional[QueryState]:
        return self._queries.get(qid)

    def prefill_pending(self) -> List[QueryState]:
        return [q for q in self._queries.values() if q.phase == PREFILL]

    def decoding(self) -> List[QueryState]:
        return [q for q in self._queries.values() if q.phase == DECODING]

    def finish(self, qid: int, reason: str) -> None:
        qs = self._queries.get(qid)
        if qs is None:
            return
        qs.phase = FINISHED
        qs.finish_reason = reason
        if 0 <= qs.slot < self.max_slots:
            self._slots[qs.slot] = None

    def remove(self, qid: int) -> None:
        qs = self._queries.pop(qid, None)
        if qs and 0 <= qs.slot < self.max_slots and \
                self._slots[qs.slot] == qid:
            self._slots[qs.slot] = None
