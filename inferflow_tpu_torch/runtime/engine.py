"""InferenceEngine: the serving facade with continuous batching (port of
inferflow_tpu/runtime/engine.py).

Same step loop as the JAX engine, run eagerly on one CUDA device:
  - a query's prompt is prefilled in one bucketed pass (length padded to a
    power of two) into a (1, bucket) temp cache that is then scattered into
    the query's slot of the shared cache;
  - prompts longer than ``prefill_chunk`` are prefilled chunk by chunk
    straight into the main cache, one chunk per engine step (kernel B3);
    while that runs the slot's length is parked at max_context_len - 1, so
    the decode steps of other slots write their throw-away row for it
    there and not over the chunk's rows;
  - one batched decode step over every slot (B = max_concurrent_queries,
    inactive slots included): the whole-model fused step (kernel B4) for
    i8mm, i4 or Q8 block weights and B <= 8 (a routed MoE stack in its
    mode (g)), else the per-layer loop (kernel B1, B5 or the i8mm product
    for the weights, B2 for attention, moe_block for a MoE layer);
  - sampling on the host (sampling/strategies.py), saturation as an
    implicit end of the query.
With ``kv_cache_paging`` the cache is a page pool (runtime/paged_kv.py) of
``kv_pool_tokens`` tokens: a query reserves the pages covering
min(prompt + max_new + 1, max_context_len) before its prefill and stays
prefill-pending while the pool cannot give them; its prompt is prefilled
whole (no chunks) and scattered into its pages; decode runs B4's paged
mode for i8mm weights and B <= 8, else the per-layer loop with kernel B7.
A finished query's pages go back to the pool and its table row is zeroed
(page 0), so its slot's throw-away rows never land in a page that a live
query owns.
``from_config`` builds the engine an EngineConfig describes, loading the
checkpoint and tokenizer from the model dir (runtime/factory.make_engine
calls it for decoder-only models).
Not ported here: host offload, speculative decoding, meshes, ring and
pipelined prefill (their options raise), CUDA graphs, and the JAX engine's
fused-step probe: if kernel B4 fails to build or launch, the step raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.decoder import (check_supported, decoder_forward,
                              decoder_layers_chunk, decoder_layers_unrolled,
                              embed_tokens, fuse_layer_weights, output_logits,
                              stack_moe_experts)
from ..models.spec import ModelSpec
from ..quant.codec_torch import Int8MXUTensor, QuantizedTensor
from ..quant.formats import is_quantized
from ..sampling.strategies import DecodingStrategies, SamplingOptions
from ..utils.logging_util import log_memory_stat
from ..utils.study import TAG_LOGITS, PerfStat, StudyMode, perf_key
from .kv_cache import KVCache
from .paged_kv import PagedKVCache, scatter_prefill_pages
from .query_state import DECODING, FINISHED, QueryState, QueryStateTable


@dataclasses.dataclass
class InferenceResult:
    """One step's outcome for one query."""

    query_id: int
    next_tokens: List[int]
    is_end: bool
    finish_reason: str = ""


def _bucket(n: int, lo: int = 16, hi: int = 4096) -> int:
    """Smallest power of two >= n, clamped to [lo, hi]."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _to_device(node, dev):
    if isinstance(node, (QuantizedTensor, Int8MXUTensor)):
        return node.to(dev)
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, dev) for v in node]
    return node.to(dev)


class InferenceEngine:
    """Single-model serving engine on one device."""

    def __init__(self, spec: ModelSpec, params: dict,
                 max_concurrent_queries: int = 8,
                 max_context_len: int = 0,
                 tokenizer=None, vocab=None,
                 kv_cache_quantized: Optional[bool] = None,
                 device="cuda",
                 cpu_layer_count: int = 0,
                 mesh=None,
                 sequence_parallel: int = 0,
                 pipeline_prefill: bool = False,
                 draft: Optional[tuple] = None,
                 kv_cache_paging: bool = False,
                 kv_pool_tokens: int = 0):
        if kv_cache_paging and (
                mesh is not None or sequence_parallel > 1
                or cpu_layer_count > 0 or spec.host_kv_cache_percent > 0
                or spec.decoder_cpu_layer_count > 0 or draft is not None):
            raise ValueError("kv_cache_paging composes with the plain "
                             "single-device engine (no device groups, "
                             "ring prefill, host offload or draft)")
        unported = {"cpu_layer_count": cpu_layer_count, "mesh": mesh,
                    "sequence_parallel": sequence_parallel,
                    "pipeline_prefill": pipeline_prefill, "draft": draft,
                    "host_kv_cache_percent": spec.host_kv_cache_percent,
                    "decoder_cpu_layer_count":
                        max(spec.decoder_cpu_layer_count, 0)}
        used = [k for k, v in unported.items() if v]
        if used:
            raise NotImplementedError(f"not ported: {', '.join(used)}")
        check_supported(spec)
        self.device = resolve_device(device)
        hp = spec.hyper_params
        layers = params["layers"]
        had_separate = all("wq" in lp["attn"] for lp in layers)
        # E-leading expert stacks: the routed decode paths index them (a
        # list of experts stays a list when its experts differ)
        layers = stack_moe_experts(fuse_layer_weights(layers))
        if had_separate and all("qkv" in lp["attn"] for lp in layers):
            spec = dataclasses.replace(spec, qkv_format=1)
        self.spec = spec
        self.params = _to_device(dict(params, layers=layers), self.device)
        self.tokenizer = tokenizer
        self.vocab = vocab
        self.max_slots = max_concurrent_queries
        self.max_context_len = max_context_len or spec.max_context_len
        if self.max_context_len <= 0:
            self.max_context_len = hp.training_context_len
        if self.max_context_len <= 0:
            self.max_context_len = 2048
        if kv_cache_quantized is None:
            kv_cache_quantized = is_quantized(spec.device_kv_cache_data_type)
        # paged: page 0 is never handed out (unassigned table entries and
        # inactive slots point at it)
        self._paging = bool(kv_cache_paging)
        self._free_pages: List[int] = []
        self._slot_pages: Dict[int, List[int]] = {}
        if self._paging:
            self.cache = PagedKVCache.create(
                hp.decoder_layers, self.max_slots, self.max_context_len,
                hp.kv_heads, hp.head_dim, pool_tokens=kv_pool_tokens,
                quantized=kv_cache_quantized, device=self.device)
            self._free_pages = list(range(1, self.cache.num_pages))
        else:
            self.cache = KVCache.create(
                hp.decoder_layers, self.max_slots, self.max_context_len,
                hp.kv_heads, hp.head_dim, quantized=kv_cache_quantized,
                device=self.device)
        self.table = QueryStateTable(self.max_slots)
        eos_ids = set()
        if vocab is not None and getattr(vocab, "eos_id", -1) >= 0:
            eos_ids.add(vocab.eos_id)
        self.strategies = DecodingStrategies(eos_ids=eos_ids)
        self.eos_ids = eos_ids
        self._lock = threading.Lock()
        self.perf_stat: Dict[str, float] = {}
        # study-mode logits dumps and per-phase perf statistics (off unless
        # from_config turns them on)
        self.study = StudyMode(enabled=False)
        self.perf = PerfStat(enabled=False)
        self.load_stats: Dict[str, float] = {}  # from_config's load times
        log_memory_stat(self.params, self.cache)
        # chunked prefill: prompts longer than one chunk take prefill_chunk
        # tokens per engine step against the main cache
        self.prefill_chunk = 256

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.int32).to(
            self.device)

    # -- steps ------------------------------------------------------------
    def _prefill_step(self, tokens: np.ndarray, length: int, bucket: int):
        """tokens (1, bucket); returns last-token logits and the temp
        cache to scatter into the slot."""
        hp = self.spec.hyper_params
        tmp = KVCache.create(hp.decoder_layers, 1, bucket, hp.kv_heads,
                             hp.head_dim, quantized=self.cache.quantized,
                             device=self.device)
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device)[None]
        logits, tmp = decoder_forward(self.spec, self.params,
                                      self._tensor(tokens), positions, tmp)
        return logits[0, length - 1], tmp

    def _chunk_step(self, tokens: np.ndarray, slot: int, start: int,
                    need_logits: bool):
        """One prefill chunk (1, C) of one slot against the main cache."""
        c = tokens.shape[1]
        positions = start + torch.arange(c, dtype=torch.int32,
                                         device=self.device)[None]
        x = embed_tokens(self.spec, self.params, self._tensor(tokens),
                         positions)
        x, _ = decoder_layers_chunk(self.spec, self.params["layers"], x,
                                    positions, self.cache, slot, start)
        if not need_logits:
            return None
        return output_logits(self.spec, self.params, x)[0]

    def _decode_step(self, tokens: np.ndarray, active: np.ndarray):
        """tokens (B, 1); active (B,) 0/1.  Returns logits (B, V)."""
        cache = self.cache
        positions = cache.length[:, None]
        x = embed_tokens(self.spec, self.params, self._tensor(tokens),
                         positions)
        x, _ = decoder_layers_unrolled(self.spec, self.params["layers"], x,
                                       positions, cache)
        logits = output_logits(self.spec, self.params, x)
        cache.with_length(cache.length + self._tensor(active))
        return logits[:, -1]

    # -- paged-pool bookkeeping (kv_cache_paging) -------------------------
    def _reserve_pages(self, qs: QueryState) -> bool:
        """Reserve the pages covering min(prompt + max_new + 1,
        max_context_len) for a pending query.  False: the pool cannot give
        them now, and the query stays prefill-pending (reserving up front
        means decode never stalls mid-stream).  Raises RuntimeError for a
        query larger than the whole pool."""
        if qs.slot in self._slot_pages:
            return True  # reserved on an earlier (deferred) attempt
        pt = self.cache.page_tokens
        want = min(len(qs.prompt_tokens) + qs.max_new_tokens + 1,
                   self.max_context_len)
        need = min(-(-want // pt), self.cache.max_pages_per_slot)
        if need > self.cache.num_pages - 1:
            raise RuntimeError(
                f"query needs {need} pages but the pool only has "
                f"{self.cache.num_pages - 1}; raise kv_pool_tokens")
        if need > len(self._free_pages):
            return False
        pids = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[qs.slot] = pids
        self.cache.with_page_row(qs.slot, pids)
        return True

    def _release_pages(self, slot: int) -> None:
        """Return a finished slot's pages to the pool and zero its table
        row (page 0, the sentinel) and its length.  The JAX engine leaves
        the row pointing at the released pages, where the idle slot's
        throw-away rows would land in a page another query may own."""
        pids = self._slot_pages.pop(slot, None)
        if pids:
            self._free_pages.extend(pids)
        self.cache.with_page_row(slot, [])
        self.cache.length[slot] = 0

    # -- public API -------------------------------------------------------
    def add_query(self, prompt: Sequence[int] | str,
                  sampling: Optional[SamplingOptions] = None,
                  max_new_tokens: int = 256) -> int:
        """Admission control.  Returns the query id, -1 when every slot is
        taken, -2 on an empty or oversized prompt."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string query but no tokenizer configured")
            tokens = self.tokenizer.tokenize(prompt, add_bos=True)
        else:
            tokens = list(prompt)
        if not tokens or len(tokens) >= self.max_context_len:
            return -2
        with self._lock:
            qid = self.table.add(tokens, sampling, max_new_tokens)
        if qid > 0:
            self.strategies.begin_query(qid, sampling or SamplingOptions())
        return qid

    def infer(self) -> List[InferenceResult]:
        """One engine step: at most one prefill (or prefill chunk), then one
        batched decode step over every decoding slot."""
        t0 = time.perf_counter()
        results: List[InferenceResult] = []
        with self._lock:
            pending = self.table.prefill_pending()
        if pending and self._paging and not self._reserve_pages(pending[0]):
            pending = []  # pool exhausted; retry when queries release pages
        if pending:
            qs = pending[0]
            tokens = qs.prompt_tokens
            # paged: the whole prompt into a dense temp cache, then pages
            if len(tokens) > self.prefill_chunk and not self._paging:
                c = self.prefill_chunk
                start = qs.prefill_pos
                if start == 0:
                    self.cache.length[qs.slot] = self.max_context_len - 1
                n = min(c, len(tokens) - start)
                chunk = np.zeros((1, c), np.int32)
                chunk[0, :n] = tokens[start:start + n]
                done = start + n >= len(tokens)
                logits = self._chunk_step(chunk, qs.slot, start, done)
                qs.prefill_pos = start + n
                if done:
                    self.cache.length[qs.slot] = len(tokens)
                    self._finish_prefill(
                        qs, logits[n - 1].cpu().numpy(), results)
            else:
                bucket = _bucket(len(tokens), hi=self.max_context_len)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :len(tokens)] = tokens
                last_logits, tmp = self._prefill_step(padded, len(tokens),
                                                      bucket)
                if self._paging:
                    pids = self._slot_pages[qs.slot]
                    n_copy = min(-(-len(tokens) // self.cache.page_tokens),
                                 len(pids))
                    scatter_prefill_pages(self.cache, tmp, pids[:n_copy],
                                          len(tokens), qs.slot)
                else:
                    self.cache.scatter_slot(tmp, qs.slot, len(tokens))
                self._finish_prefill(qs, last_logits.cpu().numpy(), results)
            self.perf_stat["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            self.perf.add(perf_key(-1, 1), self.perf_stat["prefill_ms"])

        with self._lock:
            # a query prefilled this step already produced its token
            done_ids = {r.query_id for r in results}
            decoding = [q for q in self.table.decoding()
                        if q.query_id not in done_ids]
        if decoding:
            t1 = time.perf_counter()
            tokens = np.zeros((self.max_slots, 1), np.int32)
            active = np.zeros((self.max_slots,), np.int32)
            by_slot: Dict[int, QueryState] = {}
            for qs in decoding:
                tokens[qs.slot, 0] = (qs.generated[-1] if qs.generated
                                      else qs.prompt_tokens[-1])
                active[qs.slot] = 1
                by_slot[qs.slot] = qs
            rows = self._decode_step(tokens, active).cpu().numpy()
            for slot, qs in by_slot.items():
                self.study.dump(TAG_LOGITS, rows[slot],
                                name=f"decode q{qs.query_id}")
                tok = self.strategies.choose_token(
                    qs.query_id, rows[slot], qs.prompt_tokens + qs.generated)
                results.append(self._make_result(qs, tok))
            self.perf_stat["decode_ms"] = (time.perf_counter() - t1) * 1e3
            self.perf.add(perf_key(-1, 2), self.perf_stat["decode_ms"])
        return results

    @classmethod
    def from_config(cls, config, model_index: int = 0,
                    device="cuda") -> "InferenceEngine":
        """A loaded engine from an EngineConfig (the JAX package's
        InferenceEngine.from_config; the Init facade,
        inference_engine.cc:43-229), on `device`: the card unless the
        caller passes "cpu".  Loads the model's checkpoint
        (loaders/model_loader.load_model) and tokenizer
        (tokenizer/loading.load_tokenizer), and wires the config's slots,
        context, paging, prefill budget (max_batch_tokens -> prefill_chunk)
        and the study and perf flags.  Device groups of more than one
        device (meshes, ROADMAP A item 10) raise NotImplementedError, as
        do the other options the engine has not ported."""
        from ..loaders.model_loader import load_model
        from ..tokenizer.loading import load_tokenizer

        groups = config.device_groups or [[0]]
        if len(groups) > 1 or any(len(g) > 1 for g in groups):
            raise NotImplementedError(
                f"device groups {groups}: serving over more than one device "
                "is not ported (ROADMAP A item 10)")
        spec = config.models[model_index]
        load_stats: Dict[str, float] = {}
        params = load_model(spec, device=device, stats=load_stats)
        tok = load_tokenizer(spec)
        eng = cls(spec, params,
                  max_concurrent_queries=config.max_concurrent_queries,
                  max_context_len=spec.max_context_len,
                  tokenizer=tok, vocab=tok.vocab if tok else None,
                  device=device,
                  cpu_layer_count=max(config.decoder_cpu_layer_count, 0),
                  sequence_parallel=config.sequence_parallel,
                  pipeline_prefill=config.pipeline_prefill,
                  kv_cache_paging=config.kv_cache_paging,
                  kv_pool_tokens=config.kv_pool_tokens)
        eng.load_stats = load_stats
        eng.study = StudyMode(enabled=config.is_study_mode,
                              show_tensors=config.show_tensors)
        eng.perf = PerfStat(enabled=config.enable_perf_stat)
        if config.max_batch_tokens > 0:
            # the reference's max_token_num prefill budget per step
            eng.prefill_chunk = config.max_batch_tokens
        return eng

    def _finish_prefill(self, qs: QueryState, row: np.ndarray,
                        results: list) -> None:
        self.study.dump(TAG_LOGITS, row, name=f"prefill q{qs.query_id}")
        tok = self.strategies.choose_token(qs.query_id, row,
                                           qs.prompt_tokens)
        results.append(self._make_result(qs, tok))
        qs.phase = DECODING

    def _make_result(self, qs: QueryState, tok: int) -> InferenceResult:
        is_eos = tok in self.eos_ids
        saturated = (qs.context_len + 1 >= self.max_context_len
                     or len(qs.generated) + 1 >= qs.max_new_tokens)
        reason = "eos" if is_eos else ("length" if saturated else "")
        return InferenceResult(qs.query_id, [tok], is_eos or saturated,
                               reason)

    def commit_inference_result(self, results: List[InferenceResult]) -> None:
        """Append accepted tokens and finish ended queries."""
        with self._lock:
            for r in results:
                qs = self.table.get(r.query_id)
                if qs is None or qs.phase == FINISHED:
                    continue
                for t in r.next_tokens:
                    if t not in self.eos_ids:
                        qs.generated.append(t)
                if r.is_end:
                    if self._paging:
                        self._release_pages(qs.slot)
                    self.table.finish(r.query_id, r.finish_reason)
                    self.strategies.end_query(r.query_id)

    def _cache_arrays(self) -> list:
        c = self.cache
        return [a for a in (c.k, c.v, c.k_scale, c.v_scale) if a is not None]

    def warmup(self, buckets=None) -> None:
        """Build the kernels and run each kind of step once (a port of the
        JAX engine's warmup, which compiles its prefill programs), so that
        the first request does not pay the build: one bucketed prefill per
        bucket (16, 64 and 256, at most the context and the prefill chunk),
        one prefill chunk when prompts can exceed a chunk (dense cache),
        and one decode step over every slot.  The query table, the cache
        (its rows and lengths) and the page pool are left as they were:
        the rows the chunk and the decode step write are saved first and
        written back."""
        if self.device.type == "cuda":
            from ..kernels import _build
            _build.build()
        for b in buckets or (16, 64, 256):
            b = min(b, _bucket(self.max_context_len, hi=self.max_context_len))
            if b > self.max_context_len or b > self.prefill_chunk:
                continue
            self._prefill_step(np.zeros((1, b), np.int32), 1, b)
        cache = self.cache
        lengths = cache.length.clone()
        arrays = self._cache_arrays()
        if self.max_context_len > self.prefill_chunk and not self._paging:
            c = self.prefill_chunk
            saved = [a[:, 0, :, :c].clone() for a in arrays]
            self._chunk_step(np.zeros((1, c), np.int32), 0, 0, True)
            for a, rows in zip(arrays, saved):
                a[:, 0, :, :c] = rows
        # the decode step writes one row per slot: at its length (clamped),
        # through the page table when paged
        if self._paging:
            at = cache._row_address(lengths)
        else:
            at = (torch.arange(self.max_slots, device=self.device),
                  lengths.to(device=self.device, dtype=torch.long).clamp(
                      0, cache.max_len - 1))
        saved = [a[:, at[0], :, at[1]].clone() for a in arrays]
        self._decode_step(np.zeros((self.max_slots, 1), np.int32),
                          np.zeros((self.max_slots,), np.int32))
        for a, rows in zip(arrays, saved):
            a[:, at[0], :, at[1]] = rows
        cache.with_length(lengths)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.table.active)

    def query_tokens(self, qid: int) -> List[int]:
        qs = self.table.get(qid)
        return list(qs.generated) if qs else []

    def generate(self, prompt: Sequence[int] | str,
                 sampling: Optional[SamplingOptions] = None,
                 max_new_tokens: int = 64) -> List[int]:
        """One-query convenience loop."""
        qid = self.add_query(prompt, sampling, max_new_tokens)
        if qid < 0:
            raise RuntimeError(f"add_query failed: {qid}")
        while True:
            self.commit_inference_result(self.infer())
            qs = self.table.get(qid)
            if qs is None or qs.phase == FINISHED:
                break
        return self.query_tokens(qid)
