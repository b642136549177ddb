"""Decoding strategy registry + per-query sampling state (a copy of
inferflow_tpu/sampling/strategies.py, kept so that the PyTorch package
imports nothing of the JAX one).

Covers the reference's DecodingStrategyId surface (reference:
src/transformer/sampling_strategy.h:55-68): Greedy, TopK, TopP, FSD,
RandomizedFSD, MinP, TFS, Typical, Mirostat — all operating on one logits
row per query, with per-query state created by `begin_query` (JSON-style
config, rng seed, temperature; sampling_strategy.h:72-118) and the
`eos_bypassing_max` escape hatch of the standard strategy
(sampling_strategy.cc StdSamplingStrategy).

Host-side numpy on a single (vocab,) row — the device copies back one row
per query per step exactly as the reference does
(inference_engine.cc:1986-2106).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

STRATEGY_IDS = ("greedy", "top_k", "top_p", "fsd", "randomized_fsd",
                "min_p", "tfs", "typical", "mirostat")

_ALIASES = {
    "sample.top_k": "top_k",
    "sample.top_p": "top_p",
    "topk": "top_k",
    "topp": "top_p",
    "std": "top_p",
    "sample": "top_p",
    "minp": "min_p",
    "tail_free": "tfs",
    "typical_p": "typical",
    "random_fsd": "randomized_fsd",
}


def get_strategy_id(name: str) -> str:
    """reference: DecodingStrategies::GetId (decoding_strategies.cc)."""
    key = (name or "").strip().lower()
    key = _ALIASES.get(key, key)
    if not key:
        return "top_p"
    if key not in STRATEGY_IDS:
        raise KeyError(f"unknown decoding strategy: {name}")
    return key


@dataclasses.dataclass
class SamplingOptions:
    """Per-query decoding configuration.

    `strategy` may carry inline JSON (the reference allows the ini value
    `decoding_strategy` to be a JSON object selecting + configuring the
    strategy, inference_engine.cc:1590-1626)."""

    strategy: str = "top_p"
    temperature: float = 1.0
    seed: int = 0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 0.95
    typical_p: float = 0.95
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    mirostat_m: int = 100
    # FSD: n-gram penalized contrastive decoding
    fsd_alpha: float = 0.4
    fsd_k: int = 6
    fsd_n: int = 3
    eos_bypassing_max: int = 0

    @classmethod
    def from_strategy_string(cls, s: str, **overrides) -> "SamplingOptions":
        opts = cls(**overrides)
        s = (s or "").strip()
        if s.startswith("{"):
            cfg = json.loads(s)
            name = cfg.pop("name", cfg.pop("strategy", "top_p"))
            opts.strategy = get_strategy_id(str(name))
            for key, val in cfg.items():
                if hasattr(opts, key):
                    setattr(opts, key, type(getattr(opts, key))(val))
        elif s:
            opts.strategy = get_strategy_id(s)
        return opts


@dataclasses.dataclass
class _QueryState:
    opts: SamplingOptions
    rng: np.random.Generator
    mirostat_mu: float = 0.0
    eos_bypassed: int = 0


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    e = np.exp(x, dtype=np.float64)
    return e / e.sum()


def _apply_temperature(logits: np.ndarray, t: float) -> np.ndarray:
    if t <= 0 or abs(t - 1.0) < 1e-6:
        return logits
    return logits / t


def _top_k_filter(probs: np.ndarray, k: int) -> np.ndarray:
    if k <= 0 or k >= probs.size:
        return probs
    kth = np.partition(probs, -k)[-k]
    out = np.where(probs >= kth, probs, 0.0)
    return out


def _top_p_filter(probs: np.ndarray, p: float) -> np.ndarray:
    if p >= 1.0:
        return probs
    order = np.argsort(-probs)
    sorted_p = probs[order]
    csum = np.cumsum(sorted_p)
    # keep the smallest prefix whose mass reaches p (always >= 1 token)
    cut = int(np.searchsorted(csum, p) + 1)
    mask = np.zeros_like(probs)
    mask[order[:cut]] = 1.0
    return probs * mask


def _min_p_filter(probs: np.ndarray, min_p: float) -> np.ndarray:
    if min_p <= 0:
        return probs
    return np.where(probs >= probs.max() * min_p, probs, 0.0)


def _tfs_filter(probs: np.ndarray, z: float) -> np.ndarray:
    """Tail-free sampling: drop the low-curvature tail of the sorted
    distribution (second-derivative mass below z)."""
    if z >= 1.0 or probs.size < 3:
        return probs
    order = np.argsort(-probs)
    sp = probs[order]
    d2 = np.abs(np.diff(sp, n=2))
    total = d2.sum()
    if total < 1e-12:
        return probs
    w = d2 / total
    csum = np.cumsum(w)
    cut = int(np.searchsorted(csum, z) + 1)
    cut = max(1, min(cut + 1, probs.size))  # d2 index i covers tokens [0, i+2)
    mask = np.zeros_like(probs)
    mask[order[:cut + 1]] = 1.0
    return probs * mask


def _typical_filter(probs: np.ndarray, p: float) -> np.ndarray:
    """Locally typical sampling: keep tokens whose surprisal is closest to
    the distribution entropy until mass p is covered."""
    if p >= 1.0:
        return probs
    nz = np.maximum(probs, 1e-12)
    surprisal = -np.log(nz)
    entropy = float((probs * surprisal).sum())
    dist = np.abs(surprisal - entropy)
    order = np.argsort(dist)
    csum = np.cumsum(probs[order])
    cut = int(np.searchsorted(csum, p) + 1)
    mask = np.zeros_like(probs)
    mask[order[:cut]] = 1.0
    return probs * mask


def _sample(probs: np.ndarray, rng: np.random.Generator) -> int:
    total = probs.sum()
    if total <= 0:
        return int(probs.argmax())
    return int(rng.choice(probs.size, p=probs / total))


def _ngram_penalties(prev_tokens: Sequence[int], candidates: np.ndarray,
                     n: int) -> np.ndarray:
    """FSD penalty: for each candidate token c, the count of times the
    context (n-1)-gram followed by c already occurred in prev_tokens,
    normalized by the max count (an n-gram LM over the generated prefix —
    the degeneration penalty of FSD; reference NGram class,
    sampling_strategy.h:125-236)."""
    counts = np.zeros(len(candidates), dtype=np.float64)
    prev = list(prev_tokens)
    if len(prev) < n - 1:
        return counts
    ctx = tuple(prev[-(n - 1):]) if n > 1 else ()
    table: Dict[tuple, Dict[int, int]] = {}
    for i in range(len(prev) - n + 1):
        g_ctx = tuple(prev[i:i + n - 1])
        nxt = prev[i + n - 1]
        table.setdefault(g_ctx, {}).setdefault(nxt, 0)
        table[g_ctx][nxt] += 1
    hits = table.get(ctx, {})
    for j, c in enumerate(candidates):
        counts[j] = hits.get(int(c), 0)
    m = counts.max()
    if m > 0:
        counts = counts / m
    return counts


class DecodingStrategies:
    """Strategy registry + per-query state table.

    reference: DecodingStrategies (decoding_strategies.h:15) +
    SamplingStrategy per-query state (sampling_strategy.h:72-118).
    """

    def __init__(self, eos_ids: Optional[set] = None):
        self._queries: Dict[int, _QueryState] = {}
        self.eos_ids = eos_ids or set()

    def begin_query(self, query_id: int, opts: SamplingOptions) -> None:
        seed = opts.seed if opts.seed else (query_id * 2654435761) & 0x7FFFFFFF
        st = _QueryState(opts=opts, rng=np.random.default_rng(seed))
        st.mirostat_mu = 2.0 * opts.mirostat_tau
        self._queries[query_id] = st

    def end_query(self, query_id: int) -> None:
        self._queries.pop(query_id, None)

    def choose_token(self, query_id: int, logits: np.ndarray,
                     prev_tokens: Sequence[int] = ()) -> int:
        st = self._queries.get(query_id)
        if st is None:
            self.begin_query(query_id, SamplingOptions(strategy="greedy"))
            st = self._queries[query_id]
        opts = st.opts
        tok = self._choose(st, np.asarray(logits, np.float32).reshape(-1),
                           prev_tokens)
        # eos_bypassing: re-sample up to N eos tokens per query
        if (tok in self.eos_ids and st.eos_bypassed < opts.eos_bypassing_max):
            st.eos_bypassed += 1
            masked = np.array(logits, np.float32, copy=True).reshape(-1)
            for e in self.eos_ids:
                masked[e] = -1e30
            tok = self._choose(st, masked, prev_tokens)
        return tok

    def _choose(self, st: _QueryState, logits: np.ndarray,
                prev_tokens: Sequence[int]) -> int:
        opts = st.opts
        sid = get_strategy_id(opts.strategy)
        if sid == "greedy" or opts.temperature <= 0:
            return int(logits.argmax())

        scaled = _apply_temperature(logits, opts.temperature)
        probs = _softmax(scaled)

        if sid == "top_k":
            probs = _top_k_filter(probs, opts.top_k)
        elif sid == "top_p":
            probs = _top_k_filter(probs, opts.top_k)
            probs = _top_p_filter(probs, opts.top_p)
        elif sid == "min_p":
            probs = _min_p_filter(probs, opts.min_p)
        elif sid == "tfs":
            probs = _tfs_filter(probs, opts.tfs_z)
        elif sid == "typical":
            probs = _typical_filter(probs, opts.typical_p)
        elif sid == "mirostat":
            return self._mirostat(st, probs)
        elif sid in ("fsd", "randomized_fsd"):
            return self._fsd(st, probs, prev_tokens,
                             randomized=(sid == "randomized_fsd"))
        return _sample(probs, st.rng)

    def _mirostat(self, st: _QueryState, probs: np.ndarray) -> int:
        """Mirostat v2: truncate to tokens with surprisal < mu, sample,
        then adapt mu toward target tau."""
        opts = st.opts
        surprisal = -np.log(np.maximum(probs, 1e-12)) / math.log(2.0)
        keep = surprisal < st.mirostat_mu
        if not keep.any():
            keep[probs.argmax()] = True
        p = np.where(keep, probs, 0.0)
        tok = _sample(p, st.rng)
        err = float(surprisal[tok]) - opts.mirostat_tau
        st.mirostat_mu -= opts.mirostat_eta * err
        return tok

    def _fsd(self, st: _QueryState, probs: np.ndarray,
             prev_tokens: Sequence[int], randomized: bool) -> int:
        """FSD: n-gram-penalized contrastive scoring over the top-k
        candidates: score = (1-alpha) * p - alpha * penalty."""
        opts = st.opts
        k = max(1, opts.fsd_k)
        cand = np.argpartition(probs, -k)[-k:]
        pen = _ngram_penalties(prev_tokens, cand, max(2, opts.fsd_n))
        scores = (1.0 - opts.fsd_alpha) * probs[cand] - opts.fsd_alpha * pen
        if randomized:
            w = np.maximum(scores - scores.min(), 0.0) + 1e-9
            j = _sample(w, st.rng)
        else:
            j = int(scores.argmax())
        return int(cand[j])
