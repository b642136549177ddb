"""Attention in plain PyTorch: causal-prefix masked multi-head attention with
GQA (port of inferflow_tpu/ops/attention.py, which XLA compiled; there it
was no Pallas kernel, so there is no hand kernel here either).  Scores and
softmax in float32; the probabilities are cast to V's dtype before the
value product, as in the JAX version."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mha(q, k, v, *, q_positions, kv_len=None, kq_scale: float = 1.0,
        causal: bool = True):
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D), Hq a multiple of Hkv.
    q_positions: (B, Tq) absolute position of each query row (key j is
    visible iff j <= position); kv_len: (B,) valid KV rows."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float().reshape(b, tq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) \
        * (1.0 / (d ** 0.5)) * kq_scale
    key_idx = torch.arange(tk, device=q.device)[None, None, None, None, :]
    mask = torch.ones((b, 1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = key_idx <= q_positions.to(q.device)[:, None, None, :, None]
    if kv_len is not None:
        mask = mask & (key_idx < kv_len.to(q.device)[:, None, None, None,
                                                     None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(b, tq, hq, d)
