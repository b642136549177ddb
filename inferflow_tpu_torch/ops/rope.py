"""Rotary position embedding (port of inferflow_tpu/ops/rope.py, RoPE only;
ALiBi and the sinusoidal tables are not ported)."""

from __future__ import annotations

import torch


def rope(x, positions, *, base: float = 10000.0, order: int = 1,
         rope_dim: int = -1):
    """RoPE over the last axis of x, computed in float32.

    x: (..., T, H, D) or (..., T, D); positions: (..., T) absolute positions.
    order=1: interleaved pairs (col, col+1), frequency index col//2.
    order=2: half-split pairs (col, col+rope_dim/2) ("rotate_half"), with
    pass-through beyond rope_dim.
    """
    d = x.shape[-1]
    rd = d if rope_dim is None or rope_dim <= 0 else rope_dim
    xf = x.float()
    pos = positions.to(device=x.device, dtype=torch.float32)
    extra = x.dim() - positions.dim() - 1
    pos = pos.reshape(tuple(pos.shape) + (1,) * extra)

    half = rd // 2
    freq_idx = torch.arange(half, dtype=torch.float32, device=x.device)
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32,
                                      device=x.device),
                         -2.0 * freq_idx / rd)
    theta = pos[..., None] * inv_freq
    cos, sin = torch.cos(theta), torch.sin(theta)

    if order == 1:
        xr = xf[..., :rd].reshape(tuple(xf.shape[:-1]) + (half, 2))
        x0, x1 = xr[..., 0], xr[..., 1]
        rot = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(tuple(xf.shape[:-1]) + (rd,))
    else:
        x0 = xf[..., :half]
        x1 = xf[..., half:rd]
        rot = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    if rd < d:
        rot = torch.cat([rot, xf[..., rd:]], dim=-1)
    return rot.to(x.dtype)
