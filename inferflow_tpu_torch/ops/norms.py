"""Normalization ops (port of inferflow_tpu/ops/norms.py).

All norms compute in float32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight=None, bias=None, eps: float = 1e-5,
             multi_base: float = 0.0):
    """RMS norm with optional (multi_base + weight) scaling."""
    xf = x.float()
    mean_sq = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(mean_sq + eps))
    if weight is not None:
        y = y * (multi_base + weight.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def std_norm(x, weight=None, bias=None, eps: float = 1e-5,
             multi_base: float = 0.0):
    """LayerNorm (mean/variance)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * (multi_base + weight.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def linear_norm(x, scale: float = 0.0):
    """Scale-only 'norm'; scale <= 1e-4 means sqrt(dim)."""
    if scale <= 0.0001:
        scale = float(x.shape[-1]) ** 0.5
    return (x.float() * scale).to(x.dtype)


NORM_FNS = {"rms": rms_norm, "std": std_norm}


def apply_norm(alg: str, x, weight=None, bias=None, eps: float = 1e-5,
               multi_base: float = 0.0):
    alg = alg.lower()
    if alg == "linear":
        return linear_norm(x)
    return NORM_FNS[alg](x, weight, bias, eps, multi_base)
