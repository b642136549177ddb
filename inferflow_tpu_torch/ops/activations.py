"""Activation functions incl. GLU variants (port of
inferflow_tpu/ops/activations.py).  Computed in the input dtype, op by op,
as the JAX version writes them."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def weak_scalar(value: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing takes it against `like`:
    rounded to like's dtype first (bf16 * 0.111111 multiplies by
    bf16(0.111111)), where torch would keep it at full precision.  The
    rounding is done on the host and the result stays a Python float (no
    device tensor, no copy to the card): torch multiplies a bf16 tensor by
    it in float32 and rounds once, the same bits as JAX's bf16 product."""
    return _rounded(float(value), like.dtype)


def _sigmoid(x):
    # 1 / (1 + exp(-x)) op by op, each rounded to x's dtype: the form XLA
    # lowers jax.nn.sigmoid to for bf16
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x)


def _gelu(x):
    # jax.nn.gelu(approximate=True) op by op in x's dtype, each constant
    # rounded to it: x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))
    inner = weak_scalar(0.7978845608028654, x) * (
        x + weak_scalar(0.044715, x) * x ** 3)
    return x * (weak_scalar(0.5, x) * (1 + torch.tanh(inner)))


ACT_FNS = {
    "sigmoid": _sigmoid,
    "elu": F.elu,
    "relu": torch.relu,
    "gelu": _gelu,
    "silu": _silu,
}


def activate(name: str, x, gate=None):
    """Apply activation; GLU variants compute act(x) * gate."""
    name = name.lower()
    if name.startswith("glu_"):
        if gate is None:
            raise ValueError(f"{name} requires a gate input")
        return ACT_FNS[name[4:]](x) * gate
    y = ACT_FNS[name](x)
    if gate is not None:
        y = y * gate
    return y
