"""Activation functions incl. GLU variants (port of
inferflow_tpu/ops/activations.py).  Computed in the input dtype, op by op,
as the JAX version writes them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sigmoid(x):
    # 1 / (1 + exp(-x)) op by op, each rounded to x's dtype: the form XLA
    # lowers jax.nn.sigmoid to for bf16
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


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
