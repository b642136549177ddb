"""Tensor numeric-diff + debug helpers.

A copy of inferflow_tpu/utils/tensor_util.py (no JAX in it), kept so that
this package imports nothing of the JAX one.

reference: src/tensor/tensor_util.{h,cc} — Compare/Rmsd/NormRmsd are the
de-facto accuracy harness (tensor_util.h:76-89), TensorToJson/Print for
study-mode dumps; TensorOpr::CheckElements NaN/Inf scan (tensor_opr.h:124).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np


def rmsd(a, b) -> float:
    """Root-mean-square deviation (tensor_util.h:84)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def norm_rmsd(a, b) -> float:
    """RMSD normalized by the mean magnitude of both sides
    (tensor_util.h:89)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = 0.5 * (np.sqrt(np.mean(a * a)) + np.sqrt(np.mean(b * b))) + 1e-12
    return float(np.sqrt(np.mean((a - b) ** 2)) / denom)


def compare(a, b, atol: float = 1e-3, rtol: float = 1e-3
            ) -> Tuple[bool, int, float]:
    """Elementwise compare (tensor_util.h:76): returns (ok, diff_count,
    max_abs_diff)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    bad = diff > (atol + rtol * np.abs(b))
    return (not bad.any(), int(bad.sum()), float(diff.max(initial=0.0)))


def check_elements(x) -> Tuple[int, int]:
    """NaN/Inf scan (TensorOpr::CheckElements)."""
    x = np.asarray(x)
    return int(np.isnan(x).sum()), int(np.isinf(x).sum())


def tensor_to_json(x, max_elements: int = 64) -> str:
    """Debug serialization (TensorUtil::TensorToJson)."""
    x = np.asarray(x)
    flat = x.reshape(-1)[:max_elements]
    return json.dumps({
        "shape": list(x.shape), "dtype": str(x.dtype),
        "data": [float(v) for v in flat.astype(np.float64)],
        "truncated": bool(x.size > max_elements),
    })
