"""Moving params from the JAX package into this one, through numpy.

``params_from_numpy`` takes the JAX package's param tree with every leaf
already converted to numpy: dense arrays as arrays (bfloat16 included),
each QuantizedTensor as its ``to_np()`` dict (any plane set: wire planes,
``data_i4p`` or Q3H's ``pair8``, K-padded storage included) and each
Int8MXUTensor as a ``{"shape", "data", "scale"}`` dict.  Layer-stacked
trees (a leading L axis on every ``layers`` leaf) are split into the
per-layer list this package uses, only the L axis stripped: a MoE layer's
``experts_stacked`` leaves, (L, E, K, N) there, arrive as (E, K, N)
expert stacks.  Tests use it to give both packages identical weights.
"""

from __future__ import annotations

import numpy as np

from .device import resolve_device
from .models.spec import ModelSpec
from .quant.codec_torch import Int8MXUTensor, QuantizedTensor, _numpy_to_torch

_QT_KEYS = {"format", "shape", "planes", "scale", "base"}
_I8_KEYS = {"shape", "data", "scale"}


def _is_qt(node) -> bool:
    return isinstance(node, dict) and set(node) == _QT_KEYS


def _is_i8(node) -> bool:
    return isinstance(node, dict) and set(node) == _I8_KEYS


def _convert(node, device):
    if _is_qt(node):
        return QuantizedTensor.from_np(node, device)
    if _is_i8(node):
        return Int8MXUTensor.from_np(node, device)
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_convert(v, device) for v in node]
    return _numpy_to_torch(np.asarray(node)).to(device)


def _layer_count(node) -> int:
    if _is_qt(node) or _is_i8(node):
        return int(np.asarray(node["scale"]).shape[0])
    if isinstance(node, dict):
        return next(_layer_count(v) for v in node.values())
    return int(np.asarray(node).shape[0])


def _select_layer(node, i: int):
    """Layer i of a layer-stacked node: the leading axis only."""
    if _is_qt(node):
        return {"format": node["format"], "shape": tuple(node["shape"])[1:],
                "planes": {k: v[i] for k, v in node["planes"].items()},
                "scale": node["scale"][i],
                "base": None if node["base"] is None else node["base"][i]}
    if _is_i8(node):
        return {"shape": tuple(node["shape"])[1:], "data": node["data"][i],
                "scale": node["scale"][i]}
    if isinstance(node, dict):
        return {k: _select_layer(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def params_from_numpy(tree: dict, spec: ModelSpec = None,
                      device="cuda") -> dict:
    """The port's params from the JAX package's numpy tree.  When the
    layers carry a fused qkv and a spec is given, sets spec.qkv_format = 1
    as the JAX builder does."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, dict):  # stacked: split per layer
        layers = [_select_layer(layers, i)
                  for i in range(_layer_count(layers))]
    out = {k: _convert(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(lp, dev) for lp in layers]
    if spec is not None and all("qkv" in lp.get("attn", {})
                                for lp in out["layers"]):
        spec.qkv_format = 1
    return out

