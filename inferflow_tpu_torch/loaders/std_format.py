"""`Std` model format: save/load the engine's own params (port of
inferflow_tpu/loaders/std_format.py).

reference: ModelWriter::Save writes the reference's internal Std format
(src/transformer/model_writer.{h,cc}); here the Std container is one
safetensors file holding dense tensors and quantized plane/scale/base
arrays keyed by slot path, plus a JSON manifest of shapes/formats and the
ModelSpec — so a quantized model reloads without re-running the codec.
The container is the JAX package's: a file either package writes loads in
the other.  Dense tensors are stored as float32 (a bf16 value exactly) and
load as bf16; quantized weights keep their planes (wire, ``data_i4p`` or
``pair8``) and metadata bytes.  The JAX package's GlobalQuant and delta
entries raise NotImplementedError here (ROADMAP A item 5).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.spec import HyperParams, ModelSpec
from ..quant.codec_torch import QuantizedTensor, _numpy_to_torch
from .safetensors import SafetensorsFile, save_safetensors

MANIFEST_KEY = "__inferflow_manifest__"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _flatten(val, prefix + (str(key),))
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from _flatten(val, prefix + (str(i),))
    elif tree is not None:
        yield ".".join(prefix), tree


def _cpu(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def save_std(path: str, spec: ModelSpec, params: dict) -> None:
    """Write params (dense tensors and QuantizedTensors, on any device)
    with the spec's manifest."""
    tensors: Dict[str, np.ndarray] = {}
    manifest = {"spec": dataclasses.asdict(spec), "tensors": {}}
    for name, val in _flatten(params):
        if isinstance(val, QuantizedTensor):
            manifest["tensors"][name] = {
                "kind": "quant", "format": val.format,
                "shape": [int(s) for s in val.shape],
                "planes": sorted(val.planes),
                "has_base": val.base is not None,
                "has_delta": False,
            }
            for pname, plane in val.planes.items():
                tensors[f"{name}:{pname}"] = _cpu(plane)
            tensors[f"{name}:scale"] = _cpu(val.scale)
            if val.base is not None:
                tensors[f"{name}:base"] = _cpu(val.base)
        elif isinstance(val, torch.Tensor):
            manifest["tensors"][name] = {"kind": "dense"}
            tensors[name] = _cpu(val.float() if val.is_floating_point()
                                 and val.dtype != torch.float16 else val)
        else:
            raise NotImplementedError(
                f"{name}: {type(val).__name__} has no Std entry here (the "
                "Std container holds dense and block-quantized weights)")
    save_safetensors(path, tensors, {MANIFEST_KEY: json.dumps(manifest)})


def _set_path(tree, path_parts, value):
    node = tree
    for i, part in enumerate(path_parts[:-1]):
        key = int(part) if part.isdigit() else part
        nxt = path_parts[i + 1]
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if nxt.isdigit() else {})
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if nxt.isdigit() else {}
            node = node[key]
    last = path_parts[-1]
    key = int(last) if last.isdigit() else last
    if isinstance(key, int):
        while len(node) <= key:
            node.append(None)
        node[key] = value
    else:
        node[key] = value


def load_std(path: str, device="cuda") -> Tuple[ModelSpec, dict]:
    """(spec, params) from a Std file, the params on `device` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    sf = SafetensorsFile(path)
    try:
        manifest = json.loads(sf.metadata[MANIFEST_KEY])
        spec_data = manifest["spec"]
        hp = HyperParams(**spec_data.pop("hyper_params"))
        known = {f.name for f in dataclasses.fields(ModelSpec)}
        spec = ModelSpec(hyper_params=hp,
                         **{k: v for k, v in spec_data.items() if k in known
                            and k != "hyper_params"})
        params: dict = {}
        for name, info in manifest["tensors"].items():
            parts = name.split(".")
            if info["kind"] == "global_quant" or info.get("has_delta"):
                raise NotImplementedError(
                    f"{name}: GlobalQuant and delta tensors are not ported "
                    "(ROADMAP A item 5)")
            if info["kind"] == "quant":
                planes = {p: sf.torch_tensor(f"{name}:{p}").to(dev)
                          for p in info["planes"]}
                scale = sf.torch_tensor(f"{name}:scale").to(dev)
                base = (sf.torch_tensor(f"{name}:base").to(dev)
                        if info["has_base"] else None)
                val = QuantizedTensor(info["format"], tuple(info["shape"]),
                                      planes, scale, base)
            else:
                arr = np.asarray(sf.tensor(name), np.float32)
                val = _numpy_to_torch(arr).to(dev).to(torch.bfloat16)
            _set_path(params, parts, val)
        return spec, params
    finally:
        sf.close()
