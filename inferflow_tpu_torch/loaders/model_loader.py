"""Checkpoint -> the port's params on an explicit device (port of
inferflow_tpu/loaders/model_loader.py).

reference: ModelReader::Load + NetworkBuilder (src/transformer/
model_reader.cc:19-191, network_builder.cc): detect the checkpoint format,
stream tensors, canonicalize names, transpose to the (K, N) convention,
and quantize weight matrices into the configured block format while
loading (the analog of DeviceTensorBuilder's quantize-and-upload pipeline,
device_tensor_builder.cu).

The same rules as the JAX loader: per-tensor dtype overrides
(``device_weight_data_types``), the ``tensor_quant_threshold`` small-tensor
exemption (network_builder.cc:1648-1652), the load-time lm_head
normalization and a tied lm_head (no ``lm_head`` leaf: the decoder reads
the embeddings).  What differs, on purpose (ROADMAP C):
  - tensors are read in their stored type (safetensors BF16 stays two
    bytes), moved to the target device, and transposed, rounded to f16 as
    the JAX loader rounds them, and quantized there with
    ``codec_torch.quantize`` (the same bytes as the JAX loader's
    ``quant/codec_native``), one tensor at a time, so only one float32
    tensor exists at once (llama2-7b's checkpoint is 13.5 GB of bf16);
  - K is not padded to a TPU tile (every consumer in this package takes
    the logical K);
  - GlobalQuant element types and delta tensors raise NotImplementedError
    (ROADMAP A item 5).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.network_structure import NameMapper
from ..models.spec import ModelSpec
from ..quant.codec_torch import (QuantizedTensor, _numpy_to_torch,
                                 layout_for_leaf, quantize, repack_i4,
                                 requantize_i8_colwise,
                                 requantize_q8_container, resolve_auto_layout)
from ..quant.formats import GLOBAL_TYPES, get_format, is_quantized
from .gguf import GGUFFile
from .hf_config import load_hf_config
from .pickle_reader import load_torch_checkpoint
from .safetensors import SafetensorsFile, resolve_index

# slot leaf names eligible for weight quantization (the reference's
# LayerTensorId weight matrices; norms/biases/embeddings stay dense)
_QUANTIZABLE = {"wq", "wk", "wv", "wo", "qkv", "w1", "w2", "w3", "w1n3",
                "lm_head", "gate", "mlm_transform"}


def detect_format(path: str) -> str:
    low = path.lower()
    if low.endswith((".safetensors",)) or low.endswith(".safetensors.index.json"):
        return "safetensors"
    if low.endswith(".gguf"):
        return "gguf"
    if low.endswith((".bin", ".pt", ".pth")) and "tokenizer" not in low:
        # .bin is ambiguous (torch pickle vs llama2.c): sniff the magic —
        # torch checkpoints are zip (PK..) or a bare pickle stream (\x80),
        # llama2.c starts with 7 raw int32 hyperparams (model_reader.cc:3248)
        try:
            with open(path, "rb") as fh:
                magic = fh.read(2)
            if magic[:2] in (b"PK", b"\x80\x02", b"\x80\x04", b"\x80\x05") \
                    or magic[:1] == b"\x80":
                return "pickle"
            if low.endswith(".bin"):
                return "llama2.c"
            return "pickle"
        except OSError:
            if re.search(r"(stories|llama2)[^/]*\.bin$", low):
                return "llama2.c"
            return "pickle"
    if low.endswith(".index.json"):
        return "safetensors" if "safetensors" in low else "pickle"
    return "unknown"


def iter_checkpoint_tensors(files, fmt: str
                            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Stream (name, CPU torch tensor) from checkpoint file(s) of a given
    format: safetensors in the stored type, the other readers' numpy
    arrays (bf16 widened to float32, GGML blocks dequantized) as they
    come."""
    for path in files:
        if fmt == "safetensors":
            for shard in resolve_index(path):
                sf = SafetensorsFile(shard)
                try:
                    for name in sf.names():
                        yield name, sf.torch_tensor(name)
                finally:
                    sf.close()
        elif fmt == "pickle":
            if path.endswith(".index.json"):
                with open(path) as fh:
                    idx = json.load(fh)
                base = os.path.dirname(path)
                shards = [os.path.join(base, s) for s in
                          sorted(set(idx.get("weight_map", {}).values()))]
            else:
                shards = [path]
            for shard in shards:
                for name, arr in load_torch_checkpoint(shard).items():
                    yield name, _numpy_to_torch(arr)
        elif fmt in ("gguf", "ggml"):
            if fmt == "gguf":
                gf = GGUFFile(path)
            else:
                from .ggml import GGMLFile
                gf = GGMLFile(path)
            try:
                for name in gf.names():
                    yield name, _numpy_to_torch(gf.tensor(name))
            finally:
                gf.close()
        else:
            raise ValueError(f"unsupported model file format: {fmt}")


def _weight_dtype_for(spec: ModelSpec, leaf: str, shape) -> Optional[str]:
    """Element type for a weight slot: per-tensor override, global default,
    and the small-tensor quant exemption."""
    et = spec.device_weight_data_types.get(leaf, spec.device_weight_data_type)
    if not (is_quantized(et) or et.upper() in GLOBAL_TYPES):
        return None
    if len(shape) != 2:
        return None
    if shape[0] * shape[1] < spec.tensor_quant_threshold:
        return None
    return et


def _layout(spec: ModelSpec, et: str, leaf: str, qt: QuantizedTensor,
            device: torch.device):
    """The weight in the spec's device layout ('' / 'auto' resolved on the
    device, as make_synthetic_params does)."""
    layout = spec.device_layout
    if layout in ("", "auto"):
        layout = resolve_auto_layout(spec, et, device)
    layout = layout_for_leaf(layout, leaf)
    if layout == "i8mm":
        return requantize_i8_colwise(qt)
    if layout == "q8c":
        return requantize_q8_container(qt)
    if layout == "i4":
        return repack_i4(qt)
    return qt


def _prepare_tensor(spec: ModelSpec, path: tuple, t: torch.Tensor,
                    transpose: bool, device: torch.device):
    """One checkpoint tensor as its params leaf on `device`."""
    leaf = path[-1]
    t = t.to(device)
    if t.dim() == 2 and transpose:
        t = t.t().contiguous()
    if leaf == "lm_head" and t.dim() == 2 \
            and (spec.normalize_lm_head
                 or getattr(spec, "_normalize_lm_head_at_load", False)):
        # Baichuan2: L2-normalize each vocab unit of the head at LOAD time,
        # before quantization (network_builder.cc:439-444); after the
        # transpose the head is (E, V): one vocab unit per column
        f32 = t.float()
        t = f32 / torch.clamp(torch.linalg.vector_norm(f32, dim=0,
                                                       keepdim=True), 1e-12)
    et = _weight_dtype_for(spec, leaf, tuple(t.shape)) \
        if leaf in _QUANTIZABLE else None
    if et is not None and et.upper() in GLOBAL_TYPES:
        raise NotImplementedError(
            f"{'.'.join(map(str, path))}: whole-tensor element type {et} "
            "(GlobalQuantTensor) is not ported (ROADMAP A item 5)")
    if et is not None and t.shape[0] % get_format(et).block == 0:
        if spec.delta_tensor_ratio > 0:
            raise NotImplementedError(
                "delta tensors (delta_tensor_ratio > 0) are not ported "
                "(ROADMAP A item 5)")
        # the JAX loader quantizes the f16-rounded weights
        f32 = t.to(torch.float16).to(torch.float32).contiguous()
        del t
        return _layout(spec, et, leaf, quantize(f32, et), device)
    # dense: norms, biases, embeddings and K not a block multiple, bf16
    return t.to(torch.float32).to(torch.bfloat16).contiguous()


def _set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt_key = path[i + 1]
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt_key, int) else [])
            if node[key] == {} and isinstance(nxt_key, int):
                node[key] = []
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt_key, int) else {}
            node = node[key]
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
        node[last] = value
    else:
        node[last] = value


def load_model(spec: ModelSpec, model_dir: Optional[str] = None,
               device="cuda", stats: Optional[dict] = None) -> dict:
    """Load a checkpoint into the params of models/decoder.py on `device`
    (the card unless the caller asks for the CPU): per-layer lists with
    unfused wq/wk/wv and w1/w3, as the JAX loader leaves them (the engine
    fuses them).  `stats`, when given, receives the seconds spent reading
    the files into host memory ("read_s") and moving, transposing and
    quantizing the tensors on the device up to its last result
    ("quantize_s"), and the tensors and bytes read."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    model_dir = model_dir or spec.dir
    spec = load_hf_config(spec, model_dir)
    files = [os.path.join(model_dir, f) if model_dir else f
             for f in spec.model_files]
    fmt = spec.model_file_format
    if fmt in ("", "unknown") and files:
        fmt = detect_format(files[0])

    if fmt == "llama2.c":
        from .llama2c import load_llama2c_checkpoint
        ck_spec, raw = load_llama2c_checkpoint(files[0])
        # adopt the checkpoint header's hyperparams (model_reader.cc:3248)
        spec.hyper_params = ck_spec.hyper_params
        if spec.max_context_len <= 0:
            spec.max_context_len = ck_spec.max_context_len
        return finalize_params(spec, _llama2c_params(raw, dev))

    mapper = NameMapper(spec.network_structure, spec.tensor_name_map,
                        spec.tensor_name_prefix)
    params: dict = {}
    unmapped = []
    read_s, n_read, n_bytes = 0.0, 0, 0
    stream = iter_checkpoint_tensors(files, fmt)
    while True:
        t0 = time.perf_counter()
        item = next(stream, None)
        read_s += time.perf_counter() - t0
        if item is None:
            break
        name, t = item
        n_read += 1
        n_bytes += t.numel() * t.element_size()
        mapped = mapper.map_name(name)
        if mapped is None:
            unmapped.append(name)
            continue
        path, transpose = mapped
        _set_path(params, path, _prepare_tensor(spec, path, t, transpose,
                                                dev))
    if unmapped:
        logging.getLogger(__name__).warning(
            "unmapped checkpoint tensors: %s", unmapped[:20])
    if spec.normalize_lm_head and "lm_head" in params:
        # applied at load by _prepare_tensor; clear so output_logits
        # doesn't normalize a second time.  The private marker keeps a
        # second load_model() with the same spec object normalizing at load
        spec.normalize_lm_head = False
        spec._normalize_lm_head_at_load = True
    params = finalize_params(spec, params, unmapped=unmapped)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.update(read_s=read_s, tensors=n_read, bytes=n_bytes,
                     quantize_s=time.perf_counter() - t_start - read_s)
    return params


def _llama2c_params(raw: dict, dev: torch.device) -> dict:
    """A llama2.c checkpoint's tree (numpy leaves already in the (K, N)
    convention) as dense bf16 leaves on `dev`, as the JAX loader's
    finalize_params converts them (no quantization on this path)."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, np.ndarray):
            return _numpy_to_torch(node.astype(np.float32)).to(dev).to(
                torch.bfloat16)
        return node

    return walk(raw)


def finalize_params(spec: ModelSpec, params: dict, unmapped=None) -> dict:
    """Post-load fixups: hyperparam backfill and model validation (the
    analog of CheckHostModel/CheckDeviceModel, network_builder.cc:1690-1790).
    Every leaf is already a torch tensor or a quantized weight on the
    device; a tied lm_head stays absent (the decoder reads the
    embeddings)."""
    hp = spec.hyper_params
    emb_key = ("dec_embeddings" if "dec_embeddings" in params
               else "enc_embeddings")
    if emb_key in params:
        v, e = params[emb_key].shape
        if hp.vocab_size in (0, -1):
            hp.vocab_size = v
        if hp.embd_dims in (0, -1):
            hp.embd_dims = e
    if hp.decoder_layers in (0, -1) and "layers" in params:
        hp.decoder_layers = len(params["layers"])
    if hp.encoder_layers in (0, -1) and "enc_layers" in params:
        hp.encoder_layers = len(params["enc_layers"])
    validate_params(spec, params)
    return params


def validate_params(spec: ModelSpec, params: dict) -> None:
    """Every expected tensor present with sane shapes
    (network_builder.cc CheckHostModel)."""
    hp = spec.hyper_params
    problems = []
    if "dec_embeddings" not in params and "enc_embeddings" not in params:
        problems.append("missing embeddings")
    for kind, count in (("layers", hp.decoder_layers or 0),
                        ("enc_layers", hp.encoder_layers or 0)):
        lst = params.get(kind)
        if lst is None:
            if count and kind == "layers" and spec.archetype != "encoder_only":
                problems.append(f"missing {kind}")
            continue
        if isinstance(lst, dict):
            continue  # stacked
        for i, layer in enumerate(lst):
            if layer is None:
                problems.append(f"{kind}[{i}] missing")
                continue
            attn = layer.get("attn", {})
            if not ("qkv" in attn or all(k in attn
                                         for k in ("wq", "wk", "wv"))):
                problems.append(f"{kind}[{i}] incomplete attention weights")
            if "wo" not in attn:
                problems.append(f"{kind}[{i}] missing wo")
            blk = layer.get("ffn") or layer.get("moe")
            if blk is None:
                problems.append(f"{kind}[{i}] missing ffn/moe")
    if problems:
        raise ValueError("model validation failed: " + "; ".join(problems[:8]))
