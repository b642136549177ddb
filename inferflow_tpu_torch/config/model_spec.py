"""model_spec.json parsing -> ModelSpec.

reference: ModelReader::LoadModelSpecJson (src/transformer/
model_reader.cc:194-446): files/formats/tokenizer at the top level, a
`network_structure` block with the architecture knobs, and
`tensor_name_mapping` with `{i}`/`{j}` placeholders.  JSON may contain
`#`-prefixed comment banner lines (the reference's JSON parser skips them).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from ..models.spec import HyperParams, ModelSpec


def _strip_comments(text: str) -> str:
    return "\n".join(l for l in text.splitlines()
                     if not l.lstrip().startswith("#"))


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def load_model_spec(path: str, sid: str = "") -> ModelSpec:
    with open(path, encoding="utf-8") as fh:
        data = json.loads(_strip_comments(fh.read()))
    return parse_model_spec(data, sid=sid,
                            base_dir=os.path.dirname(os.path.abspath(path)),
                            spec_file=path)


def parse_model_spec(data: dict, sid: str = "", base_dir: str = "",
                     spec_file: str = "") -> ModelSpec:
    spec = ModelSpec(sid=sid, dir=base_dir, spec_file=spec_file)
    spec.config_file = data.get("config_file", "")
    spec.model_files = (_as_list(data.get("model_files"))
                        or _as_list(data.get("model_file")))
    spec.model_file_format = data.get("model_file_format", "unknown").lower()
    spec.tokenizer_files = (_as_list(data.get("tokenizer_files"))
                            or _as_list(data.get("tokenizer_file")))
    spec.token_remap_file = data.get("token_remap_file", "")
    spec.tokenization_algorithm = data.get("tokenization_algorithm",
                                           "bpe").lower()
    spec.generation_config_file = data.get("generation_config", "")
    spec.token_bytes_mapping = int(data.get("token_bytes_mapping", 0))
    spec.qkv_format = int(data.get("qkv_format", 0))

    for tok in ("unk_token", "pad_token", "bos_token", "eos_token",
                "mask_token"):
        if tok in data:
            setattr(spec, tok, data[tok])

    ns = data.get("network_structure", {})
    spec.network_structure = ns.get("type", data.get("type",
                                                     "transformer.llama"))
    spec.norm_alg = ns.get("normalization_function", "rms").lower()
    spec.activation_fn = ns.get("activation_function", "silu").lower()
    spec.pos_embedding_alg = ns.get("position_embedding", "rope").lower()
    if spec.pos_embedding_alg == "empty":
        spec.pos_embedding_alg = ""
    spec.qk_column_order = int(ns.get("qk_column_order", 0))
    if "qkv_format" in ns:
        spec.qkv_format = int(ns["qkv_format"])
    spec.normalize_lm_head = bool(ns.get("normalize_lm_head", False))
    spec.is_parallel_attn = bool(ns.get("is_parallel_attn", False))
    spec.mlp_attn_share_input = bool(ns.get("mlp_attn_share_input", False))
    spec.is_attn_post_as_residual = bool(
        ns.get("is_attn_post_as_residual", True))
    spec.use_self_attn_pre_norm = bool(ns.get("use_self_attn_pre_norm", True))
    spec.device_layout = str(ns.get("device_layout",
                                    data.get("device_layout", ""))).lower()
    spec.tensor_name_prefix = ns.get("tensor_name_prefix", "")
    spec.tensor_name_map = dict(ns.get("tensor_name_mapping", {}))
    spec.tensor_name_pre_map = dict(ns.get("tensor_name_pre_mapping", {}))

    if "max_context_len" in data:
        spec.max_context_len = int(data["max_context_len"])

    hp = spec.hyper_params
    # top-level vocab sizes (chatglm2-style specs place them outside
    # network_structure; model_reader.cc:194-446 reads both)
    for field, key in (("vocab_size", "vocab_size"),
                       ("padded_vocab_size", "padded_vocab_size")):
        if key in data:
            setattr(hp, field, int(data[key]))
    for field, keys in (("vocab_size", ("vocab_size",)),
                        ("embd_dims", ("hidden_size", "embd_dims")),
                        ("decoder_layers", ("decoder_layer_count", "layers")),
                        ("decoder_heads", ("decoder_head_count", "heads")),
                        ("decoder_kv_heads", ("decoder_kv_head_count",)),
                        ("decoder_intermediate_size", ("intermediate_size",)),
                        ("encoder_layers", ("encoder_layer_count",)),
                        ("encoder_heads", ("encoder_head_count",)),
                        ("experts", ("expert_count",)),
                        ("in_use_experts", ("using_expert_count",)),
                        ("moe_top_k", ("moe_top_k",))):
        for key in keys:
            if key in ns:
                setattr(hp, field, int(ns[key]))
                break
    if "has_shared_expert" in ns:
        hp.has_shared_expert = bool(ns["has_shared_expert"])
    if "moe_norm_top_k_prob" in ns:
        hp.moe_norm_top_k_prob = bool(ns["moe_norm_top_k_prob"])
    if "moe_layer_start" in ns:
        hp.moe_layer_start = int(ns["moe_layer_start"])
    if "moe_layer_end" in ns:
        hp.moe_layer_end = int(ns["moe_layer_end"])

    for fld in ("rope_theta", "partial_rotary_factor", "kq_scale",
                "attn_out_scale", "ffn_out_scale", "out_scale",
                "embedding_linear_scale", "attn_pre_norm_base",
                "ffn_pre_norm_base", "output_norm_base", "norm_eps"):
        if fld in ns:
            setattr(spec, fld, float(ns[fld]))
    for fld in ("rope_dim", "pos_embedding_offset"):
        if fld in ns:
            setattr(spec, fld, int(ns[fld]))
    for fld in ("has_embedding_linear_norm",
                "has_linear_norm_before_sinusoidal", "transform_qk"):
        if fld in ns:
            setattr(spec, fld, bool(ns[fld]))
    return spec
