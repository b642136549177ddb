"""HuggingFace config.json -> HyperParams / ModelSpec resolution.

A copy of inferflow_tpu/loaders/hf_config.py (no JAX in it), kept so that
this package imports nothing of the JAX one.

reference: ModelReader::LoadConfigJson (src/transformer/
model_reader.cc:449-671) — every hyperparameter has several aliases across
checkpoint families; generation_config.json is read alongside
(model_reader.cc:674-742).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..models.spec import HyperParams, ModelSpec

# alias tables: first present key wins
_ALIASES = {
    "vocab_size": ["vocab_size", "n_vocab", "padded_vocab_size"],
    "embd_dims": ["hidden_size", "n_embd", "d_model", "dim", "n_embed"],
    "decoder_layers": ["num_hidden_layers", "n_layer", "num_layers",
                       "decoder_layers", "n_layers"],
    "decoder_heads": ["num_attention_heads", "n_head", "num_heads",
                      "decoder_attention_heads", "n_heads"],
    "decoder_kv_heads": ["num_key_value_heads", "num_kv_heads", "n_head_kv",
                         "kv_n_heads", "multi_query_group_num"],
    "decoder_intermediate_size": ["intermediate_size", "n_inner", "ffn_dim",
                                  "decoder_ffn_dim", "ffn_hidden_size",
                                  "inner_hidden_size", "hidden_dim"],
    "encoder_layers": ["encoder_layers", "num_encoder_layers"],
    "encoder_heads": ["encoder_attention_heads"],
    "training_context_len": ["max_position_embeddings", "n_positions",
                             "seq_length", "max_sequence_length",
                             "model_max_length", "n_ctx"],
    "experts": ["num_local_experts", "num_experts", "n_routed_experts",
                "moe_num_experts"],
    "moe_top_k": ["num_experts_per_tok", "moe_top_k", "moe_k",
                  "num_experts_per_token"],
}

_SPEC_ALIASES = {
    "rope_theta": ["rope_theta", "rotary_emb_base"],
    "norm_eps": ["rms_norm_eps", "layer_norm_eps", "layer_norm_epsilon",
                 "layernorm_epsilon"],
    "partial_rotary_factor": ["partial_rotary_factor"],
    "rope_dim": ["rotary_dim"],
}


def _first(cfg: dict, keys):
    for key in keys:
        if key in cfg and cfg[key] is not None:
            return cfg[key]
    return None


def apply_hf_config(spec: ModelSpec, cfg: dict) -> ModelSpec:
    """Fill spec.hyper_params (and spec knobs) from a parsed config.json.
    Values already set explicitly in model_spec.json take precedence when
    non-default (the reference reads config.json first, then the spec
    overrides; we apply config only to unset fields)."""
    hp = spec.hyper_params
    for field, keys in _ALIASES.items():
        val = _first(cfg, keys)
        if val is None:
            continue
        if getattr(hp, field, 0) in (0, -1):
            setattr(hp, field, int(val))
    if hp.hidden_dim == 0:
        head_dim = cfg.get("head_dim")
        if head_dim:
            hp.hidden_dim = int(head_dim) * hp.decoder_heads
        else:
            hp.hidden_dim = hp.embd_dims
    if hp.decoder_kv_heads == 0:
        if cfg.get("multi_query"):
            hp.decoder_kv_heads = 1
        else:
            hp.decoder_kv_heads = hp.decoder_heads

    for field, keys in _SPEC_ALIASES.items():
        val = _first(cfg, keys)
        if val is not None:
            setattr(spec, field, type(getattr(spec, field))(val))

    act = cfg.get("hidden_act") or cfg.get("activation_function")
    if act:
        act = str(act).lower()
        spec.activation_fn = {"gelu_new": "gelu", "gelu_fast": "gelu",
                              "gelu_pytorch_tanh": "gelu",
                              "swiglu": "silu"}.get(act, act)
    if cfg.get("alibi") or cfg.get("use_alibi"):
        spec.pos_embedding_alg = "alibi"
    if cfg.get("parallel_attn") is not None:
        spec.is_parallel_attn = bool(cfg["parallel_attn"])
    if cfg.get("new_decoder_architecture"):
        spec.is_parallel_attn = True
    if cfg.get("tie_word_embeddings") is not None:
        spec.tie_word_embeddings = bool(cfg["tie_word_embeddings"])
    mt = (cfg.get("model_type") or "").lower()
    if mt and spec.network_structure in ("", "transformer.llama"):
        fam = {"llama": "llama", "mistral": "llama", "mixtral": "sparse_moe",
               "falcon": "falcon", "RefinedWeb": "falcon", "bloom": "bloom",
               "gpt2": "gpt2", "bert": "bert", "m2m_100": "encoder_decoder",
               "bart": "encoder_decoder", "qwen2": "llama",
               "deepseek": "sparse_moe", "phi": "llama",
               "baichuan": "llama", "yi": "llama",
               "internlm": "llama", "aquila": "llama",
               "stablelm": "llama", "gpt_neox": "llama"}.get(mt)
        if fam:
            spec.network_structure = fam
    # MoE extras
    if _first(cfg, ["n_shared_experts", "moe_num_shared_experts"]):
        hp.has_shared_expert = True
    norm_topk = _first(cfg, ["norm_topk_prob"])
    if norm_topk is not None:
        hp.moe_norm_top_k_prob = bool(norm_topk)
    first_dense = _first(cfg, ["first_k_dense_replace"])
    if first_dense is not None:
        hp.moe_layer_start = int(first_dense)
    # BLOOM-family layer norms sit inside the embedding block
    if mt == "bloom":
        spec.norm_alg = "std"
        spec.pos_embedding_alg = "alibi"
    if mt == "gpt2":
        spec.norm_alg = "std"
        spec.pos_embedding_alg = ""
        spec.activation_fn = spec.activation_fn or "gelu"
    return spec


def load_hf_config(spec: ModelSpec, model_dir: str) -> ModelSpec:
    path = spec.config_file or "config.json"
    if model_dir and not os.path.isabs(path):
        path = os.path.join(model_dir, path)
    if os.path.isfile(path):
        with open(path) as fh:
            cfg = json.load(fh)
        spec = apply_hf_config(spec, cfg)
    gen_path = spec.generation_config_file or "generation_config.json"
    if model_dir and not os.path.isabs(gen_path):
        gen_path = os.path.join(model_dir, gen_path)
    if os.path.isfile(gen_path):
        with open(gen_path) as fh:
            gen = json.load(fh)
        if not spec.decoding_strategy:
            if gen.get("do_sample"):
                spec.decoding_strategy = "top_p"
        for key in ("temperature", "top_k", "top_p"):
            if key in gen and not spec.decoding_strategy_config:
                pass  # carried via SamplingOptions defaults at query time
    return spec
