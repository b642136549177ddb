"""Model schema: hyperparameters + the full config surface (a copy of
inferflow_tpu/models/spec.py, kept so that the PyTorch package imports
nothing of the JAX one).

Mirrors the reference's ModelHyperParams / ModelSpec (src/transformer/
model.h:41-151) and NetworkType (network_structure.h:98-112), as python
dataclasses consumed by the loaders, graph builders, and engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

NETWORK_TYPES = {
    # model_spec.json "type" strings -> archetype
    "transformer": "decoder_only",
    "transformer.decoder_only": "decoder_only",
    "transformer.llama": "decoder_only",
    "llama": "decoder_only",
    "transformer.bloom": "decoder_only",
    "bloom": "decoder_only",
    "transformer.encoder_decoder": "encoder_decoder",
    "encoder_decoder": "encoder_decoder",
    "transformer.encoder_only": "encoder_only",
    "encoder_only": "encoder_only",
    "bert": "encoder_only",
    "transformer.bert": "encoder_only",
    "transformer.sparse_moe": "decoder_only",
    "sparse_moe": "decoder_only",
    "transformer.sparse_moe.decoder_only": "decoder_only",
}


@dataclasses.dataclass
class HyperParams:
    """reference: ModelHyperParams (model.h:41-70)"""

    vocab_size: int = 0
    padded_vocab_size: int = 0
    output_vocab_size: int = 0
    embd_dims: int = 0

    encoder_layers: int = 0
    encoder_heads: int = 0
    encoder_kv_heads: int = 0

    decoder_layers: int = 0
    decoder_heads: int = 0
    hidden_dim: int = 0  # head_dim * heads (attention inner dim)
    decoder_kv_heads: int = 0
    decoder_intermediate_size: int = 0

    training_context_len: int = -1

    # MoE
    experts: int = 0
    in_use_experts: int = 0
    moe_top_k: int = 0
    moe_norm_top_k_prob: bool = True
    moe_layer_start: int = 0
    moe_layer_end: int = -1
    has_shared_expert: bool = False

    @property
    def head_dim(self) -> int:
        heads = self.decoder_heads or self.encoder_heads
        inner = self.hidden_dim or self.embd_dims
        return inner // heads

    @property
    def kv_heads(self) -> int:
        return self.decoder_kv_heads or self.decoder_heads


@dataclasses.dataclass
class ModelSpec:
    """reference: ModelSpec (model.h:72-151)"""

    sid: str = ""
    hyper_params: HyperParams = dataclasses.field(default_factory=HyperParams)

    dir: str = ""
    spec_file: str = ""
    model_files: List[str] = dataclasses.field(default_factory=list)
    config_file: str = ""
    tokenizer_files: List[str] = dataclasses.field(default_factory=list)
    token_remap_file: str = ""
    tokenization_algorithm: str = "bpe"  # std|fmm|fmm2|bpe|ulm
    generation_config_file: str = ""
    token_bytes_mapping: int = 0
    model_file_format: str = "unknown"  # std|pickle|safetensors|ggml|gguf|llama2.c
    network_structure: str = "transformer.llama"

    norm_alg: str = "rms"  # std|rms|linear
    activation_fn: str = "silu"
    pos_embedding_alg: str = "rope"  # empty|rope|alibi|sinusoidal|sinusoidal2
    has_embedding_linear_norm: bool = False
    embedding_linear_scale: float = 0.0
    has_linear_norm_before_sinusoidal: bool = True
    rope_theta: float = 10000.0
    rope_dim: int = -1
    partial_rotary_factor: float = 1.0
    pos_embedding_offset: int = 0
    attn_pre_norm_base: float = 0.0
    ffn_pre_norm_base: float = 0.0
    output_norm_base: float = 0.0
    attn_out_scale: float = 1.0
    ffn_out_scale: float = 1.0
    out_scale: float = 1.0
    tensor_name_map: Dict[str, str] = dataclasses.field(default_factory=dict)
    tensor_name_pre_map: Dict[str, str] = dataclasses.field(default_factory=dict)

    tie_word_embeddings: bool = False
    qk_column_order: int = 0
    qkv_format: int = 0  # 0: split by head then Q+K+V; 1: Q+K+V
    # fused w1n3 column layout: 0/1 = [all W1 | all W3]; r > 1 = rank-major
    # [w1_0|w3_0|...|w1_{r-1}|w3_{r-1}] so a contiguous tensor-parallel
    # shard holds a matched (w1_r, w3_r) pair (parallel/tp_step.py)
    w1n3_ranks: int = 0
    kq_scale: float = 1.0
    transform_qk: bool = False
    normalize_lm_head: bool = False
    is_attn_post_as_residual: bool = True
    is_parallel_attn: bool = False
    mlp_attn_share_input: bool = False
    tensor_name_prefix: str = ""

    use_self_attn_pre_norm: bool = True

    unk_token: str = ""
    pad_token: str = ""
    bos_token: str = ""
    eos_token: str = ""
    mask_token: str = ""

    decoding_strategy: str = ""
    decoding_strategy_config: str = ""

    encoder_input_template: str = ""
    decoder_input_template: str = ""

    be_host_embeddings: bool = True
    device_weight_data_type: str = "F16"
    # device layout for sub-byte weight formats: "" keeps the wire packing;
    # "q8c" re-encodes into the int8-container fast path at load
    # (quant/codec_jax.requantize_q8_container)
    device_layout: str = ""
    device_weight_data_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    device_kv_cache_data_type: str = "Q8_B32T2"
    host_weight_data_type: str = "F16"
    delta_tensor_ratio: float = 0.0
    tensor_quant_threshold: int = 2000 * 2000
    host_kv_cache_percent: int = 0
    has_cross_attn_kv_cache: bool = True

    max_context_len: int = -1
    max_input_len: int = 1024

    multi_gpu_strategy: str = "by_layer"  # by_layer|by_tensor|hybrid
    device_groups: List[List[int]] = dataclasses.field(default_factory=list)
    encoder_cpu_layer_count: int = -1
    decoder_cpu_layer_count: int = -1

    is_eager_device_building: bool = False

    # norm eps (the reference hard-codes eps in kernels; HF configs carry it)
    norm_eps: float = 1e-5

    @property
    def archetype(self) -> str:
        key = self.network_structure.lower()
        return NETWORK_TYPES.get(key, "decoder_only")

    @property
    def rope_order(self) -> int:
        """qk_column_order 2 -> half-split ("rotate_half", reference
        PosEmbedding_Rope_Order2_Kernel); 0/1 -> interleaved pairs
        (PosEmbedding_Rope_Std_Kernel) — the reference dispatches Order2
        only when order_type == 2 (tensor_opr.cu:727)."""
        return 2 if self.qk_column_order == 2 else 1

    def effective_rope_dim(self) -> int:
        hd = self.hyper_params.head_dim
        if self.rope_dim > 0:
            return self.rope_dim
        if self.partial_rotary_factor < 1.0:
            return int(hd * self.partial_rotary_factor)
        return hd
