"""Engine / service configuration loading.

reference: InferenceEngine::LoadConfig / LoadModelSpec / LoadDeviceGroups /
LoadPromptTemplates (src/transformer/inference_engine.cc:1412-1836):
`[main]` (http port/workers), `[transformer_engine]` (models, devices,
max_concurrent_queries, cpu layers, debug), `[model.X]` per-model overrides
(weight/KV dtypes, host offload, context len, prompt template), and the
`devices = 0&1;2&3` group syntax whose shape implies the multi-device
strategy (by-layer `;`, by-tensor `&`, hybrid both;
inference_engine.cc:1509-1515,1738-1783).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..models.spec import ModelSpec
from .ini import ConfigData
from .model_spec import load_model_spec


def parse_device_groups(text: str) -> List[List[int]]:
    """'0&1;2&3' -> [[0,1],[2,3]]  (`;` layer groups, `&` tensor ranks)."""
    groups = []
    for part in text.replace(" ", "").split(";"):
        if not part:
            continue
        groups.append([int(x) for x in part.split("&") if x != ""])
    return groups


def strategy_from_groups(groups: List[List[int]]) -> str:
    if len(groups) > 1 and any(len(g) > 1 for g in groups):
        return "hybrid"
    if len(groups) > 1:
        return "by_layer"
    if groups and len(groups[0]) > 1:
        return "by_tensor"
    return "by_layer"


@dataclasses.dataclass
class EngineConfig:
    """reference: InferenceConfig (inference_types.h:21-43)."""

    models: List[ModelSpec] = dataclasses.field(default_factory=list)
    http_port: int = 8080
    worker_count: int = 8
    max_concurrent_queries: int = 16
    max_batch_tokens: int = 256
    device_groups: List[List[int]] = dataclasses.field(default_factory=list)
    multi_device_strategy: str = "by_layer"
    decoder_cpu_layer_count: int = 0
    sequence_parallel: int = 0  # >1: ring-attention prefill over 'sp'
    pipeline_prefill: bool = False  # micro-batch pipeline over 'pp'
    kv_cache_paging: bool = False  # page-pool KV cache (runtime/paged_kv)
    kv_pool_tokens: int = 0  # pool size; 0 = slots * max_context
    encoder_cpu_layer_count: int = 0
    cpu_threads: int = 8
    return_output_tensors: bool = False
    # debug options (DebugOptions, inference_types.h:21-26)
    is_study_mode: bool = False
    show_tensors: bool = False
    enable_perf_stat: bool = False
    default_prompt_template: str = "{query}"
    prompt_templates: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> Optional[ModelSpec]:
        return self.models[0] if self.models else None


def load_engine_config(path: str, data_root_dir: str = "",
                       section: str = "transformer_engine") -> EngineConfig:
    macros = {"data_root_dir": data_root_dir or os.path.dirname(path) + "/"}
    cfg = ConfigData.load(path, macros)
    ec = EngineConfig()
    ec.http_port = cfg.get_int("main", "http_port", 8080)
    ec.worker_count = cfg.get_int("main", "worker_count", 8)
    ec.default_prompt_template = cfg.get(
        "main", "default_prompt_template", "{query}")
    ec.is_study_mode = cfg.get_bool("main", "is_study_mode", False)

    ec.max_concurrent_queries = cfg.get_int(section, "max_concurrent_queries",
                                            16)
    ec.max_batch_tokens = cfg.get_int(section, "max_batch_tokens", 256)
    ec.decoder_cpu_layer_count = cfg.get_int(section,
                                             "decoder_cpu_layer_count", 0)
    ec.encoder_cpu_layer_count = cfg.get_int(section,
                                             "encoder_cpu_layer_count", 0)
    ec.cpu_threads = cfg.get_int(section, "cpu_threads", 8)
    ec.return_output_tensors = cfg.get_bool(section, "return_output_tensors",
                                            False)
    ec.is_study_mode = cfg.get_bool(section, "is_study_mode",
                                    ec.is_study_mode)
    ec.show_tensors = cfg.get_bool(section, "show_tensors", False)
    ec.enable_perf_stat = cfg.get_bool(section, "enable_perf_stat", False)

    ec.sequence_parallel = cfg.get_int(section, "sequence_parallel", 0)
    ec.pipeline_prefill = cfg.get_bool(section, "pipeline_prefill", False)
    ec.kv_cache_paging = cfg.get_bool(section, "kv_cache_paging", False)
    ec.kv_pool_tokens = cfg.get_int(section, "kv_pool_tokens", 0)
    ec.device_groups = parse_device_groups(cfg.get(section, "devices", "0"))
    ec.multi_device_strategy = strategy_from_groups(ec.device_groups)

    # prompt template sections ([prompt_template.X], multi-line via {\n})
    for sec in cfg.section_names():
        if sec.startswith("prompt_template."):
            name = sec[len("prompt_template."):]
            tpl = cfg.get(sec, "template", "")
            ec.prompt_templates[name] = tpl

    for model_name in cfg.get_list(section, "models"):
        extra = {"model_name": model_name}
        msec = f"model.{model_name}"
        spec_file = cfg.get(msec, "model_specification_file", "", extra)
        model_dir = cfg.get(msec, "model_dir", "", extra)
        if spec_file and os.path.isfile(spec_file):
            spec = load_model_spec(spec_file, sid=model_name)
        else:
            spec = ModelSpec(sid=model_name)
        if model_dir:
            spec.dir = model_dir
        # per-model overrides (inference_engine.cc LoadModelSpec tail)
        val = cfg.get(msec, "device_weight_data_type", "", extra)
        if val:
            spec.device_weight_data_type = val
        val = cfg.get(msec, "device_layout", "", extra)
        if val:
            spec.device_layout = val.lower()
        val = cfg.get(msec, "device_kv_cache_data_type", "", extra)
        if val:
            spec.device_kv_cache_data_type = val
        val = cfg.get(msec, "host_weight_data_type", "", extra)
        if val:
            spec.host_weight_data_type = val
        spec.host_kv_cache_percent = cfg.get_int(msec, "host_kv_cache_percent",
                                                 spec.host_kv_cache_percent,
                                                 extra)
        spec.be_host_embeddings = cfg.get_bool(msec, "be_host_embeddings",
                                               spec.be_host_embeddings, extra)
        spec.delta_tensor_ratio = cfg.get_float(msec, "delta_tensor_ratio",
                                                spec.delta_tensor_ratio,
                                                extra)
        spec.tensor_quant_threshold = cfg.get_int(
            msec, "tensor_quant_threshold", spec.tensor_quant_threshold,
            extra)
        mcl = cfg.get_int(msec, "max_context_len", -1, extra)
        if mcl > 0:
            spec.max_context_len = mcl
        val = cfg.get(msec, "prompt_template", "", extra)
        if val:
            spec.decoder_input_template = val
        val = cfg.get(msec, "decoding_strategy", "", extra)
        if val:
            spec.decoding_strategy = val
        ec.models.append(spec)
    return ec


def expand_prompt_template(template: str, query: str = "",
                           system_prompt: str = "", res_prefix: str = "",
                           bos: str = "", eos: str = "") -> str:
    """Prompt template expansion
    (reference BuildEncoderInput/BuildDecoderInput keys
    `{query}/{bos}/{eos}/{system_prompt}/{res_prefix}/{\\n}`,
    inference_engine.cc:456-709).  `{#id}` token-id escapes are resolved at
    tokenization time by the tokenizer (kept verbatim here)."""
    out = template
    out = out.replace(r"{\n}", "\n")
    out = out.replace("{query}", query)
    out = out.replace("{system_prompt}", system_prompt)
    out = out.replace("{res_prefix}", res_prefix)
    out = out.replace("{bos}", bos)
    out = out.replace("{eos}", eos)
    return out
