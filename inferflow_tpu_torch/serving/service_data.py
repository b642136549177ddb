"""Service request/response types: native + OpenAI chat JSON (a copy of
inferflow_tpu/serving/service_data.py, kept so that the PyTorch package
imports nothing of the JAX one).

reference: src/service/service_data.{h,cc} — InferFlowRequest with both
native and OpenAI parsers (service_data.h:34-35), InferFlowResponseChunk
with ToJson / ToJson_OpenAI{,_Chunk} SSE formats.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional


@dataclasses.dataclass
class InferFlowRequest:
    """reference: InferFlowRequest (service_data.h:16-36)."""

    text: str = ""
    system_prompt: str = ""
    res_prefix: str = ""
    encoder_prompt_template: str = ""
    decoder_prompt_template: str = ""
    decoding_alg: str = ""
    random_seed: int = 0
    temperature: float = 1.0
    max_output_len: int = 256
    is_streaming_mode: bool = False
    query_id: int = 0
    is_openai: bool = False

    @classmethod
    def from_json(cls, data: dict) -> "InferFlowRequest":
        req = cls()
        req.text = data.get("text", data.get("query", ""))
        req.system_prompt = data.get("system_prompt", "")
        req.res_prefix = data.get("res_prefix", "")
        req.encoder_prompt_template = data.get("encoder_prompt_template", "")
        req.decoder_prompt_template = data.get(
            "decoder_prompt_template", data.get("prompt_template", ""))
        req.decoding_alg = data.get("decoding_alg", data.get("strategy", ""))
        req.random_seed = int(data.get("random_seed", data.get("seed", 0)))
        req.temperature = float(data.get("temperature", 1.0))
        req.max_output_len = int(data.get("max_output_len",
                                          data.get("max_tokens", 256)))
        req.is_streaming_mode = bool(data.get("is_streaming_mode",
                                              data.get("stream", False)))
        return req

    @classmethod
    def from_openai_json(cls, data: dict) -> "InferFlowRequest":
        """OpenAI /chat/completions body (service_data.cc OpenAI parser)."""
        req = cls()
        req.is_openai = True
        for msg in data.get("messages", []):
            role = msg.get("role", "user")
            content = msg.get("content", "")
            if role == "system":
                req.system_prompt = content
            elif role == "assistant":
                req.res_prefix = content
            else:
                req.text = content
        req.temperature = float(data.get("temperature", 1.0))
        req.max_output_len = int(data.get("max_tokens", 256))
        req.is_streaming_mode = bool(data.get("stream", False))
        if data.get("top_p") is not None or data.get("temperature") is not None:
            req.decoding_alg = "top_p"
        if data.get("seed") is not None:
            req.random_seed = int(data.get("seed") or 0)
        return req


@dataclasses.dataclass
class ResponseChunk:
    """reference: InferFlowResponseChunk (service_data.h:38-60)."""

    query_id: int
    text: str
    is_end: bool = False
    model: str = "inferflow-tpu"
    time_cost: float = 0.0

    def to_json(self) -> str:
        return json.dumps({"query_id": self.query_id, "text": self.text,
                           "is_end": self.is_end,
                           "time_cost": round(self.time_cost, 3)},
                          ensure_ascii=False)

    def to_json_openai(self) -> str:
        return json.dumps({
            "id": f"chatcmpl-{self.query_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": self.text},
                "finish_reason": "stop" if self.is_end else None,
            }],
        }, ensure_ascii=False)

    def to_json_openai_chunk(self) -> str:
        return json.dumps({
            "id": f"chatcmpl-{self.query_id}",
            "object": "chat.completion.chunk",
            "created": int(time.time()),
            "model": self.model,
            "choices": [{
                "index": 0,
                "delta": {"content": self.text},
                "finish_reason": "stop" if self.is_end else None,
            }],
        }, ensure_ascii=False)


def get_utf8_end_pos(data: bytes) -> int:
    """Largest prefix length that is complete utf-8
    (reference GetUtf8EndPos, inferflow_service.cc:409-433)."""
    n = len(data)
    i = n
    while i > 0 and (data[i - 1] & 0xC0) == 0x80:
        i -= 1
    if i == 0:
        return 0
    lead = data[i - 1]
    if lead < 0x80:
        return n
    need = 2 if lead >= 0xC0 and lead < 0xE0 else \
        3 if lead < 0xF0 else 4
    have = n - i + 1
    return n if have >= need else i - 1
