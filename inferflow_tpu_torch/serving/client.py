"""HTTP client for the service (reference: src/tools/inferflow_client.cc +
sslib HttpClient), stdlib-only; the JAX package's client with the native
requests' decoding algorithm selectable in streaming mode too."""

from __future__ import annotations

import json
from typing import Iterator
from urllib import request as urlreq


class InferFlowClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8080"):
        self.base_url = base_url.rstrip("/")

    def _post(self, path: str, body: dict, timeout: float):
        req = urlreq.Request(self.base_url + path,
                             json.dumps(body).encode("utf-8"),
                             {"Content-Type": "application/json"})
        return urlreq.urlopen(req, timeout=timeout)

    def health(self, timeout: float = 30.0) -> dict:
        with urlreq.urlopen(self.base_url + "/health",
                            timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def query(self, text: str, system_prompt: str = "",
              max_output_len: int = 256, temperature: float = 1.0,
              decoding_alg: str = "", openai: bool = False,
              timeout: float = 300.0) -> dict:
        """Blocking (non-streaming) request; returns the parsed response."""
        if openai:
            body = {"messages": [{"role": "user", "content": text}],
                    "max_tokens": max_output_len,
                    "temperature": temperature, "stream": False}
            path = "/v1/chat/completions"
        else:
            body = {"text": text, "system_prompt": system_prompt,
                    "max_output_len": max_output_len,
                    "temperature": temperature,
                    "decoding_alg": decoding_alg,
                    "is_streaming_mode": False}
            path = "/"
        with self._post(path, body, timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def stream(self, text: str, max_output_len: int = 256,
               openai: bool = False, timeout: float = 300.0,
               decoding_alg: str = "") -> Iterator[dict]:
        """SSE streaming request; yields parsed chunks."""
        if openai:
            body = {"messages": [{"role": "user", "content": text}],
                    "max_tokens": max_output_len, "stream": True}
            path = "/v1/chat/completions"
        else:
            body = {"text": text, "max_output_len": max_output_len,
                    "is_streaming_mode": True}
            if decoding_alg:
                body["decoding_alg"] = decoding_alg
            path = "/"
        with self._post(path, body, timeout) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                payload = line[len("data:"):].strip()
                if payload == "[DONE]":
                    return
                yield json.loads(payload)
