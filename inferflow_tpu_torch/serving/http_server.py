"""HTTP serving: engine loop thread + streaming handlers (port of
inferflow_tpu/serving/http_server.py).

reference: src/service/inferflow_service.{h,cc} — InferFlowServiceCore runs
the engine loop (~1ms cadence) accumulating per-query text; HTTP handlers
add queries and poll that map, streaming SSE chunks at >=16 utf8-complete
bytes; `/chat/completions` selects OpenAI mode (inferflow_service.cc:490).

Built on the stdlib ThreadingHTTPServer (the sslib BaseHttpServer analog).
The engine runs where it was built (the card unless the caller built it
on the CPU).  Where the JAX service would keep serving after a failed
step, this one does not: an exception in the loop thread ends the loop
and is kept (``InferFlowServiceCore.error``, ``InferFlowService.error``),
every waiting and later request is answered 500, and
``InferFlowService.raise_if_failed`` raises it again for the caller.
The encoder archetypes' synchronous core is not ported (ROADMAP A item 8).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..config.engine_config import expand_prompt_template
from ..runtime.engine import InferenceEngine
from ..sampling.strategies import SamplingOptions
from .service_data import InferFlowRequest, ResponseChunk, get_utf8_end_pos

MIN_CHUNK_BYTES = 16  # stream every >=16 utf8 bytes (inferflow_service.cc)
_POLL_S = 0.005  # a request's wait between looks at its result


class QueryResult:
    __slots__ = ("data", "is_end", "lock", "t0")

    def __init__(self):
        self.data = bytearray()
        self.is_end = False
        self.lock = threading.Lock()
        self.t0 = time.time()


class SyncServiceCore:
    """The encoder archetypes' per-request serving (encoder-only mask
    prediction, encoder-decoder generation): not ported, since their
    engines are not (ROADMAP A item 8)."""

    kind = "sync"

    def __init__(self, engine, prompt_template: str = "",
                 model_name: str = "inferflow-tpu"):
        raise NotImplementedError(
            f"serving {type(engine).__name__}: the encoder archetypes' "
            "synchronous service is not ported (ROADMAP A item 8)")


class InferFlowServiceCore(threading.Thread):
    """Engine loop thread (reference InferFlowServiceCore::Run,
    inferflow_service.cc:60-131)."""

    kind = "batching"

    def __init__(self, engine: InferenceEngine, prompt_template: str = "",
                 model_name: str = "inferflow-tpu"):
        super().__init__(daemon=True)
        self.engine = engine
        self.prompt_template = prompt_template or "{query}"
        self.model_name = model_name
        self.results: Dict[int, QueryResult] = {}
        self.error: Optional[BaseException] = None
        self.error_text = ""
        self._halt = threading.Event()
        # held across add_query + results registration (add_request) and
        # across result dispatch (run) so a token produced in that window
        # can't be dropped for lack of a registered QueryResult
        self._dispatch_lock = threading.Lock()

    def run(self):
        try:
            while not self._halt.is_set():
                if not self.engine.has_work():
                    time.sleep(0.001)
                    continue
                step = self.engine.infer()
                with self._dispatch_lock:
                    self._dispatch(step)
                self.engine.commit_inference_result(step)
        except BaseException as exc:  # noqa: BLE001 - kept for the caller
            self.error_text = traceback.format_exc()
            self.error = exc

    def _dispatch(self, step):
        for r in step:
            qr = self.results.get(r.query_id)
            if qr is None:
                continue
            with qr.lock:
                for tok in r.next_tokens:
                    if tok not in self.engine.eos_ids:
                        qr.data += self._token_bytes(tok)
                if r.is_end:
                    qr.is_end = True

    def _token_bytes(self, tok: int) -> bytes:
        tk = self.engine.tokenizer
        if tk is None:
            return (str(tok) + " ").encode()
        # sentencepiece visible space U+2581 -> ' '
        return tk.vocab.id_to_bytes(tok).replace(b"\xe2\x96\x81", b" ")

    def stop(self):
        self._halt.set()

    def add_request(self, req: InferFlowRequest) -> int:
        template = req.decoder_prompt_template or self.prompt_template
        prompt = expand_prompt_template(template, query=req.text,
                                        system_prompt=req.system_prompt,
                                        res_prefix=req.res_prefix, bos="")
        opts = SamplingOptions.from_strategy_string(
            req.decoding_alg or "top_p",
            temperature=req.temperature, seed=req.random_seed)
        tk = self.engine.tokenizer
        if tk is not None:
            from ..tokenizer.loading import tokenize_with_escapes
            tokens = tokenize_with_escapes(tk, prompt, add_bos=True)
        else:
            tokens = [int(x) for x in prompt.split() if x.isdigit()]
        with self._dispatch_lock:
            qid = self.engine.add_query(tokens, opts,
                                        max_new_tokens=req.max_output_len)
            if qid > 0:
                self.results[qid] = QueryResult()
        return qid


def make_handler(core: InferFlowServiceCore):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            try:
                return json.loads(raw.decode("utf-8"))
            except json.JSONDecodeError:
                return {}

        def _send_json(self, obj: str, status: int = 200):
            body = obj.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_failed(self):
            self._send_json(json.dumps(
                {"error": f"the engine loop failed: {core.error!r}"}), 500)

        def do_GET(self):
            if self.path in ("/health", "/"):
                if core.error is not None:
                    self._send_failed()
                    return
                table = getattr(core.engine, "table", None)
                self._send_json(json.dumps(
                    {"status": "ok", "model": core.model_name,
                     "active_queries": len(table.active) if table else 0}))
            else:
                self._send_json(json.dumps({"error": "not found"}), 404)

        def do_POST(self):
            is_openai = "chat/completions" in self.path
            data = self._read_body()
            req = (InferFlowRequest.from_openai_json(data) if is_openai
                   else InferFlowRequest.from_json(data))
            if not req.text:
                self._send_json(json.dumps({"error": "empty query"}), 400)
                return
            if core.error is not None:
                self._send_failed()
                return
            qid = core.add_request(req)
            if qid == -1:
                self._send_json(json.dumps(
                    {"error": "too many concurrent queries"}), 429)
                return
            if qid < 0:
                self._send_json(json.dumps({"error": "invalid query"}), 400)
                return
            if req.is_streaming_mode:
                self._stream(qid, req)
            else:
                self._blocking(qid, req)

        def _blocking(self, qid: int, req: InferFlowRequest):
            qr = core.results[qid]
            try:
                while True:
                    with qr.lock:
                        done = qr.is_end
                    if done:
                        break
                    if core.error is not None:
                        self._send_failed()
                        return
                    time.sleep(_POLL_S)
                with qr.lock:
                    text = qr.data.decode("utf-8", "replace")
                chunk = ResponseChunk(qid, text, True, core.model_name,
                                      time.time() - qr.t0)
                self._send_json(chunk.to_json_openai() if req.is_openai
                                else chunk.to_json())
            finally:
                core.results.pop(qid, None)

        def _stream(self, qid: int, req: InferFlowRequest):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            qr = core.results[qid]
            sent = 0
            try:
                while True:
                    with qr.lock:
                        data = bytes(qr.data)
                        done = qr.is_end
                    end = get_utf8_end_pos(data)
                    if end - sent >= MIN_CHUNK_BYTES or (done and end > sent):
                        piece = data[sent:end].decode("utf-8", "replace")
                        sent = end
                        chunk = ResponseChunk(qid, piece, False,
                                              core.model_name)
                        self._write_sse(chunk.to_json_openai_chunk()
                                        if req.is_openai else chunk.to_json())
                    if done and sent >= end:
                        final = ResponseChunk(qid, "", True, core.model_name,
                                              time.time() - qr.t0)
                        self._write_sse(final.to_json_openai_chunk()
                                        if req.is_openai else final.to_json())
                        if req.is_openai:
                            self._write_chunk(b"data: [DONE]\n\n")
                        self._write_chunk(b"")
                        break
                    if core.error is not None:
                        # the stream's status is sent: end it with an error
                        # event instead of a final chunk
                        self._write_sse(json.dumps(
                            {"error": f"the engine loop failed: "
                                      f"{core.error!r}"}))
                        self._write_chunk(b"")
                        break
                    time.sleep(_POLL_S)
            except (BrokenPipeError, ConnectionResetError):
                # client went away: drop the query
                # (inferflow_service.cc:284-288)
                core.engine.table.finish(qid, "disconnected")
            finally:
                core.results.pop(qid, None)

        def _write_sse(self, payload: str):
            self._write_chunk(f"data: {payload}\n\n".encode("utf-8"))

        def _write_chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

    return Handler


class InferFlowService:
    """HTTP server wrapper (reference InferFlowService :
    BaseHttpServer, inferflow_service.h:12), bound to host:port (port 0:
    an ephemeral one, read back as ``.port``)."""

    def __init__(self, engine, port: int = 8080,
                 prompt_template: str = "", model_name: str = "inferflow-tpu",
                 host: str = "0.0.0.0"):
        if isinstance(engine, InferenceEngine):
            self.core = InferFlowServiceCore(engine, prompt_template,
                                             model_name)
        else:  # encoder archetypes
            self.core = SyncServiceCore(engine, prompt_template, model_name)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.core))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._server_thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def error(self) -> Optional[BaseException]:
        """The exception that ended the engine loop, or None."""
        return self.core.error

    def raise_if_failed(self) -> None:
        """Raise the engine loop's exception again, if it ended on one."""
        if self.core.error is not None:
            raise RuntimeError("the engine loop failed:\n"
                               + self.core.error_text) from self.core.error

    def start(self, block: bool = True):
        self.core.start()
        self._serving = True
        if block:
            self.httpd.serve_forever()
        else:
            self._server_thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True)
            self._server_thread.start()

    def stop(self):
        """Stop the engine loop and the server, and wait for both."""
        self.core.stop()
        if self._serving:  # shutdown waits for serve_forever to return
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.core.is_alive():
            self.core.join()
        if self._server_thread is not None:
            self._server_thread.join()
