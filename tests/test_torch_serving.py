"""The port's HTTP/OpenAI service, its parsers, its CLIs and the engine's
warmup against the JAX package, on the CPU.

Both services serve test-tiny (vocab widened to 512 for a byte-level BPE
tokenizer.json written by loaders/synthetic.py, loaded by each package's
own loader) from the same Q4_B64T1 bytes, carried across through numpy;
the port's engine runs with device="cpu" (its plain versions).  They must
answer health, blocking, streamed (SSE) and OpenAI requests with the same
text, and frame them the same way up to ids, timestamps and the seconds a
request took.  The engines' logits agree within 2e-2 (tests/
test_torch_engine.py); greedy and seeded top-p choices on these prompts
are not near a tie, so the texts are equal.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.serving import InferFlowService as JService
from inferflow_tpu.serving import service_data as jsd
from inferflow_tpu.tokenizer.loading import load_tokenizer_json as jload_tok
from inferflow_tpu.tokenizer.tokenizer import Tokenizer as JTokenizer
from inferflow_tpu_torch.loaders.synthetic import (sample_text,
                                                   write_tokenizer_json)
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.serving import InferFlowClient
from inferflow_tpu_torch.serving import InferFlowService as TService
from inferflow_tpu_torch.serving import service_data as tsd
from inferflow_tpu_torch.tokenizer.loading import \
    load_tokenizer_json as tload_tok
from inferflow_tpu_torch.tokenizer.tokenizer import Tokenizer as TTokenizer
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import jax_params_to_numpy

VOCAB = 512
SLOTS = 4
MAX_NEW = 8
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX spec, params, tokenizer; port spec, params, tokenizer)."""
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    write_tokenizer_json(path, VOCAB, seed=0)
    spec_j = jzoo.make_spec("test-tiny", vocab=VOCAB)
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=1,
                                          stacked=True)
    spec_t = tzoo.make_spec("test-tiny", vocab=VOCAB)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return (spec_j, params_j, JTokenizer(jload_tok(path), "bpe"),
            spec_t, params_t, TTokenizer(tload_tok(path), "bpe"))


def _engines(models):
    spec_j, params_j, tok_j, spec_t, params_t, tok_t = models
    je = JEngine(spec_j, params_j, max_concurrent_queries=SLOTS,
                 max_context_len=256, kv_cache_quantized=True,
                 tokenizer=tok_j, vocab=tok_j.vocab)
    te = TEngine(spec_t, params_t, max_concurrent_queries=SLOTS,
                 max_context_len=256, kv_cache_quantized=True,
                 tokenizer=tok_t, vocab=tok_t.vocab, device="cpu")
    return je, te


def _sse(url: str, body: dict) -> list:
    """The raw SSE payloads of one streamed request, [DONE] included."""
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = [raw.decode("utf-8").rstrip("\n") for raw in resp]
    payloads = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    assert all(not ln or ln.startswith("data: ") for ln in lines)
    return payloads


def _norm(obj):
    """A response with its ids, timestamps and seconds taken out."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()
                if k not in ("id", "query_id", "created", "time_cost")}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _exchange(base: str, prompts: list) -> dict:
    """Every kind of request the service answers, each response kept."""
    client = InferFlowClient(base)
    out = {"health": client.health(timeout=TIMEOUT)}
    out["blocking"] = client.query(prompts[0], max_output_len=MAX_NEW,
                                   decoding_alg="greedy", timeout=TIMEOUT)
    out["stream"] = _sse(base + "/", {"text": prompts[0],
                                      "max_output_len": MAX_NEW,
                                      "decoding_alg": "greedy",
                                      "is_streaming_mode": True})
    out["openai"] = client.query(prompts[1], max_output_len=MAX_NEW,
                                 openai=True, timeout=TIMEOUT)
    out["openai_stream"] = _sse(
        base + "/v1/chat/completions",
        {"messages": [{"role": "user", "content": prompts[1]}],
         "max_tokens": MAX_NEW, "temperature": 1.0, "stream": True})
    answers = [None] * len(prompts)

    def one(i):
        answers[i] = client.query(prompts[i], max_output_len=MAX_NEW,
                                  decoding_alg="greedy", timeout=TIMEOUT)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    out["concurrent"] = answers
    return out


def test_service_matches_jax(models):
    """Health, a blocking query, the same prompt streamed, OpenAI blocking
    and streaming, and four concurrent greedy queries: the port's service
    on the CPU and JAX's give the same texts and the same framing; the
    port's texts are its engine's own greedy tokens."""
    prompts = [sample_text(n, seed=i) for i, n in enumerate((3, 9, 20, 40))]
    je, te = _engines(models)
    results, svcs = {}, []
    try:
        for name, svc in (("jax", JService(je, port=0,
                                           model_name="test-tiny")),
                          ("port", TService(te, port=0,
                                            model_name="test-tiny",
                                            host="127.0.0.1"))):
            svcs.append(svc)
            svc.start(block=False)
            results[name] = _exchange(f"http://127.0.0.1:{svc.port}",
                                      prompts)
    finally:
        for svc in svcs:
            svc.stop()
    j, t = results["jax"], results["port"]
    svcs[1].raise_if_failed()
    assert t["health"] == j["health"] == {"status": "ok",
                                          "model": "test-tiny",
                                          "active_queries": 0}
    assert _norm(t["blocking"]) == _norm(j["blocking"])
    text = t["blocking"]["text"]
    assert text and t["blocking"]["is_end"] is True
    assert set(t["blocking"]) == set(j["blocking"])
    for kind in ("stream", "openai_stream"):
        got, ref = ([json.loads(p) for p in r[kind] if p != "[DONE]"]
                    for r in (t, j))
        assert (t[kind][-1] == "[DONE]") == (j[kind][-1] == "[DONE]") == (
            kind == "openai_stream")
        assert _norm(got[-1]) == _norm(ref[-1])  # the final chunk
        pick = ((lambda c: c["text"]) if kind == "stream" else
                (lambda c: c["choices"][0]["delta"]["content"]))
        assert "".join(map(pick, got)) == "".join(map(pick, ref))
        for c in got[:-2]:  # every chunk but the last two: >= 16 bytes
            assert len(pick(c).encode()) >= 16
        assert {k for c in got for k in c} == {k for c in ref for k in c}
    assert "".join(c["text"] for c in map(json.loads, t["stream"])) == text
    assert _norm(t["openai"]) == _norm(j["openai"])
    assert t["openai"]["object"] == "chat.completion"
    assert t["openai"]["choices"][0]["message"]["content"]
    assert [_norm(a) for a in t["concurrent"]] == [
        _norm(a) for a in j["concurrent"]]
    assert t["concurrent"][0]["text"] == text
    # the texts are the port engine's own greedy tokens, detokenized
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    _, eng = _engines(models)
    tok = models[5]
    for prompt, answer in zip(prompts, t["concurrent"]):
        ids = eng.generate(tok.tokenize(prompt, add_bos=True),
                           SamplingOptions(strategy="greedy"), MAX_NEW)
        want = b"".join(tok.vocab.id_to_bytes(i) for i in ids).replace(
            b"\xe2\x96\x81", b" ").decode("utf-8", "replace")
        assert answer["text"] == want


def test_service_data_matches_jax():
    """InferFlowRequest's native and OpenAI parsers, ResponseChunk's three
    JSON forms and get_utf8_end_pos against the JAX package's."""
    bodies = [{}, {"text": "hi", "max_output_len": 5, "stream": True},
              {"query": "q", "prompt_template": "[{query}]", "seed": 3,
               "strategy": "greedy", "temperature": 0.5, "max_tokens": 7},
              {"text": "x", "decoding_alg": "top_k", "random_seed": "4",
               "is_streaming_mode": 1, "system_prompt": "s",
               "res_prefix": "r", "encoder_prompt_template": "e"}]
    for body in bodies:
        assert vars(tsd.InferFlowRequest.from_json(body)) == vars(
            jsd.InferFlowRequest.from_json(body))
    openai = [{"messages": [{"role": "system", "content": "sys"},
                            {"role": "user", "content": "u"},
                            {"role": "assistant", "content": "a"}],
               "max_tokens": 9, "stream": True, "seed": 5},
              {"messages": [{"content": "only"}], "top_p": 0.9},
              {"messages": [], "temperature": 0.1, "seed": None}]
    for body in openai:
        assert vars(tsd.InferFlowRequest.from_openai_json(body)) == vars(
            jsd.InferFlowRequest.from_openai_json(body))
    for args in ((3, "abc", False), (4, "é✓", True, "m", 1.23456)):
        got, ref = tsd.ResponseChunk(*args), jsd.ResponseChunk(*args)
        for form in ("to_json", "to_json_openai", "to_json_openai_chunk"):
            a, b = (json.loads(getattr(c, form)()) for c in (got, ref))
            assert abs(a.pop("created", 0) - b.pop("created", 0)) <= 1
            assert a == b, form
    rng = np.random.default_rng(0)
    text = "aé✓😀b".encode()
    cases = [text[:i] for i in range(len(text) + 1)]
    cases += [bytes(rng.integers(0, 256, int(rng.integers(0, 8))).tolist())
              for _ in range(200)]
    for data in cases:
        assert tsd.get_utf8_end_pos(data) == jsd.get_utf8_end_pos(data)


def test_loop_failure_is_kept(models):
    """An exception in the engine loop ends the loop and is kept: a waiting
    request and every later one get 500, health too, and the caller reads
    it back (raise_if_failed); an encoder engine is refused."""
    _, eng = _engines(models)

    def broken():
        raise RuntimeError("step failed")

    eng.infer = broken
    svc = TService(eng, port=0, host="127.0.0.1")
    svc.start(block=False)
    base = f"http://127.0.0.1:{svc.port}"
    try:
        for _ in range(2):
            with pytest.raises(urllib.error.HTTPError) as err:
                InferFlowClient(base).query("a b c", max_output_len=4,
                                            timeout=TIMEOUT)
            assert err.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as err:
            InferFlowClient(base).health(timeout=TIMEOUT)
        assert err.value.code == 500
        assert isinstance(svc.error, RuntimeError)
        assert not svc.core.is_alive()
        with pytest.raises(RuntimeError, match="step failed"):
            svc.raise_if_failed()
    finally:
        svc.stop()
    with pytest.raises(NotImplementedError, match="A item 8"):
        TService(object(), port=0, host="127.0.0.1")


def test_warmup_leaves_the_engine_as_it_was(models):
    """warmup() runs every bucket, a chunk and a decode step, and leaves
    the table, the cache rows and lengths and the page pool as it found
    them, with a query in flight: its tokens equal an engine's that did
    not warm up; dense (a chunk) and paged."""
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    spec_t, params_t = models[3], models[4]
    prompt = list(range(5, 45))
    for kw in ({}, {"kv_cache_paging": True, "kv_pool_tokens": 2048}):
        outs = []
        for warm in (False, True):
            eng = TEngine(spec_t, params_t, max_concurrent_queries=SLOTS,
                          max_context_len=512, kv_cache_quantized=True,
                          device="cpu", **kw)
            eng.prefill_chunk = 32
            qid = eng.add_query(prompt, SamplingOptions(strategy="greedy"),
                                MAX_NEW)
            eng.commit_inference_result(eng.infer())  # first chunk
            eng.commit_inference_result(eng.infer())
            if warm:
                before = [a.clone() for a in eng._cache_arrays()]
                state = (eng.cache.length.clone(),
                         len(eng.table), list(eng._free_pages),
                         None if not kw else eng.cache.page_table.clone())
                calls = []
                real = eng._decode_step
                eng._decode_step = lambda *a: calls.append(1) or real(*a)
                eng.warmup()
                assert calls == [1]
                for a, b in zip(eng._cache_arrays(), before):
                    assert torch.equal(a, b)
                assert torch.equal(eng.cache.length, state[0])
                assert len(eng.table) == state[1]
                assert eng._free_pages == state[2]
                if kw:
                    assert torch.equal(eng.cache.page_table, state[3])
            while eng.has_work():
                eng.commit_inference_result(eng.infer())
            outs.append(eng.query_tokens(qid))
        assert outs[0] == outs[1] and len(outs[0]) == MAX_NEW


def test_clis_run_on_the_cpu(tmp_path, capsys):
    """Each CLI's main once on test-tiny with --device cpu: the service
    (warmed up, bound, answering both clients' requests), the client
    (blocking native and streamed OpenAI) and llm_inference; multi-host
    flags are refused."""
    from inferflow_tpu_torch.tools import inferflow_client, inferflow_service
    from inferflow_tpu_torch.tools import llm_inference
    svc = inferflow_service.main(
        ["--zoo", "test-tiny", "--quant", "Q4_B64T1", "--device", "cpu",
         "--port", "0", "--host", "127.0.0.1", "--max-queries", "2"],
        block=False)
    try:
        url = f"http://127.0.0.1:{svc.port}"
        assert svc.core.engine.device.type == "cpu"
        text = inferflow_client.main(["--url", url, "--query", "3 17 9",
                                      "--max-output-len", "4"])
        assert len(text.split()) == 4
        streamed = inferflow_client.main(["--url", url, "--query", "3 17",
                                          "--max-output-len", "3",
                                          "--openai", "--stream"])
        assert len(streamed.split()) == 3
        svc.raise_if_failed()
    finally:
        svc.stop()
    out = llm_inference.main(["--zoo", "test-tiny", "--quant", "Q4_B64T1",
                              "--device", "cpu", "--max-new", "4",
                              "--prompt", "a", "--prompt", "b"])
    assert sorted(out) == [1, 2] and all(len(t) == 4 for t in out.values())
    assert "tokens/sec" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="A item 10"):
        inferflow_service.main(["--zoo", "test-tiny", "--device", "cpu",
                                "--coordinator", "host0:1234",
                                "--num-processes", "2"])
