"""The port's engine construction from config (``runtime/factory.
make_engine`` -> ``InferenceEngine.from_config`` -> ``load_model`` and
``load_tokenizer``) against the JAX package's, from files written in
tmp_path: an ini in the deployment of configs/inferflow_service.q4b32.ini
(8 -> 4 slots, Q8 cache), a test-llama-shaped safetensors checkpoint
(Hugging Face names, bf16, sharded through an index), its config.json,
a generated tokenizer.json and a copy of the llama2_7b model_spec.json.

Both engines serve the same three greedy queries (one from text through
the loaded tokenizer, one of 70 tokens prefilled in three 32-token chunks
since max_batch_tokens = 32), in the i4 layout (Q4_B32T1A: every decode
step the fused step's i4x8 mode, INFERFLOW_I4_DOT=i8, the JAX one in
interpret mode) and in the packed layout (wire planes, the per-layer
path).  The layout is pinned in the ini (ROADMAP C2: the JAX auto rule
resolves nothing off its accelerator).

Tolerance: every sampled logits row within ENGINE_LOGIT_TOL = 5e-2
(logits of magnitude ~1; the two engines quantize the same bytes and take
the same int8 activation codes in the fused step, so they differ by
float32 summation orders and bf16 roundings, as tests/test_torch_i4.py
states), and greedy tokens equal but at a near-tie of the JAX engine's
logits (top-2 gap within twice the tolerance).
"""

import functools
import os
import shutil

import numpy as np
import pytest

from inferflow_tpu.config import load_engine_config as jload_config
from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.runtime.factory import make_engine as jmake_engine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.config import load_engine_config as tload_config
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.loaders.synthetic import (llama_config, sample_text,
                                                   write_llama_checkpoint,
                                                   write_tokenizer_json)
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.factory import make_engine as tmake_engine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.utils.logging_util import memory_stat

from test_torch_engine import _record_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_LOGIT_TOL = 5e-2
MODEL = "llama2_7b"


def _ini(root: str, layout: str, extra: str = "", devices: str = "0",
         spec_name: str = "model_spec.json") -> str:
    """The q4b32 ini's deployment, cut to 4 slots and a 256-token context,
    with the given layout."""
    path = os.path.join(root, f"svc_{layout}.ini")
    with open(path, "w") as fh:
        fh.write(f"""[main]
global_model_dir = ${{data_root_dir}}models/

[transformer_engine]
models = {MODEL}
devices = {devices}
max_concurrent_queries = 4
max_batch_tokens = 32
{extra}
[model.{MODEL}]
model_dir = ${{global_model_dir}}${{model_name}}/
model_specification_file = ${{model_dir}}{spec_name}
device_weight_data_type = Q4_B32T1A
device_kv_cache_data_type = Q8
device_layout = {layout}
max_context_len = 256
tensor_quant_threshold = 0
""")
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The data root: models/llama2_7b/ with the checkpoint, its config,
    tokenizer and model_spec.json."""
    d = str(tmp_path_factory.mktemp("data_root"))
    mdir = os.path.join(d, "models", MODEL)
    write_llama_checkpoint(mdir, llama_config(256, 512, 2, 8, 2, 512,
                                              context=256),
                           seed=11, shard_bytes=900_000, device="cpu")
    write_tokenizer_json(os.path.join(mdir, "tokenizer.json"), 512, seed=1)
    shutil.copy(os.path.join(ROOT, "configs", "models", MODEL,
                             "model_spec.json"), mdir)
    return d


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """The JAX engine's fused decode path on the CPU: forced on, its Pallas
    kernel in interpret mode, pinned to i4x8."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setenv("INFERFLOW_I4_DOT", "i8")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    yield
    jds.enable_mega()


def _serve(eng, opts, prompts):
    qids = [eng.add_query(p, opts, max_new_tokens=6) for p in prompts]
    assert all(q > 0 for q in qids)
    for _ in range(60):
        if not eng.has_work():
            break
        eng.commit_inference_result(eng.infer())
    assert not eng.has_work()
    return [eng.query_tokens(q) for q in qids]


@pytest.mark.parametrize("layout", ["i4", "packed"])
def test_make_engine_matches_jax(root, layout, jax_fused_interpret,
                                 monkeypatch):
    ini = _ini(root, layout)
    je = jmake_engine(jload_config(ini, data_root_dir=root + "/"))
    te = tmake_engine(tload_config(ini, data_root_dir=root + "/"),
                      device="cpu")
    assert isinstance(te, TEngine) and te.prefill_chunk == 32
    assert te.spec.device_layout == layout
    planes = set(te.params["layers"][0]["attn"]["qkv"].planes)
    assert planes == ({"data_i4p"} if layout == "i4" else {"data"})
    calls = {"fused": 0}
    real = tds.fused_decode_step_plain
    monkeypatch.setattr(tds, "fused_decode_step_plain", lambda *a, **k: (
        calls.__setitem__("fused", calls["fused"] + 1) or real(*a, **k)))
    vocab = te.spec.hyper_params.vocab_size
    rng = np.random.default_rng(5)
    prompts = [sample_text(12, seed=2),
               [int(t) for t in rng.integers(3, vocab, 70)],
               [int(t) for t in rng.integers(3, vocab, 9)]]
    assert te.tokenizer.tokenize(prompts[0], add_bos=True) == \
        je.tokenizer.tokenize(prompts[0], add_bos=True)
    jr, tr = _record_rows(je), _record_rows(te)
    ref = _serve(je, JOpts(strategy="greedy"), prompts)
    got = _serve(te, TOpts(strategy="greedy"), prompts)
    assert (calls["fused"] > 0) == (layout == "i4")
    assert jds.mega_disabled() is None  # the JAX engine kept its fused path
    for q, (a, b) in enumerate(zip(got, ref), start=1):
        assert len(a) == len(b) == 6
        for i, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if x != y:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (q, i)
                break


def test_config_wiring_and_refusals(root):
    """from_config wires the study and perf flags, the prefill budget and
    paging (and the engine's memory statistics count its weights and
    cache); the encoder archetypes (ROADMAP A item 8) and serving over
    more than one device (A item 10) raise NotImplementedError."""
    ini = _ini(root, "packed", extra="is_study_mode = false\n"
               "enable_perf_stat = true\nkv_cache_paging = true\n")
    eng = tmake_engine(tload_config(ini, data_root_dir=root + "/"),
                       device="cpu")
    assert eng.perf.enabled and not eng.study.enabled
    assert eng.prefill_chunk == 32 and eng._paging
    stat = memory_stat(eng.params, eng.cache)
    assert stat["weight_bytes"] == sum(
        t.nbytes for lp in eng.params["layers"] for g in lp.values()
        for t in g.values()) + eng.params["lm_head"].nbytes + sum(
        eng.params[k].numel() * 2 for k in ("dec_embeddings",
                                            "dec_output_norm"))
    assert stat["kv_cache_bytes"] > 0 and "bytes_in_use" not in stat
    eng.generate([5, 6, 7], TOpts(strategy="greedy"), 2)
    assert eng.perf.time_map
    multi = _ini(root, "packed", devices="0;1")
    with pytest.raises(NotImplementedError, match="A item 10"):
        tmake_engine(tload_config(multi, data_root_dir=root + "/"),
                     device="cpu")
    mdir = os.path.join(root, "models", MODEL)
    with open(os.path.join(mdir, "bert_spec.json"), "w") as fh:
        fh.write('{"network_structure": {"type": "bert"}}')
    bert = _ini(root, "packed", spec_name="bert_spec.json")
    with pytest.raises(NotImplementedError, match="A item 8"):
        tmake_engine(tload_config(bert, data_root_dir=root + "/"),
                     device="cpu")
