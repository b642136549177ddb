"""The port's InferenceEngine against the JAX InferenceEngine on test-tiny.

Same weights on both sides (Q4_B64T1 wire planes with ``device_layout =
"packed"`` pinned, moved over with ``weights.params_from_numpy``), a Q8 KV
cache, greedy sampling.  Each engine's sampler is wrapped to record the
logits row it is given, so the test compares:
  - the logits of every step while the two greedy streams agree:
    |diff| <= 2e-2 (the port's decode and chunk attention dequantize K/V in
    float32 where the JAX CPU path rounds them to bf16; logits move by a
    few bf16 steps of ~8e-3);
  - the streams themselves: equal token for token, except that they may
    part at a near-tie, a step where the JAX engine's two best logits are
    within 2 * 2e-2 of each other (random weights make such ties; after
    one, greedy streams go their own ways).  Without a near-tie the whole
    stream must agree.
"""

import numpy as np
import pytest

from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts

from test_torch_decoder import tiny_models

LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=5)


def _record_rows(eng):
    """Wrap the engine's sampler: rows[qid] lists every logits row sampled."""
    rows = {}
    choose = eng.strategies.choose_token

    def recording(qid, logits, prev=()):
        rows.setdefault(qid, []).append(np.asarray(logits, np.float32).copy())
        return choose(qid, logits, prev)

    eng.strategies.choose_token = recording
    return rows


def _engines(models, slots=4, chunk=None):
    spec_j, params_j, spec_t, params_t = models
    je = JEngine(spec_j, params_j, max_concurrent_queries=slots,
                 max_context_len=128, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=slots,
                 max_context_len=128, kv_cache_quantized=True, device="cpu")
    if chunk:
        je.prefill_chunk = te.prefill_chunk = chunk
    return je, te


def _check(je_rows, te_rows, je_out, te_out, qids):
    for qj, qt in qids:
        got, ref = te_out[qt], je_out[qj]
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(te_rows[qt][i], je_rows[qj][i],
                                       atol=LOGIT_TOL)
            if a != b:
                top2 = np.sort(je_rows[qj][i])[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (i, got, ref)
                break


def test_single_query_matches_jax(models):
    je, te = _engines(models)
    jr, tr = _record_rows(je), _record_rows(te)
    prompt = [3, 17, 9, 41, 5]
    ref = je.generate(prompt, JOpts(strategy="greedy"), max_new_tokens=8)
    got = te.generate(prompt, TOpts(strategy="greedy"), max_new_tokens=8)
    assert len(got) == 8
    _check(jr, tr, {1: ref}, {1: got}, [(1, 1)])


def _interleaved(eng, opts, prompts, steps_before_second=3):
    q1 = eng.add_query(prompts[0], opts, max_new_tokens=8)
    for _ in range(steps_before_second):
        eng.commit_inference_result(eng.infer())
    q2 = eng.add_query(prompts[1], opts, max_new_tokens=8)
    for _ in range(30):
        if not eng.has_work():
            break
        eng.commit_inference_result(eng.infer())
    assert not eng.has_work()
    return {q1: eng.query_tokens(q1), q2: eng.query_tokens(q2)}


def test_two_interleaved_queries_match_jax(models):
    je, te = _engines(models)
    jr, tr = _record_rows(je), _record_rows(te)
    prompts = ([3, 17, 9], [100, 55, 23, 8, 61, 2, 90])
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts)
    _check(jr, tr, ref, got, [(1, 1), (2, 2)])


def test_chunked_prefill_matches_jax(models):
    """A 40-token prompt with prefill_chunk = 16 takes three chunks (the
    last one padded) while a short query decodes beside it."""
    je, te = _engines(models, chunk=16)
    jr, tr = _record_rows(je), _record_rows(te)
    rng = np.random.default_rng(7)
    long_prompt = [int(t) for t in rng.integers(0, 128, 40)]
    prompts = ([11, 12, 13, 14], long_prompt)
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    _check(jr, tr, ref, got, [(1, 1), (2, 2)])
    assert te.cache.length[te.table.get(2).slot].item() \
        == len(long_prompt) + 7  # prompt + tokens fed back to the cache


def test_admission_and_saturation():
    """Admission control and the context-budget end, port only."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    spec = make_spec("test-tiny", kv_heads=2, vocab=128,
                     device_layout="packed")
    params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device="cpu")
    eng = TEngine(spec, params, max_concurrent_queries=2, max_context_len=32,
                  device="cpu")
    assert eng.add_query([1, 2], TOpts(strategy="greedy")) > 0
    assert eng.add_query([3, 4]) > 0
    assert eng.add_query([5, 6]) == -1  # every slot taken
    assert eng.add_query([]) == -2
    assert eng.add_query(list(range(40))) == -2  # longer than the context
    eng2 = TEngine(spec, params, max_concurrent_queries=1, max_context_len=32,
                   device="cpu")
    out = eng2.generate(list(range(1, 29)), TOpts(strategy="greedy"),
                        max_new_tokens=100)
    assert len(out) == 32 - 28  # saturated at the context budget
