"""INFERFLOW_MEGA in the port's fused-step routing against the JAX
package, on the CPU.

The JAX package reads the switch at each routing decision: 0 turns the
whole-model fused step off (every decode step takes the per-layer loop),
2 takes it wherever it is supported, anything else routes by its measured
rule.  The port reads it the same way (``decode_step.mega_mode``); where
the JAX package would fuse a mode the port has not ported (Q3H pair8,
mode (h); sub-byte wire planes, the wire mode), the port raises
NotImplementedError naming the mode instead of routing elsewhere.

Weights: test-llama from the JAX builder (seed 3; one layer for the
routing rule, three for the engines), i8mm, Q8_B32T2, Q4 wire planes and
Q3H pair8, the JAX side layer-stacked, the port's the same bytes per
layer.  INFERFLOW_MEGA_FORCE=1 lets the JAX engine take
its fused path on the CPU (its Pallas kernel in interpret mode) where the
switch allows it.  Engine tolerance: tests/test_torch_decode_step.py's
(5e-2 on logits, greedy streams equal but for near-ties of the JAX
engine's logits).
"""

import functools

import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

ENGINE_LOGIT_TOL = 5e-2
CACHE_ROWS = 512  # the JAX rule's sequence tile: 512 / pf = 128
# (format, layout) of each weight set, with the port's answer under
# INFERFLOW_MEGA=1: "fused", "per-layer", or the mode it raises for
LAYOUTS = (("Q4_B64T1", "i8mm", "fused"),
           ("Q8_B32T2", "packed", "fused"),
           ("Q4_B64T1", "packed", "wire mode"),
           ("Q3H_B64T1", "packed", "mode \\(h\\)"))


def _models(fmt, layout, layers=3):
    spec_j = jzoo.make_spec("test-llama", device_layout=layout,
                            layers=layers)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=3, stacked=True,
                                          device_layout=layout)
    spec_t = tzoo.make_spec("test-llama", device_layout=layout,
                            layers=layers)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


@pytest.fixture
def jax_mega(monkeypatch):
    """The JAX fused path on the CPU, its Pallas kernel interpreted."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    jds.enable_mega()
    yield
    jds.enable_mega()


def test_switch_matches_jax_routing(jax_mega, monkeypatch):
    """fused_step_supported / fused_step_preferred under INFERFLOW_MEGA 0,
    1 and 2 against the JAX functions, B = 2, on each weight set; and a
    bf16 cache (supported by neither) under every value."""
    for fmt, layout, unported in LAYOUTS:
        # one layer: the rule reads every layer alike
        spec_j, params_j, spec_t, params_t = _models(fmt, layout, layers=1)
        hp = spec_t.hyper_params
        jc = JKVCache.create(hp.decoder_layers, 2, CACHE_ROWS, hp.kv_heads,
                             hp.head_dim, quantized=True)
        tc = TKVCache.create(hp.decoder_layers, 2, CACHE_ROWS, hp.kv_heads,
                             hp.head_dim, quantized=True, device="cpu")
        args_j = (spec_j, params_j["layers"], jc, 2)
        args_t = (spec_t, params_t["layers"], tc, 2)
        for mega in ("0", "1", "2"):
            monkeypatch.setenv("INFERFLOW_MEGA", mega)
            sup_j = jds.fused_step_supported(*args_j)
            pref_j = jds.fused_step_preferred(*args_j)
            assert sup_j == (mega != "0"), (fmt, layout, mega)
            if unported == "fused" or mega == "0":
                assert tds.fused_step_supported(*args_t) == sup_j
                assert tds.fused_step_preferred(*args_t) == pref_j
                continue
            # a mode the JAX package fuses and the port has not ported
            with pytest.raises(NotImplementedError, match=unported):
                tds.fused_step_supported(*args_t)
            if mega == "1":  # supported, not preferred: the per-layer loop
                assert not pref_j
                assert not tds.fused_step_preferred(*args_t)
            else:  # forced: the JAX package fuses it, the port refuses
                assert pref_j
                with pytest.raises(NotImplementedError, match=unported):
                    tds.fused_step_preferred(*args_t)
        bf16 = TKVCache.create(hp.decoder_layers, 2, CACHE_ROWS, hp.kv_heads,
                               hp.head_dim, quantized=False, device="cpu")
        for mega in ("0", "1", "2"):
            monkeypatch.setenv("INFERFLOW_MEGA", mega)
            assert not tds.fused_step_supported(spec_t, params_t["layers"],
                                                bf16, 2)
            assert not tds.fused_step_preferred(spec_t, params_t["layers"],
                                                bf16, 2)


def test_engine_under_mega_off_matches_jax(jax_mega, monkeypatch):
    """Both engines serve test-llama in i8mm at 4 slots under
    INFERFLOW_MEGA=0: the port launches no fused step (each decode step
    takes the per-layer loop; the same engine under the default switch
    takes it), and its greedy tokens and logits follow the JAX engine's
    under 0."""
    spec_j, params_j, spec_t, params_t = _models("Q4_B64T1", "i8mm")
    calls = []
    real = tdec.fused_decode_step
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 11)])
    monkeypatch.setenv("INFERFLOW_MEGA", "0")
    je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True,
                 device="cpu")
    jr, tr = _record_rows(je), _record_rows(te)
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    assert calls == []
    for q in (1, 2):
        assert len(got[q]) == len(ref[q])
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break
    # the switch is read per step: the same engine fuses again under 1
    monkeypatch.setenv("INFERFLOW_MEGA", "1")
    te.add_query(prompts[0], TOpts(strategy="greedy"), max_new_tokens=2)
    while te.has_work():
        te.commit_inference_result(te.infer())
    assert calls
