"""The fused decode step's per-matmul output biases (kernel B4's mode (d))
in the port against the JAX package, on the CPU.

The TPU kernel adds a product's float32 bias to its output tile before
the qkv split, the residual add or the GLU (``finish``); its rule takes a
layer-stacked (L, N) bias on any of the four products, the port one (N,)
tensor per layer, and a MoE layer's bias on an expert product is shared by
its experts.  A bias changes neither package's routing.  Weights: the JAX
zoo's test-llama params (3 layers) and test-moe's (one layer, i8mm
experts), with seeded biases of scale 0.05 (as JAX's
test_fused_step_biases), moved over with ``weights.params_from_numpy``.

Tolerances: tests/test_torch_b4_wire.py's for the wire products (the JAX
package's own fused-against-per-layer bounds: hidden norm_rmsd 3e-2, max
abs 6e-2; the interpreter keeps each wire weight in float32), and the
i8mm case within the same bounds;
mode (g) tests/test_torch_moe.py's STEP_NRMSD = 0.01; engines
ENGINE_LOGIT_TOL = 5e-2 on logits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts

from test_torch_b4_wire import (CACHE_ROWS, ENGINE_LOGIT_TOL, STEP_TOL,
                                check_step, models)
from test_torch_decode_step import _caches
from test_torch_engine import _interleaved, _record_rows
from test_torch_moe import STEP_NRMSD, WIDE, _models, norm_rmsd


def test_fused_step_biases_match_jax(monkeypatch):
    """JAX's test_fused_step_biases mirrored: qkv and w2 biases on Q4_B64T1
    wire planes (B = 1), then wo and w1n3 biases on i8mm weights (B = 2),
    the plain B4 against JAX fused_decode_step(interpret=True); both
    packages support and route them as without biases."""
    for fmt, layout, biases, lengths, fused in (
            ("Q4_B64T1", "packed", ("qkv", "w2"), [13], False),
            ("Q4_B64T1", "i8mm", ("wo", "w1n3"), [9, 200], True)):
        m = models(fmt, layout, biases)
        for name in biases:  # one (N,) bias per layer
            grp = m[3]["layers"][0]["attn" if name in ("qkv", "wo")
                                    else "ffn"]
            assert grp[f"{name}_b"].shape == (int(grp[name].shape[-1]),)
        jc, tc = _caches(m[0], m[2], lengths, 3)
        b = len(lengths)
        assert jds.fused_step_preferred(m[0], m[1]["layers"], jc, b) == fused
        assert tds.fused_step_preferred(m[2], m[3]["layers"], tc, b) == fused
        check_step(m, lengths, 4, STEP_TOL, monkeypatch)
    # the bias moves the result: the same step without it reads otherwise
    plain = [dict(lp, attn={k: v for k, v in lp["attn"].items()
                            if k != "wo_b"}) for lp in m[3]["layers"]]
    x = torch.ones((2, 1, m[2].hyper_params.embd_dims), dtype=torch.bfloat16)
    pos = torch.asarray([[9], [200]], dtype=torch.int32)
    with_b = tds.fused_decode_step(m[2], m[3]["layers"], x, pos,
                                   _caches(m[0], m[2], [9, 200], 3)[1])[0]
    without = tds.fused_decode_step(m[2], plain, x, pos,
                                    _caches(m[0], m[2], [9, 200], 3)[1])[0]
    assert (with_b.float() - without.float()).abs().max() > 1e-2


def test_moe_expert_biases_match_jax():
    """Mode (g) with biases on the expert products (test-moe, i8mm
    experts, one layer; the experts share each bias), B = 2, against the
    interpreted JAX kernel."""
    spec_j, params_j, spec_t, params_t = _models("Q4_B64T1", "i8mm", seed=2,
                                                 layers=1, **WIDE)
    rng = np.random.default_rng(11)
    ex_j = dict(params_j["layers"]["moe"]["experts_stacked"])
    ex_t = params_t["layers"][0]["moe"]["experts_stacked"]
    for name in ("w1n3", "w2"):
        n = int(ex_t[name].shape[-1])
        b = (rng.standard_normal((1, n)) * 0.05).astype(np.float32)
        ex_j[f"{name}_b"] = jnp.asarray(b)
        ex_t[f"{name}_b"] = torch.from_numpy(b[0].copy())
    layers_j = dict(params_j["layers"], moe=dict(params_j["layers"]["moe"],
                                                 experts_stacked=ex_j))
    hp = spec_t.hyper_params
    lengths = [4, 21]
    jc, tc = _caches(spec_j, spec_t, lengths, 5)
    assert jds.fused_step_supported(spec_j, layers_j, jc, 2)
    assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, 2)
    x = (np.random.default_rng(1).standard_normal((2, 1, hp.embd_dims))
         * 0.3).astype(np.float32)
    pos = np.asarray(lengths, np.int32)[:, None]
    ref, _ = jds.fused_decode_step(
        spec_j, layers_j, jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(pos), jc, interpret=True)
    got, _ = tds.fused_decode_step(spec_t, params_t["layers"],
                                   torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(pos), tc)
    err = norm_rmsd(got.float().numpy(), ref)
    assert err < STEP_NRMSD, err


def test_biased_engine_takes_fused_step(monkeypatch):
    """Both engines serve test-llama in i8mm with biases on all four
    products at 4 slots under the default switch: the port's every decode
    step takes the fused step (it raised NotImplementedError before mode
    (d) was ported), as the JAX engine's takes its own; tokens and logits
    as ENGINE_LOGIT_TOL says."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    spec_j, params_j, spec_t, params_t = models(
        "Q4_B64T1", "i8mm", ("qkv", "wo", "w1n3", "w2"))
    steps = []
    real = tdec.fused_decode_step
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True,
                 device="cpu")
    jr, tr = _record_rows(je), _record_rows(te)
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 11)])
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    jds.enable_mega()
    assert len(steps) >= 8
    for q in (1, 2):
        assert len(got[q]) == len(ref[q])
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break
