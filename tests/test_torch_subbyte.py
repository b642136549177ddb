"""The port's sub-byte block formats in their wire planes (kernel B1's
``subbyte_matmul`` case) against the JAX package, on the CPU.

Q6_B64T1, Q5_B64T1, Q5_B32T1, Q4_B32T1A/B, Q4_B32T2, Q4_B16, Q3_B32T1A/B
and Q2_B32T1A/B keep their wire planes on the device under ``device_layout
= packed`` (and wherever i8mm does not fit): every product runs kernel B1,
decode takes the per-layer loop (B1 and B2), since the TPU package does
not fuse multi-plane formats and supports but does not prefer its wire
mode for the single-plane ones.  Weights: the JAX zoo's test-llama params,
moved over with ``weights.params_from_numpy``.  The JAX Pallas kernel runs
in interpret mode.

Tolerances:
  - codec: exact (Q5_B32T1's split-nibble bytes, scale and base;
    dequantize's values; from_np of the JAX numpy codec's wire planes; the
    golden values of the reference's own quantizer for every sub-byte
    format);
  - B1's plain version against quantized_matmul_interpret: the port
    follows the codec, w = bf16(code*scale + base), where the TPU kernel
    rounds the scale (times each plane's 2^shift) and the base to bf16 and
    dots each plane's values apart in bf16 (ROADMAP section C): each weight
    moves by at most 2^-7 of |code*scale| + |base|, so each output by at
    most 2^-7 * (|x| @ that) plus one bf16 step of the output (measured
    0.56-0.88% of max|ref| on weights of std 0.05);
  - engines: ENGINE_LOGIT_TOL = 5e-2 on logits of magnitude ~1, greedy
    streams equal but for near-ties of the JAX engine's logits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.config import load_engine_config as jload
from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.kernels.dequant_matmul import (pad_weight_for_tpu,
                                                  quantized_matmul_interpret)
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.quant import codec_np as jcodec_np
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.config import load_engine_config as tload
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.kernels import dequant_matmul as tdm
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.ops import linear as tlinear
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.quant.formats import get_format
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q6_INI = os.path.join(ROOT, "configs", "inferflow_service.q6.ini")
FORMATS = ("Q6_B64T1", "Q5_B64T1", "Q5_B32T1", "Q4_B32T1A", "Q4_B32T1B",
           "Q4_B32T2", "Q4_B16", "Q3_B32T1A", "Q3_B32T1B", "Q2_B32T1A",
           "Q2_B32T1B")
ENGINE_FORMATS = ("Q6_B64T1", "Q3_B32T1A")
ENGINE_LOGIT_TOL = 5e-2
PAD_K = 8256  # pad_weight_for_tpu stores it as 8448 to 9216 rows


def _models(fmt):
    spec_j = jzoo.make_spec("test-llama", device_layout="packed")
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=3, stacked=True,
                                          device_layout="packed")
    spec_t = tzoo.make_spec("test-llama", device_layout="packed")
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def llama():
    """test-llama in each engine format under the packed layout, by name."""
    return {fmt: _models(fmt) for fmt in ENGINE_FORMATS}


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def test_split_nibble_codec_matches_jax():
    """Q5_B32T1 (the split-nibble low plane): quantize gives JAX's bytes,
    scale and base (an all-zero column and a constant block included);
    dequantize JAX's values in float32 and bf16; from_np of the JAX numpy
    codec's wire planes and of JAX's own quantize give the same planes
    and values.  The other sub-byte formats' from_np keeps their planes."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    w[:32, 5] = -1.0
    ref = codec_jax.quantize(jnp.asarray(w), "Q5_B32T1")
    got = codec_torch.quantize(torch.from_numpy(w), "Q5_B32T1")
    assert sorted(got.planes) == sorted(ref.planes) == ["data", "data_h"]
    for name in ref.planes:
        np.testing.assert_array_equal(got.planes[name].numpy(),
                                      np.asarray(ref.planes[name]))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.base.numpy(), np.asarray(ref.base))
    for fmt in FORMATS:
        wire = jcodec_np.quantize_np(w, fmt)
        qt_j = codec_jax.QuantizedTensor.from_np(wire)
        qt_t = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
        assert sorted(qt_t.planes) == sorted(wire["planes"]), fmt
        for name, plane in wire["planes"].items():
            np.testing.assert_array_equal(qt_t.planes[name].numpy(), plane)
        for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                                 (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                codec_torch.dequantize(qt_t, dtype_t).float().numpy(),
                np.asarray(codec_jax.dequantize(qt_j, dtype_j), np.float32),
                err_msg=fmt)
    np.testing.assert_array_equal(
        codec_torch.dequantize(got, torch.float32).numpy(),
        np.asarray(codec_jax.dequantize(ref, jnp.float32)))


def test_golden_dequant_values():
    """The reference quantizer's own dequantized values (tests/golden) for
    every sub-byte format it has them for (all but Q4_B32T2): the port's
    from_np of the JAX numpy quantizer's wire planes and its dequantize in
    float32 reproduce them exactly."""
    golden = os.path.join(ROOT, "tests", "golden", "data")
    have = [fmt for fmt in FORMATS if os.path.exists(
        os.path.join(golden, f"{fmt}.dequant.f32.bin"))]
    assert set(FORMATS) - set(have) == {"Q4_B32T2"}
    for fmt in have:
        src = np.fromfile(os.path.join(golden, f"{fmt}.input.f16.bin"),
                          dtype=np.float16)
        ref = np.fromfile(os.path.join(golden, f"{fmt}.dequant.f32.bin"),
                          dtype=np.float32)
        wire = jcodec_np.quantize_np(src.reshape(-1, 1), fmt)
        qt = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
        got = codec_torch.dequantize(qt, torch.float32).numpy().reshape(-1)
        np.testing.assert_array_equal(got, ref, err_msg=fmt)


def _magnitude(qt) -> np.ndarray:
    """|code*scale| + |base| per logical weight: the bound's scale."""
    fmt = get_format(qt.format)
    k_s, n = qt.storage_k, int(qt.shape[-1])
    code = codec_torch._codes(qt.planes, fmt).float()
    mag = (code.view(k_s // fmt.block, fmt.block, n)
           * qt.scale.float().abs()[:, None, :]
           + qt.base.float().abs()[:, None, :])
    return mag.reshape(k_s, n)[:int(qt.shape[0])].numpy()


def test_b1_subbyte_plain_matches_interpret():
    """B1's plain version for every sub-byte format (quantized_matmul on
    the CPU, and ops.linear) against the JAX kernel in interpret mode, M
    in {1, 5, 37}, on a 512 x 256 weight and on a 8256-row weight that
    pad_weight_for_tpu stores K-padded."""
    rng = np.random.default_rng(1)
    small = rng.standard_normal((512, 256)).astype(np.float32) * 0.05
    tall = rng.standard_normal((PAD_K, 128)).astype(np.float32) * 0.02
    for fmt in FORMATS:
        padded = pad_weight_for_tpu(codec_jax.quantize(jnp.asarray(tall),
                                                       fmt))
        assert int(padded.scale.shape[0]) * get_format(fmt).block > PAD_K
        for w_j in (codec_jax.quantize(jnp.asarray(small), fmt), padded):
            w_t = codec_torch.QuantizedTensor.from_np(w_j.to_np(),
                                                      device="cpu")
            assert w_t.storage_k == int(w_j.scale.shape[0]) \
                * get_format(fmt).block
            k = int(w_t.shape[0])
            mag = _magnitude(w_t)
            for m in (1, 5, 37):
                x = rng.standard_normal((m, k)).astype(np.float32)
                ref = np.asarray(quantized_matmul_interpret(
                    jnp.asarray(x).astype(jnp.bfloat16), w_j), np.float32)
                xt = torch.from_numpy(x).to(torch.bfloat16)
                tol = 2.0 ** -7 * (np.abs(xt.float().numpy()) @ mag) \
                    + _bf16_step(ref)
                for got in (tdm.quantized_matmul(xt, w_t),
                            tlinear.linear(xt, w_t)):
                    got = got.float().numpy()
                    assert got.shape == ref.shape
                    assert np.all(np.abs(got - ref) <= tol), (fmt, k, m)


def test_engine_subbyte_matches_jax(llama, monkeypatch):
    """Both engines serve test-llama in Q6_B64T1 (two planes, 64-row
    blocks) and Q3_B32T1A (a 2-bit and a 1-bit plane, 32-row blocks) under
    the packed layout at 4 slots: the per-layer loop on every decode step
    (the fused step never), B1 in every product, and one prompt takes
    three 32-token chunks while the other decodes."""
    real_plain = tdm.quantized_matmul_plain

    def refuse(*a, **k):
        raise AssertionError("a sub-byte product reached another path")

    monkeypatch.setattr(tdec, "fused_decode_step", refuse)
    monkeypatch.setattr(tdm, "i4_matmul_plain", refuse)
    for fmt in ENGINE_FORMATS:
        spec_j, params_j, spec_t, params_t = llama[fmt]
        products = []
        monkeypatch.setattr(tdm, "quantized_matmul_plain",
                            lambda x, qt: products.append(qt.format)
                            or real_plain(x, qt))
        rng = np.random.default_rng(9)
        vocab = spec_t.hyper_params.vocab_size
        prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
                   [int(t) for t in rng.integers(1, vocab, 70)])
        je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                     max_context_len=256, kv_cache_quantized=True)
        te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                     max_context_len=256, kv_cache_quantized=True,
                     device="cpu")
        je.prefill_chunk = te.prefill_chunk = 32
        jr, tr = _record_rows(je), _record_rows(te)
        ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        assert products and set(products) == {fmt}
        for q in (1, 2):
            for i, (a, b) in enumerate(zip(got[q], ref[q])):
                np.testing.assert_allclose(tr[q][i], jr[q][i],
                                           atol=ENGINE_LOGIT_TOL,
                                           err_msg=fmt)
                if a != b:  # only at a near-tie of the JAX engine's logits
                    top2 = np.sort(jr[q][i])[-2:]
                    assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, \
                        (fmt, i, q)
                    break
            assert len(got[q]) == len(ref[q])


def test_q6_ini_loads_in_both_packages(monkeypatch):
    """configs/inferflow_service.q6.ini reads to the same EngineConfig in
    both loaders: llama2_7b, 8 slots, Q6 weights in the packed layout, a
    Q8 cache and a 4096-token context; the layout stays packed on an
    80 GB card, where the auto rule would pick i8mm."""
    ref, got = jload(Q6_INI), tload(Q6_INI)
    assert (got.max_concurrent_queries, got.kv_cache_paging) == (8, False)
    assert got.max_concurrent_queries == ref.max_concurrent_queries
    m_t, m_j = got.model, ref.model
    for f in ("sid", "device_weight_data_type", "device_kv_cache_data_type",
              "device_layout", "max_context_len", "be_host_embeddings",
              "host_kv_cache_percent"):
        assert getattr(m_t, f) == getattr(m_j, f), f
    assert (m_t.sid, m_t.device_weight_data_type,
            m_t.device_kv_cache_data_type, m_t.device_layout,
            m_t.max_context_len) == ("llama2_7b", "Q6", "Q8", "packed", 4096)
    monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                        lambda dev: 80 * 10 ** 9)
    spec = tzoo.make_spec("llama2-7b", device_layout=m_t.device_layout)
    assert codec_torch.resolve_auto_layout(
        spec, m_t.device_weight_data_type, "cuda") == "packed"
    assert codec_torch.resolve_auto_layout(
        tzoo.make_spec("llama2-7b"), m_t.device_weight_data_type,
        "cuda") == "i8mm"


def test_routing_follows_jax(llama):
    """Neither package fuses Q6_B64T1 (two planes) or prefers its fused
    wire mode for the single-plane Q4_B32T1A; both support that mode."""
    spec_j, params_j, spec_t, params_t = llama["Q6_B64T1"]
    lengths = (30, 7, 0, 100)
    b = len(lengths)
    jc, tc = _caches(spec_j, spec_t, lengths, seed=2)
    assert not jds.fused_step_supported(spec_j, params_j["layers"], jc, b)
    assert not jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
    assert not tds.fused_step_supported(spec_t, params_t["layers"], tc, b)
    assert not tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
    spec_j, params_j, spec_t, params_t = _models("Q4_B32T1A")
    assert jds.fused_step_supported(spec_j, params_j["layers"], jc, b)
    assert not jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
    assert not tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
    assert tds.fused_step_supported(spec_t, params_t["layers"], tc, b)
