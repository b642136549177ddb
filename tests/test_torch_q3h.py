"""The port's Q3H weights (pair8 device layout) against the JAX package, on
the CPU.

Q3H_B64T1 is the 3.5-bit format: 11 levels per weight, value pairs packed
base-11 into 7-bit codes.  On the device both packages keep it as the
``pair8`` plane, one byte per pair code (``codec_jax.quantize`` emits it,
``from_np`` re-packs the wire planes into it), and every product runs
kernel B6 (``kernels/dequant_matmul.quantized_matmul`` picks it for the
pair8 plane): decode is the per-layer loop, since both packages support
but do not prefer the fused mode (h).  Weights: the JAX zoo's test-llama
params from Q3H_B64T1 under ``device_layout="packed"``, moved over with
``weights.params_from_numpy``; a variant with an intermediate width of
8256, whose w2 the JAX zoo stores
K-padded to 8704 (zero-scale blocks).  The JAX Pallas kernel runs in
interpret mode.

Tolerances:
  - codec: exact (quantize's pair8 bytes, scale and base; dequantize's
    values; repack_pair8's bytes; the golden values of the reference's
    own quantizer);
  - B6's plain version against quantized_matmul_interpret: one bf16 step
    of each output (the same bf16 weights on both sides, float32 sums in
    another order);
  - engines: ENGINE_LOGIT_TOL = 5e-2 on logits of magnitude ~1, greedy
    streams equal but for near-ties of the JAX engine's logits; both
    engines run the same per-layer arithmetic on the same bf16 weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.kernels.dequant_matmul import (pad_weight_for_tpu,
                                                  quantized_matmul_interpret)
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.quant import codec_np as jcodec_np
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.kernels import dequant_matmul as tdm
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.ops import linear as tlinear
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

FMT = "Q3H_B64T1"
ENGINE_LOGIT_TOL = 5e-2
PAD_INTER = 8256  # the JAX zoo stores w2 with K = 8704


def _models(**overrides):
    spec_j = jzoo.make_spec("test-llama", device_layout="packed",
                            **overrides)
    params_j = jzoo.make_synthetic_params(spec_j, FMT, seed=3, stacked=True,
                                          device_layout="packed")
    spec_t = tzoo.make_spec("test-llama", device_layout="packed",
                            **overrides)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_j.qkv_format == spec_t.qkv_format == 1
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def llama():
    """test-llama in Q3H pair8: JAX's layer-stacked params and the port's
    per-layer copy of the same bytes."""
    return _models()


@pytest.fixture(scope="module")
def llama_pad():
    """One layer of test-llama at an intermediate width of 8256: JAX's w2
    is stored K-padded to 8704."""
    return _models(layers=1, inter=PAD_INTER)


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def test_codec_matches_jax():
    """quantize gives JAX's pair8 bytes, scale and base (negative codes
    clipped to 0, an all-zero column included); dequantize JAX's values
    in float32 and bf16, for every byte value too; from_np re-packs the
    JAX numpy codec's wire planes to repack_pair8's bytes."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    w[:64, 5] = -1.0  # a constant block: scale 0
    ref = codec_jax.quantize(jnp.asarray(w), FMT)
    got = codec_torch.quantize(torch.from_numpy(w), FMT)
    assert set(got.planes) == set(ref.planes) == {"pair8"}
    assert got.planes["pair8"].dtype == torch.uint8
    np.testing.assert_array_equal(got.planes["pair8"].numpy(),
                                  np.asarray(ref.planes["pair8"]))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.base.numpy(), np.asarray(ref.base))
    # every byte value, not only the codes 0..120 quantize writes
    every = ref.to_np()
    every["planes"] = {"pair8": np.tile(np.arange(256, dtype=np.uint8),
                                        (128 * 96) // 256).reshape(128, 96)}
    for qt_np in (ref.to_np(), every):
        qt_j = codec_jax.QuantizedTensor.from_np(qt_np)
        qt_t = codec_torch.QuantizedTensor.from_np(qt_np, device="cpu")
        for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                                 (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                codec_torch.dequantize(qt_t, dtype_t).float().numpy(),
                np.asarray(codec_jax.dequantize(qt_j, dtype_j), np.float32))
    # the wire planes and their re-pack
    wire = jcodec_np.quantize_np(w, FMT)
    assert sorted(wire["planes"]) == ["data", "data_h", "data_m"]
    qt = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
    assert set(qt.planes) == {"pair8"} and qt.shape == (256, 96)
    np.testing.assert_array_equal(
        qt.planes["pair8"].numpy(),
        jcodec_np.repack_pair8(wire)["planes"]["pair8"])
    np.testing.assert_array_equal(qt.planes["pair8"].numpy(),
                                  got.planes["pair8"].numpy())


def test_golden_dequant_values(golden_dir):
    """The reference quantizer's own dequantized values (tests/golden):
    the port's pair8 re-pack (from_np) of the JAX numpy quantizer's wire
    planes and the port's dequantize in float32 reproduce them exactly."""
    src = np.fromfile(os.path.join(golden_dir, f"{FMT}.input.f16.bin"),
                      dtype=np.float16)
    ref = np.fromfile(os.path.join(golden_dir, f"{FMT}.dequant.f32.bin"),
                      dtype=np.float32)
    wire = jcodec_np.quantize_np(src.reshape(-1, 1), FMT)
    qt = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
    got = codec_torch.dequantize(qt, torch.float32).numpy().reshape(-1)
    np.testing.assert_array_equal(got, ref)


def test_b6_plain_matches_interpret(llama, llama_pad):
    """B6's plain version, and ops.linear on a pair8 weight, against the
    JAX kernel in interpret mode: M in {1, 5, 37}, on the lm_head, on the
    stacked K-padded w2 and on a tensor K-padded by pad_weight_for_tpu
    (K 8256 stored as 8704)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((PAD_INTER, 128)).astype(np.float32) * 0.02
    padded = pad_weight_for_tpu(codec_jax.quantize(jnp.asarray(w), FMT))
    assert int(padded.scale.shape[0]) * 64 == 8704
    cases = [(llama[1]["lm_head"], llama[3]["lm_head"]),
             (jax.tree_util.tree_map(lambda a: a[0],
                                     llama_pad[1]["layers"]["ffn"]["w2"]),
              llama_pad[3]["layers"][0]["ffn"]["w2"]),
             (padded, codec_torch.QuantizedTensor.from_np(padded.to_np(),
                                                          device="cpu"))]
    for w_j, w_t in cases:
        # the stacked slice keeps JAX's stacked aux shape: set the logical one
        w_j = codec_jax.QuantizedTensor(w_j.format, tuple(w_t.shape),
                                        w_j.planes, w_j.scale, w_j.base)
        assert set(w_t.planes) == {"pair8"}
        k = int(w_t.shape[0])
        for m in (1, 5, 37):
            x = rng.standard_normal((m, k)).astype(np.float32)
            ref = np.asarray(quantized_matmul_interpret(
                jnp.asarray(x).astype(jnp.bfloat16), w_j), np.float32)
            xt = torch.from_numpy(x).to(torch.bfloat16)
            for got in (tdm.quantized_matmul(xt, w_t),
                        tlinear.linear(xt, w_t)):
                got = got.float().numpy()
                assert got.shape == ref.shape
                assert np.all(np.abs(got - ref) <= _bf16_step(ref)), (k, m)


def test_params_from_jax_stacked_and_padded(llama, llama_pad):
    """params_from_numpy splits JAX's layer-stacked pair8 params byte for
    byte, the K-padded w2 included; the port's own zoo makes the same
    layout without padding."""
    for spec_j, params_j, spec_t, params_t in (llama, llama_pad):
        hp = spec_t.hyper_params
        assert len(params_t["layers"]) == hp.decoder_layers
        for grp, name in (("attn", "qkv"), ("attn", "wo"), ("ffn", "w1n3"),
                          ("ffn", "w2")):
            stacked = params_j["layers"][grp][name]
            for i, lp in enumerate(params_t["layers"]):
                w = lp[grp][name]
                assert set(w.planes) == {"pair8"}
                assert w.shape == tuple(stacked.shape)[1:]
                np.testing.assert_array_equal(
                    w.planes["pair8"].numpy(),
                    np.asarray(stacked.planes["pair8"][i]))
                for a, b in ((w.scale, stacked.scale), (w.base, stacked.base)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b[i]))
        w2 = params_t["layers"][0]["ffn"]["w2"]
        inter = hp.decoder_intermediate_size
        assert w2.shape[0] == inter
        assert w2.storage_k == (8704 if inter == PAD_INTER else inter)
        np.testing.assert_array_equal(
            params_t["lm_head"].planes["pair8"].numpy(),
            np.asarray(params_j["lm_head"].planes["pair8"]))
    own = tzoo.make_synthetic_params(
        tzoo.make_spec("test-llama", layers=1, inter=PAD_INTER), FMT,
        seed=0, device="cpu", device_layout="packed")
    w2 = own["layers"][0]["ffn"]["w2"]
    assert set(w2.planes) == {"pair8"} and w2.storage_k == PAD_INTER
    assert set(own["lm_head"].planes) == {"pair8"}


def test_routing_follows_jax(llama, monkeypatch):
    """At B <= 8 both packages support the fused mode (h) for pair8 but do
    not prefer it (the per-layer loop); at B > 8 neither fuses.  Under the
    80 GB capacity rule Q3H resolves to i8mm; 'packed' stays explicit."""
    spec_j, params_j, spec_t, params_t = llama
    for lengths in ((40,), (30, 7, 0, 100), (5,) * 9):
        b = len(lengths)
        jc, tc = _caches(spec_j, spec_t, lengths, seed=2)
        assert jds.fused_step_supported(spec_j, params_j["layers"], jc,
                                        b) == (b <= 8)
        assert not jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
        assert not tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
        assert tds.fused_step_supported(spec_t, params_t["layers"], tc,
                                        b) == (b <= 8)
    monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                        lambda dev: 80 * 10 ** 9)
    assert codec_torch.resolve_auto_layout(tzoo.make_spec("llama2-13b"), FMT,
                                           "cuda") == "i8mm"
    assert codec_torch.resolve_auto_layout(
        tzoo.make_spec("llama2-13b", device_layout="packed"), FMT,
        "cuda") == "packed"


def test_engine_q3h_matches_jax(llama, monkeypatch):
    """Both engines serve test-llama in Q3H pair8 at 4 slots and at 9: the
    per-layer loop on every decode step, B6 in every product (B1 and the
    fused step never), and one prompt takes three 32-token chunks while
    the other decodes."""
    spec_j, params_j, spec_t, params_t = llama
    calls = {"b6": 0}
    real_plain = tdm.quantized_matmul_plain

    def refuse(*a, **k):
        raise AssertionError("a Q3H product reached another kernel")

    def b6_plain(x, qt):  # B1 and B6 share the plain version on the CPU
        if set(qt.planes) != {"pair8"}:
            refuse()
        calls["b6"] += 1
        return real_plain(x, qt)

    monkeypatch.setattr(tdm, "quantized_matmul_plain", b6_plain)
    monkeypatch.setattr(tdm, "i4_matmul_plain", refuse)
    monkeypatch.setattr(tdec, "fused_decode_step", refuse)
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 70)])
    for slots in (4, 9):
        calls.update(b6=0)
        je = JEngine(spec_j, params_j, max_concurrent_queries=slots,
                     max_context_len=512, kv_cache_quantized=True)
        te = TEngine(spec_t, params_t, max_concurrent_queries=slots,
                     max_context_len=512, kv_cache_quantized=True,
                     device="cpu")
        je.prefill_chunk = te.prefill_chunk = 32
        jr, tr = _record_rows(je), _record_rows(te)
        ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        assert calls["b6"] > 0
        for q in (1, 2):
            for i, (a, b) in enumerate(zip(got[q], ref[q])):
                np.testing.assert_allclose(tr[q][i], jr[q][i],
                                           atol=ENGINE_LOGIT_TOL)
                if a != b:  # only at a near-tie of the JAX engine's logits
                    top2 = np.sort(jr[q][i])[-2:]
                    assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                    break
            assert len(got[q]) == len(ref[q])
