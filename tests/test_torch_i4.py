"""The port's i4 device layout against the JAX package, on the CPU.

The layout (``device_layout="i4"``, codec_jax.repack_i4) re-stores a 4-bit
single-plane format's codes as signed code-8 nibbles (``data_i4p``).  It
runs kernel B5 (``kernels/dequant_matmul.quantized_matmul``'s route for
``data_i4p``) for every product
outside the fused step and B4's mode (b), i4x8, on every decode step of at
most 8 slots.  Weights: the JAX zoo's test-llama params from Q4_B64T1
in the i4 layout, moved over with ``weights.params_from_numpy``; a
variant with an intermediate width of 8448, whose w2 the JAX zoo pads
to a stored K of 8704 (zero-scale blocks) before it repacks.  The JAX
Pallas kernels run in interpret mode; its fused step is pinned to i4x8
(INFERFLOW_I4_DOT=i8, its default).

Tolerances:
  - codec: exact (repack_i4's bytes, i4 dequantize's values);
  - B5's plain version against quantized_matmul_interpret: one bf16 step
    of each output (the same bf16 weights, n*sc + (8*sc + base); float32
    sums in another order);
  - the fused step, one Q8 step for the appended rows and STEP_TOL_B1 /
    STEP_TOL on the hidden state, as tests/test_torch_decode_step.py
    states for i8mm: the int8 activation codes are the same rule on both
    sides, the block dots exact, and only float32 summation orders and
    the batched mode's bf16 roundings (relative to other running maxima)
    differ; measured 0.0 at B = 1, 0.023 at B = 4 and 0.0034 with the
    K-padded w2 (B = 2);
  - engines: ENGINE_LOGIT_TOL = 5e-2 on logits of magnitude ~1, greedy
    streams equal but for near-ties of the JAX engine's logits.  The JAX
    engine's per-layer products dequantize through its codec, (n + 8)*sc
    + base, whose one float32 rounding can move a bf16 weight by an ulp
    against B5's two; measured well inside the gate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.kernels.dequant_matmul import (pad_weight_for_tpu,
                                                  quantized_matmul_interpret)
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.kernels import dequant_matmul as tdm
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.ops import linear as tlinear
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches, _grab_rows
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

STEP_TOL = 6e-2
STEP_TOL_B1 = 1e-2
ENGINE_LOGIT_TOL = 5e-2
PAD_INTER = 8448  # the JAX zoo stores w2 with K = 8704


def _models(**overrides):
    spec_j = jzoo.make_spec("test-llama", device_layout="i4", **overrides)
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=3,
                                          stacked=True, device_layout="i4")
    spec_t = tzoo.make_spec("test-llama", device_layout="i4", **overrides)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_j.qkv_format == spec_t.qkv_format == 1
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def llama():
    """test-llama in the i4 layout: JAX's layer-stacked params and the
    port's per-layer copy of the same bytes."""
    return _models()


@pytest.fixture(scope="module")
def llama_pad():
    """One layer of test-llama at an intermediate width of 8448: JAX's w2
    is stored K-padded to 8704."""
    return _models(layers=1, inter=PAD_INTER)


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def test_repack_and_dequantize_match_jax():
    """repack_i4's bytes and the i4 dequantize equal JAX's, for a plain
    and a K-padded tensor; from_np/to_np carry the plane; ineligible
    formats pass through repack_i4 unchanged."""
    rng = np.random.default_rng(0)
    for k, n in ((256, 96), (PAD_INTER, 128)):
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
        qt_j = pad_weight_for_tpu(codec_jax.quantize(jnp.asarray(w),
                                                     "Q4_B64T1"))
        k_s = int(qt_j.scale.shape[0]) * 64
        assert k_s == (8704 if k == PAD_INTER else k)
        ref = codec_jax.repack_i4(qt_j)
        qt_t = codec_torch.QuantizedTensor.from_np(qt_j.to_np(), device="cpu")
        got = codec_torch.repack_i4(qt_t)
        assert set(got.planes) == set(ref.planes) == {"data_i4p"}
        assert got.storage_k == k_s and got.shape == (k, n)
        np.testing.assert_array_equal(got.planes["data_i4p"].numpy(),
                                      np.asarray(ref.planes["data_i4p"]))
        for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                                 (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                codec_torch.dequantize(got, dtype_t).float().numpy(),
                np.asarray(codec_jax.dequantize(ref, dtype_j), np.float32))
        # the round trip through numpy keeps the plane and the stored K
        back = codec_torch.QuantizedTensor.from_np(got.to_np(), device="cpu")
        np.testing.assert_array_equal(back.planes["data_i4p"].numpy(),
                                      got.planes["data_i4p"].numpy())
        assert back.storage_k == k_s
        # B5's weights differ from the codec's by at most one bf16 ulp
        wb = tdm.i4_weight(got).float().numpy()
        wc = codec_torch.dequantize(got, torch.bfloat16).float().numpy()
        assert np.all(np.abs(wb - wc) <= _bf16_step(wc) + 1e-30)
    for fmt in ("Q8_B32T2", "Q2_B32T1A"):
        qt = codec_torch.quantize(torch.randn(128, 64), fmt)
        assert codec_torch.repack_i4(qt) is qt
    pair8 = {"format": "Q3H_B64T1", "shape": (128, 64),
             "planes": {"pair8": np.zeros((64, 64), np.uint8)},
             "scale": np.zeros((2, 64), np.float16),
             "base": np.zeros((2, 64), np.float16)}
    # Q3H's pair8 plane is taken as it is (and is no i4 format)
    qt = codec_torch.QuantizedTensor.from_np(pair8, device="cpu")
    assert set(qt.planes) == {"pair8"} and qt.storage_k == 128
    assert codec_torch.repack_i4(qt) is qt


def test_params_from_jax_stacked_and_padded(llama, llama_pad):
    """params_from_numpy splits JAX's layer-stacked i4 params byte for
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
                assert set(w.planes) == {"data_i4p"}
                assert w.shape == tuple(stacked.shape)[1:]
                np.testing.assert_array_equal(
                    w.planes["data_i4p"].numpy(),
                    np.asarray(stacked.planes["data_i4p"][i]))
                np.testing.assert_array_equal(w.scale.numpy(),
                                              np.asarray(stacked.scale[i]))
        w2 = params_t["layers"][0]["ffn"]["w2"]
        inter = hp.decoder_intermediate_size
        assert w2.shape[0] == inter
        assert w2.storage_k == (8704 if inter == PAD_INTER else inter)
        head = params_t["lm_head"]
        np.testing.assert_array_equal(
            head.planes["data_i4p"].numpy(),
            np.asarray(params_j["lm_head"].planes["data_i4p"]))
    own = tzoo.make_synthetic_params(
        tzoo.make_spec("test-llama", layers=1, inter=PAD_INTER), "Q4_B64T1",
        seed=0, device="cpu", device_layout="i4")
    w2 = own["layers"][0]["ffn"]["w2"]
    assert set(w2.planes) == {"data_i4p"} and w2.storage_k == PAD_INTER


def test_b5_plain_matches_interpret(llama, llama_pad):
    """B5's plain version, and ops.linear on an i4 weight, against the
    JAX kernel in interpret mode: M in {1, 5, 12, 40}, the lm_head and a
    K-padded w2."""
    rng = np.random.default_rng(1)
    cases = ((llama[1]["lm_head"], llama[3]["lm_head"]),
             (jax.tree_util.tree_map(lambda a: a[0],
                                     llama_pad[1]["layers"]["ffn"]["w2"]),
              llama_pad[3]["layers"][0]["ffn"]["w2"]))
    for w_j, w_t in cases:
        # the stacked slice keeps JAX's stacked aux shape: set the logical one
        w_j = codec_jax.QuantizedTensor(w_j.format, tuple(w_t.shape),
                                        w_j.planes, w_j.scale, w_j.base)
        k = int(w_t.shape[0])
        for m in (1, 5, 12, 40):
            x = rng.standard_normal((m, k)).astype(np.float32)
            ref = np.asarray(quantized_matmul_interpret(
                jnp.asarray(x).astype(jnp.bfloat16), w_j), np.float32)
            xt = torch.from_numpy(x).to(torch.bfloat16)
            for got in (tdm.quantized_matmul(xt, w_t),
                        tlinear.linear(xt, w_t)):
                got = got.float().numpy()
                assert got.shape == ref.shape
                assert np.all(np.abs(got - ref) <= _bf16_step(ref)), (k, m)


@pytest.fixture
def i4x8(monkeypatch):
    """The JAX fused step pinned to its i4x8 mode."""
    monkeypatch.setenv("INFERFLOW_I4_DOT", "i8")


def test_fused_step_i4x8_matches_jax(llama, llama_pad, i4x8, monkeypatch):
    """B4 mode (b)'s plain version against JAX fused_decode_step
    (interpret=True): B = 1 and B = 4 (one slot inactive, one at the last
    cache row) on test-llama, and B = 2 with the K-padded w2."""
    rows_j = _grab_rows(jkv, monkeypatch)
    rows_t = _grab_rows(tds, monkeypatch)
    for (spec_j, params_j, spec_t, params_t), lengths, seed, tol in (
            (llama, [300], 4, STEP_TOL_B1),
            (llama, [200, 0, 511, 17], 5, STEP_TOL),
            (llama_pad, [100, 40], 6, STEP_TOL)):
        hp = spec_t.hyper_params

        @jax.jit
        def step_j(layers, x, pos, cache):
            out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                        interpret=True)
            return out, rows_j["k"], rows_j["v"]

        jc, tc = _caches(spec_j, spec_t, lengths, seed)
        b = len(lengths)
        assert jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
        assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
        tokens = np.random.default_rng(seed).integers(
            0, hp.vocab_size, (b, 1)).astype(np.int32)
        pos = np.asarray(lengths, np.int32)[:, None]
        xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                               jnp.asarray(pos))
        xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                               torch.from_numpy(pos))
        (ref, jc), kj, vj = step_j(params_j["layers"], xj, jnp.asarray(pos),
                                   jc)
        got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                        torch.from_numpy(pos), tc)
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape == (b, 1, hp.embd_dims)
        assert np.abs(got.float().numpy() - ref).max() <= tol, lengths
        drift = [np.abs(rows_t[n].numpy() - np.asarray(r)).max(axis=-1)
                 for n, r in (("k", kj), ("v", vj))]  # (L, B, H)
        assert max(d.max() for d in drift) <= tol, lengths
        for layer in range(hp.decoder_layers):
            for a, r, dr in zip(tc.read_layer(layer, torch.float32),
                                jc.read_layer(layer, jnp.float32), drift):
                for slot, n in enumerate(lengths):
                    row = min(n, 511)
                    row_t = a[slot, row].numpy()
                    row_j = np.asarray(r[slot, row])
                    step = np.abs(row_j).max(axis=-1) / 127.0
                    assert np.all(np.abs(row_t - row_j).max(axis=-1)
                                  <= step + dr[layer, slot] + 1e-6)


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


def test_engine_i4_matches_jax(llama, jax_fused_interpret, monkeypatch):
    """Both engines serve test-llama in the i4 layout: 4 slots (every
    decode step the fused step, mode (b)) and 9 slots (the per-layer loop,
    B5 in every product); one prompt takes three 32-token chunks while the
    other decodes."""
    spec_j, params_j, spec_t, params_t = llama
    calls = {"fused": 0, "b5": 0}
    real_fused, real_b5 = tdec.fused_decode_step, tdm.i4_matmul_plain
    monkeypatch.setattr(tdec, "fused_decode_step", lambda *a, **k: (
        calls.__setitem__("fused", calls["fused"] + 1) or real_fused(*a, **k)))
    monkeypatch.setattr(tdm, "i4_matmul_plain", lambda *a, **k: (
        calls.__setitem__("b5", calls["b5"] + 1) or real_b5(*a, **k)))
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 70)])
    for slots in (4, 9):
        calls.update(fused=0, b5=0)
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
        assert jds.mega_disabled() is None
        if slots == 4:
            assert calls["fused"] >= 8  # every decode step took mode (b)
        else:
            assert calls["fused"] == 0 and calls["b5"] > 0
        for q in (1, 2):
            for i, (a, b) in enumerate(zip(got[q], ref[q])):
                np.testing.assert_allclose(tr[q][i], jr[q][i],
                                           atol=ENGINE_LOGIT_TOL)
                if a != b:  # only at a near-tie of the JAX engine's logits
                    top2 = np.sort(jr[q][i])[-2:]
                    assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                    break
            assert len(got[q]) == len(ref[q])


def test_routing_and_layouts(llama, monkeypatch):
    """i4 weights take the fused step at B <= 8 and B5 elsewhere; q8c and
    mixed build and serve (Q8_B32T2 containers for every weight, or for
    the FFN weights only); resolve_auto_layout takes i4 for llama2-13b on
    a 16 GB card and i8mm on 80 GB."""
    _, _, spec_t, params_t = llama
    hp = spec_t.hyper_params
    for b in (1, 8, 9):
        cache = TKVCache.create(hp.decoder_layers, b, 64, hp.kv_heads,
                                hp.head_dim, quantized=True, device="cpu")
        assert tds.fused_step_supported(spec_t, params_t["layers"], cache,
                                        b) == (b <= 8)
        assert tds.fused_step_preferred(spec_t, params_t["layers"], cache,
                                        b) == (b <= 8)
    for layout in ("q8c", "mixed"):
        spec = tzoo.make_spec("test-llama", device_layout=layout)
        params = tzoo.make_synthetic_params(spec, "Q4_B64T1", device="cpu",
                                            device_layout=layout)
        assert params["layers"][0]["ffn"]["w2"].format == "Q8_B32T2"
        assert params["layers"][0]["attn"]["wo"].format == (
            "Q8_B32T2" if layout == "q8c" else "Q4_B64T1")
        eng = TEngine(spec, params, max_concurrent_queries=2,
                      max_context_len=64, device="cpu")
        assert len(eng.generate([1, 2, 3], TOpts(strategy="greedy"), 2)) == 2
    got = {}
    for gb in (80, 16):
        monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                            lambda dev, gb=gb: gb * 10 ** 9)
        got[gb] = codec_torch.resolve_auto_layout(
            tzoo.make_spec("llama2-13b"), "Q4_B64T1", "cuda")
    assert got == {80: "i8mm", 16: "i4"}
    # a block-32 4-bit format repacks too, and the fused step takes it in
    # its own i4x8 instantiation beside the 64-row products
    qt = codec_torch.repack_i4(codec_torch.quantize(torch.randn(512, 256),
                                                    "Q4_B32T1A"))
    assert set(qt.planes) == {"data_i4p"}
    layers = [dict(lp, ffn=dict(lp["ffn"], w2=qt if i == 0 else
                                lp["ffn"]["w2"]))
              for i, lp in enumerate(params_t["layers"])]
    cache = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads,
                            hp.head_dim, quantized=True, device="cpu")
    assert tds.fused_step_supported(spec_t, layers, cache, 2)
    assert tds._i4_geometry(qt)[0] == 4
