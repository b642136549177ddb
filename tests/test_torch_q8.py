"""The port's Q8 block weights (kernel B1's Q8 case, the fused step's byte
mode (c)) and the q8c and mixed layouts against the JAX package, on the
CPU.

Q8_B32T2 (the ``Q8`` alias: signed int8 codes, an f16 scale per 32 rows,
no base) and Q8_B32T1 (codes 0..255, f16 scale and base) keep one code per
byte on the device.  Every product with more than 8 rows, and the lm_head,
runs kernel B1; decode steps of up to 8 slots run the fused step B4 in its
byte mode.  The q8c layout re-encodes every weight as Q8_B32T2
(``requantize_q8_container``), the mixed layout the FFN weights only.
Weights: the JAX zoo's test-llama params, moved over with
``weights.params_from_numpy``.  The JAX Pallas kernels run in interpret
mode.

Tolerances:
  - codec: exact (requantize_q8_container's bytes and scales);
  - B1-Q8's plain version against quantized_matmul_interpret: the port
    follows the codec, w = bf16(q*scale + base), where the TPU kernel
    rounds the scale (and the base) to bf16 first and each bf16 operation
    after it (ROADMAP section C): each weight moves by at most 2^-7 of
    |q*scale| + |base|, so each output by at most 2^-7 * (|x| @ that)
    plus one bf16 step of the output;
  - the plain B4 (c) step against fused_decode_step(interpret=True): both
    take bf16 activations and bf16(scale); the plain version rounds each
    weight q * bf16(scale) to bf16, as the TPU kernel's bf16 multiply
    does, where interpret mode on the CPU keeps that product in float32
    (ROADMAP C3): each weight moves by at most 2^-9 of q * bf16(scale),
    each product output by at most 2^-9 * (|x| @ |q * scale|) (measured
    1.6e-3 on layer 0's V rows of magnitude ~1.2), and three random
    layers carry it on: on the K/V rows at B = 1 measured 0.010 for
    Q8_B32T2 and 0.022 for Q8_B32T1, whose codes 0..255 make |q * scale|
    about twice |w|.  At B = 1 (per-slot attention, float32 throughout)
    the hidden state and K/V rows are held within BYTE_TOL_B1 = 4e-2; at
    B > 1 (batched attention, whose bf16 roundings of q and p * vscale
    fall relative to other running maxima, as in
    tests/test_torch_decode_step.py) within STEP_TOL = 6e-2 (measured
    0.039 at most), on values of magnitude ~1; the appended cache rows
    within one Q8 step of JAX's plus the drift of the float rows they
    quantize;
  - engines: ENGINE_LOGIT_TOL = 5e-2 on logits of magnitude ~1, greedy
    streams equal but for near-ties of the JAX engine's logits (both run
    the same B4 (c) arithmetic on the same bytes);
  - q8c and mixed decoders: LOGIT_TOL = 2e-2, as tests/test_torch_decoder.py
    (the same bf16 weights on both sides; the port's decode attention
    dequantizes K/V in float32 where the JAX CPU path rounds them to bf16
    first, and under q8c the port's decode step is its fused step, whose
    weights round the scale to bf16 as above): measured 0.0088 (q8c) and
    0.0156 (mixed) on logits of magnitude ~1.7, the prefill rows equal.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.config import load_engine_config as jload
from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.kernels.dequant_matmul import quantized_matmul_interpret
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.quant import codec_np as jcodec_np
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.config import load_engine_config as tload
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

from test_torch_decode_step import (_caches, _grab_rows,
                                    jax_fused_interpret)  # noqa: F401
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

ROOT = pathlib.Path(__file__).resolve().parents[1]
Q8_INI = ROOT / "configs" / "inferflow_service.q8.ini"
FORMATS = ("Q8_B32T2", "Q8_B32T1")
STEP_TOL = 6e-2
BYTE_TOL_B1 = 4e-2
ENGINE_LOGIT_TOL = 5e-2
LOGIT_TOL = 2e-2


def _models(fmt, layout="", stacked=True):
    """test-llama from `fmt` under `layout` in both packages (the JAX
    builder's params, layer-stacked or a list, and the port's per-layer
    copy of the same bytes).  The JAX package resolves no layout on the
    CPU: '' keeps the byte formats as they are there, as the auto rule
    does on the card."""
    spec_j = jzoo.make_spec("test-llama", device_layout=layout)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=3,
                                          stacked=stacked,
                                          device_layout=layout)
    spec_t = tzoo.make_spec("test-llama", device_layout=layout)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_j.qkv_format == spec_t.qkv_format == 1
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def llama():
    """test-llama in each Q8 block format, by format name."""
    return {fmt: _models(fmt) for fmt in FORMATS}


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def test_q8_container_matches_jax():
    """requantize_q8_container gives JAX's Q8_B32T2 bytes and scales for a
    Q4_B64T1 wire tensor, a Q3H_B64T1 tensor (the port's pair8 plane
    against the JAX codec's wire planes, whose values are the same), a
    2-bit and a 3-bit format; a Q8_B32T2 tensor passes through as it is,
    and the port's zoo builds q8c and mixed params from the same values."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column: zero scales
    w[:64, 5] = -1.0  # a constant block
    for fmt in ("Q4_B64T1", "Q3H_B64T1", "Q2_B32T1A", "Q3_B32T1A"):
        wire = jcodec_np.quantize_np(w, fmt)
        qt_j = codec_jax.QuantizedTensor.from_np(wire, fast_layout=False)
        qt_t = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
        ref = codec_jax.requantize_q8_container(qt_j)
        got = codec_torch.requantize_q8_container(qt_t)
        assert got.format == ref.format == "Q8_B32T2", fmt
        assert got.shape == tuple(ref.shape) and got.base is None
        assert set(got.planes) == set(ref.planes) == {"data"}
        np.testing.assert_array_equal(got.planes["data"].numpy(),
                                      np.asarray(ref.planes["data"]))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
        np.testing.assert_array_equal(
            codec_torch.dequantize(got, torch.float32).numpy(),
            np.asarray(codec_jax.dequantize(ref, jnp.float32)))
        assert codec_torch.requantize_q8_container(got) is got
    for layout, q8_leaves in (("q8c", {"qkv", "wo", "w1n3", "w2"}),
                              ("mixed", {"w1n3", "w2"})):
        spec = tzoo.make_spec("test-llama", device_layout=layout)
        params = tzoo.make_synthetic_params(spec, "Q4_B64T1", seed=0,
                                            device="cpu",
                                            device_layout=layout)
        lp = params["layers"][0]
        for leaf, t in (*lp["attn"].items(), *lp["ffn"].items(),
                        ("lm_head", params["lm_head"])):
            if leaf.endswith("norm"):
                continue
            want = "Q8_B32T2" if leaf in q8_leaves or (
                layout == "q8c" and leaf == "lm_head") else "Q4_B64T1"
            assert t.format == want, (layout, leaf)


def test_b1_q8_plain_matches_interpret(llama):
    """B1's plain version for Q8_B32T2 and Q8_B32T1 (quantized_matmul on
    the CPU, and ops.linear) against the JAX kernel in interpret mode, M
    in {1, 5}, on the lm_head and on layer 1's w2."""
    rng = np.random.default_rng(1)
    for fmt in FORMATS:
        _, params_j, _, params_t = llama[fmt]
        w2_j = jax.tree_util.tree_map(lambda a: a[1],
                                      params_j["layers"]["ffn"]["w2"])
        for w_j, w_t in ((params_j["lm_head"], params_t["lm_head"]),
                         (w2_j, params_t["layers"][1]["ffn"]["w2"])):
            w_j = codec_jax.QuantizedTensor(w_j.format, tuple(w_t.shape),
                                            w_j.planes, w_j.scale, w_j.base)
            assert w_t.format == fmt and set(w_t.planes) == {"data"}
            k = int(w_t.shape[0])
            # |q*scale| + |base| per weight: the bound's scale
            q = codec_torch._codes(w_t.planes, codec_torch.get_format(fmt))
            if fmt == "Q8_B32T2":
                q = torch.where(q >= 128, q - 256, q)
            mag = (q.float().view(k // 32, 32, -1).abs()
                   * w_t.scale.float()[:, None, :])
            if w_t.base is not None:
                mag = mag + w_t.base.float().abs()[:, None, :]
            mag = mag.reshape(k, -1).numpy()
            for m in (1, 5):
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


def test_byte_step_plain_matches_jax(llama, monkeypatch):
    """The plain B4 (c) step against JAX fused_decode_step(interpret=True)
    in both Q8 formats: B = 1 (per-slot attention), B = 2 and B = 5
    (batched attention; an inactive slot of length 0 and one at the last
    cache row); the hidden state and the appended cache rows."""
    rows_j = _grab_rows(jkv, monkeypatch)
    rows_t = _grab_rows(tds, monkeypatch)
    for fmt in FORMATS:
        spec_j, params_j, spec_t, params_t = llama[fmt]
        hp = spec_t.hyper_params

        @jax.jit
        def step_j(layers, x, pos, cache):
            out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                        interpret=True)
            return out, rows_j["k"], rows_j["v"]

        for lengths, seed, tol in (([300], 4, BYTE_TOL_B1),
                                   ([200, 0], 5, STEP_TOL),
                                   ([17, 0, 511, 64, 3], 6, STEP_TOL)):
            jc, tc = _caches(spec_j, spec_t, lengths, seed)
            b = len(lengths)
            assert jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
            assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
            assert tds.fused_step_supported(spec_t, params_t["layers"], tc, b)
            tokens = np.random.default_rng(seed).integers(
                0, hp.vocab_size, (b, 1)).astype(np.int32)
            pos = np.asarray(lengths, np.int32)[:, None]
            xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                                   jnp.asarray(pos))
            xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                                   torch.from_numpy(pos))
            (ref, jc), kj, vj = step_j(params_j["layers"], xj,
                                       jnp.asarray(pos), jc)
            got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                            torch.from_numpy(pos), tc)
            ref = np.asarray(ref, np.float32)
            assert got.shape == ref.shape == (b, 1, hp.embd_dims)
            assert np.abs(got.float().numpy() - ref).max() <= tol, \
                (fmt, lengths)
            drift = [np.abs(rows_t[n].numpy() - np.asarray(r)).max(axis=-1)
                     for n, r in (("k", kj), ("v", vj))]  # (L, B, H)
            assert max(d.max() for d in drift) <= tol, (fmt, lengths)
            for layer in range(hp.decoder_layers):
                for a, r, dr in zip(tc.read_layer(layer, torch.float32),
                                    jc.read_layer(layer, jnp.float32), drift):
                    for slot, n in enumerate(lengths):
                        row = min(n, tc.max_len - 1)
                        row_t = a[slot, row].numpy()  # (H, D)
                        row_j = np.asarray(r[slot, row])
                        step = np.abs(row_j).max(axis=-1) / 127.0
                        assert np.all(np.abs(row_t - row_j).max(axis=-1)
                                      <= step + dr[layer, slot] + 1e-6)


def test_engine_q8_matches_jax(llama, jax_fused_interpret, monkeypatch):
    """Both engines serve test-llama in Q8_B32T2 with the q8 ini's 8 slots
    and Q8 cache, each through its fused byte-mode step on every decode
    step (B1-Q8 for the prefill, the chunks and the lm_head); one prompt
    takes three 32-token chunks while the other decodes."""
    spec_j, params_j, spec_t, params_t = llama["Q8_B32T2"]
    cfg = tload(str(Q8_INI))
    slots = cfg.max_concurrent_queries
    je = JEngine(spec_j, params_j, max_concurrent_queries=slots,
                 max_context_len=256, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=slots,
                 max_context_len=256, kv_cache_quantized=True, device="cpu")
    je.prefill_chunk = te.prefill_chunk = 32
    jr, tr = _record_rows(je), _record_rows(te)
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 70)])
    calls, products = [], []
    real_step, real_mm = tdec.fused_decode_step, tdm.quantized_matmul_plain
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: calls.append(1) or real_step(*a, **k))
    monkeypatch.setattr(tdm, "quantized_matmul_plain",
                        lambda x, qt: products.append(qt.format)
                        or real_mm(x, qt))
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    assert jds.mega_disabled() is None
    assert len(calls) >= 8  # every decode step of the port took it
    assert products and set(products) == {"Q8_B32T2"}
    for q in (1, 2):
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break
        assert len(got[q]) == len(ref[q])


def test_q8c_and_mixed_decoders_match_jax():
    """Logits of the q8c and mixed layouts (test-llama from Q4_B64T1)
    against the JAX decoder: a 9-token prefill, then two decode steps at
    B = 1 (the port's fused byte step under q8c; under mixed the
    per-layer loop, its attention on Q4 wire planes), as
    tests/test_layouts.py runs mixed."""
    rng = np.random.default_rng(0)
    for layout in ("q8c", "mixed"):
        spec_j, params_j, spec_t, params_t = _models("Q4_B64T1", layout,
                                                     stacked=False)
        hp = spec_t.hyper_params
        attn_fmt = params_t["layers"][0]["attn"]["qkv"].format
        assert attn_fmt == ("Q8_B32T2" if layout == "q8c" else "Q4_B64T1")
        assert params_t["layers"][0]["ffn"]["w1n3"].format == "Q8_B32T2"
        jc = JKVCache.create(hp.decoder_layers, 1, 64, hp.kv_heads,
                             hp.head_dim, quantized=True)
        tc = TKVCache.create(hp.decoder_layers, 1, 64, hp.kv_heads,
                             hp.head_dim, quantized=True, device="cpu")
        assert tds.fused_step_preferred(spec_t, params_t["layers"], tc,
                                        1) == (layout == "q8c")
        toks = rng.integers(4, hp.vocab_size - 1, (1, 11)).astype(np.int32)
        for t0, t1 in ((0, 9), (9, 10), (10, 11)):
            pos = np.arange(t0, t1, dtype=np.int32)[None, :]
            ref, jc = jdec.decoder_forward(spec_j, params_j,
                                           jnp.asarray(toks[:, t0:t1]),
                                           jnp.asarray(pos), jc)
            got, tc = tdec.decoder_forward(spec_t, params_t,
                                           torch.from_numpy(toks[:, t0:t1]),
                                           torch.from_numpy(pos), tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=LOGIT_TOL, err_msg=layout)


def test_q8_ini_loads_in_both_packages():
    """configs/inferflow_service.q8.ini reads to the same EngineConfig in
    both loaders: llama2_7b, 8 slots, Q8 weights and cache, a 4096-token
    context and no device_layout (the auto rule keeps byte formats: ''
    on the card as on the CPU)."""
    ref, got = jload(str(Q8_INI)), tload(str(Q8_INI))
    assert (got.max_concurrent_queries, got.kv_cache_paging) == (8, False)
    assert got.max_concurrent_queries == ref.max_concurrent_queries
    m_t, m_j = got.model, ref.model
    for f in ("sid", "device_weight_data_type", "device_kv_cache_data_type",
              "device_layout", "max_context_len", "be_host_embeddings",
              "host_kv_cache_percent"):
        assert getattr(m_t, f) == getattr(m_j, f), f
    assert (m_t.sid, m_t.device_weight_data_type,
            m_t.device_kv_cache_data_type, m_t.device_layout,
            m_t.max_context_len) == ("llama2_7b", "Q8", "Q8", "", 4096)
    spec = tzoo.make_spec("llama2-7b")
    assert codec_torch.resolve_auto_layout(
        spec, m_t.device_weight_data_type, "cuda") == ""
