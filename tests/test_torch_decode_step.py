"""The port's i8mm layout and whole-model fused decode step (kernel B4's
plain version) against the JAX package, on the CPU.

Weights: the JAX builder's test-llama params (d = 32, 2 kv heads, g = 4,
3 layers) from Q4_B64T1, requantized into the i8mm container, moved over
with ``weights.params_from_numpy``.  The JAX fused step runs its Pallas
kernel with ``interpret=True``.

Tolerances:
  - codec bytes (requantize_i8_colwise, int8_rowwise_activations): exact;
  - i8mm ``linear``: one bf16 step of the output (both take the same int8
    codes and an exact integer product; measured: equal);
  - fused step at B = 1 (per-slot attention, float32 throughout): hidden
    state and appended float K/V rows within STEP_TOL_B1 = 1e-2; measured
    equal (0.0 and 1.2e-7);
  - fused step at B = 3 (batched attention): within STEP_TOL = 6e-2 on
    values of magnitude ~1; measured 0.023 (hidden) and 0.044 (K/V rows).
    The JAX kernel rounds q and p * vscale to bf16 relative to the running
    maximum of each (tile, sequence-parity) step of its packed cache walk,
    the port relative to the final maximum, and an ulp of rsqrt inside the
    interpret-mode kernel can move a bf16 rounding of xn and with it a
    row's int8 scale (JAX's own per-slot and batched modes differ by
    0.013 here);
  - the appended cache rows: within one Q8 step (the head row's largest
    |value| / 127) of JAX's, plus the drift of the float rows they
    quantize;
  - engine: the stream and logit rule of tests/test_torch_engine.py, at
    ENGINE_LOGIT_TOL = 5e-2 on logits of magnitude ~1.  The JAX package
    disagrees with itself on this model by more than that file's 2e-2:
    its scanned prefill (decoder_forward_scan, the engine's) and its
    unrolled decoder_forward differ by 0.025 on the first sampled row,
    and its per-layer and fused decode steps by up to 0.042 on later
    rows.  The port's prefill equals decoder_forward exactly; measured
    against the JAX engine, 0.039 at most.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.ops.linear import linear as jlinear
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.ops.linear import linear as tlinear
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

STEP_TOL = 6e-2
STEP_TOL_B1 = 1e-2
ENGINE_LOGIT_TOL = 5e-2
CACHE_ROWS = 512


@pytest.fixture(scope="module")
def llama():
    """test-llama in i8mm: the JAX layer-stacked params and the port's
    per-layer copy of the same bytes."""
    spec_j = jzoo.make_spec("test-llama", device_layout="i8mm")
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=3,
                                          stacked=True, device_layout="i8mm")
    spec_t = tzoo.make_spec("test-llama", device_layout="i8mm")
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_j.qkv_format == spec_t.qkv_format == 1
    assert isinstance(params_t["layers"][0]["attn"]["qkv"],
                      codec_torch.Int8MXUTensor)
    return spec_j, params_j, spec_t, params_t


def test_i8mm_codec_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 5] = 0.0  # an all-zero column: the 1e-12 scale floor
    qt_j = codec_jax.quantize(jnp.asarray(w), "Q4_B64T1")
    qt_t = codec_torch.QuantizedTensor.from_np(qt_j.to_np(), device="cpu")
    for src_j, src_t in ((qt_j, qt_t), (jnp.asarray(w), torch.from_numpy(w))):
        ref = codec_jax.requantize_i8_colwise(src_j)
        got = codec_torch.requantize_i8_colwise(src_t)
        assert got.shape == tuple(ref.shape)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(ref.scale))
        np.testing.assert_array_equal(
            got.dequantize(torch.float32).numpy(),
            np.asarray(ref.dequantize(jnp.float32)))
    x = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [127.5, -0.5, 1.5, 2.5]  # ties: round half to even
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
        xq_j, xs_j = codec_jax.int8_rowwise_activations(
            jnp.asarray(x).astype(dtype_j))
        xq_t, xs_t = codec_torch.int8_rowwise_activations(
            torch.from_numpy(x).to(dtype_t))
        np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
        np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))

    # the capacity rule: the port on a card of 80 GB and of 16 GB; the JAX
    # rule on its TPU path at its 16 GB default (a CPU device reports no
    # memory limit)
    cases = [("tinyllama-1.1b", "Q4_B64T1"), ("llama2-13b", "Q4_B64T1"),
             ("llama2-13b", "Q2_B32T1A"), ("llama2-13b", "Q8_B32T2"),
             ("mixtral-8x7b", "Q4_B64T1"), ("llama2-7b", "Q3H_B64T1")]
    monkeypatch.setattr(codec_jax.jax, "default_backend", lambda: "tpu")
    got = {}
    for gb in (80, 16):
        monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                            lambda dev, gb=gb: gb * 10 ** 9)
        got[gb] = [codec_torch.resolve_auto_layout(tzoo.make_spec(m), f,
                                                   "cuda") for m, f in cases]
    ref16 = [codec_jax.resolve_auto_layout(jzoo.make_spec(m), f)
             for m, f in cases]
    assert got[16] == ref16 == ["i8mm", "i4", "packed", "", "i4", "i8mm"]
    assert got[80] == ["i8mm", "i8mm", "i8mm", "", "i8mm", "i8mm"]
    assert codec_torch.resolve_auto_layout(
        tzoo.make_spec("tinyllama-1.1b"), "Q4_B64T1", "cpu") == ""
    assert codec_torch.resolve_auto_layout(
        tzoo.make_spec("test-llama", device_layout="packed"), "Q4_B64T1",
        "cuda") == "packed"
    assert codec_torch.layout_for_leaf("mixed", "w2") == "q8c"
    assert codec_torch.layout_for_leaf("mixed", "wq") == "packed"
    assert codec_torch.layout_for_leaf("i8mm", "wq") == "i8mm"


def test_i8mm_linear_matches_jax(llama):
    _, params_j, _, params_t = llama
    w_j = params_j["lm_head"]
    w_t = params_t["lm_head"]
    rng = np.random.default_rng(1)
    for m in (1, 4, 16):
        x = rng.standard_normal((m, w_t.shape[0])).astype(np.float32)
        x_j = jnp.asarray(x).astype(jnp.bfloat16)
        ref = np.asarray(jlinear(x_j, w_j), np.float32)
        got = tlinear(torch.from_numpy(x).to(torch.bfloat16), w_t).float()
        assert got.shape == ref.shape
        step = 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
        assert np.all(np.abs(got.numpy() - ref) <= step), m


def _caches(spec_j, spec_t, lengths, seed):
    """A Q8 cache of CACHE_ROWS rows on each side, filled with the same
    rows (the two codecs give equal bytes), with per-slot lengths."""
    hp = spec_t.hyper_params
    b = len(lengths)
    jc = JKVCache.create(hp.decoder_layers, b, CACHE_ROWS, hp.kv_heads,
                         hp.head_dim, quantized=True)
    tc = TKVCache.create(hp.decoder_layers, b, CACHE_ROWS, hp.kv_heads,
                         hp.head_dim, quantized=True, device="cpu")
    rng = np.random.default_rng(seed)
    rows = max(lengths)
    zeros = np.zeros((b,), np.int32)
    for layer in range(hp.decoder_layers):
        k, v = (rng.standard_normal((b, rows, hp.kv_heads, hp.head_dim))
                .astype(np.float32) for _ in range(2))
        jc = jc.update_layer(layer, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(zeros))
        tc.update_layer(layer, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(zeros))
    lens = np.asarray(lengths, np.int32)
    return jc.with_length(jnp.asarray(lens)), tc.with_length(
        torch.from_numpy(lens))


def _grab_rows(module, monkeypatch):
    """Record the (L, B, H, D) float K/V rows a fused step appends."""
    rows = {}
    real = module.append_rows_all_layers

    def grab(cache, k, v, start):
        rows["k"], rows["v"] = k, v
        return real(cache, k, v, start)

    monkeypatch.setattr(module, "append_rows_all_layers", grab)
    return rows


def test_fused_decode_step_matches_jax(llama, monkeypatch):
    """The plain fused step against JAX fused_decode_step(interpret=True):
    B = 1 (per-slot attention) and B = 3 (batched attention, one inactive
    slot of length 0 and one at the last cache row)."""
    spec_j, params_j, spec_t, params_t = llama
    hp = spec_t.hyper_params
    rows_j = _grab_rows(jkv, monkeypatch)
    rows_t = _grab_rows(tds, monkeypatch)

    @jax.jit
    def step_j(layers, x, pos, cache):
        out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                    interpret=True)
        return out, rows_j["k"], rows_j["v"]

    for lengths, seed, tol in (([300], 4, STEP_TOL_B1),
                               ([200, 0, CACHE_ROWS - 1], 5, STEP_TOL)):
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
        np.testing.assert_array_equal(tc.length.numpy(), lengths)
        # the appended rows: each within one Q8 step of JAX's, on top of
        # the drift of the float rows they quantize
        drift = [np.abs(rows_t[n].numpy() - np.asarray(r)).max(axis=-1)
                 for n, r in (("k", kj), ("v", vj))]  # (L, B, H)
        assert max(d.max() for d in drift) <= tol, lengths
        for layer in range(hp.decoder_layers):
            for a, r, dr in zip(tc.read_layer(layer, torch.float32),
                                jc.read_layer(layer, jnp.float32), drift):
                for slot, n in enumerate(lengths):
                    row = min(n, CACHE_ROWS - 1)
                    row_t = a[slot, row].numpy()  # (H, D)
                    row_j = np.asarray(r[slot, row])
                    step = np.abs(row_j).max(axis=-1) / 127.0
                    assert np.all(np.abs(row_t - row_j).max(axis=-1)
                                  <= step + dr[layer, slot] + 1e-6)


def test_routing_and_unported_modes(llama, monkeypatch):
    """B <= 8 takes the fused step and B = 9 the per-layer loop; the byte
    mode (Q8 block weights) is supported and preferred, as the TPU package
    routes it; output biases (mode (d)) and Q4 wire planes (the wire mode)
    are routed as the JAX functions route them, and the fused step runs
    both."""
    _, _, spec_t, params_t = llama
    hp = spec_t.hyper_params
    calls = []
    real = tdec.fused_decode_step

    def counting(*args, **kwargs):
        calls.append(args[2].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdec, "fused_decode_step", counting)
    for b in (1, 8, 9):
        cache = TKVCache.create(hp.decoder_layers, b, 64, hp.kv_heads,
                                hp.head_dim, quantized=True, device="cpu")
        x = torch.randn((b, 1, hp.embd_dims)).to(torch.bfloat16)
        pos = torch.zeros((b, 1), dtype=torch.int32)
        y, _ = tdec.decoder_layers_unrolled(spec_t, params_t["layers"], x,
                                            pos, cache)
        assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert calls == [1, 8]
    cache = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads,
                            hp.head_dim, quantized=False, device="cpu")
    assert not tds.fused_step_supported(spec_t, params_t["layers"], cache, 2)

    # byte-per-code weights (Q8_B32T2): fused and preferred, as on the TPU
    spec_q8 = tzoo.make_spec("test-llama", device_layout="packed")
    q8 = tzoo.make_synthetic_params(spec_q8, "Q8_B32T2", seed=0,
                                    device="cpu")
    cache = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads,
                            hp.head_dim, quantized=True, device="cpu")
    x = torch.zeros((2, 1, hp.embd_dims), dtype=torch.bfloat16)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    assert tds.fused_step_supported(spec_q8, q8["layers"], cache, 2)
    assert tds.fused_step_preferred(spec_q8, q8["layers"], cache, 2)
    calls.clear()
    y, _ = tdec.decoder_layers_unrolled(spec_q8, q8["layers"], x, pos, cache)
    assert calls == [2] and torch.isfinite(y.float()).all()
    # output biases (mode (d)) and Q4 wire planes (the wire mode): the
    # port's answers are the JAX functions' on the same weights; a biased
    # step is fused and preferred, the wire one supported but routed to
    # the per-layer loop, and the fused step runs both
    spec_j, params_j = llama[0], llama[1]
    # the JAX rule's cache: CACHE_ROWS (its sequence tile needs 128 rows
    # of the packed cache)
    jc = JKVCache.create(hp.decoder_layers, 2, CACHE_ROWS, hp.kv_heads,
                         hp.head_dim, quantized=True)
    nq = int(params_j["layers"]["attn"]["qkv"].shape[-1])
    qkv_b = np.random.default_rng(0).standard_normal(
        (hp.decoder_layers, nq)).astype(np.float32) * 0.05
    biased_j = dict(params_j["layers"], attn=dict(
        params_j["layers"]["attn"], qkv_b=jnp.asarray(qkv_b)))
    biased = [dict(lp, attn=dict(lp["attn"], qkv_b=torch.from_numpy(
        qkv_b[i]))) for i, lp in enumerate(params_t["layers"])]
    spec_q4j = jzoo.make_spec("test-llama", device_layout="packed")
    q4_j = jzoo.make_synthetic_params(spec_q4j, "Q4_B64T1", seed=0,
                                      stacked=True, device_layout="packed")
    spec_q4 = tzoo.make_spec("test-llama", device_layout="packed")
    q4 = params_from_numpy(jax_params_to_numpy(q4_j), spec_q4, device="cpu")
    for (sj, lj), (st, lt), fused in (((spec_j, biased_j), (spec_t, biased),
                                       True),
                                      ((spec_q4j, q4_j["layers"]),
                                       (spec_q4, q4["layers"]), False)):
        assert jds.fused_step_supported(sj, lj, jc, 2)
        assert tds.fused_step_supported(st, lt, cache, 2)
        assert jds.fused_step_preferred(sj, lj, jc, 2) == fused
        assert tds.fused_step_preferred(st, lt, cache, 2) == fused
        calls.clear()
        y, _ = tdec.decoder_layers_unrolled(st, lt, x, pos, cache)
        assert calls == ([2] if fused else [])
        y, _ = tds.fused_decode_step(st, lt, x, pos, cache)
        assert y.shape == x.shape and torch.isfinite(y.float()).all()


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """The JAX engine's fused decode path on the CPU: forced on, its Pallas
    kernel in interpret mode."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    yield
    jds.enable_mega()


def test_engine_fused_path_matches_jax(llama, jax_fused_interpret,
                                      monkeypatch):
    """Both engines serve test-llama in i8mm with 4 slots through their
    fused decode step; one prompt takes three 32-token chunks while the
    other decodes."""
    spec_j, params_j, spec_t, params_t = llama
    je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True,
                 device="cpu")
    je.prefill_chunk = te.prefill_chunk = 32
    jr, tr = _record_rows(je), _record_rows(te)
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 70)])
    calls = []
    real = tdec.fused_decode_step
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    assert jds.mega_disabled() is None
    assert len(calls) >= 8  # every decode step of the port took it
    for q in (1, 2):
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break
        assert len(got[q]) == len(ref[q])


def test_layer_table_cache_holds_no_weights(monkeypatch):
    """B4's per-layer pointer tables, cached by layer list, hold no
    reference to the weights: a live list hits its table; once the list
    and its params are dropped (as with a freed engine) its tensors are
    freed, and a later list that reuses its id is not served the stale
    table."""
    import gc
    import weakref
    monkeypatch.setattr(tds._build, "check_operand", lambda *a, **k: None)
    spec = tzoo.make_spec("test-llama", device_layout="i8mm")
    hp = spec.hyper_params
    dims = (hp.embd_dims, hp.decoder_heads * hp.head_dim,
            (hp.decoder_heads + 2 * hp.kv_heads) * hp.head_dim,
            hp.decoder_intermediate_size)

    def layers(seed):
        return tzoo.make_synthetic_params(spec, "Q4_B64T1", seed=seed,
                                          device="cpu",
                                          device_layout="i8mm")["layers"]

    first = layers(0)
    table = tds._layer_table(first, *dims)
    assert tds._layer_table(first, *dims) is table
    w2 = weakref.ref(first[-1]["ffn"]["w2"].data)
    stale = tds._TABLES[id(first)]
    del first
    gc.collect()
    assert w2() is None
    later = layers(1)
    monkeypatch.setitem(tds._TABLES, id(later), stale)
    fresh = tds._layer_table(later, *dims)
    assert fresh is not table
    # the table: per layer two norms, then per product (mode, stored K,
    # data, scale, base)
    assert fresh[0][4] == later[0]["attn"]["qkv"].data.data_ptr()
