"""B4 mode (b'), the i4 layout's bf16-unpack mode, against the JAX package
on the CPU.

Under INFERFLOW_I4_DOT set to anything but ``i8`` the JAX fused step
streams i4 weights against exact bf16 activations (``_mm_cfg``,
decode_step.py:137; the tile at :573-583): per quant block r,
bf16(sum x) * bf16(8*sc + base), plus sum_k x_k * bf16(bf16(n_k) *
bf16(sc)) in float32.  The port routes the same way at the same moment
(``decode_step.i4_dot_mode``) and its plain versions follow that tile.

Tolerances:
  - the plain (b') product against the tile's formula evaluated in
    numpy on the codec's bytes: 1e-5 * (|x| @ |w| + |xsum| @ |fold|)
    (float32 summation order only); against x @ the codec's weights
    (every format): 2^-8 * (|x| @ |n * sc| + |xsum| @ |fold|)
    plus 2^-7 * (|x| @ |n * sc|) for bf16(sc) and bf16(n * bf16(sc)),
    each at most 2^-9 relative, plus one bf16 step of the output;
  - the plain step against JAX ``fused_decode_step(interpret=True)`` (the
    formats with f16 metadata), on the hidden state and on the appended
    K/V rows: the interpreter upcasts its bf16 dots to float32 and keeps
    bf16(n) * bf16(sc) in float32 where the TPU (and the port) round it
    to bf16 (ROADMAP C3).  With the product in the interpreter's
    arithmetic (the same formula without that rounding) the port's step
    equals it within EXACT_TOL (measured 0.0 on the hidden state, 3e-7
    on the rows: float32 summation order); as shipped, within
    C3_STEP_TOL: each weight moves by at most 2^-9 of itself, measured
    0.004-0.020 on hidden states and rows of magnitude ~1 over three
    test-llama layers (this file takes two, to stay short);
  - the f32-metadata formats (Q4_B32T2, Q4_B16; the JAX kernels misread
    them, ROADMAP C7): the plain step against the same step whose i4
    products take x @ the codec's float32 weights, CODEC_STEP_TOL (the
    bf16 weight roundings of one layer);
  - engines: ENGINE_LOGIT_TOL = 5e-2, the i4 engines' gate, greedy tokens
    equal but for near-ties of the JAX engine's logits.
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
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches, _grab_rows
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

EXACT_TOL = 1e-5
C3_STEP_TOL = 3e-2
CODEC_STEP_TOL = 3e-2
ENGINE_LOGIT_TOL = 5e-2
FORMATS = ("Q4_B64T1", "Q4_B32T1A", "Q4_B32T1B", "Q4_B32T2", "Q4_B16")
BLOCK = {"Q4_B64T1": 64, "Q4_B16": 16}
# one narrow test-llama layer (D = 32)
NARROW = dict(layers=1, embd=128, heads=4, kv_heads=2, inter=256, vocab=256)


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float32)


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def _models(fmt, **overrides):
    spec_j = jzoo.make_spec("test-llama", device_layout="i4", **overrides)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=3, stacked=True,
                                          device_layout="i4")
    spec_t = tzoo.make_spec("test-llama", device_layout="i4", **overrides)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def llama():
    """Two test-llama layers from Q4_B64T1 in the i4 layout: JAX's
    layer-stacked params and the port's copy of the same bytes."""
    return _models("Q4_B64T1", layers=2)


def test_plain_product_follows_the_tile_and_the_codec():
    """i4_bf16_matmul_plain on every 4-bit format, M in {1, 3, 8}: against
    the TPU tile's formula in numpy on the codec's bytes (codec_torch's,
    byte-equal to the JAX codec's: tests/test_torch_i4.py,
    tests/test_torch_model_loader.py), and against x @ the codec's
    weights; no int8 activations anywhere (the product differs from
    i4x8's)."""
    rng = np.random.default_rng(0)
    k, n = 512, 128
    for fmt in FORMATS:
        blk = BLOCK.get(fmt, 32)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * (0.5 / k ** 0.5))
        qt = codec_torch.repack_i4(codec_torch.quantize(w, fmt))
        nib = codec_torch.i4_nibbles(qt.planes["data_i4p"]).float().numpy()
        sc = qt.scale.float().numpy()
        fold = _bf16(8 * sc + qt.base.float().numpy())
        wq = _bf16(nib.reshape(-1, blk, n) * _bf16(sc)[:, None, :]).reshape(
            k, n)
        w_codec = codec_torch.dequantize(qt, torch.float32).numpy()
        for m in (1, 3, 8):
            xb = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to(torch.bfloat16)
            x = xb.float().numpy()
            got = tds.i4_bf16_matmul_plain(xb, qt).numpy()
            xsum = _bf16(x.reshape(m, -1, blk).sum(-1))
            mag = np.abs(x) @ np.abs(wq) + np.abs(xsum) @ np.abs(fold)
            ref = xsum @ fold + x @ wq
            assert np.all(np.abs(got - ref) <= 1e-5 * mag + 1e-6), (fmt, m)
            nsc = np.abs(x) @ np.abs(nib.reshape(-1, blk, n)
                                     * sc[:, None, :]).reshape(k, n)
            ref = x @ w_codec
            bound = (2.0 ** -8 * (nsc + np.abs(xsum) @ np.abs(fold))
                     + 2.0 ** -7 * nsc + _bf16_step(ref))
            assert np.all(np.abs(got - ref) <= bound), (fmt, m)
            assert not np.array_equal(got, tds.i4x8_matmul_plain(xb, qt)
                                      .numpy())


def _interpreter_product(x, w):
    """i4_bf16_matmul_plain's formula in the interpreter's arithmetic:
    bf16(n) * bf16(sc) kept in float32 (ROADMAP C3)."""
    blk = int(w.storage_k // w.scale.shape[0])
    k_s, n = w.storage_k, int(w.shape[-1])
    x = torch.nn.functional.pad(x, (0, k_s - x.shape[-1])).float()
    xsum = x.reshape(x.shape[0], -1, blk).sum(-1).to(torch.bfloat16).float()
    sc = w.scale.float()
    fold = (sc * 8.0 + w.base.float()).to(torch.bfloat16).float()
    q = codec_torch.i4_nibbles(w.planes["data_i4p"]).float()
    wq = q.reshape(-1, blk, n) * sc.to(torch.bfloat16).float()[:, None, :]
    return xsum @ fold + x @ wq.reshape(k_s, n)


def check_step_against_jax(monkeypatch, models, runs):
    """The plain step in mode (b') against JAX fused_decode_step(
    interpret=True) under INFERFLOW_I4_DOT=bf16 on `models`, for each
    (lengths, seed) of `runs`, with its product as shipped (C3_STEP_TOL)
    and in the interpreter's arithmetic (EXACT_TOL), on the hidden state
    and on the appended K/V rows."""
    monkeypatch.setenv("INFERFLOW_I4_DOT", "bf16")
    rows_j = _grab_rows(jkv, monkeypatch)
    rows_t = _grab_rows(tds, monkeypatch)
    shipped = tds.i4_bf16_matmul_plain
    spec_j, params_j, spec_t, params_t = models
    hp = spec_t.hyper_params
    for grp, name in (("attn", "qkv"), ("ffn", "w2")):
        w_j = jax.tree_util.tree_map(lambda a: a[0],
                                     params_j["layers"][grp][name])
        assert jds._mm_cfg(name, w_j).i4x8 is False
        assert tds._mm_mode(params_t["layers"][0][grp][name]) == "i4bf16"

    @jax.jit
    def step_j(layers, x, pos, cache):
        out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                    interpret=True)
        return out, rows_j["k"], rows_j["v"]

    for lengths, seed in runs:
        b = len(lengths)
        tokens = np.random.default_rng(seed).integers(
            0, hp.vocab_size, (b, 1)).astype(np.int32)
        pos = np.asarray(lengths, np.int32)[:, None]
        jc, _ = _caches(spec_j, spec_t, lengths, seed)
        assert jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
        xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                               jnp.asarray(pos))
        xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                               torch.from_numpy(pos))
        (ref, _), kj, vj = step_j(params_j["layers"], xj, jnp.asarray(pos),
                                  jc)
        ref = np.asarray(ref, np.float32)
        for product, tol in ((shipped, C3_STEP_TOL),
                             (_interpreter_product, EXACT_TOL)):
            monkeypatch.setattr(tds, "i4_bf16_matmul_plain", product)
            _, tc = _caches(spec_j, spec_t, lengths, seed)
            assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
            got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                            torch.from_numpy(pos), tc)
            assert got.shape == ref.shape == (b, 1, hp.embd_dims)
            assert np.abs(got.float().numpy() - ref).max() <= tol, (b, tol)
            for name, r in (("k", kj), ("v", vj)):
                assert np.abs(rows_t[name].numpy()
                              - np.asarray(r)).max() <= tol, (b, name, tol)
        monkeypatch.setattr(tds, "i4_bf16_matmul_plain", shipped)


def test_fused_step_bf16_matches_jax(llama, monkeypatch):
    """The plain step in mode (b') on Q4_B64T1, two test-llama layers, B =
    4 (one slot inactive, one at the last cache row), against JAX
    fused_decode_step(interpret=True) under INFERFLOW_I4_DOT=bf16
    (check_step_against_jax; the 32-row formats:
    tests/test_torch_i4_bf16_formats.py)."""
    check_step_against_jax(monkeypatch, llama, (([200, 0, 511, 17], 5),))


def test_f32_formats_step_follows_the_codec(monkeypatch):
    """Q4_B32T2 and Q4_B16 (f32 metadata, ROADMAP C7): the plain (b') step
    on one narrow layer, B = 4, against the same step whose i4 products are
    x @ the codec's float32 weights."""
    monkeypatch.setenv("INFERFLOW_I4_DOT", "bf16")
    real = tds._product_f32

    def codec_product(x, w):
        if "data_i4p" not in getattr(w, "planes", {}):
            return real(x, w)
        wf = codec_torch.dequantize(w, torch.float32)
        xf = torch.nn.functional.pad(x, (0, wf.shape[0] - x.shape[-1]))
        return xf.float() @ wf

    for fmt in ("Q4_B32T2", "Q4_B16"):
        spec = tzoo.make_spec("test-llama", device_layout="i4", **NARROW)
        params = tzoo.make_synthetic_params(spec, fmt, seed=7, device="cpu",
                                            device_layout="i4")
        hp = spec.hyper_params
        assert params["layers"][0]["attn"]["qkv"].scale.dtype == torch.float32
        lengths = [200, 0, 300, 17]
        pos = torch.tensor(lengths, dtype=torch.int32)[:, None]
        tokens = torch.randint(0, hp.vocab_size, (4, 1),
                               generator=torch.Generator().manual_seed(8))
        x = tdec.embed_tokens(spec, params, tokens, pos)
        outs = []
        for product in (real, codec_product):
            monkeypatch.setattr(tds, "_product_f32", product)
            cache = _port_cache(spec, lengths)
            out, _ = tds.fused_decode_step(spec, params["layers"], x, pos,
                                           cache)
            outs.append(out.float())
        monkeypatch.setattr(tds, "_product_f32", real)
        assert (outs[0] - outs[1]).abs().max().item() <= CODEC_STEP_TOL, fmt


def _port_cache(spec, lengths):
    """A port Q8 cache of 512 rows with seeded rows and the given lengths."""
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    hp = spec.hyper_params
    b = len(lengths)
    cache = KVCache.create(hp.decoder_layers, b, 512, hp.kv_heads,
                           hp.head_dim, quantized=True, device="cpu")
    gen = torch.Generator().manual_seed(9)
    for layer in range(hp.decoder_layers):
        k, v = (torch.randn((b, max(lengths), hp.kv_heads, hp.head_dim),
                            generator=gen) for _ in range(2))
        cache.update_layer(layer, k, v, torch.zeros(b, dtype=torch.int32))
    return cache.with_length(torch.tensor(lengths, dtype=torch.int32))


def test_routing_follows_the_switch(llama, monkeypatch):
    """_mm_mode picks i4x8 exactly when JAX's _mm_cfg does (unset or
    ``i8``) and (b') for any other value, read at each call; the step's
    pointer table holds the mode and its cache serves no table built in
    the other mode; the plain product follows the switch."""
    monkeypatch.setattr(tds._build, "check_operand", lambda *a, **k: None)
    spec_j, params_j, spec_t, params_t = llama
    w_t = params_t["layers"][0]["attn"]["wo"]
    w_j = jax.tree_util.tree_map(lambda a: a[0],
                                 params_j["layers"]["attn"]["wo"])
    x = torch.randn((2, int(w_t.shape[0]))).to(torch.bfloat16)
    modes = set()
    for value, want in ((None, "i4"), ("i8", "i4"), ("bf16", "i4bf16"),
                        ("f32", "i4bf16"), ("", "i4bf16")):
        if value is None:
            monkeypatch.delenv("INFERFLOW_I4_DOT", raising=False)
        else:
            monkeypatch.setenv("INFERFLOW_I4_DOT", value)
        assert tds.i4_dot_mode() == tds._mm_mode(w_t) == want, value
        assert jds._mm_cfg("wo", w_j).i4x8 is (want == "i4"), value
        plain = (tds.i4x8_matmul_plain if want == "i4"
                 else tds.i4_bf16_matmul_plain)
        assert torch.equal(tds._product_f32(x, w_t), plain(x, w_t))
        cache = _port_cache(spec_t, [5])
        assert tds.fused_step_preferred(spec_t, params_t["layers"], cache, 1)
        # the step's pointer table holds the mode's csrc WeightMode, and a
        # table built in the other mode is not served
        hp = spec_t.hyper_params
        table = tds._layer_table(
            params_t["layers"], hp.embd_dims,
            hp.decoder_heads * hp.head_dim,
            (hp.decoder_heads + 2 * hp.kv_heads) * hp.head_dim,
            hp.decoder_intermediate_size)
        assert table[0][2] == (1 if want == "i4" else 7)
        modes.add(tds._TABLES[id(params_t["layers"])][0])
    assert modes == {"i4", "i4bf16"}
    assert tds._I4BF16_MODES[(32, torch.float16)][1] == \
        "fused_decode_step_i4bf16_b32"


def test_engine_i4_bf16_matches_jax(llama, monkeypatch):
    """Both engines serve two test-llama layers (Q4_B64T1, i4 layout) at 4
    slots under INFERFLOW_I4_DOT=bf16: every decode step the fused step in
    mode (b'); one prompt takes three 32-token chunks while the other
    decodes."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setenv("INFERFLOW_I4_DOT", "bf16")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    spec_j, params_j, spec_t, params_t = llama
    calls = {"fused": 0, "bf16": 0}
    real_fused, real_bf16 = tdec.fused_decode_step, tds.i4_bf16_matmul_plain
    monkeypatch.setattr(tdec, "fused_decode_step", lambda *a, **k: (
        calls.__setitem__("fused", calls["fused"] + 1) or real_fused(*a, **k)))
    monkeypatch.setattr(tds, "i4_bf16_matmul_plain", lambda *a, **k: (
        calls.__setitem__("bf16", calls["bf16"] + 1) or real_bf16(*a, **k)))
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 70)])
    try:
        je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                     max_context_len=512, kv_cache_quantized=True)
        te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                     max_context_len=512, kv_cache_quantized=True,
                     device="cpu")
        je.prefill_chunk = te.prefill_chunk = 32
        jr, tr = _record_rows(je), _record_rows(te)
        ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                           steps_before_second=1)
        assert jds.mega_disabled() is None
    finally:
        jds.enable_mega()
    layers = spec_t.hyper_params.decoder_layers
    assert calls["fused"] >= 8  # every decode step took the fused step
    assert calls["bf16"] == 4 * layers * calls["fused"]  # in mode (b')
    for q in (1, 2):
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break
        assert len(got[q]) == len(ref[q])
