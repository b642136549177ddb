"""The i4 layout on the 4-bit formats beside Q4_B64T1, on the CPU: kernels
B5 and B4 (b)'s plain versions on Q4_B32T1A, Q4_B32T1B, Q4_B32T2 and
Q4_B16, and an i4 engine on Q4_B16.

Q4_B32T1A/B carry f16 block metadata and follow the TPU kernels: B5's
plain version against ``quantized_matmul_interpret`` here, B4 (b)'s plain
step against ``fused_decode_step(interpret=True)`` in
tests/test_torch_i4_step_formats.py.  Q4_B32T2 and Q4_B16 carry
f32 metadata, which the TPU kernels decode as f16 bits (ROADMAP C7): the
port follows the codec there, and is held against products with
``codec_torch.dequantize``'s weights and the JAX codec's ``dequantize``.

Tolerances:
  - B5 against the interpreter (f16 formats): one bf16 step of each
    output (the same bf16 weights, n*sc + (8*sc + base); float32 sums in
    another order);
  - B5 against the codec's weights (every format): 2^-8 * (|x| @ |w|) plus
    one bf16 step of the output: each of B5's weights is the codec's or
    one bf16 ulp (2^-8 relative) from it, since B5 rounds n*sc + fold
    where the codec rounds (n + 8)*sc + base;
  - the i4x8 product against x @ w (every format): with xs the row's
    int8 scale, 0.5 * xs * sum_k |n_k * sc| for the int8 activations,
    plus 2^-8 * sum_r |xsum_r| * |fold_r| for the bf16 block sums and
    folds, plus 2^-8 * (|x| @ |w|) and one bf16 step;
  - the Q4_B16 i4 engine against a packed engine on the same codes (B1,
    the codec's weights, bf16 activations): ENGINE_LOGIT_TOL = 5e-2, the
    int8 activations of the fused step (ROADMAP C4).
"""

import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.kernels.dequant_matmul import (pad_weight_for_tpu,
                                                  quantized_matmul_interpret)
from inferflow_tpu.quant import codec_jax
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.kernels import dequant_matmul as tdm
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts


F16_FORMATS = ("Q4_B32T1A", "Q4_B32T1B")
F32_FORMATS = ("Q4_B32T2", "Q4_B16")
ENGINE_LOGIT_TOL = 5e-2


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def _weights(fmt, k, n, seed):
    """The same (K, N) i4 weight on both sides: JAX's (padded as its zoo
    pads before it repacks) and the port's, from JAX's bytes."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * (0.5 / k ** 0.5)
    qt_j = codec_jax.repack_i4(pad_weight_for_tpu(
        codec_jax.quantize(jnp.asarray(w), fmt)))
    qt_t = codec_torch.QuantizedTensor.from_np(qt_j.to_np(), device="cpu")
    assert set(qt_t.planes) == {"data_i4p"}
    return qt_j, qt_t


def test_repack_and_codec_match_jax():
    """The four formats' i4 bytes and dequantized values equal JAX's, their
    metadata keep the format's type (f32 for Q4_B32T2 and Q4_B16), and the
    port's own repack of its own quantize gives the same bytes."""
    rng = np.random.default_rng(0)
    for fmt in F16_FORMATS + F32_FORMATS:
        w = rng.standard_normal((512, 96)).astype(np.float32) * 0.05
        ref = codec_jax.repack_i4(codec_jax.quantize(jnp.asarray(w), fmt))
        got = codec_torch.repack_i4(codec_torch.quantize(
            torch.from_numpy(w), fmt))
        meta = torch.float32 if fmt in F32_FORMATS else torch.float16
        assert got.scale.dtype == got.base.dtype == meta
        np.testing.assert_array_equal(got.planes["data_i4p"].numpy(),
                                      np.asarray(ref.planes["data_i4p"]))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(ref.scale))
        np.testing.assert_array_equal(
            codec_torch.dequantize(got, torch.float32).numpy(),
            np.asarray(codec_jax.dequantize(ref, jnp.float32)))


def test_b5_plain_on_four_formats():
    """B5's plain version (and quantized_matmul on CPU tensors): f16
    formats against the interpreter, every format against the codec's
    weights (the port's and JAX's dequantize); M in {1, 5, 12}; a second
    shape for Q4_B32T1A."""
    rng = np.random.default_rng(1)
    for i, fmt in enumerate(F16_FORMATS + F32_FORMATS):
        for k, n in ((256, 128), (512, 256))[:2 if i == 0 else 1]:
            qt_j, qt_t = _weights(fmt, k, n, 10 * i + k)
            w_t = codec_torch.dequantize(qt_t, torch.bfloat16).float().numpy()
            w_j = np.asarray(codec_jax.dequantize(qt_j, jnp.bfloat16),
                             np.float32)
            for m in (1, 5, 12):
                x = rng.standard_normal((m, k)).astype(np.float32)
                xb = torch.from_numpy(x).to(torch.bfloat16)
                got = tdm.quantized_matmul(xb, qt_t).float().numpy()
                assert np.array_equal(
                    got, tdm.i4_matmul_plain(xb, qt_t).float().numpy())
                xf = xb.float().numpy()
                for w in (w_t, w_j):
                    ref = xf @ w
                    bound = (2.0 ** -8 * (np.abs(xf) @ np.abs(w))
                             + _bf16_step(ref))
                    assert np.all(np.abs(got - ref) <= bound), (fmt, k, m)
                if fmt in F16_FORMATS:
                    ref = np.asarray(quantized_matmul_interpret(
                        jnp.asarray(x).astype(jnp.bfloat16), qt_j),
                        np.float32)
                    assert np.all(np.abs(got - ref) <= _bf16_step(ref)), (
                        fmt, k, m)


def test_i4x8_plain_follows_the_codec():
    """B4 (b)'s product on every format against x @ the codec's weights,
    within the int8-activation bound of the module docstring."""
    rng = np.random.default_rng(2)
    for i, fmt in enumerate(F16_FORMATS + F32_FORMATS):
        blk = {"Q4_B16": 16}.get(fmt, 32)
        qt_j, qt_t = _weights(fmt, 512, 128, 20 + i)
        w = codec_torch.dequantize(qt_t, torch.float32).numpy()
        for m in (1, 3, 8):
            xb = torch.from_numpy(rng.standard_normal((m, 512)).astype(
                np.float32)).to(torch.bfloat16)
            got = tds.i4x8_matmul_plain(xb, qt_t).numpy()
            x = xb.float().numpy()
            ref = x @ w
            _, xs = codec_torch.int8_rowwise_activations(xb)
            sc = qt_t.scale.float().numpy()
            n = codec_torch.i4_nibbles(qt_t.planes["data_i4p"]).float()
            nsc = np.abs(n.numpy().reshape(-1, blk, 128) * sc[:, None, :])
            fold = np.abs(8 * sc + qt_t.base.float().numpy())
            xsum = np.abs(x.reshape(m, -1, blk).sum(-1))
            bound = (0.5 * xs.numpy() * nsc.sum(axis=(0, 1))[None, :]
                     + 2.0 ** -8 * (xsum @ fold)
                     + 2.0 ** -8 * (np.abs(x) @ np.abs(w))
                     + _bf16_step(ref))
            assert np.all(np.abs(got - ref) <= bound), (fmt, m)


def test_engine_q4_b16_i4_against_packed():
    """test-llama from Q4_B16 served in the i4 layout (4 slots: every
    decode step B4 (b) on 16-row f32-metadata blocks) and in the packed
    layout (the same codes as wire planes: B1 and B2, the codec's
    weights), fed the same tokens: every sampled row within
    ENGINE_LOGIT_TOL."""
    spec_i = tzoo.make_spec("test-llama", device_layout="i4")
    params_i = tzoo.make_synthetic_params(spec_i, "Q4_B16", seed=5,
                                          device="cpu", device_layout="i4")
    spec_p = tzoo.make_spec("test-llama", device_layout="packed")
    params_p = tzoo.make_synthetic_params(spec_p, "Q4_B16", seed=5,
                                          device="cpu",
                                          device_layout="packed")
    w_i, w_p = params_i["layers"][0]["ffn"]["w2"], params_p["layers"][0][
        "ffn"]["w2"]
    assert w_i.scale.dtype == torch.float32 and set(w_p.planes) == {"data"}
    assert torch.equal(w_i.planes["data_i4p"], w_p.planes["data"] ^ 0x88)
    calls = {"fused": 0}
    real = tdec.fused_decode_step

    def counting(*a, **k):
        calls["fused"] += 1
        return real(*a, **k)

    prompt = list(np.arange(5, 45) % spec_i.hyper_params.vocab_size)
    rows = []
    forced = None
    for spec, params in ((spec_i, params_i), (spec_p, params_p)):
        eng = TEngine(spec, params, max_concurrent_queries=4,
                      max_context_len=128, kv_cache_quantized=True,
                      device="cpu")
        seen = []
        choose = eng.strategies.choose_token

        def record(q, r, p=(), c=choose, seen=seen):
            seen.append(np.asarray(r, np.float32).copy())
            return forced[len(seen) - 1] if forced else c(q, r, p)

        eng.strategies.choose_token = record
        tdec.fused_decode_step = counting
        try:
            out = eng.generate(prompt, TOpts(strategy="greedy"), 8)
        finally:
            tdec.fused_decode_step = real
        forced = forced or out
        rows.append(seen)
    assert calls["fused"] == 7  # the i4 engine's decode steps only
    assert len(rows[0]) == len(rows[1]) == 8
    for a, b in zip(*rows):
        assert np.abs(a - b).max() <= ENGINE_LOGIT_TOL
