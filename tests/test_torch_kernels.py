"""Plain versions of the port's kernels against the JAX package's kernels.

The JAX kernels run as the JAX suite runs them on the CPU: Pallas in
interpret mode (``quantized_matmul_interpret``, ``decode_attention`` and
``chunk_attention`` with ``interpret=True``), plus the XLA dequantize +
matmul for B1.  Inputs come from a numpy seed and go to both packages.

Tolerances, each against its oracle:
  - B1 vs XLA dequantize + matmul: the same bf16-rounded weights (rounded
    once from float32) and float32 sums; only the summation order differs,
    so |diff| <= 8e-3 * max|ref| (two bf16 ulps at the largest output).
  - B1 vs the Pallas fast kernel: that kernel forms each weight in bf16
    arithmetic (bf16 scale and base, rounded product and sum), so weights
    differ by a few bf16 ulps: |diff| <= 3e-2 * max|ref|.
  - B2/B3: both dequantize K/V exactly in float32 and run the softmax in
    float32; outputs are bf16: |diff| <= 8e-3 * max|ref|.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from inferflow_tpu.kernels import attention as jattn
from inferflow_tpu.kernels.dequant_matmul import quantized_matmul_interpret
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu_torch.kernels import attention as tattn
from inferflow_tpu_torch.kernels.dequant_matmul import quantized_matmul
from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache


def _t(a):
    """numpy/jax (incl. bf16) -> torch on the CPU."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_close(got, ref, rel):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + 1e-6, (err, np.abs(ref).max())


@pytest.mark.parametrize("k", [512, 1024])
def test_dequant_matmul_plain_matches_jax(k):
    n = 256
    for m in (1, 4, 16):
        rng = np.random.default_rng(m * 31 + k)
        w = rng.standard_normal((k, n)).astype(np.float32) * (0.5 / np.sqrt(k))
        x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
        qt_j = codec_jax.quantize(jnp.asarray(w), "Q4_B64T1")
        got = quantized_matmul(_t(x), QuantizedTensor.from_np(qt_j.to_np(),
                                                              device="cpu"))
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        got = got.float().numpy()

        wd = codec_jax.dequantize(qt_j, jnp.bfloat16).astype(jnp.float32)
        xla = jnp.matmul(x.astype(jnp.float32), wd).astype(jnp.bfloat16)
        _assert_close(got, xla, 8e-3)
        _assert_close(got, quantized_matmul_interpret(x, qt_j), 3e-2)


def _fill_both(rng, layers, b, s, h, d, quantized):
    """The same random rows written into both packages' caches."""
    jc = JKVCache.create(layers, b, s, h, d, quantized=quantized)
    tc = TKVCache.create(layers, b, s, h, d, quantized=quantized,
                         device="cpu")
    zeros = np.zeros((b,), np.int32)
    for layer in range(layers):
        k = rng.standard_normal((b, s, h, d)).astype(np.float32)
        v = rng.standard_normal((b, s, h, d)).astype(np.float32)
        jc = jc.update_layer(layer, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(zeros))
        tc.update_layer(layer, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(zeros))
    for layer in range(layers):
        for a, b_ in zip(tc.read_layer(layer, torch.float32),
                         jc.read_layer(layer, jnp.float32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    return jc, tc


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_plain_matches_jax(quantized):
    for g in (1, 2):
        rng = np.random.default_rng(10 + g)
        layers, b, h, s, d = 3, 2, 2, 1024, 64
        jc, tc = _fill_both(rng, layers, b, s, h, d, quantized)
        q = jnp.asarray(rng.standard_normal((b, 1, h * g, d)) * 0.3,
                        jnp.bfloat16)
        lengths = np.asarray([5, 700], np.int32)
        ref, _ = jattn.decode_attention(q, jc, layers - 1,
                                        jnp.asarray(lengths), kq_scale=1.25,
                                        interpret=True)
        got, _ = tattn.decode_attention(_t(q), tc, layers - 1,
                                        torch.from_numpy(lengths),
                                        kq_scale=1.25)
        assert got.shape == (b, 1, h * g, d) and got.dtype == torch.bfloat16
        _assert_close(got.float().numpy(), ref, 8e-3)


def test_chunk_attention_plain_matches_jax():
    for quantized in (False, True):
        for g in (1, 2):
            rng = np.random.default_rng(20 + g)
            layers, b, h, s, d, c = 2, 3, 2, 512, 64, 32
            slot, start = 1, 64
            jc, tc = _fill_both(rng, layers, b, s, h, d, quantized)
            q = jnp.asarray(rng.standard_normal((1, c, h * g, d)) * 0.3,
                            jnp.bfloat16)
            ref, _ = jattn.chunk_attention(q, jc, 1, slot, start,
                                           kq_scale=0.9, interpret=True)
            got, _ = tattn.chunk_attention(_t(q), tc, 1, slot, start,
                                           kq_scale=0.9)
            assert (got.shape == (1, c, h * g, d)
                    and got.dtype == torch.bfloat16)
            _assert_close(got.float().numpy(), ref, 8e-3)


def test_kv_cache_update_slot_and_decode_rows_match_jax():
    """update_layer_slot (a chunk) and one-row update_layer writes at
    per-slot offsets leave both caches equal through read_layer."""
    rng = np.random.default_rng(30)
    layers, b, h, s, d = 2, 3, 2, 128, 32
    jc, tc = _fill_both(rng, layers, b, s, h, d, True)
    k = rng.standard_normal((1, 16, h, d)).astype(np.float32)
    v = rng.standard_normal((1, 16, h, d)).astype(np.float32)
    jc = jc.update_layer_slot(1, 2, jnp.asarray(k), jnp.asarray(v), 32)
    tc.update_layer_slot(1, 2, torch.from_numpy(k), torch.from_numpy(v), 32)
    k1 = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    v1 = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    start = np.asarray([0, 77, 127], np.int32)
    jc = jc.update_layer(0, jnp.asarray(k1), jnp.asarray(v1),
                         jnp.asarray(start))
    tc.update_layer(0, torch.from_numpy(k1), torch.from_numpy(v1),
                    torch.from_numpy(start))
    for layer in range(layers):
        for a, b_ in zip(tc.read_layer(layer, torch.float32),
                         jc.read_layer(layer, jnp.float32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
