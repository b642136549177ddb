"""Port codec (inferflow_tpu_torch.quant.codec_torch) against the JAX codec.

Inputs come from a numpy seed and go to both packages; quantize must give
the same bytes, dequantize the same values (both round once from float32),
and the KV codec the same codes and scales.  Tolerance: exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from inferflow_tpu.quant import codec_jax
from inferflow_tpu_torch.quant import codec_torch

# wire-plane formats (Q3H has its own file)
PORTED = ["Q4_B64T1", "Q8_B32T1", "Q8_B32T2", "Q6_B64T1", "Q5_B64T1",
          "Q5_B32T1", "Q4_B32T1A", "Q4_B32T1B", "Q4_B32T2", "Q4_B16",
          "Q3_B32T1A", "Q2_B32T1B"]


def _weights(seed, k=256, n=96):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column: the zero-scale branch
    return w


def test_quantize_bytes_match_jax():
    w = _weights(1)
    for fmt in PORTED:
        ref = codec_jax.quantize(jnp.asarray(w), fmt).to_np()
        got = codec_torch.quantize(torch.from_numpy(w), fmt).to_np()
        assert sorted(got["planes"]) == sorted(ref["planes"]), fmt
        for name, plane in ref["planes"].items():
            np.testing.assert_array_equal(got["planes"][name], plane,
                                          err_msg=f"{fmt} {name}")
        np.testing.assert_array_equal(got["scale"], np.asarray(ref["scale"]),
                                      err_msg=fmt)
        if ref["base"] is None:
            assert got["base"] is None, fmt
        else:
            np.testing.assert_array_equal(got["base"],
                                          np.asarray(ref["base"]),
                                          err_msg=fmt)


def test_dequantize_matches_jax():
    w = _weights(2)
    for fmt in ("Q4_B64T1", "Q8_B32T2", "Q6_B64T1"):
        qt_j = codec_jax.quantize(jnp.asarray(w), fmt)
        ref = np.asarray(codec_jax.dequantize(qt_j, jnp.float32))
        qt_t = codec_torch.QuantizedTensor.from_np(qt_j.to_np(),
                                                     device="cpu")
        got = codec_torch.dequantize(qt_t, torch.float32).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=fmt)
        ref16 = np.asarray(codec_jax.dequantize(qt_j, jnp.bfloat16),
                           np.float32)
        got16 = codec_torch.dequantize(qt_t).float().numpy()
        np.testing.assert_array_equal(got16, ref16, err_msg=fmt)


def test_dequantize_padded_storage_k():
    """Stored K beyond the logical K (zero-scale pad blocks) is cut off."""
    w = _weights(3, k=192)
    qt = codec_torch.quantize(torch.from_numpy(w), "Q4_B64T1")
    pad = 64
    planes = {"data": torch.cat([qt.planes["data"],
                                 torch.zeros((pad // 2, 96), dtype=torch.uint8)])}
    zeros = torch.zeros((1, 96), dtype=torch.float16)
    padded = codec_torch.QuantizedTensor(
        "Q4_B64T1", (192, 96), planes, torch.cat([qt.scale, zeros]),
        torch.cat([qt.base, zeros]))
    assert padded.storage_k == 256
    np.testing.assert_array_equal(codec_torch.dequantize(padded).float(),
                                  codec_torch.dequantize(qt).float())


@pytest.mark.parametrize("block", [32, 16])
def test_q8_sym_matches_jax(block):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 2, 64)).astype(np.float32)
    x[0, 0, 0, :block] = 0.0  # zero block
    codes_j, scale_j = codec_jax.quantize_q8_sym(jnp.asarray(x), block)
    codes_t, scale_t = codec_torch.quantize_q8_sym(torch.from_numpy(x),
                                                   block)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))
    deq_j = codec_jax.dequantize_q8_sym(codes_j, scale_j, block)
    deq_t = codec_torch.dequantize_q8_sym(codes_t, scale_t, block)
    np.testing.assert_array_equal(deq_t.float().numpy(),
                                  np.asarray(deq_j, np.float32))


def test_unported_formats_raise():
    """No block format is refused any more: the split-nibble Q5_B32T1
    quantizes to its 4-bit low plane (two K rows per byte) and 1-bit high
    plane, and Q3H to its pair8 plane."""
    w = torch.from_numpy(_weights(5))
    qt = codec_torch.quantize(w, "Q5_B32T1")
    assert {k: tuple(v.shape) for k, v in qt.planes.items()} == {
        "data": (w.shape[0] // 2, w.shape[1]),
        "data_h": (w.shape[0] // 8, w.shape[1])}
    qt = codec_torch.quantize(w, "Q3H_B64T1")
    assert set(qt.planes) == {"pair8"}
    assert tuple(qt.planes["pair8"].shape) == (w.shape[0] // 2, w.shape[1])
