"""Kernel B6's wire mode (Q3H in its three wire planes) and its non-pair
branch (the format-generic function) against the JAX package, on the CPU,
and the table that sends both to B1's compiled entries on the card.

Q3H's wire planes reach the port through ``QuantizedTensor.from_np(...,
fast_layout=False)`` (and ``pair8_to_wire``), as the JAX package's
``from_np(..., fast_layout=False)``; ``quantized_matmul`` routes them to
B6's wire mode.  The non-pair branch is ``dequant_matmul.generic_matmul``,
which only the kernel bench calls.  The JAX Pallas kernels run in
interpret mode: the wire mode through ``quantized_matmul_interpret``, the
non-pair branch through the JAX ``_pallas_matmul`` itself (unjitted) with
``_fast_eligible`` patched to refuse every format, so that its own specs
send the format to ``_make_kernel``'s non-pair function.

Tolerances:
  - codec: exact (the wire bytes, from_np both ways, dequantize's values);
  - products: the port computes each weight as the codec does, bf16(q *
    scale (+ base)) in float32, as the JAX kernel's non-pair and wire
    functions do; sums run in another order and the interpreter upcasts
    its bf16 dots: within 2^-7 * (|x| @ (|q*scale| + |base|)) plus one
    bf16 step of the output, the bound of tests/test_torch_subbyte.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import dequant_matmul as jdm
from inferflow_tpu.quant import codec_jax
from inferflow_tpu.quant import codec_np as jcodec_np
from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels import dequant_matmul as tdm
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.quant.formats import FORMATS, get_format

Q3H = "Q3H_B64T1"
WIRE = {"data", "data_m", "data_h"}
NONPAIR = ("Q4_B64T1", "Q6_B64T1", "Q5_B32T1", "Q8_B32T2", "Q4_B16")


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)


def _magnitude(qt: codec_torch.QuantizedTensor) -> np.ndarray:
    """(K, N) |q*scale| + |base| of the codec's weights, float64."""
    fmt = get_format(qt.format)
    k_s, n = qt.storage_k, int(qt.shape[-1])
    if fmt.pair_base11:
        q = codec_torch.pair8_values(
            codec_torch._codes(qt.planes, fmt).to(torch.uint8)).double()
    else:
        q = codec_torch._codes(qt.planes, fmt).double()
        if fmt.signed:
            q = torch.where(q >= 128, q - 256, q)
    sc = qt.scale.double().repeat_interleave(fmt.block, 0)
    mag = (q * sc).abs()
    if qt.base is not None:
        mag = mag + qt.base.double().repeat_interleave(fmt.block, 0).abs()
    return mag.reshape(k_s, n)[:int(qt.shape[-2])].numpy()


def _assert_close(got: torch.Tensor, ref: np.ndarray, x: torch.Tensor,
                  qt) -> None:
    tol = 2.0 ** -7 * (np.abs(x.float().numpy()) @ _magnitude(qt)) \
        + _bf16_step(ref)
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def _pad_k(planes: dict, scale, base, blocks: int, codes_per_block: int,
           fmt) -> tuple:
    """Numpy planes and metadata with `blocks` zero quant blocks appended
    (zero scale and base: the pad blocks add exact zeros)."""
    out = {}
    for p in fmt.planes:
        rows = blocks * codes_per_block * p.bits // 8
        a = planes[p.name]
        out[p.name] = np.concatenate([a, np.zeros((rows, a.shape[1]),
                                                  a.dtype)])

    def pad(m):
        return None if m is None else np.concatenate(
            [m, np.zeros((blocks, m.shape[1]), m.dtype)])
    return out, pad(scale), pad(base)


def test_wire_codec_matches_jax():
    """from_np(..., fast_layout=False) keeps the JAX wire bytes; from_np's
    default gives pair8, pair8_to_wire rebuilds the same three planes, and
    dequantize of the wire planes equals the JAX codec's."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    wire = jcodec_np.quantize_np(w, Q3H)
    assert set(wire["planes"]) == WIRE
    qj = codec_jax.QuantizedTensor.from_np(wire, fast_layout=False)
    qt = codec_torch.QuantizedTensor.from_np(wire, device="cpu",
                                             fast_layout=False)
    assert set(qt.planes) == set(qj.planes) == WIRE
    for name in WIRE:
        np.testing.assert_array_equal(qt.planes[name].numpy(),
                                      np.asarray(qj.planes[name]))
    pair = codec_torch.QuantizedTensor.from_np(wire, device="cpu")
    assert set(pair.planes) == {codec_torch.PAIR8_PLANE}
    rebuilt = codec_torch.pair8_to_wire(pair)
    for name in WIRE:
        np.testing.assert_array_equal(rebuilt.planes[name].numpy(),
                                      wire["planes"][name])
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(codec_jax.dequantize(qj, dt_j), np.float32)
        for src in (qt, pair):
            np.testing.assert_array_equal(
                codec_torch.dequantize(src, dt_t).float().numpy(), ref)


def test_wire_plain_matches_interpret():
    """B6's wire-mode plain version (quantized_matmul on the CPU) against
    the JAX kernel's wire mode, quantized_matmul_interpret on
    from_np(wire, fast_layout=False), at M = 1, 3 and 20, and on the same
    weight stored K-padded by two zero blocks."""
    rng = np.random.default_rng(1)
    k, n = 512, 256
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    wire = jcodec_np.quantize_np(w, Q3H)
    planes, scale, base = _pad_k(wire["planes"], wire["scale"],
                                 wire["base"], 2, 32, get_format(Q3H))
    padded = dict(wire, planes=planes, scale=scale, base=base)
    for src in (wire, padded):
        qj = codec_jax.QuantizedTensor.from_np(src, fast_layout=False)
        qt = codec_torch.QuantizedTensor.from_np(src, device="cpu",
                                                 fast_layout=False)
        assert set(qt.planes) == WIRE
        for m in (1, 3, 20):
            x = rng.standard_normal((m, k)).astype(np.float32)
            xt = torch.from_numpy(x).to(torch.bfloat16)
            ref = np.asarray(jdm.quantized_matmul_interpret(
                jnp.asarray(x).astype(jnp.bfloat16), qj), np.float32)
            _assert_close(tdm.quantized_matmul(xt, qt), ref, xt, qt)


def test_nonpair_plain_matches_jax_kernel(monkeypatch):
    """B6's non-pair plain version (generic_matmul on the CPU) against the
    JAX `_make_kernel` non-pair function, run through the JAX
    `_pallas_matmul` in interpret mode with its fast-path rule refusing
    every format: a 64-row block, two planes, the split-half nibble plane,
    signed codes without a base, f32 metadata in 16-row blocks."""
    monkeypatch.setattr(jdm, "_fast_eligible", lambda fmt: False)
    rng = np.random.default_rng(2)
    k, n = 256, 128
    for fmt in NONPAIR:
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
        qj = codec_jax.quantize(jnp.asarray(w), fmt)
        qt = codec_torch.QuantizedTensor.from_np(qj.to_np(), device="cpu")
        names = sorted(qj.planes)
        for m in (2, 17):
            x = rng.standard_normal((m, k)).astype(np.float32)
            xt = torch.from_numpy(x).to(torch.bfloat16)
            ref = np.asarray(jdm._pallas_matmul.__wrapped__(
                jnp.asarray(x).astype(jnp.bfloat16),
                tuple(qj.planes[nm] for nm in names), qj.scale, qj.base,
                fmt_name=fmt, k=k, n=n, plane_names=tuple(names),
                interpret=True), np.float32)
            got = tdm.generic_matmul(xt, qt)
            _assert_close(got, ref, xt, qt)
            # the codec's weights: the same products as B1's plain version
            torch.testing.assert_close(got, tdm.quantized_matmul(xt, qt),
                                       rtol=0, atol=0)


def test_generic_entry_refuses_pairs_and_other_devices():
    """generic_matmul takes no pair format (Q3H goes through
    quantized_matmul) and no tensor off the CPU and the card."""
    w = torch.randn(128, 64) * 0.05
    with pytest.raises(ValueError, match="pair format"):
        tdm.generic_matmul(torch.zeros((1, 128)),
                           codec_torch.quantize(w, Q3H))
    qt = codec_torch.quantize(w, "Q6_B64T1")
    with pytest.raises(ValueError, match="unsupported device"):
        tdm.generic_matmul(torch.empty((2, 128), device="meta"), qt)


def test_generic_and_wire_modes_map_to_compiled_entries():
    """On the card, B6's non-pair branch launches the B1 entry of each
    format: every non-pair block format of quant/formats maps
    (generic_entry) to an entry that its source compiles with
    IFT_MATMUL_ENTRY; Q3H, a pair format, has none and is refused by
    name.  Q3H's three wire planes map to ift_q3h_wire_matmul, compiled
    with IFT_MATMUL_ENTRY3 on the Q3HWire policy; no source of its own
    remains."""
    csrc = Path(tdm.__file__).parent / "csrc"
    text = {src: (csrc / f"{src}.cu").read_text() for src in _build.SOURCES}
    nonpair = [name for name, fmt in FORMATS.items() if not fmt.pair_base11]
    assert len(nonpair) == 14
    for name in nonpair:
        source, entry = tdm.generic_entry(name)
        assert re.search(rf"IFT_MATMUL_ENTRY\({entry}, \w+\)",
                         text[source]), (name, source, entry)
    with pytest.raises(NotImplementedError, match=Q3H):
        tdm.generic_entry(Q3H)
    wire = codec_torch.pair8_to_wire(
        codec_torch.quantize(torch.randn(128, 64) * 0.05, Q3H))
    assert set(wire.planes) == WIRE
    assert tdm.kernel_name(wire) == tdm.Q3H_WIRE_KERNEL
    _, source, entry = tdm._KERNELS["data", Q3H]
    assert entry == "ift_q3h_wire_matmul"
    assert re.search(r"IFT_MATMUL_ENTRY3\(ift_q3h_wire_matmul, Q3HWire\)",
                     text[source])
    assert not (csrc / "generic_matmul.cu").exists()
