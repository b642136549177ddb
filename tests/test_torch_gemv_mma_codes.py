"""B4's pair8 GEMV (weight mode 14, Q3H_B64T1) on the tensor-core walk
(csrc/gemv_mma.cuh's `pair8_pair`, decode_step.cu's `i4bf_walk`),
emulated in numpy on the CPU, where no card runs it.

(i)  The decoder gives the plain version's weights bit for bit for all
     256 bytes over the f16 scale sweep (extremes and subnormals):
     pair8_pair's {bf16(v0 * bf16(sc)), bf16(v1 * bf16(sc))} with v1 = b
     div 11 by one multiply-high (exact for every byte, not only the codes
     0..120).
(ii) The GEMV emulated register by register (the i4 layout's map: byte
     rows t and t + 4 of each k16 step) with the fold term bf16(sum x) *
     bf16(base) forms the plain version's bf16 weights and its product
     within 1e-5 * max|plain| of pair8_matmul_plain (Q3H's codes, and
     bytes over all of 0..255), at test-llama shapes and a ragged N.

The emulation's float64 sums take another order than the plain version's
float32 ones: hence 1e-5 * max|plain|.  The plain version is held against
the JAX package in tests/test_torch_b4_pair8.py.
"""

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels.decode_step import pair8_matmul_plain
from inferflow_tpu_torch.quant.codec_torch import (PAIR8_PLANE, pair8_values,
                                                   quantize)
from inferflow_tpu_torch.quant.formats import get_format

from test_torch_gemv_mma import (SCALES_F16, G, T, bf16_round, bf16_value,
                                 bits_of, byte_perm, emulate, fma_bf16x2,
                                 halves, lane_columns, splat)

SHAPES = ((256, 384, 8), (512, 256, 3), (128, 100, 5))  # (K, N, M)


def pair8_pair(w, c, sc2):
    """gemv_mma::pair8_pair<c>: byte c of a word of pair8 codes."""
    b = byte_perm(w, np.uint32(0), 0x4440 | c)
    t = byte_perm(w, np.uint32(0x43), 0x4540 | c)  # 0x4300 | b, 0x4300
    v1 = (b.astype(np.uint64) * 0x1745D175) >> np.uint64(32)
    v = ((t.astype(np.uint64) + v1 * 0xFFF5) & 0xFFFFFFFF).astype(np.uint32)
    return fma_bf16x2(fma_bf16x2(v, 0x3F803F80, 0xC300C300), sc2, 0x80008000)


# ----------------------------------------------------------------- (i)
def test_decoder_matches_plain_weights():
    """All 256 bytes in every byte position of a word, at every f16 scale
    of the sweep, against the plain version's weight arithmetic."""
    byte = np.arange(256, dtype=np.uint32)
    v = pair8_values(torch.arange(256, dtype=torch.uint8)[:, None])
    v0, v1 = v[0::2, 0].float(), v[1::2, 0].float()
    assert torch.equal(v1.long(), torch.arange(256) // 11)
    assert ((byte.astype(np.uint64) * 0x1745D175) >> np.uint64(32)
            == byte // 11).all()
    scb = torch.from_numpy(SCALES_F16).to(torch.bfloat16).float()
    for s_i, s in enumerate(SCALES_F16.astype(np.float32)):
        sc2 = splat(s)
        for c in range(4):
            lo, hi = halves(pair8_pair(byte << np.uint32(8 * c), c, sc2))
            np.testing.assert_array_equal(
                lo, bits_of((v0 * scb[s_i]).to(torch.bfloat16)))
            np.testing.assert_array_equal(
                hi, bits_of((v1 * scb[s_i]).to(torch.bfloat16)))


# ----------------------------------------------------------------- (ii)
def _fold(qt, x, blk, pad):
    """The blocks' fold terms bf16(sum x) @ bf16(base), (8, N_pad), or None
    where the format has no base."""
    if qt.base is None:
        return None
    xsum = torch.from_numpy(x).to(torch.bfloat16).float().reshape(
        x.shape[0], -1, blk).sum(-1).numpy()
    xsum = np.pad(bf16_value(bf16_round(xsum)), ((0, 8 - x.shape[0]), (0, 0)))
    return xsum @ bf16_value(bf16_round(np.pad(qt.base.float().numpy(),
                                               ((0, 0), (0, pad)))))


def _scales(qt, blk, steps, tiles, pad):
    sc = np.pad(qt.scale.float().numpy(), ((0, 0), (0, pad)))
    cols = lane_columns(tiles)[:, None]
    return splat(sc[(np.arange(steps) * 16 // blk)[None, :, None, None], cols])


def _word_columns(tiles):
    return (np.arange(tiles)[:, None, None, None] * 32
            + 4 * G[None, None, :, None] + np.arange(4))


def emulate_pair8(qt, x):
    """The pair8 GEMV, register by register: byte rows t and t + 4 of each
    k16 step (the i4 layout's map) through pair8_pair, the fold term."""
    blk = get_format(qt.format).block
    k, n = qt.storage_k, int(qt.shape[-1])
    tiles, steps = -(-n // 128), k // 16
    pad = tiles * 128 - n
    words = np.pad(qt.planes[PAIR8_PLANE].numpy(), ((0, 0), (0, pad))).view(
        np.uint32)
    sc2 = _scales(qt, blk, steps, tiles, pad)
    row = (np.arange(steps) * 8)[None, :, None, None] + T[None, None, :, None]
    wcol = _word_columns(tiles)
    wl, wh = words[row, wcol], words[row + 4, wcol]
    a = np.zeros((tiles, steps, 32, 8, 4), np.uint32)
    for v in range(4):
        for h in range(2):
            c0, c1 = 2 * h, 2 * h + 1
            s0, s1 = sc2[..., 4 * v + c0], sc2[..., 4 * v + c1]
            a[..., 2 * v + h, :] = np.stack([
                pair8_pair(wl[..., v], c0, s0), pair8_pair(wl[..., v], c1, s1),
                pair8_pair(wh[..., v], c0, s0), pair8_pair(wh[..., v], c1, s1)],
                -1)
    return emulate(x, n, a, _fold(qt, x, blk, pad))


def _case(fmt, k, n, m, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.05)
    qt = quantize(w, fmt)
    assert qt.storage_k == k
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    return qt, x, rng


def _check(qt, x, codes, y, w_bits, plain):
    """The emulation's weights against bf16(codes * bf16(sc)) and its
    sums against the plain version."""
    k, n = qt.storage_k, int(qt.shape[-1])
    blk = get_format(qt.format).block
    scb = qt.scale.to(torch.bfloat16).float()
    want_w = bits_of((codes.float().reshape(k // blk, blk, n)
                      * scb[:, None, :]).to(torch.bfloat16).reshape(k, n))
    np.testing.assert_array_equal(w_bits, want_w)
    ref = plain(torch.from_numpy(x).to(torch.bfloat16), qt).numpy()
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max(), (
        qt.format, k, n, x.shape[0], np.abs(y - ref).max())


@pytest.mark.parametrize("seed,shape", list(enumerate(SHAPES)))
def test_pair8_emulation_matches_plain(seed, shape):
    """Q3H_B64T1's pair8 plane at test-llama's qkv (256 x 384, 8 rows) and
    w2 (512 x 256, 3 rows) and a ragged N = 100, then the same weights with
    every byte drawn from 0..255 (the plain version and the kernel decode
    any byte)."""
    k, n, m = shape
    qt, x, rng = _case("Q3H_B64T1", k, n, m, 70 + seed)
    for plane in (qt.planes[PAIR8_PLANE], torch.from_numpy(
            rng.integers(0, 256, (k // 2, n)).astype(np.uint8))):
        qt.planes[PAIR8_PLANE] = plane
        y, w_bits = emulate_pair8(qt, x)
        _check(qt, x, pair8_values(plane), y, w_bits, pair8_matmul_plain)
