"""The tensor-core design of the 8-row code GEMV (csrc/gemv_mma.cuh: X4's
`unpack_mma_d`, B4 (b')'s GEMV in weight modes 7-10 and B4's wire GEMV in
modes 11-13), emulated in numpy on the CPU, where no card runs it.

(i)  The bf16x2 bit tricks (a nibble or an int8 code turned into bf16 by
     the bits of a magic number, times bf16(scale) by one fma.rn.bf16x2)
     give the plain versions' weights bit for bit: all 16 nibbles and all
     256 int8 codes over a sweep of scales (f16 extremes and subnormals,
     f32 metadata down to f32 subnormals).
(ii) The fragment map (each lane's 16 columns and K pairs, the A, B and C
     registers of mma.sync m16n8k16 as PTX lays them out) covers every (k,
     n) of a tile once, Q2's too (4 codes a byte: lane t's K pairs (4t,
     4t+1) and (4t+2, 4t+3), the B fragments staged in that order by
     frag_word_q2), and the emulated GEMV, register by register, forms
     exactly the plain versions' bf16 weights and their product within a
     float32 summation bound: i4_bf16_matmul_plain on the four i4
     geometries at test-llama shapes (and a ragged N), plain_d for X4,
     wire_matmul_plain on the three wire geometries (Q4_B64T1, Q4_B32T1A,
     Q2_B32T1A: unsigned_nibble_pair and q2_pair, the fold term
     bf16(sum x) * bf16(base)).
(iii) plain_d against the JAX package's run_d (interpret mode), so the
     emulation is tied to the reference.

Tolerance of (ii)/(iii) products: 1e-5 * max|plain| for the emulation,
which sums the same bf16 products in float64 in another order than the
plain version's float32; 2^-7 * max|ref| against JAX (as
tests/test_torch_unpack.py).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from inferflow_tpu_torch.kernels.decode_step import (i4_bf16_matmul_plain,
                                                     wire_matmul_plain)
from inferflow_tpu_torch.quant.codec_torch import (I4_PLANE, _unpack_plane,
                                                   i4_nibbles, quantize,
                                                   repack_i4)
from inferflow_tpu_torch.quant.formats import get_format
from inferflow_tpu_torch.tools import exp_unpack as tx

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4  # a lane's group (its 16 columns) and K pair


# ------------------------------------------------------ bit-level helpers
def bf16_round(f32):
    """float32 -> bf16 bits (uint16), round to nearest even (finite)."""
    b = np.asarray(f32, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def byte_perm(x, y, sel):
    """CUDA __byte_perm: output byte i is byte (sel >> 4i) & 7 of {y:x}."""
    pool = (np.asarray(y, np.uint64) << 32) | np.asarray(x, np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        idx = (sel >> (4 * i)) & 7
        out |= ((pool >> np.uint64(8 * idx)) & 0xFF) << np.uint64(8 * i)
    return out.astype(np.uint32)


def fma_bf16x2(a, b, c):
    """fma.rn.bf16x2 per half: bf16(a * b + c), one rounding.  a * b of
    two bf16 values is exact in float32 (a product of 8-bit significands;
    one factor here is a small integer, so no float32 subnormal loses a
    bit), and so is + c where c is -0.0 or the other addend is exact."""
    out = np.zeros(np.broadcast(a, b, c).shape, np.uint32)
    for h in (0, 16):  # a product past bf16's range rounds to inf, as IEEE
        with np.errstate(over="ignore"):
            va, vb, vc = (bf16_value((np.asarray(v, np.uint32) >> h)
                                     & 0xFFFF) for v in (a, b, c))
            r = bf16_round(va * vb + vc).astype(np.uint32)
        out |= r << h
    return out


def splat(scale_f32):
    s = bf16_round(scale_f32).astype(np.uint32)
    return s | (s << 16)


def nibble_pair(w, c, sc2):
    """gemv_mma::nibble_pair<c>: byte c of an i4-layout word."""
    sel = c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)
    t = (byte_perm(w, np.asarray(w, np.uint32) >> 4, sel) & 0x000F000F) \
        ^ 0x43084308
    return fma_bf16x2(fma_bf16x2(t, 0x3F803F80, 0xC308C308), sc2, 0x80008000)


def raw_nibble_pair(w, c):
    """gemv_mma::raw_nibble_pair<c>: byte c of a word of raw nibbles."""
    sel = c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)
    t = (byte_perm(w, np.asarray(w, np.uint32) >> 4, sel) & 0x000F000F) \
        | 0x43004300
    return fma_bf16x2(t, 0x3F803F80, 0xC300C300)


def unsigned_nibble_pair(w, c, sc2):
    """gemv_mma::unsigned_nibble_pair<c>: byte c of a word of unsigned
    nibbles, times the scale."""
    return fma_bf16x2(raw_nibble_pair(w, c), sc2, 0x80008000)


def q2_pair(a, b, c, sc2):
    """gemv_mma::q2_pair<c>: the lowest 2-bit code of byte c of a and of
    b (= a >> 2), times the scale."""
    sel = c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)
    t = (byte_perm(a, b, sel) & 0x00030003) | 0x43004300
    return fma_bf16x2(fma_bf16x2(t, 0x3F803F80, 0xC300C300), sc2, 0x80008000)


def int8_pair(lo, hi, c, sc2):
    """gemv_mma::int8_pair<c>: column c of two int8 words, xor-ed with
    0x80808080."""
    def to_f32(w):
        f = byte_perm(w, np.uint32(0x4B000000), c | 0x7540).view(np.float32)
        return f - np.float32(8388736.0)

    lo_b = bf16_round(to_f32(lo)).astype(np.uint32)
    hi_b = bf16_round(to_f32(hi)).astype(np.uint32)
    return fma_bf16x2(lo_b | (hi_b << 16), sc2, 0x80008000)


def halves(r):
    r = np.asarray(r, np.uint32)
    return r & 0xFFFF, r >> 16


def bits_of(t):
    return t.contiguous().view(torch.int16).numpy().astype(np.uint16)


# ----------------------------------------------------------------- (i)
SCALES_F16 = np.array([0.0, 1.0, -1.0, 0.0123, 65504.0, -65504.0,
                       2.0 ** -14, 2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -15,
                       0.33325, 1000.5, 7.0e-5], np.float16)
SCALES_F32 = np.array([0.0, 1.0, -2.5, 1.0e-38, 1.0e-40, 3.0e-39,
                       1.0e30, -7.3e-7, 0.0123456, 2.0 ** -126,
                       2.0 ** -149], np.float32)


def test_dequant_bits_match_plain_weights():
    """All 256 nibble pairs and all 256 int8 codes (in both rows of a
    register), at every scale of the sweep, against the plain versions'
    weight arithmetic (torch's own casts)."""
    pairs = np.arange(256, dtype=np.uint32)  # low nibble | high nibble << 4
    nib = torch.tensor([((u ^ 8) - 8) for u in range(16)], dtype=torch.float32)
    for stored in (SCALES_F16, SCALES_F32):
        scb = torch.from_numpy(stored).to(torch.bfloat16).float()  # bf16(sc)
        for s_i, s in enumerate(stored.astype(np.float32)):
            sc2 = splat(s)
            # the i4 GEMV: nibble u -> bf16(((u ^ 8) - 8) * bf16(sc))
            plain = (nib * scb[s_i]).to(torch.bfloat16)
            want = bits_of(plain)
            for c in range(4):
                w = pairs << np.uint32(8 * c)
                lo, hi = halves(nibble_pair(w, c, sc2))
                np.testing.assert_array_equal(lo, want[pairs & 15])
                np.testing.assert_array_equal(hi, want[pairs >> 4])
            # the wire modes: unsigned nibble u -> bf16(u * bf16(sc)), Q2
            # code q -> bf16(q * bf16(sc)) (codes 2H, 2H + 1 of a byte from
            # a = byte >> 4H)
            plain_u = bits_of((torch.arange(16).float() * scb[s_i])
                              .to(torch.bfloat16))
            for c in range(4):
                w = pairs << np.uint32(8 * c)
                lo, hi = halves(unsigned_nibble_pair(w, c, sc2))
                np.testing.assert_array_equal(lo, plain_u[pairs & 15])
                np.testing.assert_array_equal(hi, plain_u[pairs >> 4])
                for h in (0, 1):
                    a = w >> np.uint32(4 * h)
                    lo, hi = halves(q2_pair(a, a >> np.uint32(2), c, sc2))
                    np.testing.assert_array_equal(
                        lo, plain_u[(pairs >> (4 * h)) & 3])
                    np.testing.assert_array_equal(
                        hi, plain_u[(pairs >> (4 * h + 2)) & 3])
            # X4: int8 v -> bf16(v * bf16(sc)); the codes in both rows
            codes = np.arange(-128, 128, dtype=np.int32)
            plain8 = bits_of((torch.from_numpy(codes).float() * scb[s_i])
                             .to(torch.bfloat16))
            u = (codes & 0xFF).astype(np.uint32)
            for c in range(4):
                a = (u << np.uint32(8 * c)) ^ 0x80808080
                b = (u[::-1].copy() << np.uint32(8 * c)) ^ 0x80808080
                lo, hi = halves(int8_pair(a, b, c, sc2))
                np.testing.assert_array_equal(lo, plain8)
                np.testing.assert_array_equal(hi, plain8[::-1])


# ----------------------------------------------------------------- (ii)
def a_matrix(a):
    """(..., 32 lanes, 4 registers) bf16x2 -> the 16 x 16 A tile (bf16
    bits): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
    2t+8..), the lower K in the low half."""
    out = np.zeros(a.shape[:-2] + (16, 16), np.uint16)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = halves(a[..., reg])
        out[..., G + dr, 2 * T + dk] = lo
        out[..., G + dr, 2 * T + dk + 1] = hi
    return out


def b_matrix(b):
    """(..., 32, 2) bf16x2 -> the 16 x 8 B tile: b0 (2t..2t+1, g), b1
    (2t+8.., g)."""
    out = np.zeros(b.shape[:-2] + (16, 8), np.uint16)
    for reg in (0, 1):
        lo, hi = halves(b[..., reg])
        out[..., 2 * T + 8 * reg, G] = lo
        out[..., 2 * T + 8 * reg + 1, G] = hi
    return out


def c_lanes(d):
    """The 16 x 8 product -> (..., 32 lanes, 4 registers): c0 (g, 2t), c1
    (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)."""
    return np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                     d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]], -1)


def frag_word(m, kk, q2=False):
    """csrc gemv_mma::frag_word (q2: frag_word_q2): the word of the B
    fragment buffer holding the bf16 pair (kk, kk + 1) of row m."""
    s, w = kk // 16, kk % 16
    if q2:
        return s * 64 + m * 8 + w // 2
    return ((s * 32 + m * 4 + (w % 8) // 2) * 2) + w // 8


# the mma K index of a k16 step -> its K row for Q2's map (lane t's a0/b0
# K pair (2t, 2t+1) is K rows (4t, 4t+1), a2/b1's (2t+8, 2t+9) rows
# (4t+2, 4t+3)); the identity for the other maps
Q2_K = np.array([4 * (k % 8 // 2) + 2 * (k // 8) + k % 2 for k in range(16)])


def frag_buffer(x_bits, kc, q2=False):
    """The B fragment buffer (uint32 words) of 8 rows of bf16 bits (rows
    past x's zero), each pair stored at csrc frag_word's index."""
    buf = np.zeros(kc * 4, np.uint32)  # kc / 16 steps x 32 lanes x 2
    m, kk = np.meshgrid(np.arange(x_bits.shape[0]), np.arange(0, kc, 2),
                        indexing="ij")
    word = frag_word(m, kk, q2)
    buf[word] = (x_bits[:, 0::2].astype(np.uint32)
                 | (x_bits[:, 1::2].astype(np.uint32) << 16))
    return buf.reshape(-1, 32, 2)


def lane_columns(tiles):
    """Each lane's 16 columns in each tile, (tiles, 32, 16)."""
    return (np.arange(tiles)[:, None, None] * 128 + 16 * G[None, :, None]
            + np.arange(16))


# A row r of n-tile q holds column 16 * (r % 8) + 2q + r // 8 of the tile
A_COLUMN = 16 * (np.arange(16) % 8)[None, :] + 2 * np.arange(8)[:, None] \
    + (np.arange(16) // 8)[None, :]


def emulate(x, n, a_regs, fold=None, q2=False):
    """The warps' walk over every 128-column tile: a_regs (tiles, k16
    steps, 32 lanes, 8 n-tiles, 4) A registers, B from the fragment
    buffer (q2: Q2's order), D = A @ B in float64 per step, summed into the
    lanes' C registers; fold (8, N_pad) the quant blocks' fold terms, added
    into the C registers of their columns.  Returns y (M, N) float64 and
    the dequantized W (K, N) bf16 bits rebuilt from the A tiles through the
    C map's columns and the K map (Q2_K for q2)."""
    m, k = x.shape
    tiles, steps = a_regs.shape[:2]
    xb = frag_buffer(bits_of(torch.from_numpy(x).to(torch.bfloat16)), k, q2)
    at = a_matrix(a_regs.transpose(0, 1, 3, 2, 4))  # (tiles, S, 8, 16, 16)
    d = bf16_value(at).astype(np.float64) @ bf16_value(b_matrix(xb))[
        None, :, None]
    acc = c_lanes(d.sum(1)).transpose(0, 2, 1, 3)  # (tiles, 32, 8, 4)
    cols = lane_columns(tiles)
    if fold is not None:
        for c in range(16):
            for e in (0, 1):
                acc[:, :, c // 2, 2 * (c % 2) + e] += fold[2 * T + e,
                                                           cols[:, :, c]]
    y = np.zeros((8, tiles * 128))
    for q in range(8):
        for e in range(4):
            y[2 * T + e % 2, cols[:, :, 2 * q + e // 2]] = acc[:, :, q, e]
    w = np.zeros((k, tiles * 128), np.uint16)
    krow = Q2_K if q2 else np.arange(16)
    w[(np.arange(steps)[:, None, None, None] * 16 + krow)[None],
      (np.arange(tiles)[:, None, None, None, None] * 128
       + A_COLUMN[None, None, :, :, None])] = at
    return y[:m, :n], w[:, :n]


def test_fragment_map_covers_each_element_once():
    """A step's A registers (through the i4 byte rows t, t+4, the int8
    rows 2t, 2t+1, 2t+8, 2t+9 and Q2's byte row t), the B fragment words
    (both orders) and the C registers each cover their tile exactly once,
    A and C name the same column for every (lane, n-tile), and Q2's B
    words hold each lane's K rows in its A registers' order."""
    for kind in ("i4", "int8", "q2"):
        seen = np.zeros((16, 128), int)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for v in range(4):
                for c in range(4):
                    col = 16 * g + 4 * v + c
                    q, r = 2 * v + c // 2, g + 8 * (c % 2)
                    # A row r of n-tile q holds this column: the C map
                    assert 16 * (r % 8) + 2 * q + r // 8 == col
                    ks = {"int8": [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9],
                          "i4": [2 * t, 2 * t + 1, 2 * (t + 4),
                                 2 * (t + 4) + 1],
                          "q2": [4 * t + h for h in range(4)]}[kind]
                    for kk in ks:
                        seen[kk, col] += 1
        assert (seen == 1).all(), kind
    for q2 in (False, True):
        words = np.zeros(64, int)  # one step: 32 lanes x 2 words
        for m in range(8):
            for kk in range(0, 16, 2):
                words[frag_word(m, kk, q2)] += 1
        assert (words == 1).all()
    # Q2: lane t's b0 / b1 (words 2 lane, 2 lane + 1) hold K rows (4t,
    # 4t+1) / (4t+2, 4t+3), the codes of its a0 / a2
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in (0, 1):
            assert frag_word(g, 4 * t + 2 * j, True) == 2 * lane + j
            assert Q2_K[2 * t + 8 * j] == 4 * t + 2 * j
    out = np.zeros((128, 8), int)
    for lane in range(32):
        for q in range(8):
            for e in range(4):
                out[16 * (lane // 4) + 2 * q + e // 2, 2 * (lane % 4) + e % 2] \
                    += 1
    assert (out == 1).all()


def _i4_case(fmt, k, n, m, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.05)
    qt = repack_i4(quantize(w, fmt))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    return qt, x


def emulate_i4bf16(qt, x):
    """B4 (b')'s GEMV, register by register (i4bf_walk)."""
    blk = get_format(qt.format).block
    k, n = qt.storage_k, int(qt.shape[-1])
    tiles, steps = -(-n // 128), k // 16
    pad = tiles * 128 - n
    data = np.pad(qt.planes[I4_PLANE].numpy(), ((0, 0), (0, pad)))
    sc = np.pad(qt.scale.float().numpy(), ((0, 0), (0, pad)))
    bs = (np.zeros_like(sc) if qt.base is None else
          np.pad(qt.base.float().numpy(), ((0, 0), (0, pad))))
    xsum = torch.from_numpy(x).to(torch.bfloat16).float().reshape(
        x.shape[0], -1, blk).sum(-1).numpy()
    xsum = np.pad(bf16_value(bf16_round(xsum)), ((0, 8 - x.shape[0]), (0, 0)))
    fold = bf16_value(bf16_round(sc * np.float32(8) + bs))
    cols = lane_columns(tiles)[:, None]  # (tiles, 1, 32, 16)
    sc2 = splat(sc[(np.arange(steps) * 16 // blk)[None, :, None, None], cols])
    words = data.view(np.uint32)  # 4 columns a word: (K/2, N_pad/4)
    wcol = (np.arange(tiles)[:, None, None, None] * 32
            + 4 * G[None, None, :, None] + np.arange(4))
    row = (np.arange(steps) * 8)[None, :, None, None] + T[None, None, :, None]
    wl, wh = words[row, wcol], words[row + 4, wcol]  # byte rows t, t + 4
    a = np.zeros((tiles, steps, 32, 8, 4), np.uint32)
    for v in range(4):
        for h in range(2):
            c0, c1 = 2 * h, 2 * h + 1
            s0, s1 = sc2[..., 4 * v + c0], sc2[..., 4 * v + c1]
            a[..., 2 * v + h, :] = np.stack([
                nibble_pair(wl[..., v], c0, s0), nibble_pair(wl[..., v], c1, s1),
                nibble_pair(wh[..., v], c0, s0), nibble_pair(wh[..., v], c1, s1)],
                -1)
    return emulate(x, n, a, xsum @ fold)


def test_i4bf16_emulation_matches_plain():
    """The four i4 geometries at test-llama's qkv (256 x 384, 8 rows) and
    w2 (512 x 256, 3 rows), and a ragged N = 100 (a multiple of 4, not of
    16): the emulated (b') GEMV's weights are the plain version's bits,
    its sums within 1e-5 * max|plain|."""
    for seed, (fmt, (k, n, m)) in enumerate(
            (fmt, shape) for fmt in ("Q4_B64T1", "Q4_B32T1A", "Q4_B32T2",
                                     "Q4_B16")
            for shape in ((256, 384, 8), (512, 256, 3), (128, 100, 5))):
        qt, x = _i4_case(fmt, k, n, m, seed)
        y, w_bits = emulate_i4bf16(qt, x)
        blk = get_format(qt.format).block
        scb = qt.scale.to(torch.bfloat16).float()
        q = i4_nibbles(qt.planes[I4_PLANE]).float().reshape(k // blk, blk, n)
        want_w = bits_of((q * scb[:, None, :]).to(torch.bfloat16)
                         .reshape(k, n))
        np.testing.assert_array_equal(w_bits, want_w)
        ref = i4_bf16_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                   qt).numpy()
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max(), (
            fmt, k, n, m, np.abs(y - ref).max())


def emulate_wire(qt, x):
    """B4's wire GEMV, register by register (i4bf_walk in a wire mode):
    Q4 byte rows t, t + 4 of each k16 step through unsigned_nibble_pair,
    Q2 byte row t of each step (a ring slot's two steps: rows t and t + 4)
    through q2_pair, with the B fragments in Q2's order."""
    fmt = get_format(qt.format)
    blk, bits = fmt.block, fmt.planes[0].bits
    k, n = qt.storage_k, int(qt.shape[-1])
    tiles, steps = -(-n // 128), k // 16
    pad = tiles * 128 - n
    data = np.pad(qt.planes["data"].numpy(), ((0, 0), (0, pad)))
    sc = np.pad(qt.scale.float().numpy(), ((0, 0), (0, pad)))
    bs = np.pad(qt.base.float().numpy(), ((0, 0), (0, pad)))
    xsum = torch.from_numpy(x).to(torch.bfloat16).float().reshape(
        x.shape[0], -1, blk).sum(-1).numpy()
    xsum = np.pad(bf16_value(bf16_round(xsum)), ((0, 8 - x.shape[0]), (0, 0)))
    fold = bf16_value(bf16_round(bs))
    cols = lane_columns(tiles)[:, None]
    sc2 = splat(sc[(np.arange(steps) * 16 // blk)[None, :, None, None], cols])
    words = data.view(np.uint32)
    wcol = (np.arange(tiles)[:, None, None, None] * 32
            + 4 * G[None, None, :, None] + np.arange(4))
    a = np.zeros((tiles, steps, 32, 8, 4), np.uint32)
    if bits == 4:
        row = (np.arange(steps) * 8)[None, :, None, None] \
            + T[None, None, :, None]
        wl, wh = words[row, wcol], words[row + 4, wcol]
        lows = (wl, wl >> np.uint32(4), unsigned_nibble_pair)
        highs = (wh, wh >> np.uint32(4), unsigned_nibble_pair)
    else:
        row = (np.arange(steps) * 4)[None, :, None, None] \
            + T[None, None, :, None]
        w0 = words[row, wcol]
        lows = (w0, w0 >> np.uint32(2), q2_pair)
        highs = (w0 >> np.uint32(4), w0 >> np.uint32(6), q2_pair)
    for v in range(4):
        for h in range(2):
            c0, c1 = 2 * h, 2 * h + 1
            s0, s1 = sc2[..., 4 * v + c0], sc2[..., 4 * v + c1]
            regs = []
            for lo_w, lo_b, dec in (lows, highs):
                for c, s_ in ((c0, s0), (c1, s1)):
                    regs.append(dec(lo_w[..., v], lo_b[..., v], c, s_)
                                if dec is q2_pair else
                                dec(lo_w[..., v], c, s_))
            a[..., 2 * v + h, :] = np.stack(regs, -1)
    return emulate(x, n, a, xsum @ fold, q2=bits == 2)


def test_wire_emulation_matches_plain():
    """The three wire geometries (Q4_B64T1, Q4_B32T1A, Q2_B32T1A) at
    test-llama's qkv (256 x 384, 8 rows) and w2 (512 x 256, 3 rows) and a
    ragged N = 100: the emulated wire GEMV's weights are
    wire_matmul_plain's bits (the K rows through Q2's map), its sums
    within 1e-5 * max|plain|."""
    for seed, (fmt, (k, n, m)) in enumerate(
            (fmt, shape) for fmt in ("Q4_B64T1", "Q4_B32T1A", "Q2_B32T1A")
            for shape in ((256, 384, 8), (512, 256, 3), (128, 100, 5))):
        rng = np.random.default_rng(40 + seed)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * 0.05)
        qt = quantize(w, fmt)
        assert "data" in qt.planes and qt.storage_k == k
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        y, w_bits = emulate_wire(qt, x)
        fm = get_format(fmt)
        codes = _unpack_plane(qt.planes["data"], fm.planes[0].bits).float()
        scb = qt.scale.to(torch.bfloat16).float()
        want_w = bits_of((codes.reshape(k // fm.block, fm.block, n)
                          * scb[:, None, :]).to(torch.bfloat16).reshape(k, n))
        np.testing.assert_array_equal(w_bits, want_w)
        ref = wire_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                qt).numpy()
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max(), (
            fmt, k, n, m, np.abs(y - ref).max())


# ----------------------------------------------------------------- (iii)
def emulate_x4(x, codes8, scale):
    """X4's kernel (unpack_mma_d), register by register."""
    k, n = codes8.shape
    tiles, steps = -(-n // 128), k // 16
    pad = tiles * 128 - n
    words = np.pad(codes8, ((0, 0), (0, pad))).view(np.uint32)  # (K, N_pad/4)
    sc = np.pad(scale, ((0, 0), (0, pad)))
    cols = lane_columns(tiles)[:, None]
    sc2 = splat(sc[(np.arange(steps) * 16 // 64)[None, :, None, None], cols])
    wcol = (np.arange(tiles)[:, None, None, None] * 32
            + 4 * G[None, None, :, None] + np.arange(4))
    r0 = (np.arange(steps) * 16)[None, :, None, None] + 2 * T[None, None, :, None]
    rw = [words[r0 + dr, wcol] ^ 0x80808080 for dr in (0, 1, 8, 9)]
    a = np.zeros((tiles, steps, 32, 8, 4), np.uint32)
    for v in range(4):
        for h in range(2):
            c0, c1 = 2 * h, 2 * h + 1
            s0, s1 = sc2[..., 4 * v + c0], sc2[..., 4 * v + c1]
            lo, hi, lo8, hi8 = (r[..., v] for r in rw)
            a[..., 2 * v + h, :] = np.stack([
                int8_pair(lo, hi, c0, s0), int8_pair(lo, hi, c1, s1),
                int8_pair(lo8, hi8, c0, s0), int8_pair(lo8, hi8, c1, s1)], -1)
    return emulate(x, n, a)


def test_x4_emulation_against_plain_and_jax(monkeypatch):
    """X4 at the unpack tests' shape (K 512, N 256) and at a ragged N =
    100: the emulated kernel's weights are plain_d's bits and its sums
    within 1e-5 * max|plain|; plain_d within 2^-7 * max|ref| of the JAX
    package's run_d in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_unpack", ROOT / "tools" / "exp_unpack.py")
    jx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jx)
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    rng = np.random.default_rng(7)
    for k, n in ((512, 256), (128, 100)):
        x = torch.from_numpy(rng.standard_normal((8, k)).astype(
            np.float32)).to(torch.bfloat16)
        codes8 = rng.integers(-128, 128, (k, n)).astype(np.int8)
        scale = torch.from_numpy(rng.uniform(0, 0.01, (k // 64, n)).astype(
            np.float32)).to(torch.bfloat16)
        plain = tx.plain_d(x, torch.from_numpy(codes8), scale).numpy()
        y, w_bits = emulate_x4(x.float().numpy(), codes8,
                               scale.float().numpy())
        want_w = bits_of((torch.from_numpy(codes8).float()
                          * scale.float().repeat_interleave(64, 0))
                         .to(torch.bfloat16))
        np.testing.assert_array_equal(w_bits, want_w)
        assert np.abs(y - plain).max() <= 1e-5 * np.abs(plain).max()
        if n % 128 == 0:
            ref = np.asarray(jx.run_d(jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16), jnp.asarray(codes8), jnp.asarray(
                    scale.float().numpy()).astype(jnp.bfloat16), k, n, 128),
                np.float32)
            assert np.abs(plain - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
