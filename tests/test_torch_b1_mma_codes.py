"""B1's, B5's and B6's decode GEMV on the tensor cores (csrc
dequant_matmul.cuh's `dq_gemv_mma`, on the 17 policies of dequant_matmul.cu
and subbyte_matmul.cu), emulated in numpy on the CPU, where no card runs it.

(i)   The weight arithmetic: a code under the float32 bits of 2^23 minus
      2^23 + kBias is the value exactly; value * scale + offset as one
      fma.rn equals the codec's mul.rn then add.rn for every code of at
      most 8 bits, f16 scale and f16 offset of a sweep (extremes,
      subnormals); B5's signed nibbles (kBias 8) with its fold offset
      8 * scale + base reach i4_weight's bf16 bits for every nibble, f16
      scale and base of the sweep by one fma.rn and for f32 metadata of
      the f32 sweep by mul.rn then add.rn; Q3H's v1 = b div 11 by one
      multiply-high is exact for every byte.
(ii)  The slot geometry: each policy's slot K rows (16; a whole block for
      Q5_B32T1's split half), byte rows a plane, row pitch (the lanes'
      16-byte reads of every row pattern meet no bank twice), ring depth
      and shared memory (two CTAs fit an SM); each block's byte rows are
      copied once over its slots, and each lane's K rows read the rows
      that hold them.
      The plan: whole quant blocks a CTA, at most kMaxKc rows, K covered
      once, one or two waves of two CTAs an SM at llama2's decode shapes.
(iii) The GEMV emulated register by register for each policy: the lanes'
      cp.async chunks into a slot image (row pitch, metadata at a block's
      first slot, zeros past N), the lanes' reads of row(p, k), codes()
      on four columns a word, the K-pair packing (cvt.rn.bf16x2.f32) and
      the column map; its A fragments rebuild codec_torch.dequantize's
      bf16 weights bit for bit (B5: i4_weight's; pad blocks of a K-padded
      tensor exact zeros, whatever their bytes), and its 8-row sums equal
      quantized_matmul_plain's (B5: i4_matmul_plain's) within 1e-5 *
      max|plain| (float64 sums of
      the same bf16 products in another order than the plain version's
      float32 ones), at a ragged N (not a multiple of 128) and 1, 3 and 8
      rows.

The plain version is held against the JAX package in
tests/test_torch_subbyte.py, test_torch_q8.py, test_torch_q3h.py and (B5)
test_torch_i4.py and test_torch_i4_formats.py.
"""

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels import dequant_matmul as dm
from inferflow_tpu_torch.quant.codec_torch import (I4_PLANE, QuantizedTensor,
                                                   dequantize, pair8_to_wire,
                                                   quantize, repack_i4)
from inferflow_tpu_torch.quant.formats import get_format

from test_torch_gemv_mma import (SCALES_F16, SCALES_F32, G, T, bf16_round,
                                 bits_of, byte_perm, emulate, frag_buffer)

# ------------------------------------------------ the policies, mirrored
class Wire:
    """csrc dequant_matmul.cuh's Wire<kBlock, kBits0, kSplit, kBits1, Meta>."""

    pair, bias, base = False, 0, True

    def __init__(self, block, bits0, split, bits1, meta):
        self.block, self.bits0, self.split, self.bits1 = block, bits0, split, bits1
        self.meta = meta
        self.per0, self.per1 = 8 // bits0, (8 // bits1 if bits1 else 1)
        self.rows = (block // self.per0, block // self.per1 if bits1 else 0, 0)

    def row(self, p, k):
        if p == 0:
            return k % (self.block // 2) if self.split else k // self.per0
        return k // self.per1

    def codes(self, w0, w1, w2, k):
        k = np.asarray(k, np.uint32)
        s0 = (k // (self.block // 2)) * 4 if self.split \
            else (k % self.per0) * self.bits0
        mask0 = np.uint32(((1 << self.bits0) - 1) * 0x01010101)
        code = (w0 >> s0.astype(np.uint32)) & mask0
        if self.bits1:
            mask1 = np.uint32(((1 << self.bits1) - 1) * 0x01010101)
            code |= ((w1 >> ((k % self.per1) * self.bits1).astype(np.uint32))
                     & mask1) << np.uint32(self.bits0)
        return code


class Q8Signed:
    block, rows, meta, pair, bias, base = 32, (32, 0, 0), np.float16, False, 128, False

    def row(self, p, k):
        return k

    def codes(self, w0, w1, w2, k):
        return w0 ^ np.uint32(0x80808080)


class Pair8:
    block, rows, meta, pair, bias, base = 64, (32, 0, 0), np.float16, True, 0, True

    def row(self, p, k):
        return k // 2

    def codes(self, w0, w1, w2, k):
        return w0


class Q3HWire:
    block, rows, meta, pair, bias, base = 64, (16, 8, 4), np.float16, True, 0, True

    def row(self, p, k):
        return (k // 4, k // 8, k // 16)[p]

    def codes(self, w0, w1, w2, k):
        j = np.asarray(k, np.uint32) // 2
        return (((w0 >> (4 * (j & 1))) & np.uint32(0x0F0F0F0F))
                | (((w1 >> (2 * (j & 3))) & np.uint32(0x03030303)) << 4)
                | (((w2 >> (j & 7)) & np.uint32(0x01010101)) << 6))


class PackedI4:
    """csrc dequant_matmul.cu's PackedI4<kBlock, Meta> (B5): the nibble XOR
    8 as the code, value code - 8, offset 8 * scale + base (`fold`)."""

    pair, bias, base, fold = False, 8, True, True

    def __init__(self, block, meta):
        self.block, self.meta, self.rows = block, meta, (block // 2, 0, 0)

    def row(self, p, k):
        return k // 2

    def codes(self, w0, w1, w2, k):
        k = np.asarray(k, np.uint32)
        return (((w0 >> (4 * (k & 1))) & np.uint32(0x0F0F0F0F))
                ^ np.uint32(0x08080808))


F16, F32 = np.float16, np.float32
# (format, layout) -> policy: the 17 of the GEMV (Q4_B32T1B, Q3_B32T1B and
# Q2_B32T1B share the A variants')
POLICIES = {
    ("Q4_B64T1", "wire"): Wire(64, 4, False, 0, F16),
    ("Q8_B32T2", "wire"): Q8Signed(),
    ("Q8_B32T1", "wire"): Wire(32, 8, False, 0, F16),
    ("Q6_B64T1", "wire"): Wire(64, 4, False, 2, F16),
    ("Q5_B64T1", "wire"): Wire(64, 4, False, 1, F16),
    ("Q5_B32T1", "wire"): Wire(32, 4, True, 1, F16),
    ("Q4_B32T1A", "wire"): Wire(32, 4, False, 0, F16),
    ("Q4_B32T2", "wire"): Wire(32, 4, False, 0, F32),
    ("Q4_B16", "wire"): Wire(16, 4, False, 0, F32),
    ("Q3_B32T1A", "wire"): Wire(32, 2, False, 1, F16),
    ("Q2_B32T1A", "wire"): Wire(32, 2, False, 0, F16),
    ("Q3H_B64T1", "pair8"): Pair8(),
    ("Q3H_B64T1", "wire"): Q3HWire(),
    ("Q4_B64T1", "i4"): PackedI4(64, F16),
    ("Q4_B32T1A", "i4"): PackedI4(32, F16),
    ("Q4_B32T2", "i4"): PackedI4(32, F32),
    ("Q4_B16", "i4"): PackedI4(16, F32),
}


# ---------------------------------------- the geometry, mirrored (MmaGeo)
RING_BUDGET, SMEM_BUDGET, MAX_KC, WARPS, SUM_LD = 9216, 106496, 2048, 8, 132


def _linear(d, p):
    per = 16 * d.rows[p] // d.block
    return all(d.row(p, k) == (k // 16) * per + d.row(p, k % 16)
               and d.row(p, k % 16) < per for k in range(d.block))


def _pair_row(d, p):
    return all(d.row(p, k) == d.row(p, k + 1) for k in range(0, d.block, 2))


def _ways(d, slot_k, pitch):
    total = 0
    for p in range(3):
        if not d.rows[p]:
            continue
        for st in range(slot_k // 16):
            for dd in (0, 1, 8, 9):
                for q in range(4):
                    addr = {d.row(p, 16 * st + 2 * (lane % 4) + dd) * pitch
                            + 2 * q + lane // 4 for lane in range(8)}
                    banks = np.bincount([a % 8 for a in addr], minlength=8)
                    total += banks.max() - 1
    return total


def geometry(d):
    slot_k = 16 if all(_linear(d, p) for p in range(3) if d.rows[p]) \
        else d.block
    srows = [r * slot_k // d.block for r in d.rows]
    first = [0, srows[0], srows[0] + srows[1]]
    ways = [_ways(d, slot_k, p) for p in range(8, 13)]
    pitch = 8 + ways.index(min(ways))
    meta_per = 128 * np.dtype(d.meta).itemsize // 16
    n_meta = meta_per * (2 if d.base else 1)
    code_rows = sum(srows)
    slot = code_rows * pitch + n_meta
    ring = min(max(RING_BUDGET // (slot * 16), 3), 8)
    work = max(WARPS * ring * slot * 16, WARPS * 8 * SUM_LD * 4)
    free = (SMEM_BUDGET - work) // 16
    max_kc = MAX_KC if free >= MAX_KC else 1024 if free >= 1024 else 512
    return dict(slot_k=slot_k, srows=srows, first=first, pitch=pitch,
                ways=min(ways), meta_per=meta_per, n_meta=n_meta,
                code_rows=code_rows, slot=slot, ring=ring, max_kc=max_kc,
                smem=max_kc * 16 + work)


# ----------------------------------------------------------------- (i)
def _fma_f32(v, sc, off):
    """fma.rn.f32 where v * sc is exact: the float64 sum is exact too (at
    most 48 bits apart), so one rounding to float32."""
    return (v.astype(np.float64) * sc.astype(np.float64)
            + off.astype(np.float64)).astype(np.float32)


def test_weight_arithmetic_matches_codec():
    """Every code of a byte (and every signed Q8 code) under the magic
    bits, at every f16 scale of the sweep and f16 offsets of the same
    sweep: the fma.rn weight equals mul.rn then add.rn (the codec's) in
    float32, and so its bf16; the pair split by multiply-high is exact."""
    u = np.arange(256, dtype=np.uint32)
    for bias in (0, 128):
        v = ((u | np.uint32(0x4B000000)).view(np.float32)
             - np.float32(2 ** 23 + bias))
        np.testing.assert_array_equal(v, u.astype(np.float32) - bias)
        for s in SCALES_F16:
            sc = np.full(256, s, np.float16).astype(np.float32)
            for o in SCALES_F16:
                off = np.full(256, o, np.float16).astype(np.float32)
                two = (v * sc) + off  # numpy float32: mul.rn, then add.rn
                np.testing.assert_array_equal(_fma_f32(v, sc, off), two)
                np.testing.assert_array_equal(bf16_round(_fma_f32(v, sc, off)),
                                              bf16_round(two))
    # B5: n = code - 8 for the 16 nibbles, fold = 8 * scale + base
    n = np.arange(-8, 8, dtype=np.float32)
    v = ((n.astype(np.int64) + 8).astype(np.uint32) | np.uint32(0x4B000000)
         ).view(np.float32) - np.float32(2 ** 23 + 8)
    np.testing.assert_array_equal(v, n)
    for sweep, fma in ((SCALES_F16, True), (SCALES_F32, False)):
        for s in sweep.astype(np.float32):
            sc = np.full(16, s, np.float32)
            for o in sweep.astype(np.float32):
                fold = (sc * np.float32(8)) + o
                w = _fma_f32(v, sc, fold) if fma else (v * sc) + fold
                plain = (torch.from_numpy(n) * torch.from_numpy(sc)
                         + torch.from_numpy(fold)).to(torch.bfloat16)
                np.testing.assert_array_equal(bf16_round(w), bits_of(plain))
    v1 = (u.astype(np.uint64) * 0x1745D175) >> np.uint64(32)
    np.testing.assert_array_equal(v1, u // 11)
    np.testing.assert_array_equal(u - 11 * v1.astype(np.uint32), u % 11)


# ----------------------------------------------------------------- (ii)
# the layouts the card builds (MmaGeo<D>, printed by a host build of the
# header): slot K rows, row pitch (chunks), ring slots, K rows a CTA
GEOMETRY = {
    ("Q4_B64T1", "wire"): (16, 10, 5, 2048), ("Q8_B32T2", "wire"): (16, 9, 3, 2048),
    ("Q8_B32T1", "wire"): (16, 9, 3, 2048), ("Q6_B64T1", "wire"): (16, 10, 3, 2048),
    ("Q5_B64T1", "wire"): (16, 10, 4, 2048), ("Q5_B32T1", "wire"): (32, 9, 3, 1024),
    ("Q4_B32T1A", "wire"): (16, 10, 5, 2048), ("Q4_B32T2", "wire"): (16, 10, 4, 2048),
    ("Q4_B16", "wire"): (16, 10, 4, 2048), ("Q3_B32T1A", "wire"): (16, 10, 6, 2048),
    ("Q2_B32T1A", "wire"): (16, 10, 8, 2048), ("Q3H_B64T1", "pair8"): (16, 10, 5, 2048),
    ("Q3H_B64T1", "wire"): (16, 10, 5, 2048), ("Q4_B64T1", "i4"): (16, 10, 5, 2048),
    ("Q4_B32T1A", "i4"): (16, 10, 5, 2048), ("Q4_B32T2", "i4"): (16, 10, 4, 2048),
    ("Q4_B16", "i4"): (16, 10, 4, 2048),
}


def test_slot_geometry():
    """Each policy's slot layout: conflict-free reads, two CTAs an SM,
    each block's byte rows copied once, each lane's K rows in the rows it
    reads (row(p, k) inside the slot's rows of its plane)."""
    for key, d in POLICIES.items():
        geo = geometry(d)
        assert (geo["slot_k"], geo["pitch"], geo["ring"],
                geo["max_kc"]) == GEOMETRY[key], (key, geo)
        assert geo["ways"] == 0, key
        assert 2 * (geo["smem"] + 1024) <= 228 * 1024, key
        spb = d.block // geo["slot_k"]
        for p in range(3):
            if not d.rows[p]:
                continue
            copied = [j * geo["srows"][p] + r for j in range(spb)
                      for r in range(geo["srows"][p])]
            assert sorted(copied) == list(range(d.rows[p])), (key, p)
            for k in range(d.block):
                j, kk = divmod(k, geo["slot_k"])
                rel = d.row(p, kk)
                assert 0 <= rel < geo["srows"][p], (key, p, k)
                assert j * geo["srows"][p] + rel == d.row(p, k), (key, p, k)


CTA_COST = 96 * 1024  # csrc kMmaCtaCost


def plan(d, k, n, sm_count=132):
    """csrc plan_matmul_mma at 2-8 rows: (K rows a CTA, K splits)."""
    geo = geometry(d)
    tiles, slots, unit = -(-n // 128), 2 * sm_count, d.block
    blk_bytes = 128 * (sum(d.rows) + (2 if d.base else 1)
                       * np.dtype(d.meta).itemsize)
    best, rows_best = None, min(geo["max_kc"], -(-k // unit) * unit)
    for waves in range(1, 17):
        want = waves * slots // tiles
        if want < 1:
            continue
        rows = -(-(-(-k // want)) // unit) * unit
        if rows > geo["max_kc"]:
            continue
        splits = -(-k // rows)
        cost = -(-tiles * splits // slots) * (CTA_COST
                                             + rows // unit * blk_bytes)
        if best is None or cost < best:
            best, rows_best = cost, rows
    return rows_best, -(-k // rows_best)


def test_plan_covers_k_once():
    """Every policy at llama2-7b's and 13b's decode products and small
    shapes: whole quant blocks a CTA, at most kMaxKc rows, every K row in
    exactly one split; at 7b w1n3 (Q6, Q8_B32T2) and 13b w1n3 (Q3H) the
    plans the card took (1408 or 1376 rows, 3 splits; 1728, 3)."""
    shapes = ((4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096),
              (5120, 15360), (5120, 27648), (13824, 5120), (512, 208),
              (704, 1040))
    for key, d in POLICIES.items():
        geo = geometry(d)
        for k, n in shapes:
            k -= k % d.block
            kc, splits = plan(d, k, n)
            assert kc % d.block == 0 and kc <= geo["max_kc"], (key, k, n)
            assert kc * (splits - 1) < k <= kc * splits, (key, k, n)
    assert plan(POLICIES["Q6_B64T1", "wire"], 4096, 22016) == (1408, 3)
    assert plan(POLICIES["Q8_B32T2", "wire"], 4096, 22016) == (1376, 3)
    assert plan(POLICIES["Q3H_B64T1", "wire"], 5120, 27648) == (1728, 3)


# ----------------------------------------------------------------- (iii)
def _slot_images(d, geo, planes, scale, base, n):
    """Every slot of every column tile as the lanes' cp.async leave it:
    (tiles, slots, chunks, 16) bytes.  Chunk i of a slot's code list
    (byte row i / 8 of the planes' concatenated rows, 16-byte group i % 8)
    lands at row * pitch + group; the metadata chunks (scale row, then
    base row, of the block) at the block's first slot; zeros past N."""
    tiles = -(-n // 128)
    npad = tiles * 128
    k_s = scale.shape[0] * d.block
    nslots = k_s // geo["slot_k"]
    spb = d.block // geo["slot_k"]
    img = np.zeros((tiles, nslots, geo["slot"], 16), np.uint8)
    padded = [np.pad(pl, ((0, 0), (0, npad - n))) for pl in planes]
    u = np.arange(nslots)
    kb, j = u // spb, u % spb
    for i in range(geo["code_rows"] * 8):
        r, cg = divmod(i, 8)
        p = 0 if r < geo["first"][1] else 1 if r < geo["first"][2] else 2
        grow = kb * d.rows[p] + j * geo["srows"][p] + (r - geo["first"][p])
        col = np.arange(tiles) * 128 + 16 * cg
        img[:, :, r * geo["pitch"] + cg] = padded[p][
            grow[None, :, None], col[:, None, None] + np.arange(16)]
    size = np.dtype(d.meta).itemsize
    metas = [scale] + ([base] if d.base else [])
    for i in range(geo["n_meta"]):
        arr, c = divmod(i, geo["meta_per"])
        rowb = np.ascontiguousarray(
            np.pad(metas[arr], ((0, 0), (0, npad - n)))).view(np.uint8)
        at = (np.arange(tiles) * 128 * size + 16 * c)[:, None, None] \
            + np.arange(16)
        first = j == 0
        img[:, first, geo["pitch"] * geo["code_rows"] + i] = \
            rowb[kb[first][None, :, None], at]
    return img


def _words(chunks):
    """(..., 16) bytes -> (..., 4) little-endian uint32 words."""
    return np.ascontiguousarray(chunks).view(np.uint32)


def _weight(d, bits, sc, off):
    """csrc mma_weight<D>: the value from the magic bits, then the codec's
    arithmetic (one fma.rn for f16 metadata, whose product is exact)."""
    v = bits.view(np.float32) - np.float32(2 ** 23 + d.bias)
    if not d.base:
        return v * sc
    if d.meta is np.float16:
        return _fma_f32(v, sc, off)
    return (v * sc) + off


def _pack(lo, hi):
    return bf16_round(lo).astype(np.uint32) \
        | (bf16_round(hi).astype(np.uint32) << np.uint32(16))


def emulate_b1(d, qt, x):
    """dq_gemv_mma register by register: the slot images, each lane's
    metadata (from its block's first slot), its chunks of rows row(p, k)
    for K rows 2t + 8h + e, codes() of each word, the A registers of the
    8 n-tiles (byte c of word v: n-tile 2v + c / 2, a0/a2 for even c,
    a1/a3 for odd c), then gemv_mma's emulate for the sums."""
    geo = geometry(d)
    fmt = get_format(qt.format)
    names = dm._plane_names(dm._plane(qt), fmt)
    n = int(qt.shape[-1])
    planes = [qt.planes[nm].numpy() for nm in names]
    planes += [np.zeros((1, n), np.uint8)] * (3 - len(planes))
    scale = qt.scale.numpy().astype(d.meta)
    base = qt.base.numpy().astype(d.meta) if d.base else None
    img = _slot_images(d, geo, planes, scale, base, n)
    tiles, nslots = img.shape[:2]
    spb = d.block // geo["slot_k"]
    pitch = geo["pitch"]
    # the lanes' metadata: group g's 16 columns of the block's first slot
    mb = img[:, (np.arange(nslots) // spb) * spb]
    per = 16 // np.dtype(d.meta).itemsize
    at = pitch * geo["code_rows"] + (16 // per) * G[:, None] + np.arange(16 // per)
    sc = np.ascontiguousarray(mb[:, :, at]).view(d.meta).reshape(
        tiles, nslots, 32, 16).astype(np.float32)
    off = np.zeros_like(sc)
    if d.base:
        off = np.ascontiguousarray(mb[:, :, at + geo["meta_per"]]).view(
            d.meta).reshape(tiles, nslots, 32, 16).astype(np.float32)
    if getattr(d, "fold", False):  # PackedI4::offset: 8 * scale + base
        off = (sc * np.float32(8)) + off
    steps = geo["slot_k"] // 16
    a = np.zeros((tiles, nslots, steps, 32, 8, 4), np.uint32)
    for st in range(steps):
        words = {}
        for p in range(3):
            for h in range(2):
                for e in range(2):
                    if not d.rows[p]:
                        words[p, h, e] = np.zeros((tiles, nslots, 32, 4),
                                                  np.uint32)
                        continue
                    ee = 0 if (d.pair or _pair_row(d, p)) else e
                    rows = geo["first"][p] + np.array(
                        [d.row(p, 16 * st + 2 * t + 8 * h + ee) for t in T])
                    words[p, h, e] = _words(img[:, :, rows * pitch + G])
        for v in range(4):
            regs = np.zeros((tiles, nslots, 32, 4, 2), np.uint32)  # [c][h]
            for h in range(2):
                k = 16 * st + 2 * T + 8 * h
                w = [[words[p, h, e][..., v] for p in range(3)]
                     for e in range(2)]
                if d.pair:
                    pc = d.codes(*w[0], k)
                    for c in range(4):
                        b = byte_perm(pc, np.uint32(0), 0x4440 | c)
                        v1 = ((b.astype(np.uint64) * 0x1745D175)
                              >> np.uint64(32)).astype(np.uint32)
                        v0 = b - np.uint32(11) * v1
                        s, o = sc[..., 4 * v + c], off[..., 4 * v + c]
                        regs[..., c, h] = _pack(
                            _weight(d, v0 | np.uint32(0x4B000000), s, o),
                            _weight(d, v1 | np.uint32(0x4B000000), s, o))
                else:
                    lo, hi = d.codes(*w[0], k), d.codes(*w[1], k + 1)
                    for c in range(4):
                        s, o = sc[..., 4 * v + c], off[..., 4 * v + c]
                        sel = 0x7540 | c
                        regs[..., c, h] = _pack(
                            _weight(d, byte_perm(lo, np.uint32(0x4B000000),
                                                 sel), s, o),
                            _weight(d, byte_perm(hi, np.uint32(0x4B000000),
                                                 sel), s, o))
            for hh in range(2):  # n-tile 2v + hh: bytes 2hh (a0, a2), 2hh+1
                a[:, :, st, :, 2 * v + hh] = np.stack(
                    [regs[..., 2 * hh, 0], regs[..., 2 * hh + 1, 0],
                     regs[..., 2 * hh, 1], regs[..., 2 * hh + 1, 1]], -1)
    a = a.reshape(tiles, nslots * steps, 32, 8, 4)
    return emulate(x, n, a)


def _pad_k(qt, k_s):
    """qt stored with K = k_s: pad blocks of scale 0 and base 0 whose
    plane bytes are 0x5A (they must add exact zeros whatever they hold)."""
    fmt = get_format(qt.format)
    pad = k_s - qt.storage_k
    rows = dm._plane_rows(qt, dm._plane(qt))  # stored byte rows a plane
    per_k = {nm: r / qt.storage_k for nm, r in rows.items()}
    planes = {nm: torch.nn.functional.pad(qt.planes[nm],
                                          (0, 0, 0, int(pad * per_k[nm])),
                                          value=0x5A)
              for nm in qt.planes}
    meta = [None if t is None else torch.nn.functional.pad(
        t, (0, 0, 0, pad // fmt.block)) for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, planes, *meta)


CASES = [(fmt, layout) for fmt, layout in POLICIES]


@pytest.mark.parametrize("fmt,layout", CASES)
def test_emulated_gemv_matches_plain(fmt, layout):
    """The policy's weights rebuilt from the emulated A fragments equal
    the codec's bf16 weights bit for bit (B5: i4_weight's), and the 8-row
    sums equal quantized_matmul_plain's (B5: i4_matmul_plain's): at (512,
    208) with 8 and 3 rows, and K-padded from 448 to 512 (pad bytes 0x5A)
    with 1 row."""
    d = POLICIES[fmt, layout]
    rng = np.random.default_rng(90 + CASES.index((fmt, layout)))
    for k, k_s, n, ms in ((512, 512, 208, (8, 3)), (448, 512, 144, (1,))):
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * 0.05)
        qt = quantize(w, fmt)
        if layout == "wire" and fmt == "Q3H_B64T1":
            qt = pair8_to_wire(qt)
        if layout == "i4":
            qt = repack_i4(qt)
        if k_s != k:
            qt = _pad_k(qt, k_s)
        assert dm._plane(qt) == {"pair8": "pair8", "i4": I4_PLANE}.get(
            layout, "data")
        assert qt.storage_k == k_s
        for m in ms:
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to(torch.bfloat16).float()
            xp = np.pad(x.numpy(), ((0, 0), (0, k_s - k)))
            y, w_bits = emulate_b1(d, qt, xp)
            want = bits_of(dm.i4_weight(qt) if layout == "i4"
                           else dequantize(qt, torch.bfloat16))
            np.testing.assert_array_equal(w_bits[:k], want)
            assert not w_bits[k:].any()  # pad rows: +0.0
            plain = (dm.i4_matmul_plain if layout == "i4"
                     else dm.quantized_matmul_plain)
            ref = plain(x, qt).numpy()
            err = np.abs(y - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (fmt, layout, k, m, err)
