"""B4 mode (b)'s i4x8 GEMV on the int8 tensor cores (csrc decode_step.cu's
`i4x8_walk`: weight modes 1, 4-6 at 2..8 rows; one row keeps the dp4a
loop), emulated in numpy on the CPU, where no card runs it.

(i)   The bit tricks and the block sums: a nibble of the i4 layout in a
      byte's high half with zeros below is the int8 16 * n (hi16, lo16) for
      all 256 bytes; the staging's order of each quant block's bf16
      activation sum (a thread's K rows e + 8c over c, then e across 8
      lanes) equals the dp4a loop's warp_sum order bit for bit, on blocks
      of a wide dynamic range where another order differs.
(ii)  The fragment map of each geometry (Q4_B64T1, Q4_B32T1A, Q4_B32T2,
      Q4_B16), register by register: each lane's cp.async chunks of byte
      rows t, t + 4, t + 8, t + 12 of a k32 slot (t, t + 4 of Q4_B16's k16
      slot), transpose4 and lo16 / hi16 (k16: byte_perm) into the A
      registers, the staging's int8 codes into the B fragments, and the
      mma.sync m16n8k32 / m16n8k16 s8 layouts: the A tiles rebuild 16 * the
      block's signed nibbles and the B tiles its int8 codes in one K order,
      every (k, n) once, and each block's int32 C sums equal its exact dot
      times 16.
(iii) The 8-row result: the block terms with the dp4a loop's float32
      operations, the warps' and splits' sums in their order, on the
      plan's K splits; within 8e-3 * max|plain| of i4x8_matmul_plain
      (tests/test_torch_cuda_b4_modes.py's REL_TOL; the plain version adds
      the fold terms first, in another order) at 1, 3 and 8 rows and a
      ragged N, on the card's plan and on a one-wave plan of many blocks a
      CTA (every warp and split order exercised).
(iv)  The slot geometry (two CTAs an SM with their static and ring shared
      memory) and the plan: whole quant blocks a CTA, at most 2048 rows,
      K covered once, at llama2-7b's and 13b's decode products.

The plain version is held against the JAX package's fused step in
tests/test_torch_i4.py and test_torch_i4_step_formats.py.
"""

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels.decode_step import i4x8_matmul_plain
from inferflow_tpu_torch.quant.codec_torch import (I4_PLANE, i4_nibbles,
                                                   int8_rowwise_activations,
                                                   quantize, repack_i4)

from test_torch_gemv_mma import G, T, bf16_round, bf16_value, byte_perm

REL_TOL = 8e-3  # tests/test_torch_cuda_b4_modes.py
# format -> (block rows, metadata type, csrc WeightMode)
GEOMETRIES = {"Q4_B64T1": (64, np.float16, 1), "Q4_B32T1A": (32, np.float16, 4),
              "Q4_B32T2": (32, np.float32, 5), "Q4_B16": (16, np.float32, 6)}
WARPS, MAX_KC, CTA_COST = 8, 2048, 96 * 1024  # csrc kGemvWarps, kMaxKcBf, kBfCtaCost


def geometry(fmt):
    """csrc BfRing of an i4x8 mode: slot byte rows (one mma step), code
    chunks a lane, slots a block, ring depth, metadata chunks a group."""
    blk, meta, mode = GEOMETRIES[fmt]
    rows = 16 if blk > 16 else 8
    return dict(blk=blk, meta=meta, mode=mode, rows=rows, chunks=rows // 4,
                slots=blk // 2 // rows, k32=rows == 16,
                ring=3 if mode == 5 else 4,
                meta_chunks=8 if meta is np.float32 else 4)


# ---------------------------------------------------------- bit helpers
def hi16(w):
    return np.asarray(w, np.uint32) & np.uint32(0xF0F0F0F0)


def lo16(w):
    return (np.asarray(w, np.uint32) << np.uint32(4)) & np.uint32(0xF0F0F0F0)


def transpose4(r):
    """csrc transpose4: 4 words (rows) -> 4 words (columns)."""
    lo01, hi01 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    lo23, hi23 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def int8_bytes(w):
    """(..., ) uint32 -> (..., 4) int8 values, low byte first."""
    return np.ascontiguousarray(np.asarray(w, np.uint32)).view(np.int8).reshape(
        np.shape(w) + (4,))


def f32(v):
    return np.asarray(v, np.float32)


def loop_block_sum(v):
    """The dp4a loop's bf16 block sum: lane l holds v[l] (v[l] + v[l + 32]
    for a 64-row block, 0 past a 16-row block), then warp_sum's xor
    butterfly 16, 8, 4, 2, 1.  v (..., blk) float32; returns float32."""
    blk = v.shape[-1]
    lanes = np.zeros(v.shape[:-1] + (32,), np.float32)
    lanes[..., :min(blk, 32)] = v[..., :32]
    if blk == 64:
        lanes = f32(lanes + v[..., 32:])
    for o in (16, 8, 4, 2, 1):
        lanes = f32(lanes + lanes[..., np.arange(32) ^ o])
    return lanes[..., 0]


def walk_block_sum(v):
    """The i4x8 walk's staging: thread e holds v[e + 8c]; Q4_B16's block
    adds 0 first (the loop's empty lanes), then the sum over c high bit
    first, then xor 4, 2, 1 across the 8 lanes."""
    blk = v.shape[-1]
    kc = blk // 8
    s = v.reshape(v.shape[:-1] + (kc, 8))  # [c][e]
    if kc == 2:
        s = f32(s + np.float32(0))
    h = kc // 2
    while h >= 1:
        s = f32(s[..., :h, :] + s[..., h:2 * h, :])
        h //= 2
    s = s[..., 0, :]
    for o in (4, 2, 1):
        s = f32(s + s[..., np.arange(8) ^ o])
    return s[..., 0]


# ----------------------------------------------------------------- (i)
def test_nibbles_and_block_sums():
    """hi16 / lo16 of every byte are 16 * its signed nibbles; the walk's
    block-sum order equals the loop's bit for bit at the three block
    sizes, on values of 2^-20 .. 2^20 where a sequential sum differs."""
    b = np.arange(256, dtype=np.uint32)
    n_lo = ((b & 15) ^ 8).astype(np.int32) - 8
    n_hi = ((b >> 4) ^ 8).astype(np.int32) - 8
    np.testing.assert_array_equal(int8_bytes(hi16(b))[:, 0], 16 * n_hi)
    np.testing.assert_array_equal(int8_bytes(lo16(b))[:, 0], 16 * n_lo)
    np.testing.assert_array_equal(int8_bytes(hi16(b << 8))[:, 1], 16 * n_hi)
    rng = np.random.default_rng(7)
    for blk in (64, 32, 16):
        v = (rng.standard_normal((4000, blk))
             * 2.0 ** rng.integers(-20, 21, (4000, blk))).astype(np.float32)
        v = bf16_value(bf16_round(v))
        loop, walk = loop_block_sum(v), walk_block_sum(v)
        np.testing.assert_array_equal(loop.view(np.uint32), walk.view(np.uint32))
        seq = v[:, 0].copy()
        for k in range(1, blk):
            seq = f32(seq + v[:, k])
        assert (seq != loop).any(), blk  # the order matters on these data
        # -0.0: the loop's +0 lanes make every sum of zeros +0
        zeros = -np.zeros((1, blk), np.float32)
        assert walk_block_sum(zeros).view(np.uint32)[0] == \
            loop_block_sum(zeros).view(np.uint32)[0]


# ----------------------------------------------------------------- (ii)
def kmap(geo):
    """mma K position -> K row within the step (lane t's A registers:
    k32 a0 / a1 K 2t + 8i, a2 / a3 2t + 1 + 8i; k16 2t, 2t + 8, 2t + 1,
    2t + 9)."""
    out = []
    for p in range(32 if geo["k32"] else 16):
        t, i = (p % 16) // 4, p % 4
        if geo["k32"]:
            out.append(2 * t + 8 * i + p // 16)
        else:
            out.append(2 * t + (8 if i % 2 else 0) + i // 2)
    return np.array(out)


def stage(xq, geo):
    """The B fragment bytes of xq (M, K) int8 as gemv_body stages them:
    item (m, lb, e) writes its codes of K rows lb * blk + e + 8c."""
    m_rows, k = xq.shape
    blk, kc = geo["blk"], geo["blk"] // 8
    buf = np.zeros(8 * k, np.uint8)  # 8 rows x K codes
    m, lb, e, c = np.meshgrid(np.arange(m_rows), np.arange(k // blk),
                              np.arange(8), np.arange(kc), indexing="ij")
    if geo["k32"]:
        word = 2 * ((lb * kc // 4 + c // 4) * 32 + 4 * m + e // 2) + e % 2
        at = 4 * word + c % 4
    else:
        at = 2 * (2 * (lb * 32 + 4 * m + e // 2) + e % 2) + c
    buf[at] = xq[m, lb * blk + e + 8 * c].astype(np.uint8)
    return buf


def emulate_dots(qt, xq, geo):
    """The walk's int32 C registers of every (column tile, slot): the
    lanes' chunks, their A registers, the staged B fragments, one mma per
    n-tile.  Returns C (tiles, slots, 32, 8, 4), the A tiles (tiles, slots,
    8 n-tiles, 16, Kstep) and the B tiles (slots, Kstep, 8) as int64."""
    data = qt.planes[I4_PLANE].numpy()
    rows, n = data.shape
    tiles = -(-n // 128)
    data = np.pad(data, ((0, 0), (0, tiles * 128 - n)))
    kstep = 32 if geo["k32"] else 16
    nslots = 2 * rows // kstep
    # chunk i of lane (g, t) in slot u: byte row u * rows_slot + t + 4i, columns 16g..
    r = (np.arange(nslots)[:, None, None] * geo["rows"] + T[None, :, None]
         + 4 * np.arange(geo["chunks"])[None, None, :])  # (slots, 32, chunks)
    cols = (np.arange(tiles)[:, None, None, None, None] * 128
            + 16 * G[None, None, :, None, None] + np.arange(16))
    chunks = data[r[None, :, :, :, None], cols]  # (tiles, slots, 32, chunks, 16)
    words = np.ascontiguousarray(chunks).view(np.uint32)  # (..., chunks, 4)
    a = np.zeros((tiles, nslots, 32, 8, 4 if geo["k32"] else 2), np.uint32)
    for v in range(4):
        if geo["k32"]:
            col = transpose4([words[..., i, v] for i in range(4)])
            for h in range(2):
                a[..., 2 * v + h, :] = np.stack(
                    [lo16(col[2 * h]), lo16(col[2 * h + 1]),
                     hi16(col[2 * h]), hi16(col[2 * h + 1])], -1)
        else:
            for h in range(2):
                p = byte_perm(words[..., 0, v], words[..., 1, v],
                              0x7362 if h else 0x5140)
                lo, hi = lo16(p), hi16(p)
                a[..., 2 * v + h, :] = np.stack(
                    [byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632)], -1)
    # A (16 x Kstep): register j holds row g (+ 8 for j odd) at K 4t + i
    # (+ 16 for j >= 2)
    at = np.zeros((tiles, nslots, 8, 16, kstep), np.int64)
    for j in range(a.shape[-1]):
        vals = int8_bytes(a[..., j])  # (tiles, slots, 32, 8, 4)
        for i in range(4):
            at[:, :, :, G + 8 * (j % 2), 4 * T + i + 16 * (j // 2)] = \
                vals[..., i].transpose(0, 1, 3, 2)
    buf = stage(np.pad(xq, ((0, 8 - xq.shape[0]), (0, 0))), geo)
    per = 8 if geo["k32"] else 4  # fragment bytes a lane a step
    bb = buf.reshape(nslots, 32, per).view(np.int8).astype(np.int64)
    bt = np.zeros((nslots, kstep, 8), np.int64)
    for j in range(per):
        bt[:, 4 * T + j % 4 + 16 * (j // 4), G] = bb[:, :, j]
    d = at @ bt[None, :, None]  # (tiles, slots, 8, 16, 8)
    c = np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                  d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]], -1)
    return c.transpose(0, 1, 3, 2, 4), at, bt


# A row r of n-tile q holds lane-local column 2q + r // 8 of group r % 8
A_COLUMN = 16 * (np.arange(16) % 8)[None, :] + 2 * np.arange(8)[:, None] \
    + (np.arange(16) // 8)[None, :]


def _case(fmt, k, n, m, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    qt = repack_i4(quantize(w, fmt))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)
    return qt, x


@pytest.mark.parametrize("fmt", list(GEOMETRIES))
def test_fragment_map(fmt):
    """At (512, 208) with 8 rows: the A tiles are 16 * the signed nibbles
    and the B tiles the int8 codes through one K map that covers each
    step's K rows once, and every block's C sums are 16 * its exact dot."""
    geo = geometry(fmt)
    qt, x = _case(fmt, 512, 208, 8, 11)
    xq = int8_rowwise_activations(x)[0].numpy()
    c, at, bt = emulate_dots(qt, xq, geo)
    km = kmap(geo)
    assert sorted(km) == list(range(len(km)))
    kstep, tiles, nslots = len(km), at.shape[0], at.shape[1]
    nib = np.pad(i4_nibbles(qt.planes[I4_PLANE]).numpy().astype(np.int64),
                 ((0, 0), (0, tiles * 128 - 208)))
    krow = np.arange(nslots)[:, None] * kstep + km[None, :]  # (slots, Kstep)
    cols = np.arange(tiles)[:, None, None] * 128 + A_COLUMN[None]  # (tiles, 8, 16)
    want_a = 16 * nib[krow[None, :, None, None, :], cols[:, None, :, :, None]]
    np.testing.assert_array_equal(at, want_a)
    np.testing.assert_array_equal(bt, xq.astype(np.int64).T[krow][:, :, :8])
    # each block's C sums (over its slots) against the exact dot
    blk, spb = geo["blk"], geo["slots"]
    dots = c.reshape(tiles, -1, spb, 32, 8, 4).sum(2)  # (tiles, blocks, ...)
    exact = np.einsum("mbk,bkn->bmn", xq.reshape(8, -1, blk).astype(np.int64),
                      nib.reshape(-1, blk, tiles * 128))
    for q in range(8):
        for e in range(4):
            col = np.arange(tiles)[:, None] * 128 + 16 * G[None, :] + 2 * q + e // 2
            want = 16 * exact[:, (2 * T + e % 2)[None, :], col]  # (blocks, tiles, 32)
            np.testing.assert_array_equal(dots[..., q, e].transpose(1, 0, 2), want)


# ----------------------------------------------------------------- (iii)
def bf_plan(k, tiles, nseg, sms, geo):
    """csrc bf_plan: (K rows a CTA, K splits)."""
    slots, unit = 2 * sms, geo["blk"]
    meta = 8 if geo["meta"] is np.float32 else 4
    blk_bytes = 128 * nseg * (unit // 2 + meta)
    best = None
    for waves in range(1, 17):
        want = waves * slots // tiles
        if want < 1:
            continue
        rows = -(-(-(-k // want)) // unit) * unit
        if rows > MAX_KC:
            continue
        splits = -(-k // rows)
        cost = -(-tiles * splits // slots) * (CTA_COST + rows // unit * blk_bytes)
        if best is None or cost < best[0]:
            best = (cost, rows, splits)
    return best[1:]


def emulate_gemv(qt, x, geo, sms=132):
    """The whole GEMV: the walk's dots, then per block t = bf16(xsum) *
    fold + f32(dot) * (xs * sc) and acc += t in float32 (the loop's
    operations), each warp its blocks lb = warp, warp + 8, ... of the
    CTA's slice, the warps' sums in warp order from 0, the splits' in
    split order.  Returns (M, N) float32."""
    m = x.shape[0]
    xq, xs = int8_rowwise_activations(x)
    xq, xs = xq.numpy(), xs.numpy()[:, 0]
    k, n = qt.storage_k, int(qt.shape[-1])
    blk, spb = geo["blk"], geo["slots"]
    tiles = -(-n // 128)
    c, _, _ = emulate_dots(qt, xq, geo)
    dots = c.reshape(tiles, -1, spb, 32, 8, 4).sum(2)  # (tiles, blocks, 32, 8, 4)
    # back to (blocks, M rows, N columns) through the C map
    dmat = np.zeros((k // blk, 8, tiles * 128), np.int64)
    for q in range(8):
        for e in range(4):
            col = np.arange(tiles)[:, None] * 128 + 16 * G[None, :] + 2 * q + e // 2
            dmat[:, (2 * T + e % 2)[None, :].repeat(tiles, 0), col] = \
                dots[..., q, e].transpose(1, 0, 2)
    dmat = dmat[:, :m, :n]
    assert not (dmat % 16).any()
    xv = x.float().numpy()
    xsum = bf16_value(bf16_round(walk_block_sum(xv.reshape(m, -1, blk))))
    np.testing.assert_array_equal(xsum, bf16_value(bf16_round(
        loop_block_sum(xv.reshape(m, -1, blk)))))
    sc = qt.scale.numpy().astype(np.float32)
    bs = (np.zeros_like(sc) if qt.base is None
          else qt.base.numpy().astype(np.float32))
    fold = bf16_value(bf16_round(f32(f32(sc * np.float32(8)) + bs)))
    kc, splits = bf_plan(k, tiles, 1, sms, geo)
    y = np.zeros((m, n), np.float32)
    for z in range(splits):
        nblk = (min(kc, k - z * kc)) // blk
        red = np.zeros((m, n), np.float32)
        for w in range(WARPS):
            acc = np.zeros((m, n), np.float32)
            for lb in range(w, nblk, WARPS):
                kb = z * kc // blk + lb
                t = f32(f32(xsum[:, kb, None] * fold[kb]) + f32(
                    f32(dmat[kb] >> 4).astype(np.float32)
                    * f32(xs[:, None] * sc[kb])))
                acc = f32(acc + t)
            red = f32(red + acc)
        y = red if splits == 1 else f32(y + red)
    return y


@pytest.mark.parametrize("fmt", list(GEOMETRIES))
def test_emulated_gemv_matches_plain(fmt):
    """At (512, 208) with 8, 3 and 1 rows and at a ragged N = 100 with 5
    rows, on the card's plan (132 SMs) and on a one-wave plan of 2 SMs
    (many blocks a CTA, every warp and split order): within REL_TOL *
    max|plain| of i4x8_matmul_plain."""
    geo = geometry(fmt)
    for seed, (k, n, ms) in enumerate(((512, 208, (8, 3, 1)), (256, 100, (5,)))):
        qt, x = _case(fmt, k, n, 8, 30 + seed)
        for m in ms:
            ref = i4x8_matmul_plain(x[:m], qt).numpy()
            for sms in (132, 2):
                y = emulate_gemv(qt, x[:m], geo, sms)
                err = np.abs(y - ref).max()
                assert err <= REL_TOL * np.abs(ref).max(), (fmt, n, m, sms, err)
                assert err <= 1e-5 * np.abs(ref).max(), (fmt, n, m, sms, err)


# ----------------------------------------------------------------- (iv)
def static_smem(geo, nseg):
    """gemv_body's static shared memory of the 8-row walk instantiation:
    x_s (8 rows x 2048 codes), red_s, xsum_s, xs_s, inv_s, xrow_s, orow_s,
    last_s, nrows_s."""
    return (8 * MAX_KC + 8 * (128 * nseg + 4) * 4 + 8 * (MAX_KC // geo["blk"]) * 4
            + 4 * 8 * 4 + 2 * 4)


@pytest.mark.parametrize("fmt", list(GEOMETRIES))
def test_slot_geometry_and_plan(fmt):
    """Two CTAs of the GLU instantiation (the larger) fit an SM's 228 KB
    with their rings and 1 KB reserved each; a block's byte rows are copied
    once over its slots; the plan covers K once in whole blocks of at most
    2048 rows at llama2-7b's and 13b's products, one and two segments."""
    geo = geometry(fmt)
    slot = 32 * geo["chunks"] + 8 * geo["meta_chunks"]
    ring = WARPS * geo["ring"] * slot * 16
    assert 2 * (static_smem(geo, 2) + ring + 1024) <= 228 * 1024, (fmt, ring)
    assert ring >= WARPS * 8 * 128 * 4  # the warps' sums meet in the rings
    copied = sorted(j * geo["rows"] + t + 4 * i for j in range(geo["slots"])
                    for t in range(4) for i in range(geo["chunks"]))
    assert copied == list(range(geo["blk"] // 2))
    for k, n, nseg in ((4096, 12288, 1), (4096, 4096, 1), (4096, 22016, 2),
                       (11008, 4096, 1), (5120, 15360, 1), (5120, 27648, 2),
                       (13824, 5120, 1), (512, 208, 1), (1024, 33792, 1)):
        tiles = -(-n // nseg // 128)
        kc, splits = bf_plan(k, tiles, nseg, 132, geo)
        assert kc % geo["blk"] == 0 and kc <= MAX_KC, (fmt, k, n)
        assert kc * (splits - 1) < k <= kc * splits, (fmt, k, n)
    # the card test's shape where the walk and the loop take one split
    assert bf_plan(1024, 264, 1, 132, geo) == (1024, 1)
