"""X1, X2 and X3 on the tensor cores (csrc/unpack_exp.cu's
`unpack_mma_nibble` in its three decode modes, gemv_mma.cuh's design),
emulated in numpy on the CPU, where no card runs them.

(i)   The bf16x2 bit tricks give the plain versions' weights bit for bit:
      X3's raw nibble (the bits 0x4300 | u minus 128) for all 16 nibbles in
      every byte position, and X2's signed and X1's unsigned nibble times a
      bf16 scale (nibble_pair, unsigned_nibble_pair) over a sweep of
      scales, against plain_c's, plain_b's and plain_a's own weight
      arithmetic.
(ii)  The ring's slot map: the 16-byte chunks that a lane copies are
      exactly those it reads, each chunk of a slot's byte rows is read by
      one lane, and the 8 lanes of each quarter warp read 8 distinct bank
      groups.
(iii) The walks register by register (the plan's K splits, each warp's
      64-row blocks as two slots through the ring, the A registers from the
      slot's chunks, the B fragments, mma.sync per n-tile, X3's per-warp
      sums folded by one fma per C register with that register's column
      scale when the warp's share of a superblock ends, the warps' sums in
      warp order and the splits' in split order, each in float32) against
      plain_a, plain_b and plain_c within 1e-5 * max|plain|: the emulation
      sums each mma's 16 products in float64, the plain versions in
      float32 in another order.  plain_b and plain_c are tied to the JAX
      package's run_b and run_c by tests/test_torch_unpack.py; X1's test
      also holds plain_a against run_a in interpret mode here, within
      2^-7 * max|ref| (as tests/test_torch_unpack.py).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas

from inferflow_tpu_torch.tools import exp_unpack as tx
from test_torch_gemv_mma import (G, T, a_matrix, b_matrix, bf16_value,
                                 bits_of, byte_perm, c_lanes, frag_buffer,
                                 halves, nibble_pair, raw_nibble_pair, splat,
                                 unsigned_nibble_pair)

# csrc unpack_exp.cu: kNWarps, kNRing, kNRows, kNRowChunks, kNScale,
# kNSlot, kNMaxKc
WARPS, RING, ROWS, ROW_CHUNKS, SCALE, SLOT, MAX_KC = 8, 2, 16, 10, 160, 176, 512
SMS = 132  # an H100's SMs
ROOT = pathlib.Path(__file__).resolve().parents[1]


def plan(k, n, blk, sms):
    """csrc plan_nibble (X4's plan_d): K rows per CTA, 64-row blocks for
    about two CTAs per SM, whole superblocks for X3, and the K splits."""
    tiles, blocks, unit = -(-n // 128), k // 64, blk // 64 if blk else 1
    want = max(1, -(-2 * sms // tiles))
    per = min(-(-(-(-blocks // want)) // unit) * unit,
              MAX_KC // 64 // unit * unit)
    return per * 64, -(-blocks // per)


# ----------------------------------------------------------------- (i)
def test_nibble_bits_match_plain_weights():
    pairs = np.arange(256, dtype=np.uint32)  # low nibble | high nibble << 4
    packed = torch.from_numpy(pairs.astype(np.uint8)[:, None])  # (256, 1)
    raw = bits_of(torch.stack([(packed & 0xF).float(),
                               (packed >> 4).float()]).to(torch.bfloat16))
    for c in range(4):
        lo, hi = halves(raw_nibble_pair(pairs << np.uint32(8 * c), c))
        np.testing.assert_array_equal(lo, raw[0, :, 0])
        np.testing.assert_array_equal(hi, raw[1, :, 0])
    sweep = np.array([0.0, 1.0, -1.0, 0.0123, 0.00999, 3.0e37, -2.5e-3,
                      1.0e-38, 3.0e-39, 2.0 ** -126, 2.0 ** -133, 7.0e-5,
                      1000.5, 0.33325], np.float32)
    scales = torch.from_numpy(sweep).to(torch.bfloat16)
    # 128 byte rows (all 256 nibble pairs over two rows of 64 = one block)
    codes4 = packed.reshape(128, 2)
    for sc in scales:
        scale = sc.reshape(1, 1).expand(4, 2).contiguous()  # K/64 rows
        want = bits_of((tx._nibbles(codes4, True) * tx._scale_rows(scale, 64))
                       .to(torch.bfloat16))  # plain_b's weights, (256, 2)
        # plain_a's weights: the low and high nibbles of byte row r
        sc32 = tx._scale_rows(scale, 32)
        want_a = [bits_of(((codes4 >> sh) & 0xF).float().mul(sc32)
                          .to(torch.bfloat16)) for sh in (0, 4)]
        sc2 = splat(sc.float().item())
        for c in range(4):
            w = pairs << np.uint32(8 * c)
            lo, hi = halves(nibble_pair(w, c, sc2))
            np.testing.assert_array_equal(
                lo, want[2 * (pairs // 2), pairs % 2])
            np.testing.assert_array_equal(
                hi, want[2 * (pairs // 2) + 1, pairs % 2])
            lo, hi = halves(unsigned_nibble_pair(w, c, sc2))
            np.testing.assert_array_equal(lo, want_a[0][pairs // 2, pairs % 2])
            np.testing.assert_array_equal(hi, want_a[1][pairs // 2, pairs % 2])


# ----------------------------------------------------------------- (ii)
def test_ring_slot_map():
    read = np.zeros(SLOT, int)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        reads = {(8 * j + t + dr) * ROW_CHUNKS + g
                 for j in (0, 1) for dr in (0, 4)}
        copies = {(t + 4 * q) * ROW_CHUNKS + g for q in range(4)}
        assert reads == copies
        for ch in reads:
            read[ch] += 1
        # the scale chunks of the group's 16 columns (bytes 32g .. 32g +
        # 31 of the scale row): lanes t < 2 copy chunk 2g + t
        assert {SCALE + 2 * g + tt for tt in (0, 1)} == {
            SCALE + (32 * g + 16 * tt) // 16 for tt in (0, 1)}
    # every code chunk of a byte row (its 128 bytes from row * ROW_CHUNKS)
    # is read by one lane
    bulk = {r * ROW_CHUNKS + c for r in range(ROWS) for c in range(8)}
    assert set(np.flatnonzero(read)) == bulk and (read[list(bulk)] == 1).all()
    assert SCALE >= ROWS * ROW_CHUNKS and SLOT == SCALE + 16
    # a 16-byte load is served a quarter warp (8 lanes) at a time: their
    # chunks fall in 8 distinct groups of 4 banks
    for j in (0, 1):
        for dr in (0, 4):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                groups = {((8 * j + ln % 4 + dr) * ROW_CHUNKS + ln // 4) % 8
                          for ln in lanes}
                assert len(groups) == 8


# ----------------------------------------------------------------- (iii)
def emulate_walk(x, codes, scale, blk=0, sms=SMS, unsigned=False):
    """X2 (blk 0: codes signed nibbles), X1 (blk 0 and `unsigned`: codes
    unsigned nibbles) or X3 (raw nibbles, superblocks of blk values):
    unpack_mma_nibble register by register, planned for a card of `sms`
    SMs.  x (8, K) float32 (bf16 values), codes (K/2, N)
    uint8, scale (K/64, N) float32 (bf16 values).  Returns y (8, N)
    float32."""
    k, n = 2 * codes.shape[0], codes.shape[1]
    tiles = -(-n // 128)
    pad = tiles * 128 - n
    codes_p = np.pad(codes, ((0, 0), (0, pad)))  # the per-lane zero fill
    scale_b = np.pad(bits_of(torch.from_numpy(scale).to(torch.bfloat16)),
                     ((0, 0), (0, pad)))
    xb = frag_buffer(bits_of(torch.from_numpy(x).to(torch.bfloat16)), k)
    kc, ksplit = plan(k, n, blk, sms)
    split_sums = []
    for z in range(ksplit):
        k0 = z * kc
        nblk = min(kc, k - k0) // 64

        def folds(lb):
            kb, per = k0 // 64 + lb, blk // 64
            return lb + WARPS >= nblk or (kb + WARPS) // per != kb // per

        warp_sums = []
        for w in range(WARPS):
            ring = np.zeros((tiles, RING, SLOT, 16), np.uint8)
            slots = ((nblk - 1 - w) // WARPS + 1) * 2 if w < nblk else 0

            def issue(u):
                if u >= slots:
                    return
                lb, h = w + (u // 2) * WARPS, u % 2
                kb = k0 // 64 + lb
                sl = ring[:, u % RING]
                for r in range(ROWS):
                    sl[:, r * ROW_CHUNKS:r * ROW_CHUNKS + 8] = codes_p[
                        kb * 32 + h * ROWS + r].reshape(tiles, 8, 16)
                if h == 0 and (not blk or folds(lb)):
                    srow = kb - kb % (blk // 64) if blk else kb
                    sl[:, SCALE:SCALE + 16] = scale_b[srow].view(
                        np.uint8).reshape(tiles, 16, 16)

            acc = np.zeros((tiles, 32, 8, 4), np.float32)
            part = np.zeros_like(acc)
            for u in range(RING - 1):
                issue(u)
            for u in range(slots):
                issue(u + RING - 1)
                sl = ring[:, u % RING].view(np.uint32)  # (tiles, SLOT, 4)
                lb, h = w + (u // 2) * WARPS, u % 2
                if h == 0 and (not blk or folds(lb)):
                    sw = np.concatenate([sl[:, SCALE + 2 * G],
                                         sl[:, SCALE + 2 * G + 1]], -1)
                    sc2 = np.stack([byte_perm(sw[..., c // 2], 0,
                                              0x3232 if c % 2 else 0x1010)
                                    for c in range(16)], -1)
                for j in (0, 1):
                    lo = sl[:, (8 * j + T) * ROW_CHUNKS + G]  # (tiles, 32, 4)
                    hi = sl[:, (8 * j + T + 4) * ROW_CHUNKS + G]
                    a = np.zeros((tiles, 32, 8, 4), np.uint32)
                    for v in range(4):
                        for hh in (0, 1):
                            c0, c1 = 2 * hh, 2 * hh + 1
                            if blk:
                                regs = [raw_nibble_pair(lo[..., v], c0),
                                        raw_nibble_pair(lo[..., v], c1),
                                        raw_nibble_pair(hi[..., v], c0),
                                        raw_nibble_pair(hi[..., v], c1)]
                            else:
                                s0, s1 = sc2[..., 4 * v + c0], sc2[..., 4 * v + c1]
                                dec = (unsigned_nibble_pair if unsigned
                                       else nibble_pair)
                                regs = [dec(lo[..., v], c0, s0),
                                        dec(lo[..., v], c1, s1),
                                        dec(hi[..., v], c0, s0),
                                        dec(hi[..., v], c1, s1)]
                            a[..., 2 * v + hh, :] = np.stack(regs, -1)
                    b = xb[k0 // 16 + lb * 4 + 2 * h + j]
                    d = (bf16_value(a_matrix(a.transpose(0, 2, 1, 3)))
                         .astype(np.float64) @ bf16_value(b_matrix(b)))
                    into = part if blk else acc
                    into[:] = (into + c_lanes(d).transpose(0, 2, 1, 3)
                               ).astype(np.float32)
                if blk and h == 1 and folds(lb):
                    for c in range(16):  # C registers (c // 2, 2 (c % 2) + e)
                        half = sw[..., c // 2]
                        sc = ((half & 0xFFFF0000) if c % 2 else
                              (half << 16)).astype(np.uint32).view(np.float32)
                        for e in (0, 1):
                            q, r = c // 2, 2 * (c % 2) + e
                            acc[..., q, r] = (part[..., q, r].astype(np.float64)
                                              * sc + acc[..., q, r]).astype(
                                                  np.float32)
                    part[:] = 0
            warp_sums.append(acc)
        tot = warp_sums[0]
        for ws in warp_sums[1:]:
            tot = tot + ws  # float32, warp order
        y = np.zeros((8, tiles * 128), np.float32)
        cols = (np.arange(tiles)[:, None] * 128 + 16 * G[None, :])
        for q in range(8):
            for e in range(4):
                y[2 * T[None, :] + e % 2, cols + 2 * q + e // 2] = tot[..., q, e]
        split_sums.append(y)
    out = np.zeros((8, tiles * 128), np.float32)
    for y in split_sums:
        out = out + y  # float32, split order
    return out[:, :n]


def _inputs(rng, k, n):
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32)).to(
        torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0, 0.01, (k // 64, n)).astype(
        np.float32)).to(torch.bfloat16)
    return x, scale


def test_x2_walk_matches_plain():
    """K = 512 and 1024, N = 256 and a ragged N = 100 (a multiple of 4,
    not of 16: the copies' zero fill), K = 64 (one warp) and 37 blocks (a
    short last split), each planned for 132 SMs (one block a CTA at these
    widths) or for 1 (512 rows a CTA: 8 warps)."""
    rng = np.random.default_rng(15)
    for k, n, sms in ((512, 256, 1), (512, 256, SMS), (1024, 100, 1),
                      (64, 100, SMS), (64 * 37, 128, 1)):
        x, scale = _inputs(rng, k, n)
        codes4 = tx.pack_nibbles(torch.from_numpy(
            rng.integers(-8, 8, (k, n)).astype(np.int32)))
        plain = tx.plain_b(x, codes4, scale).numpy()
        y = emulate_walk(x.float().numpy(), codes4.numpy(),
                         scale.float().numpy(), sms=sms)
        err = np.abs(y - plain).max()
        assert err <= 1e-5 * np.abs(plain).max(), (k, n, err)


def test_x3_walk_matches_plain():
    """Superblocks of 128, 256, 384 and 512 values, K = 512 and 1024 (768
    and 1152 for an odd number of superblocks and 384's whole superblocks
    per CTA), N = 256 and 100, planned for 132 SMs or 1; each C register
    folds with its own column's scale."""
    rng = np.random.default_rng(16)
    for blk, k, n, sms in ((128, 512, 256, 1), (128, 1152, 100, SMS),
                           (256, 1024, 256, 1), (256, 768, 100, SMS),
                           (384, 768, 256, 1), (512, 1024, 100, SMS)):
        x, scale = _inputs(rng, k, n)
        packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n)).astype(
            np.uint8))
        plain = tx.plain_c(x, packed, scale, blk).numpy()
        y = emulate_walk(x.float().numpy(), packed.numpy(),
                         scale.float().numpy(), blk, sms)
        err = np.abs(y - plain).max()
        assert err <= 1e-5 * np.abs(plain).max(), (blk, k, n, err)


def test_x1_walk_matches_plain_and_jax(monkeypatch):
    """X1 (unsigned nibbles, X2's walk) at X2's shapes and plans: the
    emulated kernel within 1e-5 * max|plain_a|, and plain_a within 2^-7 *
    max|ref| of the JAX package's run_a in interpret mode (K = 512 and
    1024, N = 256, its column tile 128)."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_unpack", ROOT / "tools" / "exp_unpack.py")
    jx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jx)
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    rng = np.random.default_rng(17)
    for k, n, sms in ((512, 256, 1), (512, 256, SMS), (1024, 100, 1),
                      (64, 100, SMS), (64 * 37, 128, 1), (1024, 256, SMS)):
        x, scale = _inputs(rng, k, n)
        packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n)).astype(
            np.uint8))
        plain = tx.plain_a(x, packed, scale).numpy()
        y = emulate_walk(x.float().numpy(), packed.numpy(),
                         scale.float().numpy(), sms=sms, unsigned=True)
        err = np.abs(y - plain).max()
        assert err <= 1e-5 * np.abs(plain).max(), (k, n, err)
        if n == 256 and sms == SMS:
            ref = np.asarray(jx.run_a(
                jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(packed.numpy()),
                jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16),
                k, n, 128), np.float32)
            assert np.abs(plain - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
